// Hand-written Hopper (sm_90a) kernel F: flash-attention forward, in two
// kernels.
//
// Replaces the Pallas kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py:71, pallas_call at :90).  Wrapper,
// dispatch and plain PyTorch version: repro_torch/kernels/flash_attention.py.
//
// out[b, i, h, :] = softmax_j(scale * q[b, i, h, :] . k[b, j, h / group, :])
//                   @ v[b, :, h / group, :]
// over the keys j < Skv (the TRUE key length: ragged edges are masked here,
// nothing is padded) and, when causal, j <= i + q_offset.  Online softmax
// with m, l and acc in fp32; out = acc / max(l, 1e-30) in q's dtype.
// Layouts are the public ones, [B, S, H, hd], read with their strides.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (nvcc's default FMA contraction: the kernels are
//        held to a tolerance against their plain version, not to bits)
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s): at the serving
// shape (B = 8, S = 2048, 32 heads of 64, causal) the work is 4 * hd *
// S(S+1)/2 FLOP per (batch, head), 1.4e11 FLOP, against 0.27 GB of q/k/v/out:
// operations bound it, 0.139 ms.
//
// flash_fwd_wgmma_kernel<HD> (bf16, HD in {64, 128}; the serving path):
//   * Grid: one CTA per (batch, q-head, 128-row q tile), q tiles issued
//     longest first along the causal diagonal.  256 threads = two consumer
//     warpgroups, each owning 64 query rows.
//   * K/V tiles of 64 keys in a ring of 3 stages in shared memory, filled by
//     16-byte cp.async copies (zero-filled past Skv) that every thread issues
//     two tiles ahead of the one it computes on, one __syncthreads a tile;
//     Q is loaded once.  The tiles sit in wgmma's unswizzled core-matrix
//     layout (8 rows x 16 bytes contiguous), so a thread's copies land in
//     consecutive 16-byte slots.  Shared memory: (128 + 2 * 3 * 64) * HD * 2
//     bytes = 64 KB at HD = 64 (two CTAs, 16 warps per SM, at 127
//     registers a thread), 128 KB at HD = 128 (one CTA).
//   * S = Q K^T: wgmma m64n64k16 bf16 x bf16 -> fp32, both operands from
//     shared memory, unrounded.  The online softmax runs in the wgmma
//     accumulator registers: a row lives in 4 threads (2 shuffles); masks
//     only on the diagonal tile and on the tile past Skv; tiles wholly past
//     a warpgroup's diagonal are skipped.  The scale times log2 e is folded
//     into one FMA before ex2 (P = 2^(s sl2 - m sl2)).  A warpgroup waits
//     for its own S and P V products; the tensor cores overlap them with
//     the softmax of the other three warpgroups on the SM.
//   * O += P V: P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//     converted in registers into wgmma A fragments (the RS form), each
//     multiplied into V (transposed-B form, V unrounded): two wgmma
//     m64n{HD}k16 per 16 keys.  l sums the fp32 P.
//   * Why the split: a bf16 P carries 8 bits; rounded once, the output
//     misses the element-by-element rule (|kernel - plain| <= 2^-7 |plain|
//     + 1e-5 max(1, max |plain|)) by up to 24.7x at S = 2048, hd = 64 (an
//     fp16 P by 3.7x); P_hi + P_lo carries ~16 bits and lands at 0.96x, one
//     bf16 ulp, like an fp32 product (PyTorch emulation at S = 2048, four
//     heads; tests/test_torch_split.py pins it at a smaller size).  The
//     second product is overhead, not work: the bound does not count it.
//
// flash_fwd_fma_kernel<T, HD> (fp32 inputs, and bf16 at HD in {16, 32}):
//   the first version of kernel F, fp32 FMAs from shared memory, no tensor
//   cores.  One block of 256 threads per (batch, q-head, 64-row q tile)
//   loops over 64-key K/V tiles staged in shared memory as fp32; each thread
//   owns a 4 x 4 block of the score tile and a 4 x hd/16 block of acc in
//   registers; the 16 threads of a row reduce its max and sum with
//   half-warp shuffles; causal tiles past the diagonal are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ----------------------------------------------------------------------
// flash_fwd_fma_kernel
// ----------------------------------------------------------------------
namespace fma_path {


constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per K/V tile
constexpr int THREADS = 256;    // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq,
                 int Skv, int Hq, int Hkv, int causal, int q_offset,
                 float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);         // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);         // [BK][HD]
  float* Ps = Vs + BK * HD;               // [BQ][BK + 1]

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % Hq;
  const int b = blockIdx.x / (n_qt * Hq);
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  constexpr int DJ = HD / 16;             // acc columns per thread

  const long long q_row = (long long)Hq * HD;    // stride of a sequence step
  const long long kv_row = (long long)Hkv * HD;
  const T* qb = q + ((long long)b * Sq * Hq + h) * HD;
  const T* kb = k + ((long long)b * Skv * Hkv + hk) * HD;
  const T* vb = v + ((long long)b * Skv * Hkv + hk) * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int i = q0 + r;
    Qs[r * (HD + 1) + d] = i < Sq ? to_f32(qb[i * q_row + d]) * scale : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < DJ; ++c) acc[a][c] = 0.0f;
  }

  // keys past the last real query row's causal limit are never needed
  int kv_end = Skv;
  if (causal) {
    const int last = min(q0 + BQ, Sq) - 1 + q_offset;
    kv_end = min(Skv, last + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                       // previous tile fully consumed
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      const int j = k0 + r;
      const bool in = j < Skv;
      Ks[r * (HD + 1) + d] = in ? to_f32(kb[j * kv_row + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_f32(vb[j * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty + 16 * a) * (HD + 1) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = Ks[(tx + 16 * c) * (HD + 1) + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += qa[a] * kc[c];
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a + q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos);
        s[a][c] = ok ? s[a][c] : NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)   // the row's 16 threads
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        Ps[(ty + 16 * a) * (BK + 1) + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DJ; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();                       // P visible to all threads

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[4], vc[DJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty + 16 * a) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DJ; ++c) vc[c] = Vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DJ; ++c) acc[a][c] += pa[a] * vc[c];
    }
  }

  T* ob = out + ((long long)b * Sq * Hq + h) * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < DJ; ++c)
      store(&ob[i * q_row + tx + 16 * c], acc[a][c] * inv);
  }
}

template <int HD>
constexpr int smem_bytes() {
  return (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) *
         (int)sizeof(float);
}

template <typename T, int HD>
int launch_fma(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hq * ((Sq + BQ - 1) / BQ);
  if (blocks == 0 || Skv == 0) return (int)cudaGetLastError();
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_fma_kernel<T, HD><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, Hq, Hkv,
      causal, q_offset, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
              int q_offset, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_fma<T, 16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    case 32: return launch_fma<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    case 64: return launch_fma<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    case 128: return launch_fma<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fma_path

// ----------------------------------------------------------------------
// flash_fwd_wgmma_kernel
// ----------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int BQ = 128;         // query rows per CTA: two warpgroups of 64
constexpr int BK = 64;          // keys per K/V tile
constexpr int STAGES = 3;       // K/V tiles in the ring
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wgmma shared-memory descriptor, no swizzle: ``lbo`` is the byte distance
// between neighbouring core matrices along K, ``sbo`` along M or N, for the
// K-major and the transposed (N-contiguous) layout alike.  Checked on the
// card: the K-major Q and K tiles take (128, HD * 16), the transposed V tile
// (HD * 16, 128).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or reuses of registers that an
// asynchronous wgmma owns across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] += A[64 x 16] B[16 x N], A from registers (the accumulator-style
// fragment: a0 row g, a1 row g + 8, a2 / a3 the same rows 8 columns on), B
// from shared memory in its transposed (N-contiguous) form
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + R) of an [n, HD] bf16 matrix whose rows are ``stride``
// elements apart, into ``dst`` in the core-matrix layout (row r, column k
// at ((r / 8) * (HD / 8) + k / 8) * 64 + (r % 8) * 8 + k % 8); rows >= n are
// zero-filled.  Chunk e (16 bytes) lands at dst + 8 e.
template <int R, int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int n,
                                          int tid) {
  constexpr int CHUNKS = R * HD / 8;
  static_assert(CHUNKS % THREADS == 0, "tile not a multiple of the block");
#pragma unroll
  for (int it = 0; it < CHUNKS / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int r = (e / HD) * 8 + (e & 7);
    const int kc = (e >> 3) % (HD / 8);
    const int row = row0 + r;
    const bool ok = row < n;
    cp_async16(dst + e * 8, src + (ok ? row : 0) * stride + kc * 8, ok);
  }
}

__device__ __forceinline__ float ex2(float x) {     // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for one warpgroup's 64 rows and a 64-key tile, issued (not
// waited for): HD / 16 wgmma m64n64k16, both operands from shared memory
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint64_t dq,
                                         const bf16* Kt) {
  const uint64_t dk = make_desc(Kt, 128, HD * 16);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)          // 16 columns = 256 bytes
    wgmma_ss_n64(s, dq + 16 * ks, dk + 16 * ks, 1);
  wgmma_commit();
}

// The online-softmax step on a tile of raw scores s (keys k0..): mask (on
// the diagonal / ragged tile only), new maxima m (raw units), rescale of l
// and o, and P = 2^(s sl2 - m sl2) split into bf16 A fragments: 16-key
// slice kk takes n8 tiles 2 kk (a0 row g, a1 row g + 8) and 2 kk + 1 (a2,
// a3).  l sums the fp32 P.
template <int NO>
__device__ __forceinline__ void softmax_split(
    float (&s)[32], float (&o)[NO], uint32_t (&ph)[4][4],
    uint32_t (&pl)[4][4], float& m0, float& m1, float& l0, float& l1,
    bool edge, int k0, int c, int row0, int Skv, int causal, int q_offset,
    float sl2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int key = k0 + 8 * i + 2 * c + (e & 1);
        const int qpos = row0 + 8 * (e >> 1) + q_offset;
        if (key >= Skv || (causal && key > qpos)) s[4 * i + e] = -INFINITY;
      }
      if (e < 2) mx0 = fmaxf(mx0, s[4 * i + e]);
      else mx1 = fmaxf(mx1, s[4 * i + e]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {       // the row's 4 threads
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float base0 = mn0 == -INFINITY ? 0.0f : mn0 * sl2;
  const float base1 = mn1 == -INFINITY ? 0.0f : mn1 * sl2;
  const float al0 = ex2(fmaf(m0, sl2, -base0));
  const float al1 = ex2(fmaf(m1, sl2, -base1));
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float p0 = ex2(fmaf(s[4 * i], sl2, -base0));
    const float p1 = ex2(fmaf(s[4 * i + 1], sl2, -base0));
    const float p2 = ex2(fmaf(s[4 * i + 2], sl2, -base1));
    const float p3 = ex2(fmaf(s[4 * i + 3], sl2, -base1));
    rs0 += p0 + p1;
    rs1 += p2 + p3;
    const int kk = i >> 1, a = 2 * (i & 1);
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(p0, p1);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(p2, p3);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(p0 - __low2float(h01),
                                                     p1 - __high2float(h01));
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(p2 - __low2float(h23),
                                                     p3 - __high2float(h23));
    ph[kk][a] = bf16x2_bits(h01);
    ph[kk][a + 1] = bf16x2_bits(h23);
    pl[kk][a] = bf16x2_bits(l01);
    pl[kk][a + 1] = bf16x2_bits(l23);
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
#pragma unroll
  for (int i = 0; i < NO / 4; ++i) {
    o[4 * i] *= al0;
    o[4 * i + 1] *= al0;
    o[4 * i + 2] *= al1;
    o[4 * i + 3] *= al1;
  }
}

// O += P_hi V + P_lo V, issued (not waited for); 16 keys = two 8-key
// core-matrix groups of V
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4],
                                         const bf16* Vt) {
  const uint64_t dv = make_desc(Vt, HD * 16, 128);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (HD == 64) {
      wgmma_rs_n64_tb(o, ph[kk], dv + 2 * HD * kk);
      wgmma_rs_n64_tb(o, pl[kk], dv + 2 * HD * kk);
    } else {
      wgmma_rs_n128_tb(o, ph[kk], dv + 2 * HD * kk);
      wgmma_rs_n128_tb(o, pl[kk], dv + 2 * HD * kk);
    }
  }
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(THREADS, HD == 64 ? 2 : 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int Sq, int Skv, int Hq, int Hkv, int causal,
                       int q_offset, float sl2, int n_bh, int n_qt) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [BQ][HD]
  bf16* Ks = Qs + BQ * HD;                           // [STAGES][BK][HD]
  bf16* Vs = Ks + STAGES * BK * HD;                  // [STAGES][BK][HD]
  constexpr int NO = HD / 2;                         // O registers a thread

  const int qt = n_qt - 1 - (int)(blockIdx.x / n_bh);   // longest first
  const int bh = (int)(blockIdx.x % n_bh);
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;

  const long long q_row = (long long)Hq * HD, kv_row = (long long)Hkv * HD;
  const bf16* qb = q + ((long long)b * Sq * Hq + h) * HD;
  const bf16* kb = k + ((long long)b * Skv * Hkv + hk) * HD;
  const bf16* vb = v + ((long long)b * Skv * Hkv + hk) * HD;

  // keys past the last real row's causal limit are never needed
  const int kv_end = causal ? min(Skv, min(q0 + BQ, Sq) + q_offset) : Skv;
  const int n_kt = (kv_end + BK - 1) / BK;

  load_tile<BQ, HD>(Qs, qb, q_row, q0, Sq, tid);
  load_tile<BK, HD>(Ks, kb, kv_row, 0, Skv, tid);
  load_tile<BK, HD>(Vs, vb, kv_row, 0, Skv, tid);
  cp_async_commit();
  if (n_kt > 1) {
    load_tile<BK, HD>(Ks + BK * HD, kb, kv_row, BK, Skv, tid);
    load_tile<BK, HD>(Vs + BK * HD, vb, kv_row, BK, Skv, tid);
  }
  cp_async_commit();

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  const int wg_first = q0 + 64 * wg;            // this warpgroup's rows
  const int row0 = wg_first + 16 * w + g;       // this thread's: row0, +8
  const bool wg_live = wg_first < Sq;
  // tile j holds keys this warpgroup needs (uniform over the warpgroup)
  auto live = [&](int j) {
    return wg_live && (!causal || j * BK <= wg_first + 63 + q_offset);
  };
  // the mask is needed on the tile past Skv and across the diagonal
  auto edge = [&](int k0) {
    return k0 + BK > Skv || (causal && k0 + BK - 1 > wg_first + q_offset);
  };
  // Q rows 64 wg.. start (64 wg / 8) * (HD / 8) core matrices in
  const uint64_t dq = make_desc(Qs + 64 * wg * HD, 128, HD * 16);
  uint32_t ph[4][4], pl[4][4];

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait<1>();                         // tile j (and Q) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                            // every warp is past j - 1
    if (j + 2 < n_kt) {
      const int st = (j + 2) % STAGES;
      load_tile<BK, HD>(Ks + st * BK * HD, kb, kv_row, (j + 2) * BK, Skv,
                        tid);
      load_tile<BK, HD>(Vs + st * BK * HD, vb, kv_row, (j + 2) * BK, Skv,
                        tid);
    }
    cp_async_commit();
    if (live(j)) {
      float s[32];
      issue_qk<HD>(s, dq, Ks + (j % STAGES) * BK * HD);
      wgmma_wait0();
      fence_regs(s);
      softmax_split(s, o, ph, pl, m0, m1, l0, l1, edge(j * BK), j * BK, c,
                    row0, Skv, causal, q_offset, sl2);
      issue_pv<HD>(o, ph, pl, Vs + (j % STAGES) * BK * HD);
      wgmma_wait0();
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
    }
  }

  // epilogue: the row sums over the row's 4 threads, then out = O / l
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, off);
    l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, off);
  }
  if (!wg_live) return;
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  bf16* ob = out + ((long long)b * Sq * Hq + h) * HD;
#pragma unroll
  for (int i = 0; i < NO / 4; ++i) {
    const int col = 8 * i + 2 * c;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_row + col) =
          __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * q_row + col) =
          __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                 int q_offset, cudaStream_t stream) {
  constexpr int smem = (BQ + 2 * STAGES * BK) * HD * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const long long n_bh = (long long)B * Hq;
  const long long blocks = n_bh * n_qt;
  if (blocks == 0 || Skv == 0) return (int)cudaGetLastError();
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_wgmma_kernel<HD><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Sq, Skv, Hq,
      Hkv, causal, q_offset, (1.0f / sqrtf((float)HD)) * LOG2E, (int)n_bh,
      n_qt);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// Both entry points: q [B, Sq, Hq, hd], k/v [B, Skv, Hkv, hd], out [B, Sq,
// Hq, hd], all contiguous and of one dtype; Hq a multiple of Hkv; q_offset
// >= 0.  Each launches on ``stream`` and returns cudaGetLastError(); a shape
// it does not take returns cudaErrorInvalidValue.

// The tensor-core kernel: bf16, hd in {64, 128}.
int launch_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                 void* out, int B, int Sq, int Skv, int Hq,
                                 int Hkv, int hd, int causal, int q_offset,
                                 void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return tc::launch_wgmma<64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    case 128: return tc::launch_wgmma<128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The FMA kernel: bf16 (is_bf16) or fp32, hd in {16, 32, 64, 128}.
int launch_flash_attention_fma(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int Hq,
                               int Hkv, int hd, int causal, int q_offset,
                               int is_bf16, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fma_path::launch_fma_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, Hq,
                                             Hkv, hd, causal, q_offset, s);
  return fma_path::launch_fma_hd<float>(q, k, v, out, B, Sq, Skv, Hq, Hkv, hd,
                                   causal, q_offset, s);
}

}  // extern "C"
