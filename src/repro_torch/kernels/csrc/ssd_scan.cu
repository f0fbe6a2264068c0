// Hand-written Hopper (sm_90a) kernel M: the Mamba2 SSD chunked scan, in
// two kernels.
//
// Replaces the Pallas kernel ssd_scan_bhcqd
// (src/repro/kernels/ssd_scan.py:68, pallas_call at :77), whose oracle is
// the XLA path the reference model runs, models/mamba2.py:ssd_chunked.
// Wrapper, dispatch and plain PyTorch version: repro_torch/kernels/ssd_scan.py.
//
// Per (batch, head), over chunks of Q tokens with la = dt * A and
// L = inclusive cumsum(la) inside the chunk:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(L_i - L_j) dt_j x_j  +  exp(L_i) C_i h^T
//   h'    = exp(L_Q) h + sum_j x_j^T (B_j dt_j exp(L_Q - L_j))
// with h [dh, ds] carried from chunk to chunk (h0 at the start, hT out).
// The causal mask is applied in log space before exp (mamba2.py:110-113):
// masked entries are never exponentiated.  A ragged last chunk is masked
// here: rows past s read dt = 0, x = B = C = 0 (decay 1, input 0), which is
// the reference's zero padding, and write nothing.
// Layouts are the public ones: x/y [b, s, nh, dh], dt [b, s, nh], A [nh],
// B/C [b, s, ng, ds] (head h reads group h * ng / nh), h0/hT [b, nh, dh, ds]
// fp32.  y is written in x's dtype.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (default contraction; held to a tolerance)
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s dense bf16): per chunk and head
// the causal half of the two Q x Q products and the two [dh, ds] products
// per row, 2 * (Q(Q+1)/2 * (ds + dh) + 2 * Q * dh * ds) FLOP, as
// chip_smoke.ssd_ops counts it: about 3.45e10 FLOP against about 0.29 GB (x
// and y in bf16 dominate) at zamba2's shapes, b = 8, s = 2048 (Q = 128,
// nh = 64, dh = ds = 64).  Bytes bound it: 0.085 ms.
//
// ssd_scan_mma_kernel<DH, DS> (bf16; dh and ds multiples of 16 up to 128,
// zero-padded to DH, DS in {64, 128}; chunk rows Q <= 128, zero-padded to a
// multiple of 16; the serving path):
//   * One CTA per (batch, head) loops over the chunks (the sequential axis):
//     DH / 16 warps (128 threads at zamba2's widths).  b * nh = 512 CTAs at
//     b = 8.  (Eight warps, two on each h strip, ran no faster: the work a
//     chunk holds is the limit, not the warps in flight.)
//   * Staging: x and B of the next chunk (bf16, as they are) and its dt
//     (fp32) are copied with cp.async while the current chunk computes, into
//     a second stage; C has one buffer, refilled for the next chunk as soon
//     as the current chunk's y is done (it overlaps the state update).  Rows
//     past the chunk or past s and columns past dh / ds are zero-filled.
//     Tiles are [rows][W] bf16 with 16-byte chunks XOR-swizzled by row, so
//     ldmatrix reads 8 rows without bank conflicts.
//     Shared memory at DH = DS = 64: x 2 x 16 KB, B 2 x 16 KB, C 16 KB, one
//     16 KB region that holds h's bf16 halves (h_hi, h_lo) during the y
//     products and B's folded low half during the state update, dt and L:
//     99,856 bytes, two CTAs (8 warps) per SM.  (227 KB at DH = DS = 128,
//     one CTA.)
//   * L is a block-wide scan (warp shuffles, then the warps' totals), kept
//     in log2 units so that each exp is one ex2: the decay's exps, not the
//     products, were the largest share of the kernel's instructions.
//   * All four products run on the tensor cores, mma.sync m16n8k16 bf16 x
//     bf16 -> fp32 with ldmatrix, x, B and C unrounded:
//     - G = C B^T, one product, a 16 x 16 block at a time and only the
//       causal blocks; each warp owns two 16-row strips (w and 7 - w at Q =
//       128), so the causal work is balanced.
//     - y_intra = (G o exp(L_i - L_j) dt_j) x: dt_j is folded into the
//       matrix, not into x; the fp32 block is split into bf16 hi and lo
//       terms straight from the accumulator registers into A fragments: two
//       products; key blocks above the diagonal are skipped.
//     - y_inter = exp(L_i) (C h^T): h is split into bf16 hi and lo copies in
//       shared memory once per chunk: two products.
//     - h' = exp(L_Q) h + x^T (B o dt_j exp(L_Q - L_j)): the scalars are
//       folded into B, split into hi and lo: two products; h stays in fp32
//       accumulator registers across the chunks (warp w owns rows 16 w..).
//   * Why the split: bf16 operands carry 8 bits; rounding the fp32 side of
//     each product once puts y at 42.8x and hT at 30.8x the limits
//     (element by element for bf16 y, |kernel - plain| <= 2^-7 |plain| +
//     1e-5 max(1, max |plain|); normwise 1e-4 for the fp32 state), while
//     the split form lands at 0.96x and 0.04x (PyTorch emulation at S =
//     2048, Q = 128, dh = ds = 64, eight heads; tests/test_torch_split.py
//     pins it at a smaller size).  The extra products are overhead, not
//     work: the bound does not count them.
//   * Not done: with ng = 1 all heads of a batch share G; one CTA over
//     several heads could form it once.
//
// ssd_scan_fma_kernel<T> (fp32 inputs, and every width or chunk the mma
// kernel does not take): the first version of kernel M.  One block of 256
// threads owns one (batch, head) and loops over its chunks, keeping h in
// shared memory (fp32).  Per chunk it stages u = x dt, B, C (fp32, rows
// padded by one word against bank conflicts), scans L with one warp, builds
// the masked decay matrix a tile of rows at a time, and forms y and the new
// h with fp32 FMAs from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ----------------------------------------------------------------------
// ssd_scan_fma_kernel
// ----------------------------------------------------------------------
namespace fma_path {


constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;   // the most a block may opt in to on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// shared-memory floats for chunk Q, widths dh/ds and a decay tile of QT rows
inline long long smem_floats(int Q, int dh, int ds,
                                                 int QT) {
  return (long long)Q * dh            // u
         + 2LL * Q * (ds + 1)         // B, C
         + (long long)dh * (ds + 1)   // h
         + (long long)QT * (Q + 1)    // decay tile
         + 4LL * Q;                   // dt, L, exp(L), exp(L_Q - L)
}

// the largest decay tile (rows) that fits, or 0
inline int pick_tile(int Q, int dh, int ds) {
  const int tiles[] = {64, 32, 16, 8, 4, 2, 1};
  for (int QT : tiles) {
    const int qt = QT < Q ? QT : Q;
    if (smem_floats(Q, dh, ds, qt) * 4 <= MAX_SMEM) return qt;
  }
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_fma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hT, int s, int nh,
                int dh, int ng, int ds, int Q, int QT) {
  extern __shared__ float smem[];
  const int dsp = ds + 1;
  float* us = smem;                       // [Q][dh]
  float* Bs = us + Q * dh;                // [Q][ds + 1]
  float* Cs = Bs + Q * dsp;               // [Q][ds + 1]
  float* hs = Cs + Q * dsp;               // [dh][ds + 1]
  float* Gs = hs + dh * dsp;              // [QT][Q + 1]
  float* dts = Gs + QT * (Q + 1);         // [Q]
  float* Ls = dts + Q;                    // [Q]
  float* eL = Ls + Q;                     // [Q]  exp(L_i)
  float* wL = eL + Q;                     // [Q]  exp(L_Q - L_j)

  const int h = blockIdx.x % nh;
  const int b = blockIdx.x / nh;
  const int g = h * ng / nh;
  const int tid = threadIdx.x;
  const float a = A[h];

  for (int e = tid; e < dh * ds; e += THREADS) {
    const int d = e / ds, n = e % ds;
    hs[d * dsp + n] =
        h0 ? h0[(((long long)b * nh + h) * dh + d) * ds + n] : 0.0f;
  }

  for (int c0 = 0; c0 < s; c0 += Q) {
    __syncthreads();                       // previous chunk fully consumed
    for (int j = tid; j < Q; j += THREADS) {
      const int t = c0 + j;
      dts[j] = t < s ? dt[((long long)b * s + t) * nh + h] : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < Q * dh; e += THREADS) {
      const int j = e / dh, d = e % dh;
      const int t = c0 + j;
      const float xv =
          t < s ? to_f32(x[(((long long)b * s + t) * nh + h) * dh + d]) : 0.0f;
      us[j * dh + d] = xv * dts[j];
    }
    for (int e = tid; e < Q * ds; e += THREADS) {
      const int j = e / ds, n = e % ds;
      const int t = c0 + j;
      const long long off = (((long long)b * s + t) * ng + g) * ds + n;
      Bs[j * dsp + n] = t < s ? to_f32(Bm[off]) : 0.0f;
      Cs[j * dsp + n] = t < s ? to_f32(Cm[off]) : 0.0f;
    }
    // L = inclusive cumsum(dt * A): warp 0, each lane a contiguous run
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int lo = tid * per;
      float run = 0.0f;
      for (int j = lo; j < lo + per && j < Q; ++j) run += dts[j] * a;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (tid >= off) incl += o;
      }
      float acc = incl - run;              // exclusive prefix of this run
      for (int j = lo; j < lo + per && j < Q; ++j) {
        acc += dts[j] * a;
        Ls[j] = acc;
      }
    }
    __syncthreads();
    const float LQ = Ls[Q - 1];
    for (int j = tid; j < Q; j += THREADS) {
      eL[j] = expf(Ls[j]);
      wL[j] = expf(LQ - Ls[j]);
    }
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += QT) {
      // decay tile: G[i, j] = (C_i . B_j) exp(L_i - L_j) for j <= i, else 0
      for (int e = tid; e < QT * Q; e += THREADS) {
        const int ii = e / Q, j = e % Q;
        const int i = r0 + ii;
        float gv = 0.0f;
        if (i < Q && j <= i) {
          const float* ci = Cs + i * dsp;
          const float* bj = Bs + j * dsp;
          for (int n = 0; n < ds; ++n) gv += ci[n] * bj[n];
          gv *= expf(Ls[i] - Ls[j]);
        }
        Gs[ii * (Q + 1) + j] = gv;
      }
      __syncthreads();
      // y rows of this tile: intra-chunk + inter-chunk (h before update)
      for (int e = tid; e < QT * dh; e += THREADS) {
        const int ii = e / dh, d = e % dh;
        const int i = r0 + ii;
        const int t = c0 + i;
        if (i >= Q || t >= s) continue;
        const float* gi = Gs + ii * (Q + 1);
        float intra = 0.0f;
        for (int j = 0; j <= i; ++j) intra += gi[j] * us[j * dh + d];
        const float* ci = Cs + i * dsp;
        const float* hd = hs + d * dsp;
        float inter = 0.0f;
        for (int n = 0; n < ds; ++n) inter += ci[n] * hd[n];
        store(&y[(((long long)b * s + t) * nh + h) * dh + d],
              intra + eL[i] * inter);
      }
      __syncthreads();
    }

    // state update
    const float eQ = eL[Q - 1];
    for (int e = tid; e < dh * ds; e += THREADS) {
      const int d = e / ds, n = e % ds;
      float acc = 0.0f;
      for (int j = 0; j < Q; ++j)
        acc += us[j * dh + d] * wL[j] * Bs[j * dsp + n];
      hs[d * dsp + n] = eQ * hs[d * dsp + n] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < dh * ds; e += THREADS) {
    const int d = e / ds, n = e % ds;
    hT[(((long long)b * nh + h) * dh + d) * ds + n] = hs[d * dsp + n];
  }
}

template <typename T>
int launch_fma(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* h0, void* y, void* hT, int b, int s,
           int nh, int dh, int ng, int ds, int Q, cudaStream_t stream) {
  const int QT = pick_tile(Q, dh, ds);
  if (QT == 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(smem_floats(Q, dh, ds, QT) * 4);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)b * nh;
  if (blocks == 0) return (int)cudaGetLastError();
  ssd_scan_fma_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (const float*)h0, (T*)y, (float*)hT, s, nh, dh, ng, ds, Q,
      QT);
  return (int)cudaGetLastError();
}

}  // namespace fma_path

// ----------------------------------------------------------------------
// ssd_scan_mma_kernel
// ----------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int QMAX = 128;       // chunk rows the kernel takes
constexpr float LOG2E = 1.4426950408889634f;

template <int DH, int DS>
struct Cfg {
  static constexpr int NW = DH / 16;               // warps: an h strip each
  static constexpr int THREADS = NW * 32;
  static constexpr int X = QMAX * DH;              // bf16 elements a stage
  static constexpr int BC = QMAX * DS;
  static constexpr int HH = 2 * DH * DS;           // h_hi, h_lo
  static constexpr int R = HH > BC ? HH : BC;      // h halves / B's low half
  static constexpr int BYTES =
      (2 * X + 3 * BC + R) * 2 + (3 * QMAX + 4) * 4;   // + dt[2], L, sums
  static constexpr int MIN_BLOCKS = (DH == 64 && DS == 64) ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// element (r, col) of a [rows][W] bf16 tile: 16-byte chunks XOR-swizzled by
// the row's low 3 bits
template <int W>
__device__ __forceinline__ int swz(int r, int col) {
  const int ch = col >> 3;
  return r * W + (((ch ^ r) & 7) | (ch & ~7)) * 8 + (col & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {     // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// the fp32 pair (x0, x1) as a bf16 pair hi plus a bf16 pair lo
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// rows [0, QMAX) of a chunk, W bf16 columns each (``cols`` of them real),
// rows >= n zero-filled; ``src`` is row 0, rows ``stride`` elements apart
template <int W, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int n, int rows,
                                          int cols, int tid) {
  constexpr int CPR = W / 8;                      // chunks a row
  for (int e = tid; e < rows * CPR; e += THREADS) {
    const int r = e / CPR, kc = e % CPR;
    const bool ok = r < n && kc * 8 < cols;
    cp_async16(dst + swz<W>(r, kc * 8),
               ok ? src + r * stride + kc * 8 : src, ok);
  }
}

template <int DH, int DS>
__global__ void __launch_bounds__(Cfg<DH, DS>::THREADS,
                                  Cfg<DH, DS>::MIN_BLOCKS)
ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm,
                    const float* __restrict__ h0, bf16* __restrict__ y,
                    float* __restrict__ hT, int s, int nh, int dh, int ng,
                    int ds, int Q) {
  typedef Cfg<DH, DS> K;
  constexpr int NW = K::NW, THREADS = K::THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);   // [2][QMAX][DH]
  bf16* Bs = Xs + 2 * K::X;                        // [2][QMAX][DS]
  bf16* Cs = Bs + 2 * K::BC;                       // [QMAX][DS]
  bf16* Rs = Cs + K::BC;                           // h_hi, h_lo / Bw_lo
  float* dts = reinterpret_cast<float*>(Rs + K::R);   // [2][QMAX]
  float* Ls = dts + 2 * QMAX;                      // [QMAX]
  float* wsum = Ls + QMAX;                         // [4]

  const int h = blockIdx.x % nh;
  const int b = blockIdx.x / nh;
  const int grp = h * ng / nh;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const float a = A[h];
  const int QP = (Q + 15) & ~15;                   // rows, padded to 16
  const int nst = QP / 16;
  const int nch = (s + Q - 1) / Q;

  const long long x_row = (long long)nh * dh, bc_row = (long long)ng * ds;
  const bf16* xb = x + ((long long)b * s * nh + h) * dh;
  const bf16* Bb = Bm + ((long long)b * s * ng + grp) * ds;
  const bf16* Cb = Cm + ((long long)b * s * ng + grp) * ds;
  const float* dtb = dt + (long long)b * s * nh + h;
  bf16* yb = y + ((long long)b * s * nh + h) * dh;

  auto load_xb = [&](int ci, int st) {            // x, B, dt of chunk ci
    const int t0 = ci * Q, n = min(Q, s - t0);
    load_rows<DH, THREADS>(Xs + st * K::X, xb + t0 * x_row, x_row, n, QP,
                           dh, tid);
    load_rows<DS, THREADS>(Bs + st * K::BC, Bb + t0 * bc_row, bc_row, n, QP,
                           ds, tid);
    for (int j = tid; j < QP; j += THREADS)
      cp_async4(dts + st * QMAX + j, j < n ? dtb + (long long)(t0 + j) * nh
                                            : dtb, j < n);
  };
  auto load_c = [&](int ci) {
    const int t0 = ci * Q, n = min(Q, s - t0);
    load_rows<DS, THREADS>(Cs, Cb + t0 * bc_row, bc_row, n, QP, ds, tid);
  };

  load_xb(0, 0);
  load_c(0);
  cp_async_commit();

  // h: warp w owns rows 16 w + g, + 8, all DS columns, in fp32 fragments
  float hacc[DS / 8][4];
  const int d0 = 16 * w + g, d1 = d0 + 8;
#pragma unroll
  for (int t = 0; t < DS / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = e < 2 ? d0 : d1, n = 8 * t + 2 * c + (e & 1);
      hacc[t][e] = h0 && d < dh && n < ds
          ? h0[(((long long)b * nh + h) * dh + d) * ds + n] : 0.0f;
    }
  // h's bf16 halves for the y products: [DH][DS] each, in Rs
  auto write_h = [&]() {
#pragma unroll
    for (int t = 0; t < DS / 8; ++t) {
      const int n = 8 * t + 2 * c;
      uint32_t hi, lo;
      split2(hacc[t][0], hacc[t][1], hi, lo);
      *reinterpret_cast<uint32_t*>(Rs + swz<DS>(d0, n)) = hi;
      *reinterpret_cast<uint32_t*>(Rs + DH * DS + swz<DS>(d0, n)) = lo;
      split2(hacc[t][2], hacc[t][3], hi, lo);
      *reinterpret_cast<uint32_t*>(Rs + swz<DS>(d1, n)) = hi;
      *reinterpret_cast<uint32_t*>(Rs + DH * DS + swz<DS>(d1, n)) = lo;
    }
  };
  write_h();

  for (int ci = 0; ci < nch; ++ci) {
    const int st = ci & 1;
    const int t0 = ci * Q, n_rows = min(Q, s - t0);
    if (ci + 1 < nch) load_xb(ci + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();                              // chunk ci has landed
    __syncthreads();
    const bf16* Xc = Xs + st * K::X;
    bf16* Bc = Bs + st * K::BC;
    const float* dtc = dts + st * QMAX;

    // L = inclusive cumsum(dt * a) over the chunk: warp scans, then totals
    {
      float v = tid < QP ? dtc[tid] * a : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xFFFFFFFFu, v, off);
        if (lane >= off) v += o;
      }
      if (lane == 31 && w < 4) wsum[w] = v;
      __syncthreads();
      if (tid < QP) {
        float add = 0.0f;
        for (int i = 0; i < w; ++i) add += wsum[i];
        Ls[tid] = (v + add) * LOG2E;              // log2 units from here
      }
      __syncthreads();
    }
    const float LQ = Ls[QP - 1];

    // y: each warp takes strips w and 2 NW - 1 - w
    for (int pass = 0; pass < 2; ++pass) {
      const int sp = pass ? 2 * NW - 1 - w : w;
      if (sp >= nst) continue;
      const int i0 = 16 * sp;
      const int ri0 = i0 + g, ri1 = ri0 + 8;
      const float Li0 = Ls[ri0], Li1 = Ls[ri1];
      uint32_t cf[DS / 16][4];                     // C rows i0.., A fragments
#pragma unroll
      for (int ks = 0; ks < DS / 16; ++ks)
        ldsm_x4(cf[ks], Cs + swz<DS>(i0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                     16 * ks + (lane >> 4) * 8));
      float yacc[DH / 8][4];
#pragma unroll
      for (int t = 0; t < DH / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[t][e] = 0.0f;

      // inter-chunk: C (h_hi + h_lo)^T, then times exp(L_i)
#pragma unroll
      for (int ks = 0; ks < DS / 16; ++ks)
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          const int off = swz<DS>(16 * dp + (lane & 7) + (lane >> 4) * 8,
                                  16 * ks + ((lane >> 3) & 1) * 8);
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, Rs + off);
          ldsm_x4(bl, Rs + DH * DS + off);
          mma(yacc[2 * dp], cf[ks], bh[0], bh[1]);
          mma(yacc[2 * dp + 1], cf[ks], bh[2], bh[3]);
          mma(yacc[2 * dp], cf[ks], bl[0], bl[1]);
          mma(yacc[2 * dp + 1], cf[ks], bl[2], bl[3]);
        }
      const float e0 = ex2(Li0), e1 = ex2(Li1);
#pragma unroll
      for (int t = 0; t < DH / 8; ++t) {
        yacc[t][0] *= e0;
        yacc[t][1] *= e0;
        yacc[t][2] *= e1;
        yacc[t][3] *= e1;
      }

      // intra-chunk, one 16-key block at a time up to the diagonal
      for (int kb = 0; kb <= sp; ++kb) {
        const int j0 = 16 * kb;
        float gacc[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[t][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < DS / 16; ++ks) {
          uint32_t bb[4];
          ldsm_x4(bb, Bc + swz<DS>(j0 + (lane & 7) + (lane >> 4) * 8,
                                   16 * ks + ((lane >> 3) & 1) * 8));
          mma(gacc[0], cf[ks], bb[0], bb[1]);
          mma(gacc[1], cf[ks], bb[2], bb[3]);
        }
        // fold exp(L_i - L_j) dt_j, masked in log space, and split
        uint32_t ah[4], al[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = j0 + 8 * t + 2 * c;
          const float Lj0 = Ls[j], Lj1 = Ls[j + 1];
          const float dj0 = dtc[j], dj1 = dtc[j + 1];
          const float v00 = j <= ri0 ? gacc[t][0] * ex2(Li0 - Lj0) * dj0 : 0.0f;
          const float v01 = j + 1 <= ri0 ? gacc[t][1] * ex2(Li0 - Lj1) * dj1 : 0.0f;
          const float v10 = j <= ri1 ? gacc[t][2] * ex2(Li1 - Lj0) * dj0 : 0.0f;
          const float v11 = j + 1 <= ri1 ? gacc[t][3] * ex2(Li1 - Lj1) * dj1 : 0.0f;
          split2(v00, v01, ah[2 * t], al[2 * t]);
          split2(v10, v11, ah[2 * t + 1], al[2 * t + 1]);
        }
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t xb4[4];
          ldsm_x4_t(xb4, Xc + swz<DH>(j0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                      16 * dp + (lane >> 4) * 8));
          mma(yacc[2 * dp], ah, xb4[0], xb4[1]);
          mma(yacc[2 * dp + 1], ah, xb4[2], xb4[3]);
          mma(yacc[2 * dp], al, xb4[0], xb4[1]);
          mma(yacc[2 * dp + 1], al, xb4[2], xb4[3]);
        }
      }

      // store the chunk's real rows and columns
#pragma unroll
      for (int t = 0; t < DH / 8; ++t) {
        const int d = 8 * t + 2 * c;
        if (d >= dh) continue;
        if (ri0 < n_rows)
          *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + ri0) * x_row + d) =
              __floats2bfloat162_rn(yacc[t][0], yacc[t][1]);
        if (ri1 < n_rows)
          *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + ri1) * x_row + d) =
              __floats2bfloat162_rn(yacc[t][2], yacc[t][3]);
      }
    }
    __syncthreads();                               // C, B, h halves read

    if (ci + 1 < nch) load_c(ci + 1);
    cp_async_commit();

    // B o dt_j exp(L_Q - L_j), split: hi over B in place, lo into Rs
    for (int e = tid; e < QP * (DS / 8); e += THREADS) {
      const int j = e / (DS / 8), kc = e % (DS / 8);
      const float wj = dtc[j] * ex2(LQ - Ls[j]);
      const int off = swz<DS>(j, kc * 8);
      uint4 raw = *reinterpret_cast<const uint4*>(Bc + off);
      uint32_t* rw = reinterpret_cast<uint32_t*>(&raw);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q2 = 0; q2 < 4; ++q2) {
        const __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&rw[q2]);
        split2(__low2float(p) * wj, __high2float(p) * wj, hi[q2], lo[q2]);
      }
      *reinterpret_cast<uint4*>(Bc + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Rs + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();

    // h = exp(L_Q) h + x^T (Bw_hi + Bw_lo) for this warp's 16 rows of h
    const float eQ = ex2(LQ);
#pragma unroll
    for (int t = 0; t < DS / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[t][e] *= eQ;
    for (int kb = 0; kb < nst; ++kb) {
      const int j0 = 16 * kb;
      uint32_t ax[4];                              // x^T rows 16 w.., cols j0..
      ldsm_x4_t(ax, Xc + swz<DH>(j0 + (lane & 7) + (lane >> 4) * 8,
                                 16 * w + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int np = 0; np < DS / 16; ++np) {
        const int off = swz<DS>(j0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                16 * np + (lane >> 4) * 8);
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, Bc + off);
        ldsm_x4_t(bl, Rs + off);
        mma(hacc[2 * np], ax, bh[0], bh[1]);
        mma(hacc[2 * np + 1], ax, bh[2], bh[3]);
        mma(hacc[2 * np], ax, bl[0], bl[1]);
        mma(hacc[2 * np + 1], ax, bl[2], bl[3]);
      }
    }
    __syncthreads();                               // x, Bw halves read
    write_h();
  }

#pragma unroll
  for (int t = 0; t < DS / 8; ++t) {
    const int n = 8 * t + 2 * c;
    if (n >= ds) continue;
    float* hb = hT + ((long long)b * nh + h) * dh * ds;
    if (d0 < dh)
      *reinterpret_cast<float2*>(hb + (long long)d0 * ds + n) =
          make_float2(hacc[t][0], hacc[t][1]);
    if (d1 < dh)
      *reinterpret_cast<float2*>(hb + (long long)d1 * ds + n) =
          make_float2(hacc[t][2], hacc[t][3]);
  }
}

template <int DH, int DS>
int launch_mma(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* h0, void* y, void* hT, int b, int s,
               int nh, int dh, int ng, int ds, int Q, cudaStream_t stream) {
  typedef Cfg<DH, DS> K;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel<DH, DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, K::BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)b * nh;
  if (blocks == 0) return (int)cudaGetLastError();
  ssd_scan_mma_kernel<DH, DS><<<(unsigned)blocks, K::THREADS, K::BYTES,
                                stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const float*)h0, (bf16*)y, (float*)hT, s, nh, dh, ng,
      ds, Q);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// Both entry points: x [b, s, nh, dh], B/C [b, s, ng, ds] in one dtype; dt
// [b, s, nh], A [nh], h0 (or NULL for zeros) and hT [b, nh, dh, ds] fp32; y
// like x.  All contiguous; nh a multiple of ng; s >= 1.  Each launches on
// ``stream`` and returns cudaGetLastError(); what it does not take returns
// cudaErrorInvalidValue.

// The tensor-core kernel: bf16; dh and ds multiples of 16 up to 128;
// min(chunk, s) <= 128.
int launch_ssd_scan_mma(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* h0, void* y,
                        void* hT, int b, int s, int nh, int dh, int ng, int ds,
                        int chunk, void* stream) {
  if (ng <= 0 || nh % ng != 0 || chunk <= 0 || s <= 0 || dh <= 0 || ds <= 0 ||
      dh % 16 || ds % 16 || dh > 128 || ds > 128)
    return (int)cudaErrorInvalidValue;
  const int Q = chunk < s ? chunk : s;
  if (Q > tc::QMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dh <= 64 && ds <= 64)
    return tc::launch_mma<64, 64>(x, dt, A, B, C, h0, y, hT, b, s, nh, dh, ng, ds, Q, st);
  if (dh <= 64)
    return tc::launch_mma<64, 128>(x, dt, A, B, C, h0, y, hT, b, s, nh, dh, ng, ds, Q, st);
  if (ds <= 64)
    return tc::launch_mma<128, 64>(x, dt, A, B, C, h0, y, hT, b, s, nh, dh, ng, ds, Q, st);
  return tc::launch_mma<128, 128>(x, dt, A, B, C, h0, y, hT, b, s, nh, dh, ng, ds, Q, st);
}

// The FMA kernel: bf16 (is_bf16) or fp32; widths whose chunk does not fit in
// shared memory return cudaErrorInvalidValue.
int launch_ssd_scan_fma(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* h0, void* y,
                        void* hT, int b, int s, int nh, int dh, int ng, int ds,
                        int chunk, int is_bf16, void* stream) {
  if (ng <= 0 || nh % ng != 0 || chunk <= 0 || s <= 0)
    return (int)cudaErrorInvalidValue;
  const int Q = chunk < s ? chunk : s;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return fma_path::launch_fma<__nv_bfloat16>(x, dt, A, B, C, h0, y, hT, b, s, nh,
                                          dh, ng, ds, Q, st);
  return fma_path::launch_fma<float>(x, dt, A, B, C, h0, y, hT, b, s, nh, dh, ng,
                                ds, Q, st);
}

}  // extern "C"
