// Hand-written Hopper (sm_90a) kernel F: flash-attention forward.
//
// Replaces the Pallas kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention.py:71, pallas_call at :90).  Wrapper and
// plain PyTorch version: repro_torch/kernels/flash_attention.py.
//
// out[b, i, h, :] = softmax_j(scale * q[b, i, h, :] . k[b, j, h / group, :])
//                   @ v[b, :, h / group, :]
// over the keys j < Skv (the TRUE key length: ragged edges are masked here,
// nothing is padded) and, when causal, j <= i + q_offset.  Online softmax
// with m, l and acc in fp32; the scale is applied in fp32 after the load,
// as the Pallas kernel does; out = acc / max(l, 1e-30) in q's dtype.
// Layouts are the public ones, [B, S, H, hd], read with their strides.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (nvcc's default FMA contraction: the kernel is
//        held to a tolerance against its plain version, not to bits)
//
// Bound: at the serving shapes (S = 2048, hd = 64, causal) operations --
// 4 * S^2 / 2 * hd FLOP per (batch, head) against 2 * S * hd * 2 bytes of
// q/k/v/out per head row -- about 1.4e11 FLOP against 0.27 GB at B = 8,
// H = 32.  Design (simple first, no tensor cores): one block of 256 threads
// per (batch, q-head, 64-row q tile) loops over 64-key K/V tiles staged in
// shared memory as fp32; each thread owns a 4 x 4 block of the score tile
// and a 4 x hd/16 block of acc, all in registers.  The 16 threads that share
// a row reduce its max and sum with half-warp shuffles.  Causal tiles past
// the diagonal are skipped.  The dot products are fp32 FMAs from shared
// memory (two loads per FMA pair), which bounds it well below the bf16
// tensor-core rate; mma.sync / wgmma tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hq * ((Sq + BQ - 1) / BQ);
  if (blocks == 0 || Skv == 0) return (int)cudaGetLastError();
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, HD><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, Hq, Hkv,
      causal, q_offset, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
              int q_offset, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, Sq, Hq, hd], k/v [B, Skv, Hkv, hd], out [B, Sq, Hq, hd], all
// contiguous and of one dtype (bf16 when is_bf16, else fp32); hd in
// {16, 32, 64, 128}; Hq a multiple of Hkv; q_offset >= 0.  Launches on
// ``stream`` and returns cudaGetLastError().
int launch_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                           int hd, int causal, int q_offset, int is_bf16,
                           void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, hd,
                                    causal, q_offset, s);
  return launch_hd<float>(q, k, v, out, B, Sq, Skv, Hq, Hkv, hd, causal,
                          q_offset, s);
}

}  // extern "C"
