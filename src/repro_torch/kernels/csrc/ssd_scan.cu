// Hand-written Hopper (sm_90a) kernel M: the Mamba2 SSD chunked scan.
//
// Replaces the Pallas kernel ssd_scan_bhcqd
// (src/repro/kernels/ssd_scan.py:68, pallas_call at :77), whose oracle is
// the XLA path the reference model runs, models/mamba2.py:ssd_chunked.
// Wrapper and plain PyTorch version: repro_torch/kernels/ssd_scan.py.
//
// Per (batch, head), over chunks of Q tokens with la = dt * A and
// L = inclusive cumsum(la) inside the chunk, u = x * dt:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(L_i - L_j) u_j  +  exp(L_i) C_i h^T
//   h'    = exp(L_Q) h + sum_j (u_j exp(L_Q - L_j))^T B_j
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
// Bound: per chunk and head the causal half of the two Q x Q products and
// the two [dh, ds] products per row, 2 * (Q(Q+1)/2 * (ds + dh)
// + 2 * Q * dh * ds) FLOP, as chip_smoke.ssd_ops counts it: about 3.45e10
// FLOP (the full Q x Q squares would be 5.2e10) against about 0.29 GB (x
// and y in bf16 dominate) at zamba2's shapes, b = 8, s = 2048 (Q = 128,
// nh = 64, dh = ds = 64).  Bytes bound it at the bf16 tensor-core rate; at
// the fp32 FMA rate this kernel uses, operations do.  Design (simple
// first): the TPU grid's sequential chunk axis has no counterpart across
// CUDA blocks, so one block of 256 threads owns one (batch, head) and loops
// over its chunks,
// keeping h in shared memory (fp32) for the whole sequence.  Per chunk it
// stages u, B, C (fp32, rows padded by one word against bank conflicts),
// scans L with one warp, then builds the masked decay matrix a tile of rows
// at a time, and forms y and the new h with fp32 FMAs from shared memory.
// Loads are coalesced along dh / ds.  Tensor-core tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* h0, void* y, void* hT, int b, int s,
           int nh, int dh, int ng, int ds, int Q, cudaStream_t stream) {
  const int QT = pick_tile(Q, dh, ds);
  if (QT == 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(smem_floats(Q, dh, ds, QT) * 4);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)b * nh;
  if (blocks == 0) return (int)cudaGetLastError();
  ssd_scan_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (const float*)h0, (T*)y, (float*)hT, s, nh, dh, ng, ds, Q,
      QT);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [b, s, nh, dh], B/C [b, s, ng, ds] in one dtype (bf16 when is_bf16,
// else fp32); dt [b, s, nh], A [nh], h0 (or NULL for zeros) and hT
// [b, nh, dh, ds] fp32; y like x.  All contiguous; nh a multiple of ng;
// s >= 1.  Widths whose chunk does not fit in shared memory return
// cudaErrorInvalidValue.  Launches on ``stream`` and returns
// cudaGetLastError().
int launch_ssd_scan(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, const void* h0, void* y,
                    void* hT, int b, int s, int nh, int dh, int ng, int ds,
                    int chunk, int is_bf16, void* stream) {
  if (ng <= 0 || nh % ng != 0 || chunk <= 0 || s <= 0)
    return (int)cudaErrorInvalidValue;
  const int Q = chunk < s ? chunk : s;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, h0, y, hT, b, s, nh, dh, ng,
                                 ds, Q, st);
  return launch<float>(x, dt, A, B, C, h0, y, hT, b, s, nh, dh, ng, ds, Q,
                       st);
}

}  // extern "C"
