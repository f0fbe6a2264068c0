// Hand-written Hopper (sm_90a) kernels for the hosting engine's hot loops.
//
// Three kernels, each behind a plain C entry point (loaded with ctypes by
// repro_torch/kernels/_build.py; wrappers in repro_torch/kernels/hosting.py):
//
//   P  slot_uniform        counter-keyed U(0,1) draws (threefry2x32)
//   D  dp_minplus          one chunk of the offline-OPT min-plus recursion
//   S  sim_chunk_alpha_rr  one chunk of the per-slot alpha-RR simulation
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false is required: the reference fixes which multiply-adds are
// one FMA and which are two rounded ops.  XLA:CPU contracts a product that
// feeds an add inside one fusion: in this slice's path that is w = c*lv + svc
// and the margin M*|lv - lv_r| + S of alpha-RR (written here as __fmaf_rn)
// and the rents lo + u*(hi - lo) and the DP's c*lv + svc (computed in
// PyTorch before the kernels).  Everything else is two rounded ops, which
// only --fmad=false guarantees.  Every kernel is held bit-for-bit
// against its plain PyTorch version (chip_smoke.py) and, through that, against
// the JAX package (tests/test_torch_*.py).
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// threefry2x32: 20 rounds, 5 key injections (jax's hash, word for word).
// ---------------------------------------------------------------------

// one funnel shift (SHF) on sm_90
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rots[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rots[r & 1][i]);
      x1 ^= x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + (uint32_t)(r + 1);
  }
}

// ---------------------------------------------------------------------
// P: slot_uniform.  Replaces the Pallas kernel slot_uniform_tc
// (src/repro/kernels/hosting.py:164, pallas_call at :179).
//
// u[row, j] = U(0,1) of fold_in(fold_in(key[row], tids[j]), salt) under
// jax's scalar 32-bit draw; partitionable selects jax's layout of those
// bits (x0 ^ x1 of the block) or the original one (x0 alone).
//
// Bound: integer operations -- 2 or 3 threefry blocks (79 32-bit ops
// each, a rotate being one funnel shift) per 4-byte output.  Design: one thread per (row, slot), the whole
// fold -> salt -> bits chain in registers; neighbouring threads take
// neighbouring slots of one row, so the store is coalesced and the key
// load is a broadcast.
// ---------------------------------------------------------------------

__global__ void slot_uniform_kernel(const long long* __restrict__ keys,
                                    const int* __restrict__ tids,
                                    float* __restrict__ out, int R, int chunk,
                                    long long salt, int partitionable) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R * chunk) return;
  const int row = (int)(idx / chunk);
  const int j = (int)(idx - (long long)row * chunk);
  // key words are int64 tensors holding values in [0, 2**32)
  const uint32_t k0 = (uint32_t)keys[2 * row];
  const uint32_t k1 = (uint32_t)keys[2 * row + 1];
  uint32_t a0 = 0u, a1 = (uint32_t)tids[j];
  threefry2x32(k0, k1, a0, a1);                  // fold_in(key, t)
  if (salt >= 0) {
    uint32_t s0 = 0u, s1 = (uint32_t)salt;
    threefry2x32(a0, a1, s0, s1);                // fold_in(., salt)
    a0 = s0;
    a1 = s1;
  }
  uint32_t b0 = 0u, b1 = 0u;
  threefry2x32(a0, a1, b0, b1);                  // random_bits(key, 32, ())
  const uint32_t bits = partitionable ? (b0 ^ b1) : b0;
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  out[idx] = fmaxf(0.0f, u);
}

// ---------------------------------------------------------------------
// D: dp_minplus.  Replaces the Pallas kernel dp_minplus_kc
// (src/repro/kernels/hosting.py:116, body :96, pallas_call at :138).
//
// Per row and slot t: trans[kp, k] = J[kp] + fetch[kp, k];
// args[t, k] = first kp minimising trans[:, k] (an all-+inf column gives 0);
// J[k] = min_kp trans[kp, k] + w[t, k]; on an invalid slot J is frozen and
// args[t, k] = k.
//
// Bound: bytes -- it reads w and writes args, 8 bytes per (slot, level).
// Design: one warp per row, lane k owns J[k] and column k of fetch (in
// registers); each slot broadcasts J with __shfl_sync and scans kp upward
// with a strict <, which is jnp.argmin's first-index rule.  K <= 32.
// ---------------------------------------------------------------------

constexpr unsigned kFullMask = 0xFFFFFFFFu;

__global__ void dp_minplus_kernel(const float* __restrict__ J,
                                  const float* __restrict__ wck,
                                  const float* __restrict__ fetch,
                                  const bool* __restrict__ valid,
                                  float* __restrict__ Jout,
                                  int* __restrict__ args, int R, int chunk,
                                  int K) {
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int k = threadIdx.x & 31;
  if (row >= R) return;                          // warp-uniform exit
  const bool act = k < K;
  float f[32];
#pragma unroll
  for (int kp = 0; kp < 32; ++kp)
    f[kp] = (act && kp < K) ? fetch[((long long)row * K + kp) * K + k] : 0.0f;
  float Jk = act ? J[(long long)row * K + k] : 0.0f;
  const float* w = wck + (long long)row * chunk * K;
  const bool* v = valid + (long long)row * chunk;
  int* a = args + (long long)row * chunk * K;
  for (int t = 0; t < chunk; ++t) {
    float best = __shfl_sync(kFullMask, Jk, 0) + f[0];
    int arg = 0;
#pragma unroll
    for (int kp = 1; kp < 32; ++kp) {
      if (kp < K) {                              // K is warp-uniform
        const float tr = __shfl_sync(kFullMask, Jk, kp) + f[kp];
        if (tr < best) {
          best = tr;
          arg = kp;
        }
      }
    }
    if (act) {
      const bool vt = v[t];
      const float Jn = best + w[(long long)t * K + k];
      Jk = vt ? Jn : Jk;
      a[(long long)t * K + k] = vt ? arg : k;
    }
  }
  if (act) Jout[(long long)row * K + k] = Jk;
}

// ---------------------------------------------------------------------
// S: sim_chunk_alpha_rr.  New: replaces the XLA lax.scan of
// sim_chunk_core (src/repro/core/simulator.py:147-227) driving
// alpha_rr_step (src/repro/core/policies/alpha_rr.py:88-124); no Pallas
// kernel covered it.
//
// Per row and slot it reproduces the reference op for op: the Model-1
// service x*g, w = fma(c, lv, svc), d = w - w[r], the suffix minima S, the
// margins fma(M, |lv - lv_r|, S), the +1e-6 tie break, the first-index argmin,
// margin* < -0.0, freeze_invalid past T_len, the fetch M*max(lv' - lv, 0)
// (zeroed on the last slot without include_final_fetch), and the
// sequential float32 adds into sums.
//
// Bound: latency -- a dependency chain of chunk slots per row, with only R
// rows in flight.  Design: one thread per row, the policy state (r, S[K],
// age) and the accumulator (sums[3], counts[K]) in registers across the
// whole chunk (K is a template argument, so every level loop unrolls);
// blocks of 32 threads spread the few warps over as many SMs as possible.
// ---------------------------------------------------------------------

template <int K>
__device__ __forceinline__ float select_k(const float (&a)[K], int i) {
  // exact a[i] (the reference's one-hot sum) without dynamic register indexing
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) v = (k == i) ? a[k] : v;
  return v;
}

template <int K>
__global__ void sim_alpha_rr_kernel(
    const float* __restrict__ plv_g, const bool* __restrict__ mask_g,
    const float* __restrict__ pM_g, const float* __restrict__ lv_g,
    const float* __restrict__ g_g, const float* __restrict__ M_g,
    const int* __restrict__ Tlen_g, const int* __restrict__ r_in,
    const float* __restrict__ S_in, const int* __restrict__ age_in,
    const float* __restrict__ sums_in, const int* __restrict__ counts_in,
    const int* __restrict__ x_g, const float* __restrict__ c_g, int t0,
    int chunk, int R, int include_final_fetch, int* __restrict__ r_out,
    float* __restrict__ S_out, int* __restrict__ age_out,
    float* __restrict__ sums_out, int* __restrict__ counts_out,
    int* __restrict__ r_hist) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const float BIG = (float)3.4e38;   // alpha_rr._BIG
  const float EPS = (float)1e-6;     // alpha_rr._TIE_EPS
  // policy params (plv, mask, pM) and the accounting grid (lv, g, M) are
  // separate inputs, as in the reference (they coincide for every fleet
  // built by AlphaRR.fleet / RetroRenting.fleet)
  float plv[K], lv[K], g[K], S[K];
  bool mk[K];
  int cnt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    plv[k] = plv_g[row * K + k];
    lv[k] = lv_g[row * K + k];
    g[k] = g_g[row * K + k];
    mk[k] = mask_g[row * K + k];
    S[k] = S_in[row * K + k];
    cnt[k] = counts_in[row * K + k];
  }
  const float pM = pM_g[row];
  const float M = M_g[row];
  const int Tl = Tlen_g[row];
  int r = r_in[row];
  int age = age_in[row];
  float s_rent = sums_in[row * 3 + 0];
  float s_svc = sums_in[row * 3 + 1];
  float s_fetch = sums_in[row * 3 + 2];
  const int* xr = x_g + (long long)row * chunk;
  const float* cr = c_g + (long long)row * chunk;
  int* hr = r_hist ? r_hist + (long long)row * chunk : nullptr;

  for (int j = 0; j < chunk; ++j) {
    const int t = t0 + j;
    const bool valid = t < Tl;
    const bool last = t == Tl - 1;
    const float c = cr[j];
    const float xf = (float)xr[j];
    float svc[K], w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      svc[k] = xf * g[k];                        // Model-1 service
      w[k] = __fmaf_rn(c, plv[k], svc[k]);       // one rounding, as XLA
    }
    // ---- alpha_rr_step ----
    const int age1 = age + 1;
    const float w_r = select_k<K>(w, r);
    const float plv_r = select_k<K>(plv, r);
    float Sn[K], marg[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float d = w[k] - w_r;
      const float s_new = d + fminf(0.0f, S[k]);
      Sn[k] = (age1 >= 2) ? s_new : S[k];
      float m = __fmaf_rn(pM, fabsf(plv[k] - plv_r),
                          (age1 >= 2) ? Sn[k] : BIG);
      m = mk[k] ? m : BIG;
      marg[k] = (k == r) ? 0.0f : m;
    }
    int js = 0;
    float best = marg[0] + ((0 != r) ? EPS : 0.0f);
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const float v = marg[k] + ((k != r) ? EPS : 0.0f);
      if (v < best) {
        best = v;
        js = k;
      }
    }
    const bool sw = select_k<K>(marg, js) < -0.0f;
    // ---- accounting (sim_chunk_core), state frozen past T_len ----
    const float lv_t = select_k<K>(lv, r);
    const float rent = c * lv_t;
    const float svc_t = select_k<K>(svc, r);
    const int r_next = valid ? (sw ? js : r) : r;
    const float lv_next = select_k<K>(lv, r_next);
    float fetch = M * fmaxf(lv_next - lv_t, 0.0f);
    if (!include_final_fetch && last) fetch = 0.0f;
    s_rent = s_rent + (valid ? rent : 0.0f);
    s_svc = s_svc + (valid ? svc_t : 0.0f);
    s_fetch = s_fetch + (valid ? fetch : 0.0f);
#pragma unroll
    for (int k = 0; k < K; ++k) cnt[k] += (valid && k == r) ? 1 : 0;
    if (hr) hr[j] = r;
    if (valid) {
#pragma unroll
      for (int k = 0; k < K; ++k) S[k] = sw ? BIG : Sn[k];
      age = sw ? 0 : age1;
      r = r_next;
    }
  }

  r_out[row] = r;
  age_out[row] = age;
  sums_out[row * 3 + 0] = s_rent;
  sums_out[row * 3 + 1] = s_svc;
  sums_out[row * 3 + 2] = s_fetch;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    S_out[row * K + k] = S[k];
    counts_out[row * K + k] = cnt[k];
  }
}

inline unsigned n_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int launch_slot_uniform(const void* keys, const void* tids, void* out, int R,
                        int chunk, long long salt, int partitionable,
                        void* stream) {
  const int threads = 256;
  const long long n = (long long)R * chunk;
  if (n > 0)
    slot_uniform_kernel<<<n_blocks(n, threads), threads, 0,
                          (cudaStream_t)stream>>>(
        (const long long*)keys, (const int*)tids, (float*)out, R, chunk, salt,
        partitionable);
  return (int)cudaGetLastError();
}

int launch_dp_minplus(const void* J, const void* wck, const void* fetch,
                      const void* valid, void* Jout, void* args, int R,
                      int chunk, int K, void* stream) {
  const int threads = 128;                       // 4 rows per block
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  if (R > 0)
    dp_minplus_kernel<<<n_blocks((long long)R * 32, threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)J, (const float*)wck, (const float*)fetch,
        (const bool*)valid, (float*)Jout, (int*)args, R, chunk, K);
  return (int)cudaGetLastError();
}

int launch_sim_alpha_rr(const void* plv, const void* mask, const void* pM,
                        const void* lv, const void* g, const void* M,
                        const void* T_len, const void* r_in,
                        const void* S_in, const void* age_in,
                        const void* sums_in, const void* counts_in,
                        const void* x, const void* c, int t0, int chunk, int R,
                        int K, int include_final_fetch, void* r_out,
                        void* S_out, void* age_out, void* sums_out,
                        void* counts_out, void* r_hist, void* stream) {
  const int threads = 32;
  if (R <= 0) return (int)cudaGetLastError();
  const dim3 grid(n_blocks(R, threads));
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_SIM_CASE(KK)                                                    \
  case KK:                                                                    \
    sim_alpha_rr_kernel<KK><<<grid, threads, 0, st>>>(                        \
        (const float*)plv, (const bool*)mask, (const float*)pM,               \
        (const float*)lv, (const float*)g, (const float*)M,                   \
        (const int*)T_len, (const int*)r_in,                                  \
        (const float*)S_in, (const int*)age_in, (const float*)sums_in,        \
        (const int*)counts_in, (const int*)x, (const float*)c, t0, chunk, R,  \
        include_final_fetch, (int*)r_out, (float*)S_out, (int*)age_out,       \
        (float*)sums_out, (int*)counts_out, (int*)r_hist);                    \
    break;
  switch (K) {
    REPRO_SIM_CASE(2) REPRO_SIM_CASE(3) REPRO_SIM_CASE(4) REPRO_SIM_CASE(5)
    REPRO_SIM_CASE(6) REPRO_SIM_CASE(7) REPRO_SIM_CASE(8) REPRO_SIM_CASE(9)
    REPRO_SIM_CASE(10) REPRO_SIM_CASE(11) REPRO_SIM_CASE(12)
    REPRO_SIM_CASE(13) REPRO_SIM_CASE(14) REPRO_SIM_CASE(15)
    REPRO_SIM_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SIM_CASE
  return (int)cudaGetLastError();
}

}  // extern "C"
