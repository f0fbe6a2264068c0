// Hand-written Hopper (sm_90a) kernels for the hosting engine's hot loops.
//
// Plain C entry points (loaded with ctypes by repro_torch/kernels/_build.py;
// wrappers in repro_torch/kernels/hosting.py) for these kernels:
//
//   P  counter_stream_kernel<KIND>  one stream's chunk of counter-keyed
//                          draws, finished in the kernel: U(0,1) uniforms
//                          (slot_uniform), Bernoulli arrivals, uniform rents,
//                          NA-pair rents, scaled normals (XLA's erf_inv)
//      ge_chain_kernel     the Gilbert-Elliot chain and its Bernoulli
//                          emissions over one chunk
//      arma_rents_kernel   the ARMA(p, q) rents over one chunk: producer
//                          warps draw the normals into an mbarrier ring,
//                          one walker lane a row runs the recursion behind
//      poisson_kernel      jax.random.poisson a slot (Knuth's branch below
//                          rate 10, Hormann's rejection at and above), at
//                          a per-row rate or the GE states' per-slot rates:
//                          lanes refilled from staged slot keys
//      model2_service_kernel  the Model-2 service costs of one chunk (the
//                          live requests' coupled uniforms)
//   D  dp_fwd_kernel       one chunk of the offline-OPT min-plus recursion
//                          with the cost assembly fused in (the fleet DP):
//                          Model 1 (dp_fwd_model1) or a Model-2 service
//                          slab (dp_fwd_model2)
//      dp_minplus_kernel   the same recursion on a finished w (K <= 32)
//   B  dp_backtrack_kernel  one chunk's argmin table walked back to the
//                          schedule (the backtracked OPT, K <= 32)
//   E  schedule_kernel<SVC, FMA, BULK, MAT>  given schedules priced over
//                          one chunk, fetches charged on entry (Model 1 or
//                          a Model-2 slab; a scalar M or, MAT, a joint
//                          grid's explicit fetch matrix)
//   G  joint_slab_kernel<SVC>  the N per-service sub-slabs of a
//                          multi-service instance reduced to its joint
//                          slab (the joint OPT's chunk), and a DP's
//                          w = fma(c, lv, svc) on a slab of more than 16
//                          levels
//   S  sim_kernel<K, SVC, TABLE>  one chunk of the per-slot simulation,
//                          alpha-RR (sim_chunk_alpha_rr) or a table policy
//                          (static, MDP, ABC: sim_chunk_table), under
//                          Model 1 or on a Model-2 service slab (the _svc
//                          wrappers)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false is required: the reference fixes which multiply-adds are
// one FMA and which are two rounded ops.  XLA:CPU contracts a product that
// feeds an add inside one fusion: in this slice's path that is w = c*lv + svc
// and the margin M*|lv - lv_r| + S of alpha-RR, the fused DP's c*lv + svc,
// the rents lo + u*(hi - lo), every Horner step of XLA's erf_inv / log /
// log1p, and the ARMA scan's two-term dots, each written here as __fmaf_rn.
// Everything else is two rounded ops, which only --fmad=false guarantees.
// Every kernel is held bit-for-bit against its plain PyTorch version
// (chip_smoke.py) and, through that, against the JAX package
// (tests/test_torch_*.py).
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>

// The library builds as one translation unit, or (kernels/_build.py) as
// parts that nvcc compiles in parallel, each with -DREPRO_PART=n, linked
// into one library: part n holds the entry points marked REPRO_IN_PART(n)
// and so instantiates only their kernels.  Without REPRO_PART every entry
// point is compiled.
#ifndef REPRO_PART
#define REPRO_PART -1
#endif
#define REPRO_IN_PART(n) (REPRO_PART < 0 || REPRO_PART == (n))
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// ---------------------------------------------------------------------
// threefry2x32: 20 rounds, 5 key injections (jax's hash, word for word).
// ---------------------------------------------------------------------

// one funnel shift (SHF) on sm_90
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// a + b as a * one + b, where one is a kernel argument that holds 1:
// ptxas cannot fold it, so the add issues as IMAD on the FMA pipe and
// leaves the integer ALU pipe to the rotates (SHF) and xors (LOP3).
__device__ __forceinline__ uint32_t add32(uint32_t a, uint32_t b,
                                          uint32_t one) {
  return a * one + b;
}

// x through a move the compiler cannot look into, so that it does not
// reassociate x1 + (ks + c): the injection word ks + c stays one value
// (computed once a thread when the key is the row's) and the add one IMAD,
// not IMAD + VIADD
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  uint32_t y;
  asm("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// Counter words that are the literal 0 fold away once inlined (fold_in's
// first word; both words of the bits block); a key that is the same for
// every call of a thread (the row's key) has its schedule hoisted out.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1,
                                             uint32_t one) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rots[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 = add32(x0, k0, one);
  x1 = add32(x1, k1, one);
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 = add32(x0, x1, one);
      x1 = rotl32(x1, rots[r & 1][i]);
      x1 ^= x0;
    }
    x0 = add32(x0, ks[(r + 1) % 3], one);
    x1 = add32(x1, opaque(ks[(r + 2) % 3] + (uint32_t)(r + 1)), one);
  }
}

// fold_in(key, d): the counter (0, d); the folded key comes back in (a0, a1)
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1, uint32_t d,
                                        uint32_t& a0, uint32_t& a1,
                                        uint32_t one) {
  a0 = 0u;
  a1 = d;
  threefry2x32(k0, k1, a0, a1, one);
}

// jax's scalar 32-bit uniform under key (a0, a1): the bits block (counter
// (0, 0)), the layout's word (x0 ^ x1 partitionable, x0 original), the top
// 23 bits spliced into [1, 2), minus 1.  jax.random.uniform then clamps at
// 0 (the plain version keeps it); on [1, 2) - 1, whose least value is +0,
// that is the identity, so the kernel spends no ALU op on it.
__device__ __forceinline__ float uniform_of(uint32_t a0, uint32_t a1,
                                            bool partitionable,
                                            uint32_t one) {
  uint32_t b0 = 0u, b1 = 0u;
  threefry2x32(a0, a1, b0, b1, one);
  const uint32_t bits = partitionable ? (b0 ^ b1) : b0;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// ---------------------------------------------------------------------
// mbarriers in shared memory: the rings of P's ARMA kernel, D and S.
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ---------------------------------------------------------------------
// P: the counter-keyed stream kernels.  Replace the Pallas kernel
// slot_uniform_tc (src/repro/kernels/hosting.py:164, pallas_call at :179)
// together with the consumer code the reference runs on its output
// (src/repro/core/scenarios/streams.py: _bernoulli_chunk, _ge_states +
// _ge_emit, _uniform_rents_chunk, _na_rents_chunk).
//
// For row i and slot j (counter t = tids[j]), u = the uniform of
// fold_in(fold_in(key[i], t), salt) (no salt fold when salt < 0), and
//   kUniform       out = u                                   float32
//   kBernoulli     out = (flip ? 1 - u : u) < p[i]           int32
//   kUniformRents  out = fma(flip ? 1 - u : u, hi - lo, lo)  float32
//   kNaRents       u from the pair counter t >> 1 (floor(t / 2));
//                  out = fma(t even ? u : 1 - u, hi - lo, lo)
//   kNormal        out = (sigma * sqrt(2)) * erf_inv(max(lo, 2u + lo)),
//                  lo = nextafter(-1, 0): jax.random.normal scaled by
//                  sigma as XLA folds the scale inside a jit (a = sigma)
// hi - lo is one float32 subtraction and the FMA one rounding, as XLA:CPU
// computes lo + u * (hi - lo) inside its fusion.
//
// Bound: integer operations.  Two threefry blocks a draw (three with a
// salt); of each block's ops the 20 rotates (SHF) and 20-21 xors (LOP3)
// can only issue on the integer ALU pipe, 64 lanes a clock per SM, and
// the ~30 adds can go to the FMA pipe.  The sm_90a build holds ~170-176
// ops a slot, ~88-91 of them for the ALU pipe, so the ALU pipe and the
// issue rate (128 a clock per SM) bound it about equally.  Design: a
// block's threads take one row (the grid's x; no index division), each
// thread kSlots consecutive slots of it, so the row's key words and
// params load once and the key schedule of the first block is hoisted;
// its kSlots hashes are independent (instruction-level parallelism); the
// outputs leave as one 16-byte store per 4 slots (scalar stores at a
// ragged edge or when chunk % 4 != 0); the adds issue on the FMA pipe
// (add32).  No uniform slab goes to device memory and nothing runs in
// float64.  An NA pair's two slots share one hash when one thread holds
// both.
// ---------------------------------------------------------------------

// ---------------------------------------------------------------------
// XLA:CPU's float32 log, log1p and erf_inv, op for op, for the normal draw
// (jax.random.normal is sqrt(2) * erf_inv(u); XLA lowers erf_inv to Giles's
// polynomials over -log1p(-u * u), log1p to a rational approximation near 0
// and log(1 + x) elsewhere, and log to an inlined Cephes logf).  XLA's LLVM
// backend contracts every multiply that feeds only an add into one FMA:
// those are the __fmaf_rn below; the rest are single rounded operations
// (--fmad=false).  Constants are the float32 values XLA uses.
// ---------------------------------------------------------------------

constexpr float kNormalLo = -0.99999994f;  // nextafter(-1, 0)
constexpr float kSqrt2 = 1.4142135f;

__device__ __forceinline__ float xla_logf(float v) {
  const float xc = v > 1.1754944e-38f ? v : 1.1754944e-38f;  // FLT_MIN
  const int bits = __float_as_int(xc);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool small = m < 0.70710677f;
  const float e = ((float)((bits >> 23) - 127) + 1.0f) - (small ? 1.0f : 0.0f);
  const float x = (m + -1.0f) + (small ? m : 0.0f);
  const float z = x * x;
  const float x3 = z * x;
  const float y1 = __fmaf_rn(__fmaf_rn(x, 0.070376836f, -0.1151461f), x,
                             0.116769984f);
  const float y2 = __fmaf_rn(__fmaf_rn(x, -0.12420141f, 0.14249323f), x,
                             -0.16668057f);
  const float y3 = __fmaf_rn(__fmaf_rn(x, 0.20000714f, -0.24999994f), x,
                             0.3333333f);
  const float y = __fmaf_rn(__fmaf_rn(__fmaf_rn(y1, x3, y2), x3, y3), x3,
                            e * -0.00021219444f);
  const float out = ((x - z * 0.5f) + y) + e * 0.693359375f;
  return v == __int_as_float(0x7F800000) ? v
         : v == 0.0f                    ? __int_as_float(0xFF800000)
                                        : out;
}

// XLA's log1p: the rational approximation where |x| < sqrt(2) - 1 (its
// Horner steps FMAs; x2 * -0.5 is exact, so that sum is one rounding
// either way), else log(1 + x)
__device__ __forceinline__ float xla_log1pf(float x) {
  const float x2 = x * x;
  float num = 4.527e-05f;
  num = __fmaf_rn(num, x, 0.49854103f);
  num = __fmaf_rn(num, x, 6.5787325f);
  num = __fmaf_rn(num, x, 29.911919f);
  num = __fmaf_rn(num, x, 60.94967f);
  num = __fmaf_rn(num, x, 57.112965f);
  num = __fmaf_rn(num, x, 20.039553f);
  float den = 1.0f;
  den = __fmaf_rn(den, x, 15.062909f);
  den = __fmaf_rn(den, x, 83.04757f);
  den = __fmaf_rn(den, x, 221.7624f);
  den = __fmaf_rn(den, x, 309.09872f);
  den = __fmaf_rn(den, x, 216.42789f);
  den = __fmaf_rn(den, x, 60.11866f);
  const float near0 = x + (x2 * -0.5f + (x * x2) * __fdiv_rn(num, den));
  return fabsf(x) < 0.41421357f ? near0 : xla_logf(x + 1.0f);
}

__device__ __forceinline__ float xla_erf_invf(float u) {
  const float l1p = xla_log1pf(u * -u);
  const bool lt = l1p > -5.0f;
  const float w = lt ? -2.5f - l1p : __fsqrt_rn(-l1p) + -3.0f;
  float p = lt ? 2.8102264e-08f : -0.00020021426f;
  p = __fmaf_rn(p, w, lt ? 3.4327394e-07f : 0.00010095056f);
  p = __fmaf_rn(p, w, lt ? -3.5233877e-06f : 0.0013493432f);
  p = __fmaf_rn(p, w, lt ? -4.3915065e-06f : -0.0036734284f);
  p = __fmaf_rn(p, w, lt ? 0.00021858087f : 0.0057395077f);
  p = __fmaf_rn(p, w, lt ? -0.001253725f : -0.0076224613f);
  p = __fmaf_rn(p, w, lt ? -0.0041776816f : 0.0094388705f);
  p = __fmaf_rn(p, w, lt ? 0.24664073f : 1.001674f);
  p = __fmaf_rn(p, w, lt ? 1.5014094f : 2.8329768f);
  return u * (fabsf(u) == 1.0f ? __int_as_float(0x7F800000) : p);
}

// XLA's float32 lgamma(z + 1) for an integer z >= 0 (the rejection draw's
// k, where XLA folds (k + 1) - 1 to k): the Lanczos sum (g = 7, base 1 in
// float32) in order, log_t = log1p(z / 7.5) + log(7.5) (XLA multiplies by
// the reciprocal), then fma((z + 0.5) - (z + 7.5) / log_t, log_t,
// log(sqrt(2 pi))) + log(sum), the one FMA XLA contracts there
__device__ __forceinline__ float xla_lgamma1pf(float z) {
  float s = 1.0f;
  s = s + __fdiv_rn(676.5204f, z + 1.0f);
  s = s + __fdiv_rn(-1259.1392f, z + 2.0f);
  s = s + __fdiv_rn(771.3234f, z + 3.0f);
  s = s + __fdiv_rn(-176.61504f, z + 4.0f);
  s = s + __fdiv_rn(12.507343f, z + 5.0f);
  s = s + __fdiv_rn(-0.1385711f, z + 6.0f);
  s = s + __fdiv_rn(0.000009984369f, z + 7.0f);
  s = s + __fdiv_rn(0.00000015056327f, z + 8.0f);
  const float log_t = xla_log1pf(z * 0.13333334f) + 2.014903f;
  const float q = __fdiv_rn(z + 7.5f, log_t);
  return __fmaf_rn((z + 0.5f) - q, log_t, 0.9189385f) + xla_logf(s);
}

// (scale * sqrt(2)) * erf_inv(u) for the [0, 1) uniform f of a draw: u =
// max(lo, 2 f + lo) (2 f is exact), scale2 = scale * sqrt(2)
__device__ __forceinline__ float normal_of(float f, float scale2) {
  return scale2 * xla_erf_invf(fmaxf(kNormalLo, f * 2.0f + kNormalLo));
}

constexpr int kSlots = 4;                  // consecutive slots a thread

enum StreamKind { kUniform = 0, kBernoulli = 1, kUniformRents = 2,
                  kNaRents = 3, kNormal = 4 };

struct StreamArgs {
  const long long* keys;   // [R, 2] key words in [0, 2**32)
  const int* tids;         // [chunk] global slot counters
  const float* a;          // [R] p (kBernoulli), lo (rents), sigma (kNormal)
  const float* b;          // [R] hi (rents)
  const bool* flip;        // [R] (kBernoulli, kUniformRents)
  void* out;               // [R, chunk] float32 or int32
  int R, chunk, salt, partitionable, vec;  // salt >= 0: SALT below
  uint32_t one;            // 1, opaque to the compiler (add32)
};

// SALT (kUniform only): fold the salt in after the counter
template <int KIND, bool SALT>
__global__ void __launch_bounds__(256)
    counter_stream_kernel(const StreamArgs p) {
  const int row = blockIdx.x;
  const int j0 = (blockIdx.y * blockDim.x + threadIdx.x) * kSlots;
  if (j0 >= p.chunk) return;
  const uint32_t k0 = (uint32_t)p.keys[2 * row];
  const uint32_t k1 = (uint32_t)p.keys[2 * row + 1];
  const bool part = p.partitionable != 0;
  float pa = 0.0f, width = 0.0f;
  bool flip = false;
  if (KIND != kUniform) pa = p.a[row];
  if (KIND == kUniformRents || KIND == kNaRents) width = p.b[row] - pa;
  if (KIND == kNormal) pa = pa * kSqrt2;   // sigma * sqrt(2), once a row
  if (KIND == kBernoulli || KIND == kUniformRents) flip = p.flip[row];
  uint32_t v[kSlots];
  uint32_t prev = 0u;
  float prev_u = 0.0f;
  auto slot = [&](int s) {
    // past a ragged edge: draw for the last slot, store nothing
    const int t = p.tids[min(j0 + s, p.chunk - 1)];
    const uint32_t ctr = KIND == kNaRents ? (uint32_t)(t >> 1) : (uint32_t)t;
    float u;
    if (KIND == kNaRents && s > 0 && ctr == prev) {
      u = prev_u;                          // the pair's first slot's draw
    } else {
      uint32_t a0, a1;
      fold_in(k0, k1, ctr, a0, a1, p.one);
      if (SALT) {
        uint32_t s0, s1;
        fold_in(a0, a1, (uint32_t)p.salt, s0, s1, p.one);
        a0 = s0;
        a1 = s1;
      }
      u = uniform_of(a0, a1, part, p.one);
    }
    prev = ctr;
    prev_u = u;
    if (KIND == kUniform) {
      v[s] = __float_as_uint(u);
    } else if (KIND == kBernoulli) {
      v[s] = (flip ? 1.0f - u : u) < pa ? 1u : 0u;
    } else if (KIND == kNormal) {
      v[s] = __float_as_uint(normal_of(u, pa));
    } else {
      const float w = KIND == kNaRents ? ((t & 1) == 0 ? u : 1.0f - u)
                                       : (flip ? 1.0f - u : u);
      v[s] = __float_as_uint(__fmaf_rn(w, width, pa));
    }
  };
  if (SALT) {
    // three chained blocks a slot: unrolled over the slots, this kernel
    // ran slower on the H100 at the fleet's shapes than with the slots one
    // after the other (its unrolled code is 4x larger)
#pragma unroll 1
    for (int s = 0; s < kSlots; ++s) slot(s);
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) slot(s);
  }
  uint32_t* out = (uint32_t*)p.out + (long long)row * p.chunk + j0;
  if (p.vec) {                             // chunk % 4 == 0: whole, aligned
#pragma unroll
    for (int s = 0; s < kSlots; s += 4)
      *(uint4*)(out + s) = make_uint4(v[s], v[s + 1], v[s + 2], v[s + 3]);
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (j0 + s < p.chunk) out[s] = v[s];
  }
}

// ---------------------------------------------------------------------
// P: shaped_uniform_kernel, jax.random.uniform(key, (n,)) of ONE key: the
// draws of jax.random.choice(key, n_inputs, (B,), p=w) in
// mixture_from_weights (src/repro/core/scenarios/combinators.py :212) and
// the [T, R] request uniforms of simulator.model2_service_matrix
// (src/repro/core/simulator.py :499).  No TPU kernel: the reference draws
// these through XLA's threefry (jax/_src/random.py: _random_bits), not
// through slot_uniform_tc.
//  - partitionable layout: word i hashes the counter (0, i) and is the xor
//    of the block's two output words;
//  - original layout: the counters 0 .. n - 1, a 0 appended when n is odd,
//    cut into halves x0 = [0, h) and x1 = [h, 2h), h = ceil(n / 2); block i
//    hashes (x0[i], x1[i]), word i is its first output and word h + i its
//    second.
// Then the uniform's mapping: the top 23 bits spliced into [1, 2), minus 1.
//
// Bound: integer operations, one threefry block a word (partitionable) or
// half a block a word (original); 4 bytes a word written.
// Design: a thread a block (one word, or two in the original layout), the
// key in registers; the draws are few (B or T * R words a call), so the
// kernel is a plain grid over the blocks.
// ---------------------------------------------------------------------

struct ShapedArgs {
  const long long* key;    // [2] key words in [0, 2**32)
  float* out;              // [n]
  int n, partitionable;
  uint32_t one;            // 1, opaque to the compiler (add32)
};

__global__ void __launch_bounds__(256)
    shaped_uniform_kernel(const ShapedArgs p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t k0 = (uint32_t)p.key[0], k1 = (uint32_t)p.key[1];
  auto word = [](uint32_t bits) {
    return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  };
  if (p.partitionable) {
    if (i >= p.n) return;
    uint32_t x0 = 0u, x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1, p.one);
    p.out[i] = word(x0 ^ x1);
    return;
  }
  const int h = (p.n + 1) >> 1;
  if (i >= h) return;
  const int j = h + i;                     // == n only for odd n: counter 0
  uint32_t x0 = (uint32_t)i, x1 = j < p.n ? (uint32_t)j : 0u;
  threefry2x32(k0, k1, x0, x1, p.one);
  p.out[i] = word(x0);
  if (j < p.n) p.out[j] = word(x1);
}

// ---------------------------------------------------------------------
// P: ge_chain_kernel, the Gilbert-Elliot chain with Bernoulli emissions.
// Replaces slot_uniform_tc's two salted draws a slot plus the reference's
// lax.scan of the chain (src/repro/core/scenarios/streams.py: _ge_states,
// _ge_emit).
//
// Per slot t: a = fold_in(key, t); u0 = uniform of fold_in(a, 0), u1 =
// uniform of fold_in(a, 1); s_t = s_{t-1} == 1 ? (u0 >= p_hl) : (u0 <
// p_lh), from the s carried in from the previous chunk; x = u1 < (s_t ?
// rate_h : rate_l); states = s_t; s_out = the last state.  EMIT false
// (x NULL: a caller that draws its own emissions) draws no u1.
//
// Bound: integer operations (five threefry blocks a slot; fold_in(key, t)
// serves both salts).  Design: one warp per row walks the chunk in tiles
// of 32 * kSlots slots, each lane drawing kSlots consecutive slots (the
// hashes run in parallel).  A slot's step is a map {0, 1} -> {0, 1}, two
// bits; composing maps is associative and exact, so each lane composes
// its slots' maps, a shuffle scan over the lanes gives each lane the map
// from the tile's entry state to its own, and each lane re-walks its slots
// from there to write the states and emissions (16-byte stores).  The
// chain costs a few dozen instructions a tile against kSlots * 5 hashes a
// lane; one launch a chunk replaces a few launches a slot.
// ---------------------------------------------------------------------

// a map m of {0, 1}: bit s holds the image of s
constexpr uint32_t kIdentityMap = 2u;

__device__ __forceinline__ uint32_t map_apply(uint32_t m, uint32_t s) {
  return (m >> s) & 1u;
}

// g after f
__device__ __forceinline__ uint32_t map_then(uint32_t f, uint32_t g) {
  return map_apply(g, f & 1u) | (map_apply(g, (f >> 1) & 1u) << 1);
}

constexpr int kGeWarps = 4;                // rows (one warp each) a block

struct GeArgs {
  const long long* keys;   // [R, 2]
  const int* tids;         // [chunk]
  const int* s_in;         // [R] the chain state before the chunk
  const float* p_hl;       // [R]
  const float* p_lh;
  const float* rate_h;
  const float* rate_l;
  int* s_out;              // [R]
  int* states;             // [R, chunk]
  int* x;                  // [R, chunk]
  int R, chunk, partitionable, vec;
  uint32_t one;
};

template <bool EMIT>
__global__ void __launch_bounds__(32 * kGeWarps)
    ge_chain_kernel(const GeArgs p) {
  const int row = blockIdx.x * kGeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.R) return;                  // warp-uniform exit
  const uint32_t k0 = (uint32_t)p.keys[2 * row];
  const uint32_t k1 = (uint32_t)p.keys[2 * row + 1];
  const bool part = p.partitionable != 0;
  const float p_hl = p.p_hl[row], p_lh = p.p_lh[row];
  const float rate_h = p.rate_h[row], rate_l = p.rate_l[row];
  uint32_t state = (uint32_t)p.s_in[row];
  const long long base_off = (long long)row * p.chunk;
  for (int base = 0; base < p.chunk; base += 32 * kSlots) {
    const int j0 = base + lane * kSlots;
    uint32_t f[kSlots], xb[kSlots];
    uint32_t m = kIdentityMap;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = j0 + s;
      const uint32_t t = (uint32_t)p.tids[min(j, p.chunk - 1)];
      uint32_t a0, a1, c0, c1, d0 = 0u, d1 = 0u;
      fold_in(k0, k1, t, a0, a1, p.one);
      fold_in(a0, a1, 0u, c0, c1, p.one);
      if constexpr (EMIT) fold_in(a0, a1, 1u, d0, d1, p.one);
      const float u0 = uniform_of(c0, c1, part, p.one);
      const float u1 = EMIT ? uniform_of(d0, d1, part, p.one) : 0.0f;
      // past the chunk's end: the identity, so the scan passes through
      f[s] = j < p.chunk
                 ? (uint32_t)(u0 < p_lh) | ((uint32_t)(u0 >= p_hl) << 1)
                 : kIdentityMap;
      xb[s] = EMIT ? (uint32_t)(u1 < rate_l) | ((uint32_t)(u1 < rate_h) << 1)
                   : 0u;
      m = map_then(m, f[s]);
    }
    // inclusive scan over the lanes (slot order): scan = lane's map after
    // the maps of every lane before it
    uint32_t scan = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFullMask, scan, d);
      if (lane >= d) scan = map_then(o, scan);
    }
    uint32_t before = __shfl_up_sync(kFullMask, scan, 1);
    if (lane == 0) before = kIdentityMap;
    uint32_t st = map_apply(before, state);
    uint32_t sv[kSlots], xv[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      st = map_apply(f[s], st);
      sv[s] = st;
      xv[s] = (xb[s] >> st) & 1u;
    }
    uint32_t* so = (uint32_t*)p.states + base_off + j0;
    uint32_t* xo = EMIT ? (uint32_t*)p.x + base_off + j0 : nullptr;
    if (p.vec && j0 < p.chunk) {           // chunk % 4 == 0: whole, aligned
#pragma unroll
      for (int s = 0; s < kSlots; s += 4) {
        *(uint4*)(so + s) = make_uint4(sv[s], sv[s + 1], sv[s + 2], sv[s + 3]);
        if constexpr (EMIT)
          *(uint4*)(xo + s) =
              make_uint4(xv[s], xv[s + 1], xv[s + 2], xv[s + 3]);
      }
    } else if (!p.vec) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (j0 + s < p.chunk) {
          so[s] = sv[s];
          if constexpr (EMIT) xo[s] = xv[s];
        }
    }
    state = map_apply(__shfl_sync(kFullMask, scan, 31), state);
  }
  if (lane == 0) p.s_out[row] = (int)state;
}

// ---------------------------------------------------------------------
// P: arma_rents_kernel, the ARMA(p, q) rents over one chunk.  No TPU
// kernel: the reference draws the innovations with jax.random.normal on
// per-slot keys and walks the recursion in a lax.scan
// (src/repro/core/scenarios/streams.py: _arma_eps_at :316, _arma_chunk
// :330); the Pallas PRNG kernel is not on that path.
//
// Per row and slot j (counter t = tids[j]): e = normal_of(the uniform of
// fold_in(key, t + q), sigma) and, in XLA's order inside its scan,
//   x = (phi . hist + e) + th . eps      (p = 1: x = fma(phi0, h0, e))
// where a two-term dot is fma(a1, b1, a0 * b0) and a longer one a
// left-to-right sum of rounded products, and at q = 1 the MA term is one
// FMA into the rest, x = fma(th0, eps0, phi . hist + e); then hist <- (x,
// hist[:-1]),
// eps <- (e, eps[:-1]) and c = min(max(mean + x, c_min), c_max).  The
// state (hist [R, p], eps [R, q]) comes in and goes out.
//
// Bound: the innovations are the normals' work, two threefry blocks and
// XLA's erf_inv a slot, so the normal chunk alone (counter_stream_kernel<
// kNormal>) bounds this kernel from below: its integer-pipe bound, ~0.134
// ms at 4,096 x 4,096 on the H100.  The recursion is a chain of dependent
// float operations a slot (p products and sums, the innovation, the MA
// dot) that no reassociation may shorten: ~24 cycles a slot, ~0.05 ms a
// 4,096-slot chunk, far below the draws once it runs behind them.
//
// Design: a block takes ROWS rows (32 when the slab gives every SM a
// block of them, else 8, so that a small slab's draws spread over more
// SMs) and decouples the draws from the walk with a ring of kArmaStages
// tiles of kArmaTile slots, each with a full and an empty mbarrier.
// ArmaShape<ROWS>::kProducers producer warps (16; 8 at 8 rows) draw a
// tile's innovations slot-parallel (warp w rows w, w + kProducers, ..., a
// lane a slot: 2 or 1 draws a thread, so the producers split a tile's
// draws exactly and a thread's draws run as independent chains), arrive
// on the tile's full barrier and go on to the next tile once the walker
// has released its stage: they run up to kArmaStages tiles ahead and wait
// on nothing else.  The walker warp (a lane a row: all 32 lanes at 32
// rows) waits for a tile and walks its recursion, four innovations a
// 16-byte shared load; it clips each rent in registers and stores four
// slots a 16-byte store (scalar stores on a ragged tile or when chunk % 4
// != 0), so no store waits on the next tile's draws.  A whole tile is
// walked by straight-line code (the AR order is a template argument), so
// the history shifts are register renames and the walker issues ~15
// instructions a slot; a loop with a variable trip count keeps the
// shifted state in place with ~10 moves a slot.
// Measured (chip_smoke.py; H100 80GB HBM3, 700 W, 4,096 x 4,096, p = 4,
// q = 2): 0.222 ms, 60% of the integer-pipe bound, against 0.168 for the
// normal chunk alone.  32 rows a block on a wide slab because a walker of
// 32 busy lanes issues half the instructions a row of two 16-lane ones
// (0.253 ms at 16 rows a block, tools/compare_hosting.py).
// Left: the walker's issue slots on the scheduler it shares with four
// producer warps, one tile of ring fill and drain at the chunk's ends,
// and at R = 4,096 four of the 132 SMs without a block; at 8 rows a
// block, the walker's idle lanes and the last block's rows past R
// (drawn, not stored).
// ---------------------------------------------------------------------

constexpr int kArmaMaxP = 8, kArmaMaxQ = 8;
constexpr int kArmaTile = 32;              // slots a tile: a lane each
constexpr int kArmaStride = kArmaTile + 4; // a tile row, 16-byte aligned
constexpr int kArmaStages = 4;             // tiles in the ring
constexpr int kArmaWideRows = 32;          // rows a block on a wide slab
constexpr int kArmaNarrowRows = 8;         // rows a block on a small one

// a block of ROWS rows: its producer warps (then one walker warp)
template <int ROWS>
struct ArmaShape {
  static constexpr int kProducers = ROWS >= 32 ? 16 : 8;
  static constexpr int kThreads = 32 * (kProducers + 1);
};

struct ArmaArgs {
  const long long* keys;   // [R, 2]
  const int* tids;         // [chunk]
  const float* hist_in;    // [R, P] newest first
  const float* eps_in;     // [R, Q] newest first
  const float* phi;        // [R, P]
  const float* th;         // [R, Q]
  const float* sigma;      // [R]
  const float* mean;
  const float* c_min;
  const float* c_max;
  float* hist_out;         // [R, P]
  float* eps_out;          // [R, Q]
  float* c;                // [R, chunk]
  int R, chunk, P, Q, partitionable;
  int vec;                 // chunk % 4 == 0 and c 16-byte aligned
  uint32_t one;
};

// How XLA orders a dot of n terms in the scan.  On a batch of rows:
// kDotFma2 is n == 2, fma(a1, b1, a0 * b0); kDotSum a left-to-right sum of
// rounded products.  On a single row (R == 1, a dot of two vectors):
// kDotChain, every term after the first an FMA into the sum, for the AR
// dot as for the MA one.  At q = 1 the MA term th0 * eps0 is one FMA into
// the AR part and the innovation: kMa1Sum on a batch (the AR dot as
// kDotSum past two terms), kMa1Chain on one row (the AR dot a chain).
enum DotOrder { kDotSum = 0, kDotChain = 1, kDotFma2 = 2, kMa1Sum = 3,
                kMa1Chain = 4 };

// the dot of a[0 .. n) and b[0 .. n) in XLA's order (n >= 2; N the
// arrays' compile-time length, n <= N)
template <int ORDER, int N>
__device__ __forceinline__ float xla_dot(const float (&a)[N],
                                         const float (&b)[N], int n) {
  float x = a[0] * b[0];
  if (ORDER == kDotFma2) return __fmaf_rn(a[1], b[1], x);
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (i < n) x = ORDER == kDotChain ? __fmaf_rn(a[i], b[i], x)
                                      : x + a[i] * b[i];
  return x;
}

// P: the AR order (the walker's chain unrolls over registers); MA: the
// dots' order (kDotFma2: q == 2; kDotSum: q >= 3 up to kArmaMaxQ;
// kDotChain: one row, q >= 2, the AR dot a chain too; kMa1Sum /
// kMa1Chain: q == 1 on a batch / on one row); ROWS: rows a block
template <int P, int MA, int ROWS>
__global__ void __launch_bounds__(ArmaShape<ROWS>::kThreads)
    arma_rents_kernel(const ArmaArgs p) {
  constexpr int NPROD = ArmaShape<ROWS>::kProducers;
  constexpr bool MA1 = MA == kMa1Sum || MA == kMa1Chain;
  constexpr bool CHAIN = MA == kDotChain || MA == kMa1Chain;
  constexpr int QN = MA == kDotFma2 ? 2 : MA1 ? 1 : kArmaMaxQ;  // MA regs
  constexpr int DRAWS = ROWS / NPROD;                   // a thread a tile
  __shared__ __align__(16) float eps_s[kArmaStages][ROWS][kArmaStride];
  __shared__ uint32_t key_s[ROWS][2];
  __shared__ float scale_s[ROWS];
  __shared__ __align__(8) uint64_t full[kArmaStages], empty[kArmaStages];
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, p.R - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (p.chunk + kArmaTile - 1) / kArmaTile;
  if (threadIdx.x < ROWS) {
    // rows past R take the last row's params: drawn, never stored
    const int row = min(row0 + (int)threadIdx.x, p.R - 1);
    key_s[threadIdx.x][0] = (uint32_t)p.keys[2 * row];
    key_s[threadIdx.x][1] = (uint32_t)p.keys[2 * row + 1];
    scale_s[threadIdx.x] = p.sigma[row] * kSqrt2;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kArmaStages; ++s) {
      mbar_init(&full[s], 32u * NPROD);
      mbar_init(&empty[s], 32u);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp < NPROD) {
    const bool part = p.partitionable != 0;
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % kArmaStages;
      // past the chunk's end: the last slot drawn again, never read
      const int j = min(k * kArmaTile + lane, p.chunk - 1);
      const uint32_t ctr = (uint32_t)p.tids[j] + (uint32_t)p.Q;
      if (k >= kArmaStages)
        mbar_wait(&empty[s], (uint32_t)(((k / kArmaStages) - 1) & 1));
      float e[DRAWS];
#pragma unroll
      for (int d = 0; d < DRAWS; ++d) {
        const int r = warp + NPROD * d;
        uint32_t a0, a1;
        fold_in(key_s[r][0], key_s[r][1], ctr, a0, a1, p.one);
        e[d] = normal_of(uniform_of(a0, a1, part, p.one), scale_s[r]);
      }
#pragma unroll
      for (int d = 0; d < DRAWS; ++d)
        eps_s[s][warp + NPROD * d][lane] = e[d];
      mbar_arrive(&full[s]);
    }
    return;
  }

  // the walker: lane r < nrows holds row row0 + r's state, coefficients
  // and clip bounds
  const bool walks = lane < nrows;
  const int row = row0 + min(lane, nrows - 1);
  float h[P], ph[P], ep[QN], th[QN];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    h[i] = p.hist_in[(long long)row * P + i];
    ph[i] = p.phi[(long long)row * P + i];
  }
#pragma unroll
  for (int i = 0; i < QN; ++i) {
    ep[i] = i < p.Q ? p.eps_in[(long long)row * p.Q + i] : 0.0f;
    th[i] = i < p.Q ? p.th[(long long)row * p.Q + i] : 0.0f;
  }
  const float mean = p.mean[row], lo = p.c_min[row], hi = p.c_max[row];
  float* crow = p.c + (long long)row * p.chunk;
  // one slot: x in XLA's order, the state shifted, the rent clipped
  auto step = [&](float e) {
    float x;
    if constexpr (P == 1) {
      x = __fmaf_rn(ph[0], h[0], e);
    } else if constexpr (P == 2) {
      x = __fmaf_rn(ph[1], h[1], ph[0] * h[0]) + e;
    } else {
      x = ph[0] * h[0];
#pragma unroll
      for (int i = 1; i < P; ++i)
        x = CHAIN ? __fmaf_rn(ph[i], h[i], x) : x + ph[i] * h[i];
      x = x + e;
    }
    if constexpr (MA1)
      x = __fmaf_rn(th[0], ep[0], x);
    else
      x = x + xla_dot<MA>(th, ep, p.Q);
#pragma unroll
    for (int i = P - 1; i > 0; --i) h[i] = h[i - 1];
    h[0] = x;
#pragma unroll
    for (int i = QN - 1; i > 0; --i) ep[i] = ep[i - 1];
    ep[0] = e;
    return fminf(fmaxf(mean + x, lo), hi);
  };
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kArmaStages;
    const int j0 = k * kArmaTile;
    const int n = min(kArmaTile, p.chunk - j0);
    mbar_wait(&full[s], (uint32_t)((k / kArmaStages) & 1));
    const float* e_t = eps_s[s][min(lane, ROWS - 1)];
    if (walks && n == kArmaTile && p.vec) {
#pragma unroll
      for (int t = 0; t < kArmaTile; t += 4) {
        const float4 e4 = *reinterpret_cast<const float4*>(e_t + t);
        float4 c4;
        c4.x = step(e4.x);
        c4.y = step(e4.y);
        c4.z = step(e4.z);
        c4.w = step(e4.w);
        *reinterpret_cast<float4*>(crow + j0 + t) = c4;
      }
    } else if (walks) {
      for (int t = 0; t < n; ++t) crow[j0 + t] = step(e_t[t]);
    }
    __syncwarp();
    mbar_arrive(&empty[s]);
  }
  if (walks) {
#pragma unroll
    for (int i = 0; i < P; ++i) p.hist_out[(long long)row * P + i] = h[i];
#pragma unroll
    for (int i = 0; i < QN; ++i)
      if (i < p.Q) p.eps_out[(long long)row * p.Q + i] = ep[i];
  }
}

// ---------------------------------------------------------------------
// P: poisson_kernel, jax.random.poisson on per-slot keys: Knuth's branch
// below rate 10 (and at NaN), Hormann's transformed rejection at 10 and
// above, a per-item branch.  No TPU kernel: the reference draws through
// XLA's while loops of jax.random.poisson (jax/_src/random.py:
// _poisson_knuth, _poisson_rejection) on per-slot keys
// (src/repro/core/scenarios/streams.py: _poisson_chunk :80, _ge_emit :92).
//
// Per row and slot j (counter t = tids[j]): key = fold_in(key[row], t)
// (then fold_in(., salt) with SALT); the rate lam[row], or with STATES
// (the GE chain's states[row, j]) lam_h[row] in state 1 and lam[row] in
// state 0.
//  - Knuth (lam < 10): while log_prod > -lam: (key, sub) = split(key),
//    log_prod += xla_logf(uniform of sub), rounds += 1; out = lam == 0 ?
//    0 : rounds - 1.  split is two threefry blocks in either layout
//    (partitionable: the counters (0, 0) and (0, 1); original: (0, 2) and
//    (1, 3), key' their first words, sub their second), the uniform a
//    third.  XLA computes the log inside the loop's fusion exactly as
//    xla_logf, and the add after it as a single rounded add.
//  - Hormann (lam >= 10): the rate's constants once (RejRate, at
//    staging), then rounds until the first acceptance (hormann_round):
//    split(key, 3) (three blocks; original layout: the counters 0 .. 5 in
//    halves, the words regrouped in pairs), two uniforms (two blocks), k
//    = floor(fma(2a / us + b, u, lam) + 0.43), the quick accept / reject
//    tests, and only where they decide nothing s = log(v inv_alpha / (a /
//    us^2 + b)) against t = fma(k, log lam, -lam) - lgamma(k + 1); out =
//    k.  sqrt, / and the three FMAs are where XLA rounds and contracts.
// A draw depends only on its own key and rate (vmapped, jax freezes a
// finished lane), so the order in which the items are drawn changes no
// bit.
//
// Bound: integer operations, the threefry blocks: one (two with SALT) a
// slot for its key; three a Knuth round; five a Hormann round (mean
// rounds ~1.1-1.2 at the figures' rates 10 and 200), plus its float
// work, about the ops of two logs, a log1p, nine divisions and the
// Lanczos sum where the quick tests do not decide.  With one thread a
// slot a warp runs as long as its slowest lane (the largest of 32
// draws, ~1.7-2x the mean for Knuth), which held that design at 43% of
// the bound (1.85 ms at 4,096 x 4,096, rates {2, 4, 8}).
//
// Design: lanes refilled from staged tickets.  The grid is one wave of
// blocks (what the SMs hold), and its warps take tickets from a counter
// (one atomicAdd a ticket): a ticket is `span` consecutive slots of one
// row (128; 64 or 32 on small slabs, so that every warp of the wave gets
// two or more).  Tickets, not equal shares of the slab: a warp's work is
// its items' rates, and with equal shares the warps on rate-8 rows ran
// alone at the end (1.79 ms against 1.20 with tickets, both measured by
// tools/compare_hosting.py).
//  - Staging: the warp hashes a ticket's slot keys (the fold_ins, the
//    salt) slot-parallel into one of its two shared buffers, with one
//    state bit a slot (STATES, a ballot a 32 slots), and the row's two
//    rates' Hormann constants: uniform work, no divergence.
//  - Rounds: every lane holding an item runs one round of its item's
//    branch (knuth_round or hormann_round); a lane whose draw ended
//    writes its count over the item's key in the buffer.  The idle lanes
//    (one ballot a round) take the next items of the current buffer in
//    lane order (__popc of the idle lanes below, no atomics) and load
//    their staged keys, rates and (Hormann) constants; an item that needs
//    no round (lam == 0) ends at once.  When the buffer is handed out,
//    the warp takes a ticket into the other buffer and goes on refilling
//    from it while the old buffer's last draws finish; that buffer's
//    counts are stored (coalesced) before it is staged again, after a
//    round if a lane still holds one of its items.
// Measured (chip_smoke.py; H100 80GB HBM3, 700 W, 4,096 x 4,096, Knuth
// at rates {2, 4, 8}): 1.20 ms, 66% of the integer-pipe bound.  Left:
// what a round issues beyond its hashes' ALU-pipe ops (the round's log,
// its loop, the refill's ballot and selects), the lanes a laggard keeps
// idle, each warp's final drain and the wave's last tickets; a Hormann
// round diverges from a Knuth one within a warp only on rows that mix
// the branches.
// ---------------------------------------------------------------------

constexpr int kPoisWarps = 8;              // warps a block
constexpr int kPoisSpan = 128;             // slots a staging buffer holds
constexpr float kKnuthMax = 10.0f;         // Knuth below, Hormann at/above

struct PoissonArgs {
  const long long* keys;   // [R, 2]
  const int* tids;         // [chunk]
  const float* lam;        // [R] the rate, or the state-0 rate with STATES
  const float* lam_h;      // [R] the state-1 rate (STATES)
  const int* states;       // [R, chunk] (STATES)
  int* out;                // [R, chunk]
  unsigned* work;          // [0] the ticket counter, [1] set when a Hormann
                           // item ran (both 0 at the launch), [2] the
                           // launches that ran one
  int R, chunk, salt, partitionable;
  int span;                // slots a ticket (a multiple of 32, <= kPoisSpan)
  int spans_per_row;       // ceil(chunk / span)
  long long n_spans;       // R * spans_per_row: the tickets
  uint32_t one;
};

// jax.random.split(key): (r0, r1) the next key, (s0, s1) the subkey
__device__ __forceinline__ void split2(uint32_t k0, uint32_t k1, bool part,
                                       uint32_t& r0, uint32_t& r1,
                                       uint32_t& s0, uint32_t& s1,
                                       uint32_t one) {
  if (part) {
    r0 = 0u;
    r1 = 0u;
    threefry2x32(k0, k1, r0, r1, one);
    s0 = 0u;
    s1 = 1u;
    threefry2x32(k0, k1, s0, s1, one);
  } else {
    uint32_t a0 = 0u, a1 = 2u, b0 = 1u, b1 = 3u;
    threefry2x32(k0, k1, a0, a1, one);
    threefry2x32(k0, k1, b0, b1, one);
    r0 = a0;
    r1 = b0;
    s0 = a1;
    s1 = b1;
  }
}

// one round of Knuth's loop on the key (a0, a1); true once the draw ended
__device__ __forceinline__ bool knuth_round(uint32_t& a0, uint32_t& a1,
                                            float& log_prod, int& rounds,
                                            float neg, bool part,
                                            uint32_t one) {
  uint32_t r0, r1, s0, s1;
  split2(a0, a1, part, r0, r1, s0, s1, one);
  log_prod = log_prod + xla_logf(uniform_of(s0, s1, part, one));
  ++rounds;
  a0 = r0;
  a1 = r1;
  return !(log_prod > neg);
}

// Hormann's per-rate constants, as XLA computes them before its loop:
// b = fma(sqrt(lam), 2.53, 0.931), a = fma(b, 0.02483, -0.059),
// inv_alpha = 1.1328 / fma(sqrt(lam), 2.53, 0.931 - 3.4) + 1.1239, v_r =
// 0.9277 - 3.6224 / fma(sqrt(lam), 2.53, 0.931 - 2) (XLA folds b - c into
// the FMA's constant), log_lam = XLA's log
struct RejRate {
  float log_lam, b, a, inv_alpha, v_r;
};

__device__ __forceinline__ RejRate rej_rate(float lam) {
  const float sq = __fsqrt_rn(lam);
  RejRate q;
  q.log_lam = xla_logf(lam);
  q.b = __fmaf_rn(sq, 2.53f, 0.931f);
  q.a = __fmaf_rn(q.b, 0.02483f, -0.059f);
  q.inv_alpha = __fdiv_rn(1.1328f, __fmaf_rn(sq, 2.53f, -2.469f)) + 1.1239f;
  q.v_r = 0.9277f - __fdiv_rn(3.6224f, __fmaf_rn(sq, 2.53f, -1.069f));
  return q;
}

// one round of Hormann's rejection on the key (a0, a1) at rate -neg; true
// once a k is accepted (then in k)
__device__ __forceinline__ bool hormann_round(uint32_t& a0, uint32_t& a1,
                                              const RejRate& q, float neg,
                                              bool part, uint32_t one,
                                              float& k) {
  // split(key, 3): three blocks, the key and two subkeys
  uint32_t x0 = 0u, x1 = part ? 0u : 3u;
  uint32_t y0 = part ? 0u : 1u, y1 = part ? 1u : 4u;
  uint32_t z0 = part ? 0u : 2u, z1 = part ? 2u : 5u;
  threefry2x32(a0, a1, x0, x1, one);
  threefry2x32(a0, a1, y0, y1, one);
  threefry2x32(a0, a1, z0, z1, one);
  uint32_t s0, s1, w0, w1;
  if (part) {                       // key i: the block of counter (0, i)
    a0 = x0; a1 = x1; s0 = y0; s1 = y1; w0 = z0; w1 = z1;
  } else {                          // the words x0 y0 z0 x1 y1 z1 in pairs
    a0 = x0; a1 = y0; s0 = z0; s1 = x1; w0 = y1; w1 = z1;
  }
  const float u = uniform_of(s0, s1, part, one) - 0.5f;
  const float v = uniform_of(w0, w1, part, one);
  const float us = 0.5f - fabsf(u);
  const float lam = -neg;
  k = floorf(__fmaf_rn(__fdiv_rn(q.a * 2.0f, us) + q.b, u, lam) + 0.43f);
  if (us >= 0.07f && v <= q.v_r) return true;             // accept1
  if (k < 0.0f || (us < 0.013f && v > us)) return false;  // reject
  const float sl = xla_logf(
      __fdiv_rn(v * q.inv_alpha, __fdiv_rn(q.a, us * us) + q.b));
  const float t = __fmaf_rn(k, q.log_lam, neg) - xla_lgamma1pf(k);
  return sl <= t;                                         // accept2
}

// a warp's staging buffer: one ticket's slots
struct PoisBuf {
  uint2 key[kPoisSpan];          // the slot keys; a finished count in .x
  uint32_t hi[kPoisSpan / 32];   // STATES: bit l of word m, slot 32 m + l
  RejRate rate[2];               // the row's two rates' Hormann constants
};

// a staged ticket (warp-uniform)
struct PoisSpan {
  long long off;                 // its first item's offset in out
  int n;                         // its slots
  float neg0, neg1;              // -lam, -lam_h of its row
};

// the next ticket (warp-uniform)
__device__ __forceinline__ long long pois_ticket(const PoissonArgs& p,
                                                 int lane) {
  unsigned t = 0u;
  if (lane == 0) t = atomicAdd(p.work, 1u);
  return (long long)__shfl_sync(kFullMask, t, 0);
}

// stage ticket t into B: its slot keys, hashed slot-parallel, the state
// bits and the row's Hormann constants (rates of 10 and above); rej is set
// if one of its items is drawn on Hormann's branch (warp-uniform)
template <bool SALT, bool STATES>
__device__ __forceinline__ PoisSpan pois_stage(const PoissonArgs& p,
                                               PoisBuf& B, long long t,
                                               int lane, bool& rej) {
  const long long row = t / p.spans_per_row;
  const int j0 = (int)(t - row * p.spans_per_row) * p.span;
  const int n = min(p.span, p.chunk - j0);
  const uint32_t k0 = (uint32_t)p.keys[2 * row];
  const uint32_t k1 = (uint32_t)p.keys[2 * row + 1];
  int ones = 0;                          // STATES: its slots in state 1
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    if (i < n) {
      uint32_t a0, a1;
      fold_in(k0, k1, (uint32_t)p.tids[j0 + i], a0, a1, p.one);
      if (SALT) {
        uint32_t s0, s1;
        fold_in(a0, a1, (uint32_t)p.salt, s0, s1, p.one);
        a0 = s0;
        a1 = s1;
      }
      B.key[i] = make_uint2(a0, a1);
    }
    if (STATES) {
      const unsigned m = __ballot_sync(
          kFullMask, i < n && p.states[row * p.chunk + j0 + i] == 1);
      if (lane == 0) B.hi[i0 >> 5] = m;
      ones += __popc(m);
    }
  }
  const float l0 = p.lam[row], l1 = STATES ? p.lam_h[row] : 0.0f;
  rej |= (l0 >= kKnuthMax && n > ones) || (l1 >= kKnuthMax && ones > 0);
  if (lane < (STATES ? 2 : 1)) {
    const float l = lane ? l1 : l0;
    if (l >= kKnuthMax) B.rate[lane] = rej_rate(l);
  }
  __syncwarp();
  return PoisSpan{row * p.chunk + j0, n, -l0, -l1};
}

// store the counts of a staged ticket whose items have all finished
__device__ __forceinline__ void pois_flush(const PoissonArgs& p,
                                           const PoisBuf& B, long long off,
                                           int n, int lane) {
  __syncwarp();
  for (int i = lane; i < n; i += 32) p.out[off + i] = (int)B.key[i].x;
}

template <bool SALT, bool STATES>
__global__ void __launch_bounds__(32 * kPoisWarps)
    poisson_kernel(const PoissonArgs p) {
  __shared__ PoisBuf buf_s[kPoisWarps][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  PoisBuf* buf = buf_s[warp];
  const unsigned below = (1u << lane) - 1u;      // the lanes before this
  const bool part = p.partitionable != 0;
  // the two buffers' tickets (sp1 empty and current: the first pass
  // stages into buffer 0); pend: staged, not yet stored; more: tickets
  // may be left
  PoisSpan sp0{0, 0, 0.0f, 0.0f}, sp1{0, 0, 0.0f, 0.0f};
  bool pend0 = false, pend1 = false, more = true;
  int cb = 1, next = 0;                  // the buffer handed out, its next
  // this lane's item: buffer ib (-1: none), slot ii, key, -rate, branch;
  // Knuth: log_prod, rounds; Hormann: the rate's constants
  int ib = -1, ii = 0, rounds = 0;
  uint32_t a0 = 0u, a1 = 0u;
  float log_prod = 0.0f, neg = 0.0f;
  bool rej = false;
  RejRate q{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  bool ran_rej = false;                  // a staged item was Hormann's
  unsigned idle = kFullMask;             // the lanes without an item
  while (true) {
    // hand the idle lanes the next items, staging a ticket when the
    // buffer runs out
    while (idle != 0u) {
      const int n_cur = cb ? sp1.n : sp0.n;
      if (next >= n_cur) {
        if (!more) break;
        const int ob = cb ^ 1;
        if (ob ? pend1 : pend0) {
          // a lane still draws an item of the other buffer: a round first
          if (__ballot_sync(kFullMask, ib == ob) != 0u) break;
          pois_flush(p, buf[ob], ob ? sp1.off : sp0.off, ob ? sp1.n : sp0.n,
                     lane);
        }
        const long long t = pois_ticket(p, lane);
        if (t >= p.n_spans) {
          more = false;
          if (ob) pend1 = false;
          else pend0 = false;
          break;
        }
        const PoisSpan sp =
            pois_stage<SALT, STATES>(p, buf[ob], t, lane, ran_rej);
        if (ob) {
          sp1 = sp;
          pend1 = true;
        } else {
          sp0 = sp;
          pend0 = true;
        }
        cb = ob;
        next = 0;
        continue;
      }
      const int i = next + __popc(idle & below);
      if (ib < 0 && i < n_cur) {
        const uint2 k = buf[cb].key[i];
        a0 = k.x;
        a1 = k.y;
        log_prod = 0.0f;
        rounds = 0;
        const int h = STATES ? (int)((buf[cb].hi[i >> 5] >> (i & 31)) & 1u)
                             : 0;
        neg = cb ? (h ? sp1.neg1 : sp1.neg0) : (h ? sp0.neg1 : sp0.neg0);
        rej = neg <= -kKnuthMax;         // lam >= 10 (NaN: Knuth)
        if (rej) q = buf[cb].rate[h];
        ib = cb;
        ii = i;
        if (!rej && !(log_prod > neg)) {         // no round: lam <= 0
          buf[cb].key[i].x = neg == 0.0f ? 0u : 0xFFFFFFFFu;
          ib = -1;
        }
      }
      next = min(next + __popc(idle), n_cur);
      idle = __ballot_sync(kFullMask, ib < 0);
    }
    // the loop above stops with idle lanes only when nothing is left to
    // hand out or a lane still draws: no lane draws means the warp is done
    if (idle == kFullMask) break;
    if (ib >= 0) {
      if (rej) {
        float k;
        if (hormann_round(a0, a1, q, neg, part, p.one, k)) {
          buf[ib].key[ii].x = (uint32_t)(int)k;
          ib = -1;
        }
      } else if (knuth_round(a0, a1, log_prod, rounds, neg, part, p.one)) {
        buf[ib].key[ii].x = (uint32_t)(neg == 0.0f ? 0 : rounds - 1);
        ib = -1;
      }
    }
    idle = __ballot_sync(kFullMask, ib < 0);
  }
  if (pend0) pois_flush(p, buf[0], sp0.off, sp0.n, lane);
  if (pend1) pois_flush(p, buf[1], sp1.off, sp1.n, lane);
  // count the launch once if any of its warps staged a Hormann item
  if (lane == 0 && ran_rej && atomicCAS(p.work + 1, 0u, 1u) == 0u)
    atomicAdd(p.work + 2, 1u);
}

// ---------------------------------------------------------------------
// P: model2_service_kernel, the Model-2 service costs of one chunk.  No
// TPU kernel: the reference draws a shaped uniform(fold_in(key, t), (N,))
// a slot and counts, per level, the live requests it forwards
// (src/repro/core/scenarios/streams.py: _model2_chunk_fn :399-406).
//
// Per row and slot j: n = min(max(x[row, j], 0), N) live requests;
// request i's uniform is word i of uniform(key, (N,)) under key =
// fold_in(key[row], t); svc[row, j, k] = #{i < n : u_i < g[row, k]} as
// float32.  The words: partitionable, the xor of the block of counter (0,
// i); original, the counters 0 .. N - 1 (a 0 appended for odd N) cut in
// halves and hashed pairwise, so block i < H = ceil(N / 2) holds (0-based)
// words i and H + i -- one hash serves two requests.  Requests past n are
// never drawn (the reference masks them out), which gives the same counts.
// The counts are exact integers, so the order in which a slot's requests
// are drawn and counted changes no bit: only which requests are counted,
// and each one's word, must be the reference's.  u = m * 2^-23 exactly (m
// = bits >> 9), so u < g is m < ceil(g * 2^23) (g * 2^23 is exact; g > 1
// counts every request, g <= 0 or NaN none): the kernel compares m with
// one integer threshold a level.
//
// Bound: integer operations, one threefry block a live slot (its key
// fold; a slot with n = 0 needs none) and one a live request (a live
// block in the original layout), on the H100's integer ALU pipe.  At the
// Model-2 leg's rates {2, 4, 8} (4.67 live requests a slot) one thread a
// (row, slot) held that design at 45% of the bound (0.5514 ms at 4,096 x
// 4,096, K = 3): a warp ran as long as its slot with the most requests,
// and each thread stored K strided floats.
//
// Design: live requests spread over the lanes.  A warp takes a span of
// consecutive slots of one row (128; 64 or 32 on small slabs, so that
// the SMs hold 32 warps each); a plain grid of 4-warp blocks, whose
// scheduler balances rows of different rates (a span's work is the sum
// of 128 draws, so the warps of a block end together).
//  - Staging: a lane owns 4 consecutive slots of the span (16-byte loads
//    of x and the counters when aligned).  One warp scan of its live
//    slots and items (requests; blocks in the original layout) places
//    them; the lane folds the keys of its live slots and writes them,
//    compacted in order, to shared memory with their first items, and
//    marks where each starts: bit l of word q when its first item is 32 q
//    + l (one shared atomicOr a slot; up to 128 passes at once).
//  - Passes: the warp walks the span's flattened items 32 at a time, one
//    a lane.  A lane's slot is the live slots started before the pass
//    plus the __popc of the pass's start bits up to the lane; one 16-byte
//    shared load gives its key and first item.  It hashes its counter
//    and ranks its word: r = the levels whose threshold it reaches (u <
//    g_k iff m < T_k, so u is counted at level k iff r <= lo_k, the
//    levels with a threshold below T_k: g need not be sorted) and adds
//    one to the slot's histogram bucket r by a shared atomicAdd, with no
//    branch: bucket K, never read, takes rank K and a lane past the
//    span's items.  The original layout's lanes rank both words of their
//    block, the second counted when H + i < n.
//  - Store: a lane turns its 4 slots' buckets into prefix sums and picks
//    level k's count at lo_k in registers; the span's [slot][k] floats
//    leave as one contiguous run, 16-byte stores where aligned.
//  - More than 5 levels (Figs 12-16's K = 16 sweep; beyond_knapsack_levels'
//    union slab: K = 31): a span's histogram holds 128 (K + 1) words, so
//    a 4-warp block needs 77,824 bytes at K = 32, past the 48 KiB of
//    static shared memory from K = 19, and the register store's K^2
//    selects and strided floats grow with K.  K <= 5 keeps one
//    instantiation a K (static spans; up to K = 4 a lane's 4 K counts
//    leave as 16-byte stores); K = 6 .. 32 runs one of four bands (K <= 8,
//    16, 24, 32) with a run-time K and its spans in dynamic shared memory
//    sized for that K;
//    a level past K ranks nothing.  A band's store turns a slot's buckets
//    into prefix sums in place (K adds) and writes the span's [slot][K]
//    floats as one contiguous run, a float a lane a pass; the span rule
//    counts the warps an SM holds at that K (occupancy query).  A band's
//    slot holds an odd number of buckets (K + 1, or K + 2): at K = 31 a
//    stride of 32 words put bucket r of every slot in bank r (the 31-level
//    study slab took 8.3 ms at 4,096 x 4,096 where 32 evenly spread levels
//    took 4.3).  Its time against K at 4,096 x 4,096 (chip_smoke.py's
//    fleet_ms_by_k) is in PERF.md.
// Measured (tools/compare_hosting.py, H100 80GB HBM3, 700 W, 4,096 x
// 4,096, K = 3, partitionable): 0.3985 / 0.3965 ms against the one
// thread a slot design's 0.5496 / 0.5493 in the same call, 62% of the
// integer-pipe bound (0.2462 ms).  Left: what a pass issues beyond its
// hash (the slot lookup, a compare and a select a level, the bucket's
// address and atomic): the hash issues about as many FMA-pipe as
// ALU-pipe instructions (its adds, as IMAD), so a pass is bound by issue,
// not by the ALU pipe; a span's last, partly filled pass; a slot's
// staging (its loads, the scans, the compaction, its counts and stores).
// ---------------------------------------------------------------------

constexpr int kM2Warps = 4;                // warps a block
constexpr int kM2Span = 128;               // slots a span holds at most
constexpr int kM2Window = 128;             // passes whose starts are marked
// n_max at most: a span's items fit an int, a count a float exactly
constexpr int kM2MaxRequests = 1 << 23;
// levels a Model-2 service slab holds at most: this kernel's K and the
// slab width Kf that S's svc variant takes (kernels/hosting.py: M2_MAX_K)
constexpr int kM2MaxK = 32;
// one instantiation a K up to here (static shared memory; 16-byte stores
// of a lane's 4 K counts up to K = 4); above it the bands K <= 8, 16, 24
// and 32, each with a run-time K and dynamic shared memory.  K = 5 stays
// static: the first band ranks each word against 8 levels, and took
// 0.5866 ms where the instance took 0.5374 (PERF.md, 4,096 x 4,096)
constexpr int kM2StaticMaxK = 5;
constexpr int kM2BandStep = 8;
static_assert(kM2MaxK == 4 * kM2BandStep, "four bands cover kM2MaxK");

struct Model2Args {
  const long long* keys;   // [R, 2]
  const int* tids;         // [chunk]
  const int* x;            // [R, chunk]
  const float* g;          // [R, K]
  float* out;              // [R, chunk, K]
  int R, chunk, n_max, partitionable;
  int K;                   // levels (a band kernel's run-time K)
  int span;                // slots a span (32, 64 or kM2Span)
  int spans_per_row;       // ceil(chunk / span)
  long long n_spans;       // R * spans_per_row: one a warp
  int vec;                 // chunk % 4 == 0, x, tids, out 16-byte aligned
  uint32_t one;
};

// a warp's span in shared memory: its head, then its histogram, [slot]
// [rank], K + 1 ranks a slot (a band pads them to an odd count): rank K,
// or no item, discarded
struct M2Head {
  // the live slots in order: key (x, y), first item (z), n << 7 | the
  // slot's place in the span (w)
  uint4 live[kM2Span];
  // the window's start bits, a word a pass (a band kernel's store reads
  // each level's lo here after the walk)
  unsigned starts[kM2Window];
};

template <int K>
struct M2Span {
  M2Head head;
  int hist[kM2Span * (K + 1)];
};

// a band's words a slot at K levels, and its dynamic shared memory a warp
__host__ __device__ constexpr int m2_band_stride(int K) { return (K + 1) | 1; }
__host__ __device__ constexpr int m2_band_bytes(int K) {
  return (int)sizeof(M2Head) + 4 * kM2Span * m2_band_stride(K);
}

// T = ceil(g * 2^23), the level's threshold on m = bits >> 9: u < g iff
// m < T (g > 1 counts every request, g <= 0 or NaN none)
__device__ __forceinline__ uint32_t m2_threshold(float g) {
  return g > 0.0f ? (uint32_t)ceilf(fminf(g, 1.0f) * 8388608.0f) : 0u;
}

// a word's rank: the levels whose threshold its m reaches, m >= T iff
// bits > lim = T * 512 - 1; r0 counts the levels at T = 0 (lim 2^32 - 1,
// as for T = 2^23, which no m reaches; a band's unused levels take that
// lim too, and are not in r0)
template <int KM>
__device__ __forceinline__ int m2_rank(uint32_t bits,
                                       const uint32_t (&lim)[KM], int r0) {
  int r = r0;
#pragma unroll
  for (int k = 0; k < KM; ++k) r += bits > lim[k] ? 1 : 0;
  return r;
}

// a slot's counts from its buckets h: level k counts the ranks <= lo[k]
template <int K>
__device__ __forceinline__ void m2_counts(const int* h, const int (&lo)[K],
                                          float* c) {
  int pre[K];
  int acc = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    acc += h[r];
    pre[r] = acc;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int v = pre[0];
#pragma unroll
    for (int r = 1; r < K; ++r) v = r <= lo[k] ? pre[r] : v;
    c[k] = (float)v;
  }
}

// the passes over a staged span's W items (L live slots) into K + 1
// buckets a slot, a slot's buckets ``stride`` words apart; the starts of
// the first window are marked
template <int KM, bool PART>
__device__ __forceinline__ void m2_walk(const Model2Args& p, M2Head& S,
                                        int* hist0, int K, int stride, int L,
                                        int W,
                                        const uint32_t (&lim)[KM], int r0,
                                        int lane) {
  const unsigned upto = (2u << lane) - 1u;    // this lane and those before
  const int h = (p.n_max + 1) / 2;
  int cb = 0;                    // the live slots started before the pass
  for (int w0 = 0; w0 < W; w0 += 32 * kM2Window) {
    const int wend = min(W, w0 + 32 * kM2Window);
    if (w0 > 0) {                // a later window: its starts marked anew
      for (int q = lane; q < (wend - w0 + 31) >> 5; q += 32)
        S.starts[q] = 0u;
      __syncwarp();
      for (int c = lane; c < L; c += 32) {
        const int st = (int)S.live[c].z - w0;
        if (st >= 0 && st < 32 * kM2Window)
          atomicOr(&S.starts[st >> 5], 1u << (st & 31));
      }
      __syncwarp();
    }
    for (int base = w0; base < wend; base += 32) {
      const unsigned starts = S.starts[(base - w0) >> 5];
      const uint4 r = S.live[cb - 1 + __popc(starts & upto)];
      cb += __popc(starts);
      const int f = base + lane;
      const int i = f - (int)r.z;              // the item within its slot
      // a lane past W, and the original layout's second word past n, add
      // to the discarded bucket K
      int* hist = hist0 + (r.w & (kM2Span - 1)) * stride;
      if (PART) {
        uint32_t b0 = 0u, b1 = (uint32_t)i;
        threefry2x32(r.x, r.y, b0, b1, p.one);
        atomicAdd(hist + (f < W ? m2_rank(b0 ^ b1, lim, r0) : K), 1);
      } else {
        // the second counter word: H + i, or the appended 0 for odd N
        uint32_t b0 = (uint32_t)i,
                 b1 = h + i < p.n_max ? (uint32_t)(h + i) : 0u;
        threefry2x32(r.x, r.y, b0, b1, p.one);
        atomicAdd(hist + (f < W ? m2_rank(b0, lim, r0) : K), 1);
        atomicAdd(hist + (f < W && h + i < (int)(r.w >> 7)
                              ? m2_rank(b1, lim, r0) : K), 1);
      }
    }
    __syncwarp();
  }
}

// KM <= kM2StaticMaxK: K = KM levels, spans in static shared memory.  KM
// a band (a multiple of kM2BandStep): K = p.K levels at run time, KM -
// kM2BandStep < K <= KM, spans in dynamic shared memory (m2_band_bytes(K)
// a warp).
template <int KM>
__global__ void __launch_bounds__(32 * kM2Warps)
    model2_service_kernel(const Model2Args p) {
  constexpr bool kBand = KM > kM2StaticMaxK;
  const int K = kBand ? p.K : KM;
  // a slot's buckets: K + 1, a band's padded to an odd count, so that a
  // pass's consecutive slots spread its atomics over the banks and the
  // store's prefix sums (a lane's slots 4 apart) fall in 8 banks, not in
  // one (a stride of 32 at K = 31 put every slot's bucket r in bank r)
  const int stride = kBand ? m2_band_stride(K) : KM + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  M2Head* head;
  int* hist;
  if constexpr (kBand) {
    extern __shared__ __align__(128) unsigned char smem_buf[];
    unsigned char* base = smem_buf + warp * m2_band_bytes(K);
    head = reinterpret_cast<M2Head*>(base);
    hist = reinterpret_cast<int*>(base + sizeof(M2Head));
  } else {
    __shared__ M2Span<KM> spans[kM2Warps];
    head = &spans[warp].head;
    hist = spans[warp].hist;
  }
  const long long t = (long long)blockIdx.x * kM2Warps + warp;
  if (t >= p.n_spans) return;
  M2Head& S = *head;
  const long long row = t / p.spans_per_row;
  const int j0 = (int)(t - row * p.spans_per_row) * p.span;
  const int ns = min(p.span, p.chunk - j0);
  const long long o = row * p.chunk + j0;
  const bool part = p.partitionable != 0;
  const int h = (p.n_max + 1) / 2;
  // staging: this lane's slots sb .. sb + 3 (with vec, all or none in
  // the span), their live requests n and items w
  const int sb = 4 * lane;
  int n[4];
  uint32_t tid[4];
  if (p.vec && sb < ns) {
    const int4 xv = *reinterpret_cast<const int4*>(p.x + o + sb);
    const int4 tv = *reinterpret_cast<const int4*>(p.tids + j0 + sb);
    n[0] = xv.x, n[1] = xv.y, n[2] = xv.z, n[3] = xv.w;
    tid[0] = tv.x, tid[1] = tv.y, tid[2] = tv.z, tid[3] = tv.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = sb + j < ns;
      n[j] = in ? p.x[o + sb + j] : 0;
      tid[j] = in ? (uint32_t)p.tids[j0 + sb + j] : 0u;
    }
  }
  int w[4], items = 0, lives = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    n[j] = min(max(n[j], 0), p.n_max);
    w[j] = part ? n[j] : min(n[j], h);
    items += w[j];
    lives += w[j] > 0 ? 1 : 0;
  }
  // inclusive scans over the lanes: the items and the live slots
  int si = items, sl = lives;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int vi = __shfl_up_sync(kFullMask, si, d);
    const int vl = __shfl_up_sync(kFullMask, sl, d);
    if (lane >= d) {
      si += vi;
      sl += vl;
    }
  }
  const int W = __shfl_sync(kFullMask, si, 31);
  const int L = __shfl_sync(kFullMask, sl, 31);
  for (int q = lane; q < min((W + 31) >> 5, kM2Window); q += 32)
    S.starts[q] = 0u;
  if (sb < ns) {
    // 4 stride ints from a multiple of 16 bytes (sb % 4 == 0)
    int4* hz = reinterpret_cast<int4*>(hist + sb * stride);
    for (int r = 0; r < stride; ++r) hz[r] = make_int4(0, 0, 0, 0);
  }
  __syncwarp();
  // this lane's live slots, compacted in order: key, first item, start bit
  const uint32_t k0 = (uint32_t)p.keys[2 * row];
  const uint32_t k1 = (uint32_t)p.keys[2 * row + 1];
  int c = sl - lives, f = si - items;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (w[j] > 0) {
      uint32_t a0, a1;
      fold_in(k0, k1, tid[j], a0, a1, p.one);
      S.live[c] = make_uint4(a0, a1, (uint32_t)f,
                             (uint32_t)n[j] << 7 | (uint32_t)(sb + j));
      if (f < 32 * kM2Window) atomicOr(&S.starts[f >> 5], 1u << (f & 31));
      ++c;
      f += w[j];
    }
  }
  // the row's thresholds: lim and r0 rank a word, lo[k] (the levels with
  // a threshold below level k's) says which ranks level k counts; a
  // band's levels past K rank nothing
  uint32_t thr[KM], lim[KM];
  int lo[KM], r0 = 0;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    thr[k] = k < K ? m2_threshold(p.g[row * K + k]) : 0u;
    lim[k] = thr[k] == 0u ? kFullMask : thr[k] * 512u - 1u;
    r0 += k < K && thr[k] == 0u ? 1 : 0;
  }
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    lo[k] = 0;
#pragma unroll
    for (int q = 0; q < KM; ++q) lo[k] += q < K && thr[q] < thr[k] ? 1 : 0;
  }
  __syncwarp();
  if (part)
    m2_walk<KM, true>(p, S, hist, K, stride, L, W, lim, r0, lane);
  else
    m2_walk<KM, false>(p, S, hist, K, stride, L, W, lim, r0, lane);
  if constexpr (kBand) {
    // store: each lane turns its slots' buckets into prefix sums in
    // place; lane k < K leaves level k's lo in S.starts; then the span's
    // [slot][k] counts leave as one contiguous run, a float a lane a pass
    if (sb < ns) {
      for (int j = 0; j < 4 && sb + j < ns; ++j) {
        int* hj = hist + (sb + j) * stride;
        int acc = 0;
        for (int r = 0; r < K; ++r) {
          acc += hj[r];
          hj[r] = acc;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KM; ++k)
      if (k == lane && k < K) S.starts[k] = (unsigned)lo[k];
    __syncwarp();
    float* dst = p.out + o * K;
    // q = slot * K + k; a pass moves q by 32 = dq K + dk
    const int dq = 32 / K, dk = 32 - dq * K;
    int slot = lane / K, k = lane - slot * K;
    for (int q = lane; q < ns * K; q += 32) {
      dst[q] = (float)hist[slot * stride + (int)S.starts[k]];
      slot += dq;
      k += dk;
      if (k >= K) {
        k -= K;
        ++slot;
      }
    }
    return;
  } else {
    // store: this lane's slots' counts, [slot][k] from out[o + sb]
    if (sb >= ns) return;
    float* dst = p.out + (o + sb) * K;
    if (KM <= 4 && p.vec) {
      // 4 K consecutive floats, 16-byte aligned (o is a multiple of 4)
      int hv[4 * (KM + 1)];
      float cv[4 * KM];
#pragma unroll
      for (int q = 0; q <= KM; ++q) {
        const int4 v =
            reinterpret_cast<const int4*>(hist + sb * (KM + 1))[q];
        hv[4 * q] = v.x, hv[4 * q + 1] = v.y, hv[4 * q + 2] = v.z,
        hv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m2_counts<KM>(hv + j * (KM + 1), lo, cv + j * KM);
#pragma unroll
      for (int q = 0; q < KM; ++q)
        reinterpret_cast<float4*>(dst)[q] = make_float4(
            cv[4 * q], cv[4 * q + 1], cv[4 * q + 2], cv[4 * q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (sb + j < ns) {
          float cv[KM];
          m2_counts<KM>(hist + (sb + j) * (KM + 1), lo, cv);
#pragma unroll
          for (int k = 0; k < KM; ++k) dst[j * KM + k] = cv[k];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// Asynchronous staging shared by D (dp_fwd_model1) and S.
//
// A CTA owns kRows = 32 consecutive rows; warp 0 is its producer.  The
// producer stages the rows' c and x over a tile of TILE slots into a ring
// of raw stages: one cp.async.bulk per row and array (the row's contiguous
// segment of the tile), completed on the stage's mbarrier by transaction
// count, when the row stride and both pointers are 16-byte aligned
// (chunk % 4 == 0, the fleet's case); otherwise 4-byte cp.async copies,
// whose completion each producer lane hands to the same mbarrier
// (cp.async.mbarrier.arrive.noinc).  The producer then "cooks" the tile:
// it computes every state-free value of each (row, slot) into a second
// ring laid out [slot][field][row], one padding word per slot, so that its
// stores (lanes over slots) and the consumers' loads (lanes over rows) are
// both free of bank conflicts.  A ragged last tile and R not a multiple of
// kRows are masked here and in the consumers; nothing is padded.
// ---------------------------------------------------------------------

constexpr int kRows = 32;        // rows per CTA: one consumer lane each
constexpr int kRawStages = 2;
constexpr int kSmemMax = 227 * 1024;   // dynamic shared memory a CTA, sm_90

// a stage row's words for `words` words of payload: 16-byte aligned, at an
// odd stride in 16-byte units, so that a quarter warp's 16-byte accesses
// of 8 consecutive rows hit 8 distinct groups of 4 banks (D's argmin
// tiles, B's and E's rings)
__host__ __device__ constexpr int be_stride(int words) {
  return 4 * (((words + 3) / 4) | 1);
}

// slots per tile: the cooked ring holds K + 2 words per (row, slot)
template <int K>
struct TileOf {
  static constexpr int value = K <= 4 ? 64 : (K <= 8 ? 32 : 16);
};

// rows padded by 4 words: each row stays 16-byte aligned for the bulk
// copy, and a warp's 16-byte loads of one column (a lane per row) hit all
// 32 banks once per quarter warp.  OBS: a third int array, the
// observation slab that S's table variant reads (the side channel, or
// the arrivals on a Model-2 slab), staged when one is given: a base
// class, empty without OBS, so that D's and alpha-RR's stages keep their
// layout (every array a multiple of 16 bytes).
template <bool OBS, int W>
struct ObsRows {
  int o[kRows][W];
};

template <int W>
struct ObsRows<false, W> {};

template <int TILE, bool OBS = false>
struct RawStage : ObsRows<OBS, TILE + 4> {
  static constexpr int kStride = TILE + 4;
  float c[kRows][kStride];
  int x[kRows][kStride];
};

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a 2D tensor copy of one box into shared memory, completed on bar by
// transaction count: inner coordinate c0 (words), outer c1 (rows)
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// order this thread's generic-proxy reads of shared memory before later
// async-proxy (bulk copy) writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's bulk groups but the newest N have read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// this thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The ring's barriers: raw_full[s] (copies landed; one expect_tx arrival
// for the bulk route, 32 cp.async arrivals otherwise), full[s] (cooked,
// 32 producer lanes), empty[s] (the last reader of a cooked stage, 32
// lanes).  Called by one thread.
template <class Sm>
__device__ void init_ring(Sm& sm, int bulk) {
  for (int s = 0; s < kRawStages; ++s)
    mbar_init(&sm.raw_full[s], bulk ? 1u : 32u);
  for (int s = 0; s < Sm::NC; ++s) {
    mbar_init(&sm.full[s], 32u);
    mbar_init(&sm.empty[s], 32u);
  }
}

// the tensor maps of a producer's route 2 (one 2D tensor copy an array
// and tile): c's, then x's (Model 1) or the slab's, then the observation
// slab's
struct StageMaps {
  CUtensorMap m[3];
};

// Producer, one warp: copy tile j0 .. j0 + n of rows row0 .. row0 + nrows
// of c and x (and, OBS and given, of the observation slab o) into a raw
// stage.  bulk: 0, 4-byte cp.async; 1, one cp.async.bulk a row and
// array; 2 (TMA: S, and D's ARGS route), one 2D tensor copy an array
// (tm: c's, x's and o's maps, boxes of kRows rows x TILE + 4 words, the
// padded rows of the stage; rows past R and slots past the chunk read
// zeros).
template <int TILE, bool OBS = false, bool TMA = false>
__device__ __forceinline__ void stage_raw(RawStage<TILE, OBS>& st,
                                          uint64_t* bar,
                                          const float* __restrict__ c,
                                          const int* __restrict__ x,
                                          int row0, int nrows, int chunk,
                                          int j0, int n, int bulk, int lane,
                                          const int* __restrict__ o,
                                          const CUtensorMap* tm) {
  const bool with_o = OBS && o != nullptr;
  if constexpr (TMA)
    if (bulk == 2) {
      if (lane == 0) {
        mbar_arrive_expect_tx(
            bar, (uint32_t)(kRows * (TILE + 4) * 4 * (with_o ? 3 : 2)));
        tma_2d(&st.c[0][0], &tm[0], j0, row0, bar);
        tma_2d(&st.x[0][0], &tm[1], j0, row0, bar);
        if constexpr (OBS)
          if (with_o) tma_2d(&st.o[0][0], &tm[2], j0, row0, bar);
      }
      return;
    }
  if (bulk) {
    if (lane == 0)
      mbar_arrive_expect_tx(bar, (uint32_t)(nrows * n * (with_o ? 12 : 8)));
    __syncwarp();
    if (lane < nrows) {
      const long long off = (long long)(row0 + lane) * chunk + j0;
      bulk_g2s(&st.c[lane][0], c + off, (uint32_t)(n * 4), bar);
      bulk_g2s(&st.x[lane][0], x + off, (uint32_t)(n * 4), bar);
      if constexpr (OBS)
        if (with_o) bulk_g2s(&st.o[lane][0], o + off, (uint32_t)(n * 4), bar);
    }
  } else {
    for (int r = 0; r < nrows; ++r) {
      const long long off = (long long)(row0 + r) * chunk + j0;
      for (int jj = lane; jj < n; jj += 32) {
        cp_async4(&st.c[r][jj], c + off + jj);
        cp_async4(&st.x[r][jj], x + off + jj);
        if constexpr (OBS)
          if (with_o) cp_async4(&st.o[r][jj], o + off + jj);
      }
    }
    cp_async_arrive_noinc(bar);
  }
}

// Producer, one warp, for the whole chunk: keeps kRawStages tiles of
// copies in flight, and cooks each landed tile into the cooked ring once
// the stage's last reader has released it.  A lane cooks its own row
// (lane r: row row0 + r, its params in registers), 16 slots at a time
// whose raw words it loads first (16-byte loads); cook(out, c, x) writes
// field f of the (row, slot) at out[f * kRows] (OBS: cook(out, c, x, o),
// o the observation slab's word, 0 without one).  Lanes past R cook
// whatever the raw stage holds, and nobody reads it.
template <int TILE, int SS, bool OBS = false, bool TMA = false, class Sm,
          class Cook>
__device__ __forceinline__ void produce(Sm& sm, const float* __restrict__ c,
                                        const int* __restrict__ x, int row0,
                                        int nrows, int chunk, int bulk,
                                        int lane, Cook cook,
                                        const int* __restrict__ o = nullptr,
                                        const CUtensorMap* tm = nullptr) {
  const int ntiles = (chunk + TILE - 1) / TILE;
  for (int i = 0; i < ntiles && i < kRawStages; ++i)
    stage_raw<TILE, OBS, TMA>(sm.raw[i], &sm.raw_full[i], c, x, row0,
                              nrows, chunk, i * TILE,
                              min(TILE, chunk - i * TILE), bulk, lane, o,
                              tm);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kRawStages, cs = i % Sm::NC;
    const int n = min(TILE, chunk - i * TILE);
    mbar_wait(&sm.raw_full[s], (uint32_t)((i / kRawStages) & 1));
    if (i >= Sm::NC)
      mbar_wait(&sm.empty[cs], (uint32_t)(((i / Sm::NC) - 1) & 1));
    float* ck = sm.cooked[cs] + lane;
    const float* rc = sm.raw[s].c[lane];
    const int* rx = sm.raw[s].x[lane];
    const int* ro = nullptr;
    if constexpr (OBS) ro = sm.raw[s].o[lane];
    for (int j = 0; j < n; j += 16) {            // TILE is a multiple of 16
      float4 cv[4];
      int4 xv[4], ov[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cv[u] = *reinterpret_cast<const float4*>(rc + j + 4 * u);
        xv[u] = *reinterpret_cast<const int4*>(rx + j + 4 * u);
        if constexpr (OBS)
          ov[u] = o ? *reinterpret_cast<const int4*>(ro + j + 4 * u)
                    : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float cw[4] = {cv[u].x, cv[u].y, cv[u].z, cv[u].w};
        const int xw[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = j + 4 * u + e;
          if constexpr (OBS) {
            const int ow[4] = {ov[u].x, ov[u].y, ov[u].z, ov[u].w};
            if (jj < n) cook(ck + jj * SS, cw[e], xw[e], ow[e]);
          } else {
            if (jj < n) cook(ck + jj * SS, cw[e], xw[e]);
          }
        }
      }
    }
    fence_proxy_async();
    __syncwarp();
    const int nxt = i + kRawStages;
    if (nxt < ntiles)
      stage_raw<TILE, OBS, TMA>(sm.raw[s], &sm.raw_full[s], c, x, row0,
                                nrows, chunk, nxt * TILE,
                                min(TILE, chunk - nxt * TILE), bulk, lane,
                                o, tm);
    mbar_arrive(&sm.full[cs]);
  }
}

// The raw stage of a Model-2 slab: a tile of the rows' c and of their
// service columns.  Two routes share it.  Bulk (chunk % 4 == 0, 16-byte
// aligned slabs, at most KB slab columns): each row's tile of c and its
// [slot][Kf] segment of svc are contiguous and go by one cp.async.bulk
// each, into rows padded to 16 bytes; the cooking lane picks its row's
// columns cols[k] out of each slot's Kf words.  Gather (a ragged or
// unaligned slab, or more than KB columns): svc[row, t, cols[row][k]] by
// 4-byte cp.async, laid out [k][slot] with odd row strides.  KB, the
// columns a bulk stage holds: at least K, and 192 words a row's tile
// (the fleet's K = 2 lanes of a K = 3 slab copy in bulk).
template <int TILE, int K>
constexpr int svc_bulk_cols() {
  return K > 192 / TILE ? K : 192 / TILE;
}

template <int TILE, int K, bool OBS>
struct RawSvcGather : ObsRows<OBS, TILE + 1> {
  float c[kRows][TILE + 1];
  float s[kRows][K * TILE + 1];                // [k][slot] within a row
};

template <int TILE, int KB, bool OBS>
struct RawSvcBulk : ObsRows<OBS, TILE + 4> {
  float c[kRows][TILE + 4];
  float s[kRows][KB * TILE + 4];               // [slot][Kf] within a row
};

template <int TILE, int K, bool OBS = false>
union RawSvcStage {
  RawSvcGather<TILE, K, OBS> g;
  RawSvcBulk<TILE, svc_bulk_cols<TILE, K>(), OBS> b;
};

// Producer, one warp: copy tile j0 .. j0 + n of rows row0 .. row0 + nrows
// of c and of the rows' service columns (cols [kRows][K] in shared
// memory), and (OBS and given) of the observation slab o, into a raw
// stage, by the bulk route (one copy per row and array) or the gather
// route (lanes over slots, a row at a time).
template <int TILE, int K, bool OBS = false, bool TMA = false>
__device__ __forceinline__ void stage_raw_svc(
    RawSvcStage<TILE, K, OBS>& st, uint64_t* bar,
    const float* __restrict__ c, const float* __restrict__ svc, int Kf,
    int (*cols)[K], int row0, int nrows, int chunk, int j0, int n, int bulk,
    int lane, const int* __restrict__ o, const CUtensorMap* tm) {
  const bool with_o = OBS && o != nullptr;
  if constexpr (TMA)
    if (bulk == 2) {          // tm: c's, the slab's (Kf * TILE + 4), o's
      if (lane == 0) {
        mbar_arrive_expect_tx(
            bar, (uint32_t)(kRows * ((TILE + 4) * (with_o ? 2 : 1)
                                     + Kf * TILE + 4) * 4));
        tma_2d(&st.b.c[0][0], &tm[0], j0, row0, bar);
        tma_2d(&st.b.s[0][0], &tm[1], j0 * Kf, row0, bar);
        if constexpr (OBS)
          if (with_o) tma_2d(&st.b.o[0][0], &tm[2], j0, row0, bar);
      }
      return;
    }
  if (bulk) {
    if (lane == 0)
      mbar_arrive_expect_tx(
          bar, (uint32_t)(nrows * n * (Kf + (with_o ? 2 : 1)) * 4));
    __syncwarp();
    if (lane < nrows) {
      const long long off = (long long)(row0 + lane) * chunk + j0;
      bulk_g2s(&st.b.c[lane][0], c + off, (uint32_t)(n * 4), bar);
      bulk_g2s(&st.b.s[lane][0], svc + off * Kf, (uint32_t)(n * Kf * 4),
               bar);
      if constexpr (OBS)
        if (with_o)
          bulk_g2s(&st.b.o[lane][0], o + off, (uint32_t)(n * 4), bar);
    }
    return;
  }
  for (int r = 0; r < nrows; ++r) {
    const long long off = (long long)(row0 + r) * chunk + j0;
    for (int jj = lane; jj < n; jj += 32) {
      cp_async4(&st.g.c[r][jj], c + off + jj);
      const float* sp = svc + (off + jj) * Kf;
#pragma unroll
      for (int k = 0; k < K; ++k)
        cp_async4(&st.g.s[r][k * TILE + jj], sp + cols[r][k]);
      if constexpr (OBS)
        if (with_o) cp_async4(&st.g.o[r][jj], o + off + jj);
    }
  }
  cp_async_arrive_noinc(bar);
}

// Producer, one warp, on a Model-2 service slab (svc [R, chunk, Kf]): as
// produce, kRawStages tiles of copies in flight, each landed tile cooked,
// cook(out, c, s[K]), by the lane of its row once the stage's last reader
// has released it.  cols [kRows][K] holds each row's columns; ident: no
// column map (Kf == K).  A bulk stage without a map is read four slots at
// a time by 16-byte loads.  Otherwise word k of slot jj of the lane's raw
// row lies at jj * step + at[k] (bulk: step Kf, at the row's columns;
// gather: step 1, at k * TILE), read four slots' words before their four
// cooked stores, and the rows 8g .. 8g + 7 take those slots rotated by g
// (a bulk stage's rows start 16-byte aligned, so one word of all 32 rows
// falls in only 8 banks; rotated, with Kf odd, in 32).  OBS: cook(out, c,
// s[K], o), o the observation slab's word (0 without one).
template <int TILE, int SS, int K, bool OBS = false, bool TMA = false,
          class Sm, class Cook>
__device__ __forceinline__ void produce_svc(
    Sm& sm, const float* __restrict__ c, const float* __restrict__ svc,
    int Kf, int row0, int nrows, int chunk, int bulk, bool ident, int lane,
    Cook cook, const int* __restrict__ o = nullptr,
    const CUtensorMap* tm = nullptr) {
  const int ntiles = (chunk + TILE - 1) / TILE;
  const int step = bulk ? Kf : 1, skew = lane >> 3;
  int at[K];
#pragma unroll
  for (int k = 0; k < K; ++k) at[k] = bulk ? sm.cols[lane][k] : k * TILE;
  for (int i = 0; i < ntiles && i < kRawStages; ++i)
    stage_raw_svc<TILE, K, OBS, TMA>(sm.raw[i], &sm.raw_full[i], c, svc,
                                     Kf, sm.cols, row0, nrows, chunk,
                                     i * TILE, min(TILE, chunk - i * TILE),
                                     bulk, lane, o, tm);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kRawStages, cs = i % Sm::NC;
    const int n = min(TILE, chunk - i * TILE);
    mbar_wait(&sm.raw_full[s], (uint32_t)((i / kRawStages) & 1));
    if (i >= Sm::NC)
      mbar_wait(&sm.empty[cs], (uint32_t)(((i / Sm::NC) - 1) & 1));
    float* ck = sm.cooked[cs] + lane;
    const float* rc = bulk ? sm.raw[s].b.c[lane] : sm.raw[s].g.c[lane];
    const float* rs = bulk ? sm.raw[s].b.s[lane] : sm.raw[s].g.s[lane];
    // a tensor copy lays the rows at a pitch of Kf * TILE + 4 (selected at
    // run time in every instance, that pitch cost alpha-RR's S on a
    // Model-2 slab 23% on an H100: 40 registers instead of 48)
    if constexpr (TMA)
      if (bulk == 2) rs = &sm.raw[s].b.s[0][0] + lane * (Kf * TILE + 4);
    const int* ro = nullptr;
    if constexpr (OBS) ro = bulk ? sm.raw[s].b.o[lane] : sm.raw[s].g.o[lane];
    if (bulk && ident) {                 // n % 4 == 0 on the bulk route
      for (int j = 0; j < n; j += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(rc + j);
        const float cw[4] = {c4.x, c4.y, c4.z, c4.w};
        int ow[4] = {0, 0, 0, 0};
        if (OBS && o) {
          const int4 o4 = *reinterpret_cast<const int4*>(ro + j);
          ow[0] = o4.x;
          ow[1] = o4.y;
          ow[2] = o4.z;
          ow[3] = o4.w;
        }
        float sf[4 * K];
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(rs + j * K + 4 * q);
          sf[4 * q] = v.x;
          sf[4 * q + 1] = v.y;
          sf[4 * q + 2] = v.z;
          sf[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv[K];
#pragma unroll
          for (int k = 0; k < K; ++k) sv[k] = sf[e * K + k];
          if constexpr (OBS) cook(ck + (j + e) * SS, cw[e], sv, ow[e]);
          else cook(ck + (j + e) * SS, cw[e], sv);
        }
      }
    } else {
      for (int j = 0; j < n; j += 4) {
        float cv[4], sv[4][K];
        int ov[4] = {0, 0, 0, 0};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = min(j + ((e + skew) & 3), n - 1);
          cv[e] = rc[jj];
#pragma unroll
          for (int k = 0; k < K; ++k) sv[e][k] = rs[jj * step + at[k]];
          if (OBS && o) ov[e] = ro[jj];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = j + ((e + skew) & 3);
          if constexpr (OBS) {
            if (jj < n) cook(ck + jj * SS, cv[e], sv[e], ov[e]);
          } else {
            if (jj < n) cook(ck + jj * SS, cv[e], sv[e]);
          }
        }
      }
    }
    fence_proxy_async();
    __syncwarp();
    const int nxt = i + kRawStages;
    if (nxt < ntiles)
      stage_raw_svc<TILE, K, OBS, TMA>(sm.raw[s], &sm.raw_full[s], c, svc,
                                       Kf, sm.cols, row0, nrows, chunk,
                                       nxt * TILE,
                                       min(TILE, chunk - nxt * TILE), bulk,
                                       lane, o, tm);
    mbar_arrive(&sm.full[cs]);
  }
}

// a lane's Model-2 column map (cols[row], NULL: the identity) into the
// producer's shared table; the producer warp syncs before staging
template <int K>
__device__ __forceinline__ void load_cols(int (*dst)[K],
                                          const int* __restrict__ cols,
                                          int row, bool live, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    dst[lane][k] = live && cols ? cols[(long long)row * K + k] : k;
  __syncwarp();
}

template <int K>
__device__ __forceinline__ float select_k(const float (&a)[K], int i) {
  // exact a[i] (the reference's one-hot sum) without dynamic register indexing
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) v = (k == i) ? a[k] : v;
  return v;
}

// ---------------------------------------------------------------------
// D: dp_fwd_kernel<K, ARGS, SVC> -- the fleet DP's chunk: kernel D with the
// cost assembly of offline_opt.dp_fwd_chunk fused in, under Model 1
// (dp_fwd_model1, SVC false) or on a Model-2 service slab (dp_fwd_model2,
// SVC true: svc[k] is the slab's column cols[k], or k without a map,
// staged by produce_svc).  Replaces the Pallas kernel dp_minplus_kc (src/repro/kernels/hosting.py:116, pallas_call at
// :138) together with the w assembly that the reference's fused drivers
// run before it (src/repro/core/policies/offline_opt.py:136-138).
//
// Per row and slot t = t0 + j: svc[k] = float(x) * g[k] (one rounding),
// w[k] = kmask[k] ? fma(c, lv[k], svc[k]) : +inf (one rounding, as XLA
// contracts it); trans[kp, k] = J[kp] + fetch[kp, k]; args[j, k] = the
// first kp minimising trans[:, k] (strict <; an all-+inf column gives 0);
// J[k] = min + w[k]; a slot at or past T_len freezes J and writes args =
// k.  args is written only when asked for.
//
// Bound: bytes -- c and x (8 bytes per row-slot) and the frontier, and
// on the ARGS route the argmin table (4 K bytes a row-slot).  Design:
// warp 0 stages c / x by bulk async copies and cooks w (kmask applied)
// into the ring; warp 1 holds a row per lane, J and fetch in registers
// (fetch in shared memory past K = 8), and walks the min-plus chain
// reading only w.  With R = 4,096 rows a CTA of 32 rows lands on each
// SM.  The producer sets the pace of the instances without args (~108
// cycles a slot, 0.2245 ms a 4,096 x 4,096 chunk at K = 3, and as much on
// horizons that end before the chunk, where the chain walks nothing;
// NVIDIA H100 80GB HBM3, 700 W, tools/compare_hosting.py): its per-row
// bulk copies, 64 a tile, and the cooking.  The ARGS instances stage by
// one 2D tensor copy an array and tile (the producer's route 2, where a
// row of the slab's tile fits a box); their chain keeps four slots' args
// in registers and stores them as K 16-byte stores into its row of a ring
// of args tiles (rows at an odd number of 16-byte units, be_stride), and
// a third warp, the writer, fills the frozen identity past the chain's
// last group of valid slots and sends each row's tile segment by one
// cp.async.bulk (4-byte stores when chunk % 4 != 0), so the chain never
// writes global memory: 0.5082 -> 0.1462 ms at that shape (the same
// card; PERF.md section 6).
// ---------------------------------------------------------------------

// the fused D's threads: the producer and the chain, and on the ARGS
// instances the argmin table's writer
template <bool ARGS>
constexpr int kDpThreads = ARGS ? 96 : 64;

template <int K, bool ARGS, bool SVC>
struct DpSmem {
  static constexpr int TILE = TileOf<K>::value;
  static constexpr int SS = K * kRows + 1;     // words per cooked slot
  static constexpr int AS = be_stride(TILE * K);  // words per args tile row
  static constexpr bool kFetchSmem = K > 8;
  static constexpr int NC = 2;                 // cooked stages
  using Raw = typename std::conditional<SVC, RawSvcStage<TILE, K>,
                                        RawStage<TILE>>::type;
  static constexpr int kBase = kRawStages * (int)sizeof(Raw)
                               + (SVC ? kRows * K * 4 : 4)
                               + NC * TILE * SS * 4
                               + (kFetchSmem ? K * K * kRows * 4 : 4) + 512;
  // args tiles in the ring: three where they fit the SM's shared memory
  static constexpr int NA =
      !ARGS ? 1
            : kBase + 3 * kRows * AS * 4 <= kSmemMax
                  ? 3
                  : (kBase + 2 * kRows * AS * 4 <= kSmemMax ? 2 : 1);
  Raw raw[kRawStages];
  int cols[SVC ? kRows : 1][K];                // SVC: each row's columns
  float cooked[NC][TILE * SS];
  float fetch[kFetchSmem ? K * K * kRows : 1];
  alignas(16) int abuf[ARGS ? NA * kRows * AS : 4];  // [stage][row][AS]
  uint64_t raw_full[kRawStages];
  uint64_t full[NC];
  uint64_t empty[NC];
  uint64_t afull[NA];                          // args tile staged (32 lanes)
  uint64_t aempty[NA];                         // args tile sent (the writer)
};

template <int K, bool ARGS, bool SVC>
__global__ void __launch_bounds__(kDpThreads<ARGS>) dp_fwd_kernel(
    const float* __restrict__ J, const float* __restrict__ c,
    const int* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ svc, const int* __restrict__ cols, int Kf,
    const float* __restrict__ lv, const bool* __restrict__ kmask,
    const float* __restrict__ fetch, const int* __restrict__ Tlen,
    float* __restrict__ Jout, int* __restrict__ args, int R, int chunk,
    int t0, int bulk, int abulk, const __grid_constant__ StageMaps maps) {
  using Sm = DpSmem<K, ARGS, SVC>;
  static_assert(sizeof(Sm) <= kSmemMax, "D's tiles fit shared memory");
  constexpr int TILE = Sm::TILE, SS = Sm::SS, NA = Sm::NA;
  extern __shared__ __align__(128) unsigned char smem_buf[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_buf);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, R - row0);
  const int row = row0 + lane;                   // this lane's row
  const bool live = lane < nrows;
  if (threadIdx.x == 0) {
    init_ring(sm, bulk);
    if constexpr (ARGS)
      for (int s = 0; s < NA; ++s) {
        mbar_init(&sm.afull[s], 32u);
        mbar_init(&sm.aempty[s], 1u);
      }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 0) {
    const float INF = __int_as_float(0x7f800000);
    float lvr[K];
    bool mr[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lvr[k] = live ? lv[(long long)row * K + k] : 0.0f;
      mr[k] = live ? kmask[(long long)row * K + k] : false;
    }
    if constexpr (SVC) {
      load_cols<K>(sm.cols, cols, row, live, lane);
      produce_svc<TILE, SS, K, false, ARGS>(
          sm, c, svc, Kf, row0, nrows, chunk, bulk, cols == nullptr, lane,
          [&](float* out, float cv, const float(&sv)[K]) {
#pragma unroll
            for (int k = 0; k < K; ++k)
              out[k * kRows] = mr[k] ? __fmaf_rn(cv, lvr[k], sv[k]) : INF;
          },
          nullptr, maps.m);
    } else {
      float gr[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        gr[k] = live ? g[(long long)row * K + k] : 0.0f;
      produce<TILE, SS, false, ARGS>(
          sm, c, x, row0, nrows, chunk, bulk, lane,
          [&](float* out, float cv, int xv) {
            const float xf = (float)xv;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float s = xf * gr[k];      // Model 1
              out[k * kRows] = mr[k] ? __fmaf_rn(cv, lvr[k], s) : INF;
            }
          },
          nullptr, maps.m);
    }
    return;
  }
  const int Tl = live ? Tlen[row] : 0;
  const int ntiles = (chunk + TILE - 1) / TILE;

  if constexpr (ARGS) {
    if (warp == 2) {
      // the writer: each tile's args rows to global memory, past the
      // chain's last group of valid slots the frozen identity first
      for (int i = 0; i < ntiles; ++i) {
        const int as = i % NA, j0 = i * TILE;
        const int n = min(TILE, chunk - j0);
        mbar_wait(&sm.afull[as], (uint32_t)((i / NA) & 1));
        int* ab = sm.abuf + (as * kRows + lane) * Sm::AS;
        if (live) {
          const int nv = max(0, min(n, Tl - t0 - j0));
          for (int jj = (nv + 3) & ~3; jj < n; jj += 4)
#pragma unroll
            for (int q = 0; q < K; ++q) {
              int v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) v[e] = (4 * q + e) % K;
              *reinterpret_cast<int4*>(ab + jj * K + 4 * q) =
                  make_int4(v[0], v[1], v[2], v[3]);
            }
        }
        if (abulk) {                             // n % 4 == 0
          fence_proxy_async();                   // the identity, then the copy
          if (live) {
            bulk_s2g(args + ((long long)row * chunk + j0) * K, ab,
                     (uint32_t)(n * K * 4));
            bulk_commit();
            bulk_wait_read<0>();                 // the tile read: reusable
          }
        } else {
          __syncwarp();
          for (int r = 0; r < nrows; ++r) {
            int* dst = args + ((long long)(row0 + r) * chunk + j0) * K;
            const int* src = sm.abuf + (as * kRows + r) * Sm::AS;
            for (int e = lane; e < n * K; e += 32) dst[e] = src[e];
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.aempty[as]);
      }
      if (abulk && live) bulk_wait_all();
      return;
    }
  }

  // the chain: one row per lane
  float Jr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) Jr[k] = live ? J[(long long)row * K + k] : 0.0f;
  float freg[Sm::kFetchSmem ? 1 : K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    const float v = live ? fetch[(long long)row * K * K + i] : 0.0f;
    if constexpr (Sm::kFetchSmem)
      sm.fetch[i * kRows + lane] = v;
    else
      freg[i] = v;
  }
  auto F = [&](int kp, int k) -> float {
    if constexpr (Sm::kFetchSmem)
      return sm.fetch[(kp * K + k) * kRows + lane];
    else
      return freg[kp * K + k];
  };
  if constexpr (ARGS) {
    // four slots' args held in registers, then K 16-byte stores into the
    // lane's row of an args tile; the writer warp sends the tile
    for (int i = 0; i < ntiles; ++i) {
      const int cs = i % Sm::NC, as = i % NA, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      mbar_wait(&sm.full[cs], (uint32_t)((i / Sm::NC) & 1));
      if (i >= NA) mbar_wait(&sm.aempty[as], (uint32_t)(((i / NA) - 1) & 1));
      const float* ck = sm.cooked[cs] + lane;
      int* ab = sm.abuf + (as * kRows + lane) * Sm::AS;
      // slots jj < nv are valid; the rest of the tile is past T_len
      const int nv = max(0, min(n, Tl - t0 - j0));
      float wn[K];                               // the next slot's w
#pragma unroll
      for (int k = 0; k < K; ++k) wn[k] = ck[k * kRows];
      // slot jj: J advanced, its args into a[0..K-1]
      auto step = [&](int jj, int* a) {
        float w[K];
        const int nx = min(jj + 1, n - 1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          w[k] = wn[k];
          wn[k] = ck[nx * SS + k * kRows];
        }
        float Jn[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float best = Jr[0] + F(0, k);
          int am = 0;
#pragma unroll
          for (int kp = 1; kp < K; ++kp) {
            const float tr = Jr[kp] + F(kp, k);
            if (tr < best) {
              best = tr;
              am = kp;
            }
          }
          Jn[k] = best + w[k];
          a[k] = am;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) Jr[k] = Jn[k];
      };
      auto store4 = [&](int jj, const int* a, int q) {
        *reinterpret_cast<int4*>(ab + jj * K + 4 * q) =
            make_int4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
      };
      int jj = 0;
      for (; jj + 4 <= nv; jj += 4) {
        int a[4 * K];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          step(jj + u, a + u * K);
#pragma unroll
          for (int q = 0; q < K; ++q)            // the words now complete
            if (4 * q + 3 >= u * K && 4 * q + 3 < (u + 1) * K)
              store4(jj, a, q);
        }
      }
      if (jj < nv) {                             // the last, partial group:
        int a[4 * K];                            // frozen slots the identity
#pragma unroll
        for (int e = 0; e < 4 * K; ++e) a[e] = e % K;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (jj + u < nv) step(jj + u, a + u * K);
#pragma unroll
        for (int q = 0; q < K; ++q) store4(jj, a, q);
      }
      mbar_arrive(&sm.empty[cs]);
      fence_proxy_async();                       // the args, then the copy
      mbar_arrive(&sm.afull[as]);
    }
  } else {
    for (int i = 0; i < ntiles; ++i) {
      const int cs = i % Sm::NC, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      mbar_wait(&sm.full[cs], (uint32_t)((i / Sm::NC) & 1));
      const float* ck = sm.cooked[cs] + lane;
      // slots jj < nv are valid; the rest of the tile is past T_len
      const int nv = max(0, min(n, Tl - t0 - j0));
      float wn[K];                               // the next slot's w
#pragma unroll
      for (int k = 0; k < K; ++k) wn[k] = ck[k * kRows];
      for (int jj = 0; jj < nv; ++jj) {
        float w[K];
        const int nx = min(jj + 1, n - 1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          w[k] = wn[k];
          wn[k] = ck[nx * SS + k * kRows];
        }
        float Jn[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float best = Jr[0] + F(0, k);
#pragma unroll
          for (int kp = 1; kp < K; ++kp) {
            const float tr = Jr[kp] + F(kp, k);
            if (tr < best) best = tr;
          }
          Jn[k] = best + w[k];
        }
#pragma unroll
        for (int k = 0; k < K; ++k) Jr[k] = Jn[k];
      }
      mbar_arrive(&sm.empty[cs]);
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) Jout[(long long)row * K + k] = Jr[k];
  }
}

// ---------------------------------------------------------------------
// D (finished w): dp_minplus_kernel<KB, CW>.  Replaces the Pallas kernel
// dp_minplus_kc (src/repro/kernels/hosting.py:116, body :96, pallas_call
// at :138) for callers that hand in a finished w (offline_opt_batch, whose
// w the reference rounds twice, and offline_opt) and for K up to 32; the
// fleet DP runs dp_fwd_kernel above.
//
// Per row and slot t: trans[kp, k] = J[kp] + fetch[kp, k]; args[t, k] =
// the first kp minimising trans[:, k] (strict <, kp upward; an all-+inf
// column gives 0); J[k] = min + w[t, k]; a slot whose valid byte is 0
// freezes J and writes args[t, k] = k.  valid is any mask.
//
// Bound: bytes -- w read and args written, 8 bytes a (row, slot, level),
// and valid's byte a (row, slot).  Design: a CTA of kRows = 32 rows.  Warp
// 0 stages each tile of TILE slots (dpm_tile) of w, a [32, TILE * K + 4]
// box whose rows are an odd number of 16-byte units, and of valid by one
// 2D tensor copy each into a ring of kDpmStages stages (when chunk % 16 ==
// 0 and every pointer is 16-byte aligned; else 4-byte cp.async for w and
// byte loads for valid).  The consumer warps walk the chain a row per
// lane, reading w straight from the stage (there is nothing to cook), and
// store the argmin table into a ring of kDpmArgs args tiles with the same
// row pitch, which the last warp sends to global memory by one
// cp.async.bulk a row (4-byte stores on the 4-byte route).  K <= 8 (CW =
// 1): one consumer warp, J and fetch in registers, four slots' w read as K
// 16-byte loads and their args stored as K 16-byte stores, the next four
// slots' w loaded while these are walked.  K = 9 .. 32 (bands KB = 12, 16,
// .., 32 of a run-time K, CW = KB / 4 consumer warps of NCOL = 4 columns;
// two columns a warp on twice the warps was slower at K = 16): consumer
// warp c takes columns NCOL c .. NCOL c + NCOL - 1 of every row, its fetch
// columns in registers, each column's argmin a tree over groups of four
// predecessors merged in order (2 + KB / 4 dependent steps, not KB); the
// frontier goes through shared memory, two buffers and one named barrier
// a slot, its levels past K held at +inf with fetch 0, so that they never
// win a strict <.  The old design, one warp a row reading w a slot at a
// time, took 3.2147 ms at R = chunk = 4,096, K = 3 (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md section 6).
// ---------------------------------------------------------------------

constexpr int kDpmStages = 3;              // w / valid stages in the ring
constexpr int kDpmArgs = 3;                // args tiles in the ring

// slots a tile: a multiple of 4 with TILE * K <= 252 (the box, TILE * K +
// 4 words, within the 256 a tensor copy takes) and TILE * K % 8 == 0 (so
// that a row, TILE * K + 4 words, is an odd number of 16-byte units)
__host__ __device__ constexpr int dpm_tile(int K) {
  const int t = (252 / K < 128 ? 252 / K : 128) & ~3;
  return (t * K) % 8 ? t - 4 : t;
}

__host__ __device__ constexpr int up128(int bytes) {
  return (bytes + 127) & ~127;
}

// the shared memory of a launch at K levels: the w stages [stage][row][ws
// words], the valid stages [stage][row][vs bytes] (a tile's valid bytes
// from byte j0 & 15 of its row: a tensor copy's box must start 16-byte
// aligned, at j0 & ~15; an odd number of 16-byte units a row), the args
// tiles [tile][row][ws words], the frontier's two buffers [2][row][js
// words] (CW > 1), the barriers
struct DpmLayout {
  int tile, ws, vs, js, w_off, v_off, a_off, j_off, bar_off, bytes;
};

__host__ __device__ inline DpmLayout dpm_layout(int K, int KB, int CW) {
  DpmLayout L{};
  L.tile = dpm_tile(K);
  L.ws = L.tile * K + 4;                        // == be_stride(TILE * K)
  L.vs = 16 * (((L.tile + 12 + 15) / 16) | 1);
  L.js = CW > 1 ? 4 * ((KB / 4) | 1) : 0;
  L.w_off = 0;
  L.v_off = up128(L.w_off + kDpmStages * kRows * L.ws * 4);
  L.a_off = up128(L.v_off + kDpmStages * kRows * L.vs);
  L.j_off = up128(L.a_off + kDpmArgs * kRows * L.ws * 4);
  L.bar_off = up128(L.j_off + 2 * kRows * L.js * 4);
  L.bytes = L.bar_off + 8 * 2 * (kDpmStages + kDpmArgs);
  return L;
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// KB: K itself (CW == 1) or the band's largest K (CW consumer warps)
template <int KB, int CW>
__global__ void __launch_bounds__(32 * (CW + 2), 1) dp_minplus_kernel(
    const float* __restrict__ J, const float* __restrict__ w,
    const float* __restrict__ fetch, const uint8_t* __restrict__ valid,
    float* __restrict__ Jout, int* __restrict__ args, int R, int chunk,
    int K, int tma, const __grid_constant__ StageMaps maps) {
  // a consumer warp's columns (CW > 1)
  constexpr int NCOL = CW == 1 ? KB : 4;
  static_assert(CW == 1 ? KB <= 8 : KB == NCOL * CW && KB <= 32,
                "D's bands");
  if constexpr (CW == 1) K = KB;
  extern __shared__ __align__(128) unsigned char smem_buf[];
  const DpmLayout L = dpm_layout(K, KB, CW);
  float* wst = reinterpret_cast<float*>(smem_buf + L.w_off);
  uint8_t* vst = smem_buf + L.v_off;
  int* abuf = reinterpret_cast<int*>(smem_buf + L.a_off);
  float* jx = reinterpret_cast<float*>(smem_buf + L.j_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_buf + L.bar_off);
  uint64_t* empty = full + kDpmStages;
  uint64_t* afull = empty + kDpmStages;        // args tile stored
  uint64_t* aempty = afull + kDpmArgs;         // args tile sent
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, R - row0);
  const int row = row0 + lane;                   // this lane's row
  const bool live = lane < nrows;
  const int TILE = L.tile, ntiles = (chunk + TILE - 1) / TILE;
  const float INF = __int_as_float(0x7f800000);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDpmStages; ++s) {
      mbar_init(&full[s], tma ? 1u : 64u);
      mbar_init(&empty[s], 32u * CW);
    }
    for (int s = 0; s < kDpmArgs; ++s) {
      mbar_init(&afull[s], 32u * CW);
      mbar_init(&aempty[s], 1u);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 0) {
    // the producer: tile i into stage i % kDpmStages once its readers
    // have released it
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kDpmStages, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      if (i >= kDpmStages)
        mbar_wait(&empty[s], (uint32_t)(((i / kDpmStages) - 1) & 1));
      float* ws = wst + s * kRows * L.ws;
      uint8_t* vs = vst + s * kRows * L.vs;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s],
                                (uint32_t)(kRows * (L.ws * 4 + L.vs)));
          tma_2d(ws, &maps.m[0], j0 * K, row0, &full[s]);
          tma_2d(vs, &maps.m[1], j0 & ~15, row0, &full[s]);
        }
      } else {
        for (int r = 0; r < nrows; ++r) {
          const long long at = (long long)(row0 + r) * chunk + j0;
          const float* src = w + at * K;
          for (int e = lane; e < n * K; e += 32)
            cp_async4(ws + r * L.ws + e, src + e);
          for (int e = lane; e < n; e += 32)
            vs[r * L.vs + (j0 & 15) + e] = valid[at + e];
        }
        cp_async_arrive_noinc(&full[s]);         // the copies, and
        mbar_arrive(&full[s]);                   // the valid bytes stored
      }
    }
    return;
  }

  if (warp == CW + 1) {
    // the writer: each args tile's rows to global memory
    for (int i = 0; i < ntiles; ++i) {
      const int as = i % kDpmArgs, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      mbar_wait(&afull[as], (uint32_t)((i / kDpmArgs) & 1));
      if (tma) {                                 // n * K % 4 == 0
        if (live) {
          bulk_s2g(args + ((long long)row * chunk + j0) * K,
                   abuf + (as * kRows + lane) * L.ws, (uint32_t)(n * K * 4));
          bulk_commit();
          bulk_wait_read<0>();                   // the tile read: reusable
        }
      } else {
        for (int r = 0; r < nrows; ++r) {
          int* dst = args + ((long long)(row0 + r) * chunk + j0) * K;
          const int* src = abuf + (as * kRows + r) * L.ws;
          for (int e = lane; e < n * K; e += 32) dst[e] = src[e];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&aempty[as]);
    }
    if (tma && live) bulk_wait_all();
    return;
  }

  if constexpr (CW == 1) {
    // ---- one consumer warp: J and fetch in registers ----
    constexpr int KK = KB;
    float Jr[KK], f[KK * KK];
#pragma unroll
    for (int k = 0; k < KK; ++k)
      Jr[k] = live ? J[(long long)row * KK + k] : 0.0f;
#pragma unroll
    for (int e = 0; e < KK * KK; ++e)
      f[e] = live ? fetch[(long long)row * KK * KK + e] : 0.0f;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kDpmStages, as = i % kDpmArgs, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      mbar_wait(&full[s], (uint32_t)((i / kDpmStages) & 1));
      if (i >= kDpmArgs)
        mbar_wait(&aempty[as], (uint32_t)(((i / kDpmArgs) - 1) & 1));
      const float* ws = wst + (s * kRows + lane) * L.ws;
      const uint8_t* vs = vst + (s * kRows + lane) * L.vs + (j0 & 15);
      int* ab = abuf + (as * kRows + lane) * L.ws;
      const int last = (n - 1) & ~3;             // the tile's last group
      // four slots' w (word u * K + k: slot u, level k) and valid bytes
      float4 cur[KK], nxt[KK];
      uint32_t vcur, vnxt;
      auto load = [&](int jj, float4 (&wv)[KK], uint32_t& vb) {
#pragma unroll
        for (int q = 0; q < KK; ++q)
          wv[q] = *reinterpret_cast<const float4*>(ws + jj * KK + 4 * q);
        vb = *reinterpret_cast<const uint32_t*>(vs + jj);
      };
      load(0, cur, vcur);
      for (int jj = 0; jj < n; jj += 4) {
        load(min(jj + 4, last), nxt, vnxt);
        float wf[4 * KK];
#pragma unroll
        for (int q = 0; q < KK; ++q) {
          wf[4 * q] = cur[q].x;
          wf[4 * q + 1] = cur[q].y;
          wf[4 * q + 2] = cur[q].z;
          wf[4 * q + 3] = cur[q].w;
        }
        int a[4 * KK];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool vt = ((vcur >> (8 * u)) & 0xFFu) != 0u && jj + u < n;
          float Jn[KK];
#pragma unroll
          for (int k = 0; k < KK; ++k) {
            float best = Jr[0] + f[k];
            int am = 0;
#pragma unroll
            for (int kp = 1; kp < KK; ++kp) {
              const float tr = Jr[kp] + f[kp * KK + k];
              if (tr < best) {
                best = tr;
                am = kp;
              }
            }
            Jn[k] = best + wf[u * KK + k];
            a[u * KK + k] = vt ? am : k;
          }
#pragma unroll
          for (int k = 0; k < KK; ++k) Jr[k] = vt ? Jn[k] : Jr[k];
        }
#pragma unroll
        for (int q = 0; q < KK; ++q)
          *reinterpret_cast<int4*>(ab + jj * KK + 4 * q) =
              make_int4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
#pragma unroll
        for (int q = 0; q < KK; ++q) cur[q] = nxt[q];
        vcur = vnxt;
      }
      mbar_arrive(&empty[s]);
      fence_proxy_async();                       // the args, then the copy
      mbar_arrive(&afull[as]);
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < KK; ++k) Jout[(long long)row * KK + k] = Jr[k];
    }
  } else {
    // ---- CW consumer warps, warp c on columns NCOL c .. NCOL c + NCOL - 1
    const int c = warp - 1, k0 = NCOL * c;
    bool kin[NCOL];
    float Jo[NCOL], f[KB][NCOL];
#pragma unroll
    for (int q = 0; q < NCOL; ++q) {
      const int k = k0 + q;
      kin[q] = k < K;
      Jo[q] = live && kin[q] ? J[(long long)row * K + k] : INF;
#pragma unroll
      for (int kp = 0; kp < KB; ++kp)
        f[kp][q] = live && kin[q] && kp < K
                       ? fetch[((long long)row * K + kp) * K + k]
                       : 0.0f;
    }
    float* jb[2] = {jx + lane * L.js, jx + (kRows + lane) * L.js};
    auto put = [&](float* dst) {                 // this warp's columns of J
#pragma unroll
      for (int q = 0; q < NCOL; ++q) dst[k0 + q] = Jo[q];
    };
    put(jb[0]);                                  // levels past K: +inf
    put(jb[1]);
    named_bar_sync(1, 32 * CW);
    int p = 0;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kDpmStages, as = i % kDpmArgs, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      mbar_wait(&full[s], (uint32_t)((i / kDpmStages) & 1));
      if (i >= kDpmArgs)
        mbar_wait(&aempty[as], (uint32_t)(((i / kDpmArgs) - 1) & 1));
      const float* ws = wst + (s * kRows + lane) * L.ws + k0;
      const uint8_t* vs = vst + (s * kRows + lane) * L.vs + (j0 & 15);
      int* ab = abuf + (as * kRows + lane) * L.ws + k0;
      for (int jj = 0; jj < n; ++jj) {
        const float* jr = jb[p];
        float best[NCOL];
        int am[NCOL];
        // the first minimum of each column: a tree over each group of
        // four predecessors, the groups merged in order (the right side
        // wins only when strictly less, so the leftmost of the minima
        // wins, as in a strict < scan upward)
#pragma unroll
        for (int b = 0; b < KB / 4; ++b) {
          const float4 j4 = *reinterpret_cast<const float4*>(jr + 4 * b);
          const float jv[4] = {j4.x, j4.y, j4.z, j4.w};
#pragma unroll
          for (int q = 0; q < NCOL; ++q) {
            float t[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) t[e] = jv[e] + f[4 * b + e][q];
            const bool p1 = t[1] < t[0], p3 = t[3] < t[2];
            const float a = p1 ? t[1] : t[0], c2 = p3 ? t[3] : t[2];
            const int ia = p1 ? 1 : 0, ic = p3 ? 3 : 2;
            const bool pc = c2 < a;
            const float g = pc ? c2 : a;
            const int ig = 4 * b + (pc ? ic : ia);
            if (b == 0) {
              best[q] = g;
              am[q] = ig;
            } else if (g < best[q]) {
              best[q] = g;
              am[q] = ig;
            }
          }
        }
        const bool vt = vs[jj] != 0;
#pragma unroll
        for (int q = 0; q < NCOL; ++q)
          if (kin[q]) {
            const float Jn = best[q] + ws[jj * K + q];
            Jo[q] = vt ? Jn : Jo[q];
            ab[jj * K + q] = vt ? am[q] : k0 + q;
          }
        p ^= 1;
        put(jb[p]);
        named_bar_sync(1, 32 * CW);
      }
      mbar_arrive(&empty[s]);
      fence_proxy_async();                       // the args, then the copy
      mbar_arrive(&afull[as]);
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < NCOL; ++q)
        if (kin[q]) Jout[(long long)row * K + k0 + q] = Jo[q];
    }
  }
}

// ---------------------------------------------------------------------
// S: sim_kernel<K, SVC, TABLE> -- one chunk of the per-slot simulation,
// the reference's XLA lax.scan of sim_chunk_core
// (src/repro/core/simulator.py:147-227); no Pallas kernel covered it.
// Under Model 1 (SVC false: the service x * g) or on a Model-2 service
// slab (SVC true: svc[k] is the slab's column cols[k], or k without a
// map, staged by produce_svc), its policy warp steps
//  - alpha-RR (TABLE false: sim_chunk_alpha_rr / sim_chunk_alpha_rr_svc,
//    alpha_rr_step, src/repro/core/policies/alpha_rr.py:88-124): the
//    Model-1 service x*g, w = fma(c, lv, svc), d = w - w[r], the suffix
//    minima S, the margins fma(M, |lv - lv_r|, S), the +1e-6 tie break,
//    the first-index argmin, margin* < -0.0;
//  - or a decision table (TABLE true: sim_chunk_table /
//    sim_chunk_table_svc, static_step, mdp_step and abc_step,
//    src/repro/core/policies/baselines.py:45-170): r' = pi[row][s][r],
//    s the slot's observation, clipped to [0, S - 1]: 0 (static, a one-row
//    table of its level_idx), the side channel (MDP: the GE chain's
//    state) or float(x) >= x_threshold[row] (ABC).  The producer stages
//    that observation as one more [R, chunk] int slab (the side channel;
//    the arrivals on a Model-2 slab, which Model 1 stages anyway) and
//    cooks s into the ring.
// Both: the state frozen past T_len (freeze_invalid), then the
// accounting, op for op: the rent c * lv_r, the service (one rounded
// float(x) * g[r], or the slab's column), the fetch M * max(lv' - lv, 0)
// (zeroed on the last slot without include_final_fetch), sequential
// float32 adds into sums, frozen past T_len, the level counts.
//
// Bound: bytes (c, the observation and x or the slab's words) for the
// table variant; alpha-RR's is its policy's chain, a dependency chain of
// chunk slots per row with only R rows in flight.  Design: a CTA of 32
// rows, each warp on its own scheduler.  Warp 0 stages x / c (or c and
// the slab's rows, and the observation) and cooks each slot's state-free
// fields into the ring: one cp.async.bulk a row and array (4-byte
// cp.async on ragged chunks); the table variant's by one 2D tensor copy
// an array and tile into rows padded to an odd number of 16-byte units
// (route 2) where a row of the slab's tile fits a box.  Warp 1 walks only
// the policy's recurrence, a row per lane (alpha-RR: select w_r, S,
// margins, argmin, switch; a table: the row's table packed a byte a
// level in registers, one prmt a step at K <= 8, the cooked state read a
// slot ahead), and writes the level held in each slot into a per-stage
// ring.  alpha-RR's warp 2 does the accounting from that ring (rent,
// service, fetch in slot order, the counts, the trace).  The table
// variant splits it: warp 2 sums the rent, service and fetch, the held
// level and its lv / g carried from the slot before, the valid prefix
// walked unmasked (one x + 0 after it), four slots priced while the
// next four's level words and the four after's levels, c and x load;
// warp 3 counts the levels (a byte a level in one register while K <= 4)
// and sends the trace, a row's tile by one cp.async.bulk from a
// [row][slot] buffer (4-byte stores on ragged chunks).  On a 4,096 x
// 4,096 chunk at K = 3, MDP on the Markov leg's Model-2 slab (NVIDIA H100
// 80GB HBM3, 700 W; tools/compare_hosting.py, PERF.md section 6): 0.30 ms
// for three warps, its per-row bulk copies (96 a tile) the slowest part
// at ~140 cycles a slot; 0.13 ms as above, the staging still the slowest
// part (~63 cycles a slot, 77% of the byte bound).  The split warps made
// alpha-RR's chain 26% slower there (0.29 -> 0.37 ms, its loop's code
// the same), so alpha-RR keeps three.
// On few rows of a slab of more than 16 levels (4 <= K <= 8, the launch
// one wave of CTAs of kFewRows = 4 rows), the host picks the FEW
// instances.  Their producer stages whole slab rows, one cp.async.bulk a
// row and tile, up to four tiles in flight (the gather's 4-byte copies,
// ~9 cycles each on the one SM of beyond_knapsack_levels' call, had set
// a pace of ~5,000 cycles a tile), and cooks with all 32 lanes over
// (row, slot).  The policy warp takes kFewLevels = 2 levels a lane, 2 or
// 4 lanes a row (one level a lane, or four, and blocks of four slots
// walked speculatively, were slower).  The accounting warp takes a row's
// 8 lanes over its slots (each slot's masked rent, service and fetch
// into its spent w fields, one lane a row adding them in slot order).  At that call (4 rows, a K = 8 lane of its
// 31-level slab, 4,000 slots) one lane a row had left 28 of 32 lanes
// idle: the policy took 533 cycles a slot, the rest 338 (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md section 6).
// ---------------------------------------------------------------------

// the observation a table step indexes its table with (TableObs)
constexpr int kObsNone = 0, kObsSide = 1, kObsX = 2;
constexpr int kTableMaxS = 2;              // table rows (observed states)

template <int K, bool SVC, bool TABLE>
struct SimSmem {
  // cooked fields: alpha-RR w[0..K-1], c, then float(x) (Model 1) or
  // svc[0..K-1] (SVC); a table step s (int bits), c, then float(x) or
  // svc[0..K-1].  FC: c's field, FX: float(x)'s or svc[0]'s
  static constexpr int FC = TABLE ? 1 : K;
  static constexpr int FX = FC + 1;
  static constexpr int NF = FX + (SVC ? K : 1);
  // tiles hold NF + 0..1 fields a slot as TileOf<K> holds K + 2
  static constexpr int TILE = TileOf<NF - 2 < 1 ? 1 : NF - 2>::value;
  static constexpr int SS = NF * kRows + 1;    // words per cooked slot
  static constexpr int RS = kRows + 1;         // words per slot of rb
  static constexpr int LS = (K + 1) | 1;       // words per row of lvt, gt
  static constexpr int TS = be_stride(TILE);   // words per row of tb
  using Raw = typename std::conditional<SVC, RawSvcStage<TILE, K, TABLE>,
                                        RawStage<TILE, TABLE>>::type;
  // three cooked stages let the policy warp run a tile further ahead of
  // the accounting warp (faster than two at K = 3 on an H100); two where
  // three would not fit the SM's shared memory
  static constexpr int NC =
      kRawStages * sizeof(Raw) + 3 * (TILE * SS + (TILE + 1) * RS) * 4
              + (TABLE ? kRows * (2 * LS + TS) * 4 : 0) + 1024 <= kSmemMax
          ? 3
          : 2;
  static constexpr int NR = kRawStages;        // raw stages
  Raw raw[kRawStages];
  int cols[SVC ? kRows : 1][K];                // SVC: each row's columns
  float cooked[NC][TILE * SS];
  int rb[NC][(TILE + 1) * RS];                 // level held in each slot
  // TABLE: each row's level values and g (Model 1), the trace [row][slot]
  float lvt[TABLE ? kRows * LS : 1];
  float gt[TABLE && !SVC ? kRows * LS : 1];
  alignas(16) int tb[TABLE ? kRows * TS : 4];
  uint64_t raw_full[kRawStages];
  uint64_t full[NC];
  uint64_t rfull[NC];                          // rb written (32 lanes)
  uint64_t empty[NC];                          // read: the accounting
};

// S's threads: producer, policy and accounting warps, and on the table
// variant a fourth, the counts and the trace split off the sums
template <bool TABLE>
constexpr int kSimThreads = TABLE ? 128 : 96;

// the inputs of S: alpha-RR's policy params (plv, mask, pM) and state (S,
// age), or a table policy's (pi [R, S, K], thr [R], the observation kind
// and S); the accounting grid (lv, g: Model 1, M), the horizons, the
// carried level and sums; x and c (Model 1), or c, svc and cols (SVC),
// and the observation slab o (TABLE)
struct SimArgs {
  const void *plv, *mask, *pM, *pi, *thr, *lv, *g, *M, *T_len, *r_in, *S_in,
      *age_in, *sums_in, *counts_in, *x, *c, *svc, *cols, *o;
  int obs, S, t0, chunk, R, Kf, include_final_fetch;
  void *r_out, *S_out, *age_out, *sums_out, *counts_out, *r_hist;
};

// byte sel of {b, a} (prmt.b32's default mode: a selector nibble's low 3
// bits pick one of the 8 bytes, its msb replicates that byte's sign)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// a table row of K <= 16 levels packed a byte a level: word q holds
// levels 4q .. 4q + 3
template <int K>
constexpr int kTableWords = K <= 4 ? 1 : (K <= 8 ? 2 : 4);

// one table step r' = T[r] on the packed row w.  Only the low nibble of r
// is read, and only the low nibble of r' is exact (its other bits are
// whatever the permute leaves there): byte 0 of prmt(w0, w1, r) is byte
// (r & 7) of the row while r < 8, and 0 (the sign of a byte < 128) when
// bit 3 of r is set; K <= 8 is one permute a step.
template <int K>
__device__ __forceinline__ uint32_t table_next(
    const uint32_t (&w)[kTableWords<K>], uint32_t r) {
  if constexpr (K <= 4)
    return prmt(w[0], w[0], r);
  else if constexpr (K <= 8)
    return prmt(w[0], w[1], r);
  else
    return prmt(w[0], w[1], r) | prmt(w[2], w[3], r ^ 8u);
}

// alpha-RR's S on few rows of a wide slab (FEW): kFewRows rows a CTA
constexpr int kFewRows = 4;
// levels a lane of the few-rows policy
constexpr int kFewLevels = 2;
template <int K, bool FEW>
constexpr int kSimRows = FEW ? kFewRows : kRows;

// FEW's shared memory: SimSmem<K, true, false>'s cooked ring, and raw
// stages of whole slab rows (up to kM2MaxK words a slot) of kFewRows rows,
// as many (up to 4) as fit.  (A ring laid out for the 4 rows, in tiles of
// 64 slots, was slower: 0.69 ms at beyond_knapsack_levels' call.)
template <int K>
struct SimFewSmem {
  using B = SimSmem<K, true, false>;
  static constexpr int FC = B::FC, FX = B::FX, NF = B::NF, LS = B::LS;
  static constexpr int TILE = B::TILE, NC = B::NC;
  static constexpr int SS = B::SS, RS = B::RS;
  struct Raw {
    float c[kFewRows][TILE + 4];
    float s[kFewRows][kM2MaxK * TILE + 4];     // [slot][Kf] within a row
  };
  static constexpr int kRing = NC * (TILE * SS + (TILE + 1) * RS) * 4 + 1024;
  static constexpr int NR =
      4 * (int)sizeof(Raw) + kRing <= kSmemMax ? 4
      : (3 * (int)sizeof(Raw) + kRing <= kSmemMax ? 3 : 2);
  Raw raw[NR];
  float cooked[NC][TILE * SS];
  int rb[NC][(TILE + 1) * RS];
  uint64_t raw_full[NR];
  uint64_t full[NC];
  uint64_t rfull[NC];
  uint64_t empty[NC];
};

template <int K, bool SVC, bool TABLE, bool FEW>
using SimSmemOf = typename std::conditional<FEW, SimFewSmem<K>,
                                            SimSmem<K, SVC, TABLE>>::type;

template <int K, bool SVC, bool TABLE, bool FEW = false>
__global__ void __launch_bounds__(kSimThreads<TABLE>) sim_kernel(
    const float* __restrict__ plv_g, const bool* __restrict__ mask_g,
    const float* __restrict__ pM_g, const int* __restrict__ pi_g,
    const float* __restrict__ thr_g, const float* __restrict__ lv_g,
    const float* __restrict__ g_g, const float* __restrict__ M_g,
    const int* __restrict__ Tlen_g, const int* __restrict__ r_in,
    const float* __restrict__ S_in, const int* __restrict__ age_in,
    const float* __restrict__ sums_in, const int* __restrict__ counts_in,
    const int* __restrict__ x_g, const float* __restrict__ c_g,
    const float* __restrict__ svc_g, const int* __restrict__ cols_g,
    const int* __restrict__ o_g, int obs, int S_rows, int t0, int chunk,
    int R, int Kf, int include_final_fetch, int* __restrict__ r_out,
    float* __restrict__ S_out, int* __restrict__ age_out,
    float* __restrict__ sums_out, int* __restrict__ counts_out,
    int* __restrict__ r_hist, int bulk,
    const __grid_constant__ StageMaps maps) {
  using Sm = SimSmemOf<K, SVC, TABLE, FEW>;
  static_assert(sizeof(Sm) <= kSmemMax, "S's tiles fit shared memory");
  static_assert(!FEW || (SVC && !TABLE && K >= 4 && K <= 8),
                "FEW: alpha-RR on a slab, 4 <= K <= 8");
  constexpr int TILE = Sm::TILE, SS = Sm::SS, RS = Sm::RS, LS = Sm::LS;
  constexpr int FC = Sm::FC, FX = Sm::FX;
  constexpr int ROWS = kSimRows<K, FEW>;
  extern __shared__ __align__(128) unsigned char smem_buf[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_buf);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - row0);
  const int row = row0 + lane;                   // this lane's row
  const bool live = lane < nrows;
  const long long rk = (long long)row * K;
  if constexpr (TABLE)
    for (int i = threadIdx.x; i < nrows * K; i += blockDim.x) {
      const int r = i / K, k = i - r * K;
      sm.lvt[r * LS + k] = lv_g[(long long)row0 * K + i];
      if constexpr (!SVC) sm.gt[r * LS + k] = g_g[(long long)row0 * K + i];
    }
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sm::NR; ++s)
      mbar_init(&sm.raw_full[s], bulk ? 1u : 32u);
    for (int s = 0; s < Sm::NC; ++s) {
      mbar_init(&sm.full[s], 32u);
      mbar_init(&sm.rfull[s], 32u);
      mbar_init(&sm.empty[s], TABLE ? 64u : 32u);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // policy params and the accounting grid (lv, g, M) are separate inputs,
  // as in the reference (they coincide for every fleet built by
  // AlphaRR.fleet / RetroRenting.fleet)
  if (warp == 0) {
    if constexpr (TABLE) {
      // the slot's observation: clip(side, 0, S - 1), float(x) >= thr, 0
      const int smax = S_rows - 1;
      const float thr = live && obs == kObsX ? thr_g[row] : 0.0f;
      auto state = [=](int xv, int ov) {
        const int st = obs == kObsSide ? ov
                       : obs == kObsX  ? ((float)xv >= thr ? 1 : 0)
                                       : 0;
        return __int_as_float(min(max(st, 0), smax));
      };
      if constexpr (SVC) {
        load_cols<K>(sm.cols, cols_g, row, live, lane);
        produce_svc<TILE, SS, K, true, true>(
            sm, c_g, svc_g, Kf, row0, nrows, chunk, bulk,
            cols_g == nullptr, lane,
            [&](float* out, float cv, const float(&sv)[K], int ov) {
              // ABC on a Model-2 slab: the arrivals are the staged slab
              out[0] = state(ov, ov);
              out[FC * kRows] = cv;
#pragma unroll
              for (int k = 0; k < K; ++k) out[(FX + k) * kRows] = sv[k];
            },
            o_g, maps.m);
      } else {
        produce<TILE, SS, true, true>(
            sm, c_g, x_g, row0, nrows, chunk, bulk, lane,
            [&](float* out, float cv, int xv, int ov) {
              out[0] = state(xv, ov);
              out[FC * kRows] = cv;
              out[FX * kRows] = (float)xv;
            },
            o_g, maps.m);
      }
    } else if constexpr (FEW) {
      // few rows: each tile of the rows' c and whole slab rows (Kf words
      // a slot) by one cp.async.bulk a row and array (bulk; else 4-byte
      // cp.async, lanes over a row's words), NR tiles in flight; the
      // lanes cook over (row, slot): lane r + kFewRows * p takes row r's
      // slots p, p + 8, ..
      constexpr int NR = Sm::NR, SL = 32 / kFewRows;
      const int ntiles = (chunk + TILE - 1) / TILE;
      const int r = lane % kFewRows, ph = lane / kFewRows, rw = row0 + r;
      const bool rl = r < nrows;
      float plr[K];
      int at[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        plr[k] = rl ? plv_g[(long long)rw * K + k] : 0.0f;
        at[k] = rl && cols_g ? cols_g[(long long)rw * K + k] : k;
      }
      auto stage = [&](int i) {
        const int s = i % NR, j0 = i * TILE;
        const int n = min(TILE, chunk - j0);
        auto& st = sm.raw[s];
        if (bulk) {                              // n % 4 == 0
          if (lane == 0)
            mbar_arrive_expect_tx(&sm.raw_full[s],
                                  (uint32_t)(nrows * n * (Kf + 1) * 4));
          __syncwarp();
          if (lane < nrows) {
            const long long off = (long long)(row0 + lane) * chunk + j0;
            bulk_g2s(&st.c[lane][0], c_g + off, (uint32_t)(n * 4),
                     &sm.raw_full[s]);
            bulk_g2s(&st.s[lane][0], svc_g + off * Kf,
                     (uint32_t)(n * Kf * 4), &sm.raw_full[s]);
          }
        } else {
          for (int q = 0; q < nrows; ++q) {
            const long long off = (long long)(row0 + q) * chunk + j0;
            for (int e = lane; e < n; e += 32)
              cp_async4(&st.c[q][e], c_g + off + e);
            for (int e = lane; e < n * Kf; e += 32)
              cp_async4(&st.s[q][e], svc_g + off * Kf + e);
          }
          cp_async_arrive_noinc(&sm.raw_full[s]);
        }
      };
      for (int i = 0; i < ntiles && i < NR; ++i) stage(i);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % NR, cs = i % Sm::NC, j0 = i * TILE;
        const int n = min(TILE, chunk - j0);
        mbar_wait(&sm.raw_full[s], (uint32_t)((i / NR) & 1));
        if (i >= Sm::NC)
          mbar_wait(&sm.empty[cs], (uint32_t)(((i / Sm::NC) - 1) & 1));
        float* ck = sm.cooked[cs] + r;
        const float* rc = sm.raw[s].c[r];
        const float* rs = sm.raw[s].s[r];
        for (int jj = ph; jj < n; jj += SL) {
          const float cv = rc[jj];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float sv = rs[jj * Kf + at[k]];
            ck[jj * SS + k * kRows] = __fmaf_rn(cv, plr[k], sv);
            ck[jj * SS + (FX + k) * kRows] = sv;
          }
          ck[jj * SS + FC * kRows] = cv;
        }
        fence_proxy_async();                     // the reads, then the copy
        __syncwarp();
        if (i + NR < ntiles) stage(i + NR);
        mbar_arrive(&sm.full[cs]);
      }
    } else {
      float plr[K];
#pragma unroll
      for (int k = 0; k < K; ++k) plr[k] = live ? plv_g[rk + k] : 0.0f;
      if constexpr (SVC) {
        load_cols<K>(sm.cols, cols_g, row, live, lane);
        produce_svc<TILE, SS, K>(
            sm, c_g, svc_g, Kf, row0, nrows, chunk, bulk,
            cols_g == nullptr, lane,
            [&](float* out, float cv, const float(&sv)[K]) {
#pragma unroll
              for (int k = 0; k < K; ++k) {
                out[k * kRows] = __fmaf_rn(cv, plr[k], sv[k]);
                out[(FX + k) * kRows] = sv[k];
              }
              out[FC * kRows] = cv;
            });
      } else {
        float gr[K];
#pragma unroll
        for (int k = 0; k < K; ++k) gr[k] = live ? g_g[rk + k] : 0.0f;
        produce<TILE, SS>(sm, c_g, x_g, row0, nrows, chunk, bulk, lane,
                          [&](float* out, float cv, int xv) {
                            const float xf = (float)xv;
#pragma unroll
                            for (int k = 0; k < K; ++k) {
                              const float s = xf * gr[k];      // Model 1
                              out[k * kRows] = __fmaf_rn(cv, plr[k], s);
                            }
                            out[FC * kRows] = cv;
                            out[FX * kRows] = xf;
                          });
      }
    }
    return;
  }

  const int Tl = live ? Tlen_g[row] : 0;
  const int ntiles = (chunk + TILE - 1) / TILE;

  if (warp == 1) {
    if constexpr (TABLE) {
      // ---- a table step: r' = pi[row][s][r], frozen past T_len ----
      // the row's two table rows (one for S = 1) packed in registers
      constexpr int NW = kTableWords<K>;
      uint32_t tw0[NW], tw1[NW];
#pragma unroll
      for (int q = 0; q < NW; ++q) tw0[q] = tw1[q] = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long at = (long long)row * S_rows * K + k;
        const uint32_t v0 = live ? (uint32_t)pi_g[at] & 0xFFu : 0u;
        const uint32_t v1 =
            live && S_rows > 1 ? (uint32_t)pi_g[at + K] & 0xFFu : v0;
        tw0[k / 4] |= v0 << (8 * (k % 4));
        tw1[k / 4] |= v1 << (8 * (k % 4));
      }
      uint32_t r = live ? (uint32_t)r_in[row] : 0u;
      for (int i = 0; i < ntiles; ++i) {
        const int cs = i % Sm::NC, j0 = i * TILE;
        const int n = min(TILE, chunk - j0);
        mbar_wait(&sm.full[cs], (uint32_t)((i / Sm::NC) & 1));
        const float* ck = sm.cooked[cs] + lane;
        int* rb = sm.rb[cs] + lane;
        // slots jj < nv are valid; the state is frozen past T_len
        const int nv = max(0, min(n, Tl - t0 - j0));
        int sn = __float_as_int(ck[0]);          // the next slot's state
        for (int jj = 0; jj < nv; ++jj) {
          const int st = sn;
          sn = __float_as_int(ck[min(jj + 1, n - 1) * SS]);
          rb[jj * RS] = (int)(r & 15u);
          uint32_t w[NW];
#pragma unroll
          for (int q = 0; q < NW; ++q) w[q] = st ? tw1[q] : tw0[q];
          r = table_next<K>(w, r);
        }
        r &= 15u;
        for (int jj = nv; jj <= n; ++jj) rb[jj * RS] = (int)r;  // and after
        mbar_arrive(&sm.rfull[cs]);
      }
      if (live) r_out[row] = (int)r;
      return;
    } else if constexpr (FEW) {
      // ---- the policy on few rows: a row's KL lanes, lane h holding LP
      // levels h LP .. h LP + LP - 1 (w, S, level, mask), r, age and M in
      // each.  w_r and lv_r come by shuffles from the lane holding r; each
      // lane takes the first-index argmin of its levels and its margin, a
      // butterfly over the row's lanes the row's (levels past K price BIG
      // + EPS and never win: lane r's prices 0).  The next slot's step up
      // to its butterfly is walked beside this slot's butterfly as if no
      // row switched, and walked again when one did (every ~20 slots at
      // the study's call), so the butterflies are not one chain.  The walk
      // runs to the warp's longest valid prefix, each row frozen past its
      // own.
      constexpr int LP = kFewLevels;
      constexpr int KL = (K + LP - 1) / LP <= 2 ? 2
                         : ((K + LP - 1) / LP <= 4 ? 4 : 8);
      const float BIG = (float)3.4e38;   // alpha_rr._BIG
      const float EPS = (float)1e-6;     // alpha_rr._TIE_EPS
      const int rr = lane / KL, h = lane % KL, base = rr * KL, kb = h * LP;
      const int rw = row0 + rr;
      const bool rlive = rr < nrows;
      int r = rlive ? r_in[rw] : 0;
      int age = rlive ? age_in[rw] : 0;
      const float pM = rlive ? pM_g[rw] : 0.0f;
      const int Tr = rlive ? Tlen_g[rw] : 0;
      float S[LP], plv[LP];
      bool mk[LP];
#pragma unroll
      for (int i2 = 0; i2 < LP; ++i2) {
        const bool in = rlive && kb + i2 < K;
        const long long at = (long long)rw * K + kb + i2;
        S[i2] = in ? S_in[at] : 0.0f;
        plv[i2] = in ? plv_g[at] : 0.0f;
        mk[i2] = in ? mask_g[at] : false;
      }
      float plv_r = plv[0];                    // the level of r
#pragma unroll
      for (int i2 = 1; i2 < LP; ++i2) plv_r = (kb + i2 == r) ? plv[i2] : plv_r;
      plv_r = __shfl_sync(kFullMask, plv_r, base + r / LP);
      for (int i = 0; i < ntiles; ++i) {
        const int cs = i % Sm::NC, j0 = i * TILE;
        const int n = min(TILE, chunk - j0);
        mbar_wait(&sm.full[cs], (uint32_t)((i / Sm::NC) & 1));
        const float* ck = sm.cooked[cs] + rr;   // rr < 32: the ring's rows
        int* rb = sm.rb[cs] + rr;
        const int nv = max(0, min(n, Tr - t0 - j0));
        const int nw = __reduce_max_sync(kFullMask, nv);
        float wn[LP];                          // the next slot's w
#pragma unroll
        for (int i2 = 0; i2 < LP; ++i2)
          wn[i2] = ck[min(kb + i2, K - 1) * kRows];
        // lane r / LP's word of level r, which a shuffle fetches
        auto own = [&](const float (&a)[LP], int rr2) {
          float o = a[0];
#pragma unroll
          for (int i2 = 1; i2 < LP; ++i2) o = (kb + i2 == rr2) ? a[i2] : o;
          return o;
        };
        // a slot's step up to the butterfly, from the state before it:
        // Sn (S after it, unswitched), age + 1, and the lane's argmin v,
        // js and its margin
        struct Pre {
          float Sn[LP], v, marg;
          int js, age1;
        };
        auto pre = [&](const float (&w)[LP], float w_r, const float (&S0)[LP],
                       int age0) {
          Pre P;
          P.age1 = age0 + 1;
          const bool gate = P.age1 >= 2;
          P.v = 0.0f;
          P.marg = 0.0f;
          P.js = kb;
#pragma unroll
          for (int i2 = 0; i2 < LP; ++i2) {
            const int k = kb + i2;
            const float s_new = (w[i2] - w_r) + fminf(0.0f, S0[i2]);
            P.Sn[i2] = gate ? s_new : S0[i2];
            float m = __fmaf_rn(pM, fabsf(plv[i2] - plv_r),
                                gate ? s_new : BIG);
            m = mk[i2] ? m : BIG;
            const float mg = (k == r) ? 0.0f : m;
            const float vk = (k == r) ? 0.0f : m + EPS;
            if (i2 == 0 || vk < P.v) {
              P.v = vk;
              P.js = k;
              P.marg = mg;
            }
          }
          return P;
        };
        Pre P = pre(wn, __shfl_sync(kFullMask, own(wn, r), base + r / LP), S,
                    age);
        for (int jj = 0; jj < nw; ++jj) {
          const int nx = min(jj + 1, n - 1);
#pragma unroll
          for (int i2 = 0; i2 < LP; ++i2)
            wn[i2] = ck[nx * SS + min(kb + i2, K - 1) * kRows];
          if (h == 0) rb[jj * RS] = r;
          const bool act = jj < nv;
          float v = P.v, marg = P.marg;
          int js = P.js;
#pragma unroll
          for (int off = KL / 2; off >= 1; off /= 2) {
            const float ov = __shfl_xor_sync(kFullMask, v, off);
            const int oj = __shfl_xor_sync(kFullMask, js, off);
            const float om = __shfl_xor_sync(kFullMask, marg, off);
            const bool take = ov < v || (ov == v && oj < js);
            v = take ? ov : v;
            js = take ? oj : js;
            marg = take ? om : marg;
          }
          const bool sw = act && marg < -0.0f;
          // the next slot's step as if no row switched, beside the
          // butterfly; walked again below when one did
          float S1[LP];
#pragma unroll
          for (int i2 = 0; i2 < LP; ++i2) S1[i2] = act ? P.Sn[i2] : S[i2];
          const int age1 = act ? P.age1 : age;
          const Pre Q = pre(
              wn, __shfl_sync(kFullMask, own(wn, r), base + r / LP), S1, age1);
#pragma unroll
          for (int i2 = 0; i2 < LP; ++i2) S[i2] = sw ? BIG : S1[i2];
          age = sw ? 0 : age1;
          r = sw ? js : r;
          P = Q;
          if (__any_sync(kFullMask, sw)) {       // a switch: r's w and level
            plv_r = __shfl_sync(kFullMask, own(plv, r), base + r / LP);
            P = pre(wn, __shfl_sync(kFullMask, own(wn, r), base + r / LP), S,
                    age);
          }
        }
        if (h == 0)
          for (int t = nw; t <= n; ++t) rb[t * RS] = r;  // and after
        mbar_arrive(&sm.rfull[cs]);
      }
#pragma unroll
      for (int i2 = 0; i2 < LP; ++i2)
        if (rlive && kb + i2 < K) S_out[(long long)rw * K + kb + i2] = S[i2];
      if (rlive && h == 0) {
        r_out[rw] = r;
        age_out[rw] = age;
      }
      return;
    } else {
      // ---- the policy: alpha_rr_step, state frozen past T_len ----
      int r = live ? r_in[row] : 0;
      const float BIG = (float)3.4e38;   // alpha_rr._BIG
      const float EPS = (float)1e-6;     // alpha_rr._TIE_EPS
      float plv[K], S[K];
      bool mk[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        plv[k] = live ? plv_g[rk + k] : 0.0f;
        mk[k] = live ? mask_g[rk + k] : false;
        S[k] = live ? S_in[rk + k] : 0.0f;
      }
      const float pM = live ? pM_g[row] : 0.0f;
      int age = live ? age_in[row] : 0;
      for (int i = 0; i < ntiles; ++i) {
        const int cs = i % Sm::NC, j0 = i * TILE;
        const int n = min(TILE, chunk - j0);
        mbar_wait(&sm.full[cs], (uint32_t)((i / Sm::NC) & 1));
        const float* ck = sm.cooked[cs] + lane;
        int* rb = sm.rb[cs] + lane;
        // slots jj < nv are valid; the state is frozen past T_len
        const int nv = max(0, min(n, Tl - t0 - j0));
        float wn[K];                           // the next slot's w
#pragma unroll
        for (int k = 0; k < K; ++k) wn[k] = ck[k * kRows];
        for (int jj = 0; jj < nv; ++jj) {
          float w[K];
          const int nx = min(jj + 1, n - 1);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            w[k] = wn[k];
            wn[k] = ck[nx * SS + k * kRows];
          }
          rb[jj * RS] = r;
          const int age1 = age + 1;
          const bool gate = age1 >= 2;
          const float w_r = select_k<K>(w, r);
          const float plv_r = select_k<K>(plv, r);
          // margins[k] (0 at r), argmin of margins + (k != r) * EPS with
          // the first index winning, and the margin at the argmin, in one
          // pass
          float Sn[K];
          int js = 0;
          float best = 0.0f, m_js = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float d = w[k] - w_r;
            const float s_new = d + fminf(0.0f, S[k]);
            Sn[k] = gate ? s_new : S[k];
            float m = __fmaf_rn(pM, fabsf(plv[k] - plv_r),
                                gate ? s_new : BIG);
            m = mk[k] ? m : BIG;
            const float marg = (k == r) ? 0.0f : m;
            const float v = (k == r) ? 0.0f : m + EPS;   // marg + 0 at r
            if (k == 0 || v < best) {
              best = v;
              js = k;
              m_js = marg;
            }
          }
          const bool sw = m_js < -0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) S[k] = sw ? BIG : Sn[k];
          age = sw ? 0 : age1;
          r = sw ? js : r;
        }
        for (int jj = nv; jj < n; ++jj) rb[jj * RS] = r;
        rb[n * RS] = r;                        // held after the tile
        mbar_arrive(&sm.rfull[cs]);
      }
      if (live) {
        r_out[row] = r;
        age_out[row] = age;
#pragma unroll
        for (int k = 0; k < K; ++k) S_out[rk + k] = S[k];
      }
      return;
    }
  }

  if constexpr (FEW) {
    // ---- warp 2 on few rows: a row's KL lanes price its slots q, q + KL,
    // .. (rent, service and fetch, each masked as below) into the slot's
    // w fields 0..2 (K >= 4: spent once the policy is past the tile), and
    // count its levels; one lane a row then adds the terms to the sums in
    // slot order; the counts are summed at the end
    constexpr int KL = 32 / kFewRows;            // lanes a row
    const int rr = lane / KL, q = lane % KL, rw = row0 + rr;
    const bool rlive = rr < nrows;
    float lv[K];
    int cnt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lv[k] = rlive ? lv_g[(long long)rw * K + k] : 0.0f;
      cnt[k] = rlive && q == 0 ? counts_in[(long long)rw * K + k] : 0;
    }
    const float M = rlive ? M_g[rw] : 0.0f;
    const int Tr = rlive ? Tlen_g[rw] : 0;
    float s_rent = rlive ? sums_in[rw * 3 + 0] : 0.0f;
    float s_svc = rlive ? sums_in[rw * 3 + 1] : 0.0f;
    float s_fetch = rlive ? sums_in[rw * 3 + 2] : 0.0f;
    for (int i = 0; i < ntiles; ++i) {
      const int cs = i % Sm::NC, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      mbar_wait(&sm.rfull[cs], (uint32_t)((i / Sm::NC) & 1));
      float* ck = sm.cooked[cs] + rr;
      const int* rb = sm.rb[cs] + rr;
      const int tv = Tr - t0 - j0;
      for (int jj = q; jj < n; jj += KL) {
        const int rt = rb[jj * RS];
        const int rn = rb[(jj + 1) * RS];        // the level after the slot
        const float c = ck[jj * SS + FC * kRows];
        const bool valid = jj < tv;
        const bool last = jj == tv - 1;
        const float lv_t = select_k<K>(lv, rt);
        const float svc_t = ck[jj * SS + (FX + rt) * kRows];
        const float lv_next = select_k<K>(lv, rn);
        float fetch = M * fmaxf(lv_next - lv_t, 0.0f);
        if (!include_final_fetch && last) fetch = 0.0f;
        ck[jj * SS] = valid ? c * lv_t : 0.0f;
        ck[jj * SS + kRows] = valid ? svc_t : 0.0f;
        ck[jj * SS + 2 * kRows] = valid ? fetch : 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) cnt[k] += (valid && k == rt) ? 1 : 0;
      }
      __syncwarp();
      if (q == 0)
#pragma unroll 4
        for (int jj = 0; jj < n; ++jj) {
          s_rent = s_rent + ck[jj * SS];
          s_svc = s_svc + ck[jj * SS + kRows];
          s_fetch = s_fetch + ck[jj * SS + 2 * kRows];
        }
      if (r_hist) {
        for (int r = 0; r < nrows; ++r) {
          int* dst = r_hist + (long long)(row0 + r) * chunk + j0;
          const int* src = sm.rb[cs] + r;
          for (int jj = lane; jj < n; jj += 32) dst[jj] = src[jj * RS];
        }
      }
      __syncwarp();
      mbar_arrive(&sm.empty[cs]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int off = KL / 2; off >= 1; off /= 2)
        cnt[k] += __shfl_xor_sync(kFullMask, cnt[k], off);
    if (rlive && q == 0) {
      sums_out[rw * 3 + 0] = s_rent;
      sums_out[rw * 3 + 1] = s_svc;
      sums_out[rw * 3 + 2] = s_fetch;
#pragma unroll
      for (int k = 0; k < K; ++k) counts_out[(long long)rw * K + k] = cnt[k];
    }
  } else if constexpr (!TABLE) {
    // ---- warp 2 of alpha-RR: the accounting of sim_chunk_core in slot
    // order, the counts and the trace with it (alpha-RR's policy chain
    // sets its pace, and the table variant's split sums and counts made
    // that chain slower, PERF.md section 6)
    float lv[K], g[K];
    int cnt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lv[k] = live ? lv_g[rk + k] : 0.0f;
      g[k] = live && !SVC ? g_g[rk + k] : 0.0f;
      cnt[k] = live ? counts_in[rk + k] : 0;
    }
    const float M = live ? M_g[row] : 0.0f;
    float s_rent = live ? sums_in[row * 3 + 0] : 0.0f;
    float s_svc = live ? sums_in[row * 3 + 1] : 0.0f;
    float s_fetch = live ? sums_in[row * 3 + 2] : 0.0f;
    for (int i = 0; i < ntiles; ++i) {
      const int cs = i % Sm::NC, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      mbar_wait(&sm.rfull[cs], (uint32_t)((i / Sm::NC) & 1));
      const float* ck = sm.cooked[cs] + lane;
      const int* rb = sm.rb[cs] + lane;
      const int tv = Tl - t0 - j0;
#pragma unroll 2
      for (int jj = 0; jj < n; ++jj) {
        const int rt = rb[jj * RS];
        const int rn = rb[(jj + 1) * RS];        // the level after the slot
        const float c = ck[jj * SS + FC * kRows];
        const bool valid = jj < tv;
        const bool last = jj == tv - 1;
        const float lv_t = select_k<K>(lv, rt);
        const float rent = c * lv_t;
        // the held level's service: its slab column (SVC), or x * g
        const float svc_t = SVC ? ck[jj * SS + (FX + rt) * kRows]
                                : ck[jj * SS + FX * kRows]
                                      * select_k<K>(g, rt);
        const float lv_next = select_k<K>(lv, rn);
        float fetch = M * fmaxf(lv_next - lv_t, 0.0f);
        if (!include_final_fetch && last) fetch = 0.0f;
        s_rent = s_rent + (valid ? rent : 0.0f);
        s_svc = s_svc + (valid ? svc_t : 0.0f);
        s_fetch = s_fetch + (valid ? fetch : 0.0f);
#pragma unroll
        for (int k = 0; k < K; ++k) cnt[k] += (valid && k == rt) ? 1 : 0;
      }
      if (r_hist) {
        for (int r = 0; r < nrows; ++r) {
          int* dst = r_hist + (long long)(row0 + r) * chunk + j0;
          const int* src = sm.rb[cs] + r;
          for (int jj = lane; jj < n; jj += 32) dst[jj] = src[jj * RS];
        }
      }
      mbar_arrive(&sm.empty[cs]);
    }
    if (live) {
      sums_out[row * 3 + 0] = s_rent;
      sums_out[row * 3 + 1] = s_svc;
      sums_out[row * 3 + 2] = s_fetch;
#pragma unroll
      for (int k = 0; k < K; ++k) counts_out[rk + k] = cnt[k];
    }
  } else {
    if (warp == 3) {
      // ---- the counts (order-free integers) and the trace, off the sums;
      // the trace by bulk copies where its rows' tile segments are 16-byte
      // aligned
      const bool tbulk = r_hist && chunk % 4 == 0
                         && (uintptr_t)r_hist % 16 == 0;
      int cnt[K];
#pragma unroll
      for (int k = 0; k < K; ++k) cnt[k] = live ? counts_in[rk + k] : 0;
      for (int i = 0; i < ntiles; ++i) {
        const int cs = i % Sm::NC, j0 = i * TILE;
        const int n = min(TILE, chunk - j0);
        mbar_wait(&sm.rfull[cs], (uint32_t)((i / Sm::NC) & 1));
        const int* rb = sm.rb[cs] + lane;
        const int nv = max(0, min(n, Tl - t0 - j0));
        if constexpr (K <= 4) {
          // a byte a level, TILE < 256 slots a tile
          uint32_t pk = 0u;
#pragma unroll 4
          for (int jj = 0; jj < nv; ++jj) pk += 1u << (8 * rb[jj * RS]);
#pragma unroll
          for (int k = 0; k < K; ++k) cnt[k] += (int)((pk >> (8 * k)) & 0xFFu);
        } else {
#pragma unroll 2
          for (int jj = 0; jj < nv; ++jj) {
            const int rt = rb[jj * RS];
#pragma unroll
            for (int k = 0; k < K; ++k) cnt[k] += rt == k ? 1 : 0;
          }
        }
        if (tbulk) {                               // n % 4 == 0
          // the row's levels four slots a 16-byte store into a buffer,
          // sent by one cp.async.bulk (read before the next tile's stores)
          int* tr = sm.tb + lane * Sm::TS;
          if (i >= 1) bulk_wait_read<0>();
#pragma unroll 4
          for (int jj = 0; jj < n; jj += 4)
            *reinterpret_cast<int4*>(tr + jj) =
                make_int4(rb[jj * RS], rb[(jj + 1) * RS], rb[(jj + 2) * RS],
                          rb[(jj + 3) * RS]);
          fence_proxy_async();
          if (live)
            bulk_s2g(r_hist + (long long)row * chunk + j0, tr,
                     (uint32_t)(n * 4));
          bulk_commit();
        } else if (r_hist) {
          for (int r = 0; r < nrows; ++r) {
            int* dst = r_hist + (long long)(row0 + r) * chunk + j0;
            const int* src = sm.rb[cs] + r;
            for (int jj = lane; jj < n; jj += 32) dst[jj] = src[jj * RS];
          }
        }
        mbar_arrive(&sm.empty[cs]);
      }
      if (tbulk) bulk_wait_all();
      if (live) {
#pragma unroll
        for (int k = 0; k < K; ++k) counts_out[rk + k] = cnt[k];
      }
      return;
    }

    // ---- warp 2: the sums of sim_chunk_core, in slot order.  The valid
    // slots are a prefix of the row (t < T_len), priced unmasked; a masked
    // slot adds 0 to each sum, which one x + 0 after them stands for (it
    // changes only a sum of -0 into +0).  The level held (rt, its lv and g)
    // is carried from the slot before; loads are software-pipelined: four
    // slots are priced while the next four's level words and the four
    // after's levels, c and x are loaded.
    const float* lvr = sm.lvt + lane * LS;
    const float* gtr = sm.gt + (SVC ? 0 : lane * LS);
    const float M = live ? M_g[row] : 0.0f;
    float s_rent = live ? sums_in[row * 3 + 0] : 0.0f;
    float s_svc = live ? sums_in[row * 3 + 1] : 0.0f;
    float s_fetch = live ? sums_in[row * 3 + 2] : 0.0f;
    struct SlotsA {                                // four slots' loads
      int rn[4];                                   // the level after the slot
      float c[4], x[4];                            // c, float(x) (Model 1)
    };
    struct SlotsB {                                // their level words
      float lvn[4], gn[4], sv[4];                  // lv[rn], g[rn]; svc[r]
    };
    for (int i = 0; i < ntiles; ++i) {
      const int cs = i % Sm::NC, j0 = i * TILE;
      const int n = min(TILE, chunk - j0);
      mbar_wait(&sm.rfull[cs], (uint32_t)((i / Sm::NC) & 1));
      const float* ck = sm.cooked[cs] + lane;
      const int* rb = sm.rb[cs] + lane;
      const int tv = Tl - t0 - j0;
      const int nv = max(0, min(n, tv));
      // the slots priced with their fetch: all valid ones, but the row's
      // last when the final fetch is dropped
      const int nf = !include_final_fetch && tv >= 1 && tv <= n ? nv - 1 : nv;
      int rt = rb[0];
      float lv_t = lvr[rt], g_t = SVC ? 0.0f : gtr[rt];
      auto load_a = [&](int j, SlotsA& A) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          A.rn[u] = rb[(j + u + 1) * RS];
          A.c[u] = ck[(j + u) * SS + FC * kRows];
          A.x[u] = SVC ? 0.0f : ck[(j + u) * SS + FX * kRows];
        }
      };
      auto load_b = [&](int j, const SlotsA& A, int r0, SlotsB& B) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          B.lvn[u] = lvr[A.rn[u]];
          if constexpr (SVC) {
            const int r_u = u ? A.rn[u - 1] : r0;  // the level held in slot
            B.sv[u] = ck[(j + u) * SS + (FX + r_u) * kRows];
          } else {
            B.gn[u] = gtr[A.rn[u]];
          }
        }
      };
      // one slot: rent c * lv[r], the service (the slab's column of r, or
      // float(x) * g[r]), the fetch M * (lv[r'] - lv[r])^+
      auto price = [&](float c, float xs, float lv_n, float g_n, int rn) {
        const float rent = c * lv_t;
        const float sv = SVC ? xs : xs * g_t;
        const float fetch = M * fmaxf(lv_n - lv_t, 0.0f);
        s_rent = s_rent + rent;
        s_svc = s_svc + sv;
        s_fetch = s_fetch + fetch;
        lv_t = lv_n;
        g_t = g_n;
        rt = rn;
      };
      int j = 0;
      if (nf >= 4) {
        const int jl = n - 4;                      // the tile's last group
        SlotsA a0, a1;
        SlotsB b0;
        load_a(0, a0);
        load_b(0, a0, rt, b0);
        load_a(min(4, jl), a1);
#pragma unroll 2
        for (; j + 4 <= nf; j += 4) {
          SlotsA a2;
          SlotsB b1;
          load_a(min(j + 8, jl), a2);
          load_b(min(j + 4, jl), a1, a0.rn[3], b1);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            price(a0.c[u], SVC ? b0.sv[u] : a0.x[u], b0.lvn[u],
                  SVC ? 0.0f : b0.gn[u], a0.rn[u]);
          a0 = a1;
          a1 = a2;
          b0 = b1;
        }
      }
      for (; j < nf; ++j) {                        // the priced slots' last few
        const int rn = rb[(j + 1) * RS];
        const float xs = SVC ? ck[j * SS + (FX + rt) * kRows]
                             : ck[j * SS + FX * kRows];
        price(ck[j * SS + FC * kRows], xs, lvr[rn], SVC ? 0.0f : gtr[rn], rn);
      }
      if (nf < nv) {                               // the row's last slot, no
        const float c = ck[nf * SS + FC * kRows];  // final fetch
        s_rent = s_rent + c * lv_t;
        s_svc = s_svc + (SVC ? ck[nf * SS + (FX + rt) * kRows]
                             : ck[nf * SS + FX * kRows] * g_t);
        s_fetch = s_fetch + 0.0f;
      }
      if (nv < n) {                                // masked slots: x + 0
        s_rent = s_rent + 0.0f;
        s_svc = s_svc + 0.0f;
        s_fetch = s_fetch + 0.0f;
      }
      mbar_arrive(&sm.empty[cs]);
    }
    if (live) {
      sums_out[row * 3 + 0] = s_rent;
      sums_out[row * 3 + 1] = s_svc;
      sums_out[row * 3 + 2] = s_fetch;
    }
  }
}

// ---------------------------------------------------------------------
// B and E: a producer warp and a ring of tiles.
//
// A block owns kRows = 32 rows.  The first warps produce: they stage a
// tile of ts slots of the rows (ts a multiple of 4: be_tile) into a
// ring of kBeStages stages, by bulk
// copies completed on the stage's mbarrier by transaction count when every
// row is 16-byte aligned (chunk % 4 == 0 and aligned pointers: the BULK
// instances, one producer warp; B one cp.async.bulk a row, E one 2D
// tensor copy an array), else by 4-byte cp.async from several producer
// warps, whose lanes each hand their completion to the same mbarrier
// (cp.async.mbarrier.arrive.noinc).  The other warps
// walk tile i while the tiles after it land, and release each stage on
// its empty mbarrier.  A stage's rows are 16-byte aligned with an odd
// stride in 16-byte units, so that 8 consecutive rows start on 8 distinct
// groups of 4 banks.
// ---------------------------------------------------------------------

constexpr int kBeStages = 4;                     // tiles in the ring
constexpr int kBeBarBytes = 2 * kBeStages * 8;   // full[], empty[]
// a row's segment of a stage: at most kBeRowWords words and kBeMaxTile
// slots; a row of one of E's arrays at most kBeMaxBox words (a tensor
// copy's box)
constexpr int kBeRowWords = 320, kBeMaxTile = 256, kBeMaxBox = 256;

// the slots of one tile of B (words = K, box 0) or E (words 3, box 1
// under Model 1; 2 + Kf and Kf on a Model-2 slab): whole 4-slot groups
// (bulk copies move whole 16-byte groups), within kBeRowWords and
// kBeMaxTile, no more than the chunk needs; E's also keep a row of each
// array within a box and hold an odd number of groups (E lays a row at a
// pitch of the tile, where a quarter warp's 16-byte loads of 8 rows then
// hit the 32 banks once)
inline int be_tile(int words, int chunk, int box) {
  int g = std::min(std::min(kBeRowWords / words, kBeMaxTile),
                   std::min(kBeMaxBox / std::max(box, 1),
                            (chunk + 3) / 4 * 4)) / 4;
  if (box && g % 2 == 0) --g;
  return 4 * std::max(1, g);
}

// the ring's barriers: full[s] (one expect_tx arrival on the bulk route,
// a cp.async arrival a lane of the P producer warps otherwise), empty[s]
// (one arrival a warp that reads the stage)
template <bool BULK, int P>
__device__ __forceinline__ void be_init_ring(uint64_t* full, uint64_t* empty,
                                             int readers) {
  for (int s = 0; s < kBeStages; ++s) {
    mbar_init(&full[s], BULK ? 1u : 32u * P);
    mbar_init(&empty[s], (uint32_t)readers);
  }
  fence_mbar_init();
}

// a walker warp is done reading stage s: order its reads before the
// producer's next (async-proxy) copy into it, then one arrival
__device__ __forceinline__ void be_release(uint64_t* empty, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// ---------------------------------------------------------------------
// B: dp_backtrack_kernel<BULK>.  No TPU counterpart: the reference
// backtracks the DP's argmin table with a reverse lax.scan
// (dp_backtrack_chunk, src/repro/core/policies/offline_opt.py:162), which
// XLA runs as a loop.
//
// Per row, right to left over the chunk: r[t] = k; k = args[t, k].  It
// returns k at the chunk's entry and r [R, chunk].
//
// Bound: bytes -- it reads the table (4 K bytes a slot) and writes r (4);
// below that, the walk: one dependent shared load a slot and row.
// Design: the ring fills from the chunk's end (tile i covers the slots
// chunk - (i + 1) ts .. chunk - i ts, the ragged tile leftmost, so that on
// the bulk route every tile starts on a 4-slot boundary).  Four walker
// warps walk 8 rows each, a row a lane: 8 rows' segments start on 8
// distinct bank groups, so a step's loads (an offset k < 4 into the slot's
// K words) meet no bank conflict for K <= 4.  BULK: a lane keeps four
// slots of r and stores them with one 16-byte store into its row of a
// double buffer, and sends the tile's r with one cp.async.bulk shared ->
// global (bulk_group; read back before the buffer is reused two tiles
// later, complete before the kernel ends).  Otherwise each step stores its
// slot of r to global memory itself.
// ---------------------------------------------------------------------

constexpr int kBtWalkers = 4;                        // B's walker warps
constexpr int kBtRowsPerWalker = kRows / kBtWalkers;
// producer warps: one issues a tile's bulk copies; one warp's 4-byte
// cp.async keep too few bytes in flight, so that route takes four (the
// 4-byte route of a fleet chunk: 0.2882 ms with one, 0.1337 with four,
// 0.1390 with eight; H100 80GB HBM3, 700 W, tools/compare_hosting.py)
template <bool BULK>
constexpr int kBtProducers = BULK ? 1 : 4;
template <bool BULK>
constexpr int kBtThreads = 32 * (kBtProducers<BULK> + kBtWalkers);

// B's dynamic shared memory: barriers, the ring, r's double buffer
inline size_t bt_smem_bytes(int ts, int K) {
  const int row_words = kBeStages * be_stride(ts * K) + 2 * be_stride(ts);
  return kBeBarBytes + sizeof(int) * (size_t)kRows * row_words;
}

template <bool BULK>
__global__ void __launch_bounds__(kBtThreads<BULK>) dp_backtrack_kernel(
    const int* __restrict__ k_in, const int* __restrict__ args,
    int* __restrict__ k_out, int* __restrict__ r_out, int R, int chunk,
    int K, int ts) {
  extern __shared__ __align__(128) unsigned char be_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(be_smem);
  uint64_t* empty = full + kBeStages;
  const int as = be_stride(ts * K), rs = be_stride(ts);
  int* ring = reinterpret_cast<int*>(be_smem + kBeBarBytes);  // [s][row][as]
  int* rbuf = ring + kBeStages * kRows * as;                  // [2][row][rs]
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, R - row0);
  const int ntiles = (chunk + ts - 1) / ts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int P = kBtProducers<BULK>;
  if (threadIdx.x == 0) be_init_ring<BULK, P>(full, empty, kBtWalkers);
  __syncthreads();

  if (warp < P) {                                // a producer
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kBeStages;
      const int end = chunk - i * ts, j0 = max(0, end - ts), n = end - j0;
      if (i >= kBeStages)
        mbar_wait(&empty[s], (uint32_t)(((i / kBeStages) - 1) & 1));
      int* st = ring + s * kRows * as;
      if constexpr (BULK) {
        if (lane == 0)
          mbar_arrive_expect_tx(&full[s], (uint32_t)(nrows * n * K * 4));
        __syncwarp();
        if (lane < nrows)
          bulk_g2s(st + lane * as,
                   args + ((long long)(row0 + lane) * chunk + j0) * K,
                   (uint32_t)(n * K * 4), &full[s]);
      } else {                                   // rows warp, warp + P, ..
        const int seg = n * K;
        for (int r = warp; r < nrows; r += P) {
          const int* src = args + ((long long)(row0 + r) * chunk + j0) * K;
          for (int o = lane; o < seg; o += 32) cp_async4(st + r * as + o,
                                                         src + o);
        }
        cp_async_arrive_noinc(&full[s]);
      }
    }
    if constexpr (!BULK) cp_async_wait_all();
    return;
  }

  // a walker lane: row rl of the block (lanes past kBtRowsPerWalker idle)
  const int rl = (warp - P) * kBtRowsPerWalker + lane;
  const bool live = lane < kBtRowsPerWalker && rl < nrows;
  const long long roff = (long long)(row0 + rl) * chunk;
  int k = live ? k_in[row0 + rl] : 0;
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kBeStages;
    const int end = chunk - i * ts, j0 = max(0, end - ts), n = end - j0;
    mbar_wait(&full[s], (uint32_t)((i / kBeStages) & 1));
    if (live) {
      const int* a = ring + (s * kRows + rl) * as;
      if constexpr (BULK) {                      // n % 4 == 0
        int* rr = rbuf + ((i & 1) * kRows + rl) * rs;
        if (i >= 2) bulk_wait_read<1>();         // tile i - 2's copy out
        for (int q = n / 4 - 1; q >= 0; --q) {
          const int* aq = a + 4 * q * K;
          int4 v;
          v.w = k;
          k = aq[3 * K + k];
          v.z = k;
          k = aq[2 * K + k];
          v.y = k;
          k = aq[K + k];
          v.x = k;
          k = aq[k];
          *reinterpret_cast<int4*>(rr + 4 * q) = v;
        }
        fence_proxy_async();                     // rr's stores, then the copy
        bulk_s2g(r_out + roff + j0, rr, (uint32_t)(n * 4));
        bulk_commit();
      } else {
        int* ro = r_out + roff + j0;
        for (int j = n - 1; j >= 0; --j) {
          ro[j] = k;
          k = a[j * K + k];
        }
      }
    }
    be_release(&empty[s], lane);
  }
  if (live) {
    if constexpr (BULK) bulk_wait_all();
    k_out[row0 + rl] = k;
  }
}

// ---------------------------------------------------------------------
// E: schedule_kernel<SVC, FMA, BULK>.  No TPU counterpart: the reference
// prices a given schedule with the lax.scan of schedule_chunk_core
// (src/repro/core/simulator.py:390), which XLA runs as a loop.
//
// Per row and slot t of the chunk, entered from the held level prev: the
// fetch M * (lv[r_t] - lv[prev])^+ is charged on entry; rent c_t * lv[r_t]
// and the service of r_t (Model 1: float(x_t) * g[r_t]; SVC: the slab's
// column of r_t, through the row's column map when given) are added to
// the sums slot by slot, each term its own rounded add, masked to 0 past
// the row's horizon; counts[r_t] += valid; prev = valid ? r_t : prev.  A
// level index outside [0, K) selects nothing (0), as the reference's
// one-hot sums do.  Unlike S there is no step and no final fetch.  The
// bits of FMA fuse the rent's (1) and the fetch's (2) products into their
// adds, as the reference's vmapped scans contract them on a small batch
// (simulator.xla_acc_fma); FMA = 1 over S's trace gives S's rent so fused.
// FMA is a template argument: as a run-time flag its branches cost the
// walk 28% at the fleet's shape (a 4,096 x 4,096 chunk, H100 80GB HBM3,
// 700 W).  MAT (the joint multi-service grids): M is the row's [K, K]
// fetch matrix, and the fetch on entry its entry (prev, r_t), 0 when
// either index is out of range -- the reference's one-hot masked sum of
// M, exact since one term is left -- read through L1 (a 32-row block's
// matrices at K = 32 are 128 KB, more than the ring leaves in shared
// memory); a matrix entry has no product, so only the rent fuses.
//
// Bound: bytes -- it reads r, c and x (12 bytes a slot) or r, c and the
// slab (8 + 4 Kf).  Design: the producer stages a tile of r, c and x (or
// the slab's [slot][Kf] words) of the block's 32 rows left to right, on
// the bulk route one 2D tensor copy (cp.async.bulk.tensor) an array and
// tile: a bulk copy a row and array, ~400 bytes each, cost ~20 cycles
// apiece beside their bytes, and E's copies alone took 0.1102 ms a fleet
// chunk that way, 0.0683 ms as tensor copies (H100 80GB HBM3, 700 W;
// tools/compare_hosting.py).  The walker warp walks a row a lane, four
// slots of r, c and x a 16-byte load each (conflict-free: a quarter warp's
// 8 rows cover the 32 banks); the level value held (lv[prev], or 0) is
// carried from the slot before, and the valid slots, a prefix of the row,
// are walked without masks, so the walk stores nothing to shared memory
// and has no branch a slot.  It is software-pipelined: four slots are
// priced while the next four's level words and r, c and x of the four
// after are loaded.  The counts are order-free integers: a third warp, a
// row a lane, counts each valid slot's level, levels 0 to 3 in registers
// (added to the row's counts at the chunk's end) and, when K > 4, higher
// levels by a shared atomicAdd whose result nothing waits for (an atomic,
// or a branch, a slot made the counter the slowest warp).  The rows'
// levels, g (or column map) and counts lie in shared memory with an odd
// row stride.
// ---------------------------------------------------------------------

// producer warps as B's (E's 4-byte route of a fleet chunk: 0.4989 ms
// with one, 0.1704 with four, 0.1244 with eight; the same card and
// script), the walker, the counter
template <bool BULK>
constexpr int kScProducers = BULK ? 1 : 8;
template <bool BULK>
constexpr int kScThreads = 32 * (kScProducers<BULK> + 2);

// E's stage, a row pitch of ts words (ts / 4 odd: a quarter warp's
// 16-byte loads of 8 rows hit the 32 banks once) for r and c and x, of
// ts * Kf for the slab: each array one tensor copy's box of kRows rows
struct ScShape {
  int xw, ks, stage;
  __host__ __device__ ScShape(int ts, int K, int Kf, bool svc)
      : xw(svc ? Kf : 1), ks((K + 1) | 1),
        stage(kRows * ts * (2 + (svc ? Kf : 1))) {}
};

// E's dynamic shared memory: the ring (128-byte aligned, as the tensor
// copies want it), the rows' level words, the barriers
inline size_t sc_smem_bytes(int ts, int K, int Kf, bool svc) {
  const ScShape sh(ts, K, Kf, svc);
  return kBeBarBytes + sizeof(int) * ((size_t)kBeStages * sh.stage
                                      + (size_t)3 * kRows * sh.ks);
}


template <bool SVC, int FMA, bool BULK, bool MAT>
__global__ void __launch_bounds__(kScThreads<BULK>) schedule_kernel(
    const float* __restrict__ lv_g, const float* __restrict__ g_g,
    const float* __restrict__ M_g, const int* __restrict__ Tlen_g,
    const int* __restrict__ prev_in, const float* __restrict__ sums_in,
    const int* __restrict__ counts_in, const int* __restrict__ r_g,
    const float* __restrict__ c_g, const int* __restrict__ x_g,
    const float* __restrict__ svc_g, const int* __restrict__ cols_g,
    int* __restrict__ prev_out, float* __restrict__ sums_out,
    int* __restrict__ counts_out, int R, int chunk, int K, int Kf, int t0,
    int ts, const __grid_constant__ CUtensorMap tm_r,
    const __grid_constant__ CUtensorMap tm_c,
    const __grid_constant__ CUtensorMap tm_x) {
  extern __shared__ __align__(128) unsigned char be_smem[];
  const ScShape sh(ts, K, Kf, SVC);
  const int xw = sh.xw, ks = sh.ks;
  int* ring = reinterpret_cast<int*>(be_smem);   // [s]: r, c, x or slab
  float* lv = reinterpret_cast<float*>(ring + kBeStages * sh.stage);
  float* gk = lv + kRows * ks;                   // Model 1: g
  int* cl = reinterpret_cast<int*>(gk);          // SVC: the column map
  int* cnt = reinterpret_cast<int*>(gk + kRows * ks);
  uint64_t* full = reinterpret_cast<uint64_t*>(cnt + kRows * ks);
  uint64_t* empty = full + kBeStages;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, R - row0);
  const int ntiles = (chunk + ts - 1) / ts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int P = kScProducers<BULK>;
  for (int i = threadIdx.x; i < nrows * K; i += kScThreads<BULK>) {
    const int r = i / K, k = i - r * K;
    const long long gi = (long long)(row0 + r) * K + k;
    lv[r * ks + k] = lv_g[gi];
    cnt[r * ks + k] = counts_in[gi];
    if (SVC) cl[r * ks + k] = cols_g ? cols_g[gi] : k;
    else gk[r * ks + k] = g_g[gi];
  }
  if (threadIdx.x == 0) be_init_ring<BULK, P>(full, empty, 2);
  __syncthreads();

  if (warp < P) {                                // a producer
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kBeStages;
      const int j0 = i * ts, n = min(ts, chunk - j0);
      if (i >= kBeStages)
        mbar_wait(&empty[s], (uint32_t)(((i / kBeStages) - 1) & 1));
      int* rt = ring + s * sh.stage;
      int* ct = rt + kRows * ts;
      int* xt = ct + kRows * ts;                 // x, or the slab
      if constexpr (BULK) {
        // three boxes of kRows rows (those past R, and the slots past the
        // chunk, filled with zeros and counted all the same)
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], (uint32_t)(sh.stage * 4));
          tma_2d(rt, &tm_r, j0, row0, &full[s]);
          tma_2d(ct, &tm_c, j0, row0, &full[s]);
          tma_2d(xt, &tm_x, j0 * xw, row0, &full[s]);
        }
      } else {
        const int* xsrc = SVC ? reinterpret_cast<const int*>(svc_g) : x_g;
        for (int r = warp; r < nrows; r += P) {  // rows warp, warp + P, ..
          const long long off = (long long)(row0 + r) * chunk + j0;
          for (int jj = lane; jj < n; jj += 32) {
            cp_async4(rt + r * ts + jj, r_g + off + jj);
            cp_async4(ct + r * ts + jj, c_g + off + jj);
          }
          for (int o = lane; o < n * xw; o += 32)
            cp_async4(xt + r * ts * xw + o, xsrc + off * xw + o);
        }
        cp_async_arrive_noinc(&full[s]);
      }
    }
    if constexpr (!BULK) cp_async_wait_all();
    return;
  }

  if (warp == P + 1) {                           // the counter: a row a lane
    const bool live = lane < nrows;
    const int T_len = live ? Tlen_g[row0 + lane] : 0;
    int* cr = cnt + lane * ks;
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;          // levels 0 .. 3
    // a slot's level: levels 0 to 3 in registers (those at or past K are
    // dropped at the end), higher ones (WIDE: K > 4) by a shared atomic
    auto count = [&](int r_t, auto wide) {
      c0 += r_t == 0;
      c1 += r_t == 1;
      c2 += r_t == 2;
      c3 += r_t == 3;
      if constexpr (decltype(wide)::value)
        if (r_t >= 4 && r_t < K) atomicAdd(&cr[r_t], 1);
    };
    auto count_tile = [&](const int* rt, int nv, auto wide) {
      int j = 0;
      for (; j + 4 <= nv; j += 4) {
        const int4 r4 = *reinterpret_cast<const int4*>(rt + j);
        count(r4.x, wide);
        count(r4.y, wide);
        count(r4.z, wide);
        count(r4.w, wide);
      }
      for (; j < nv; ++j) count(rt[j], wide);
    };
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kBeStages;
      const int j0 = i * ts, n = min(ts, chunk - j0);
      mbar_wait(&full[s], (uint32_t)((i / kBeStages) & 1));
      if (live) {
        const int* rt = ring + s * sh.stage + lane * ts;
        const int nv = min(n, T_len - (t0 + j0));   // the valid slots
        if (K > 4)
          count_tile(rt, nv, std::true_type{});
        else
          count_tile(rt, nv, std::false_type{});
      }
      be_release(&empty[s], lane);
    }
    if (live) {
      const int cl4[4] = {c0, c1, c2, c3};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < K) cr[k] += cl4[k];
    }
    __syncwarp();
    for (int i = lane; i < nrows * K; i += 32) {
      const int r = i / K, k = i - r * K;
      counts_out[(long long)(row0 + r) * K + k] = cnt[r * ks + k];
    }
    return;
  }

  // the walker: one row a lane.  The valid slots are a prefix of the row
  // (t < T_len), so the walk prices the tile's first nv slots unmasked; a
  // masked slot would add 0 to each unfused sum (and leave the rest as
  // they are), which the tile's x + 0 once stands for (it changes only a
  // sum of -0 into +0).
  const bool live = lane < nrows;
  const int row = row0 + lane;
  const float* lvr = lv + lane * ks;
  const float* gkr = gk + lane * ks;
  const int* clr = cl + lane * ks;
  // MAT: the row's [K, K] fetch matrix, read through L1
  const float* fmr = MAT ? M_g + (long long)row * K * K : nullptr;
  int prev = 0, T_len = 0;
  float M = 0.0f, s_rent = 0.0f, s_svc = 0.0f, s_fetch = 0.0f;
  float lv_prev = 0.0f;           // pin ? lv[prev] : 0, carried slot to slot
  if (live) {
    prev = prev_in[row];
    T_len = Tlen_g[row];
    if constexpr (!MAT) M = M_g[row];
    s_rent = sums_in[row * 3 + 0];
    s_svc = sums_in[row * 3 + 1];
    s_fetch = sums_in[row * 3 + 2];
    lv_prev = prev >= 0 && prev < K ? lvr[prev] : 0.0f;
  }
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kBeStages;
    const int j0 = i * ts, n = min(ts, chunk - j0);
    mbar_wait(&full[s], (uint32_t)((i / kBeStages) & 1));
    if (live) {
      const int* rt = ring + s * sh.stage + lane * ts;
      const float* ct =
          reinterpret_cast<const float*>(ring + s * sh.stage + kRows * ts)
          + lane * ts;
      const int* xt = ring + s * sh.stage + 2 * kRows * ts + lane * ts * xw;
      const int nv = max(0, min(n, T_len - (t0 + j0)));
      // slot j of the row: r_t, c_t, x_t, and the level words at r_t (the
      // level value; Model 1: g, SVC: the slab's word)
      auto price = [&](int r_t, float c_t, int x_t, float lv_w, float sv_w) {
        const bool in = (unsigned)r_t < (unsigned)K;
        const float lv_t = in ? lv_w : 0.0f;
        float sv = sv_w;
        if constexpr (!SVC) sv = (float)x_t * sv_w;
        const float d = fmaxf(lv_t - lv_prev, 0.0f);
        if constexpr ((FMA & 1) != 0)
          s_rent = __fmaf_rn(c_t, lv_t, s_rent);
        else
          s_rent = s_rent + c_t * lv_t;
        if constexpr (MAT) {
          // the matrix's entry (prev, r_t), 0 when either is out of range,
          // as the reference's masked sum of M picks it; no product
          const bool pin = (unsigned)prev < (unsigned)K;
          s_fetch = s_fetch + (in && pin ? __ldg(fmr + prev * K + r_t) : 0.0f);
        } else if constexpr ((FMA & 2) != 0) {
          s_fetch = __fmaf_rn(M, d, s_fetch);
        } else {
          s_fetch = s_fetch + M * d;
        }
        s_svc = s_svc + (in ? sv : 0.0f);
        lv_prev = lv_t;
        prev = r_t;
      };
      auto level_words = [&](int r_t, int j, float& lv_w, float& sv_w) {
        const int ri = (unsigned)r_t < (unsigned)K ? r_t : 0;
        lv_w = lvr[ri];
        if constexpr (SVC)
          sv_w = __int_as_float(xt[j * Kf + clr[ri]]);
        else
          sv_w = gkr[ri];
      };
      // groups of four slots, software-pipelined: group q is priced while
      // the level words of q + 1 and r, c and x of q + 2 are loaded (loads
      // past the valid slots stay inside the row and go unused)
      struct Group {
        int r[4], x[4];
        float c[4], lv[4], sv[4];
      };
      auto load_rcx = [&](int j, Group& G) {
        const int4 r4 = *reinterpret_cast<const int4*>(rt + j);
        const float4 c4 = *reinterpret_cast<const float4*>(ct + j);
        int4 x4 = make_int4(0, 0, 0, 0);
        if constexpr (!SVC) x4 = *reinterpret_cast<const int4*>(xt + j);
        G.r[0] = r4.x, G.r[1] = r4.y, G.r[2] = r4.z, G.r[3] = r4.w;
        G.c[0] = c4.x, G.c[1] = c4.y, G.c[2] = c4.z, G.c[3] = c4.w;
        G.x[0] = x4.x, G.x[1] = x4.y, G.x[2] = x4.z, G.x[3] = x4.w;
      };
      auto load_levels = [&](int j, Group& G) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          level_words(G.r[u], j + u, G.lv[u], G.sv[u]);
      };
      const int jl = ts - 4;                     // the row's last group
      int j = 0;
      if (nv >= 4) {
        Group cur, nxt;
        load_rcx(0, cur);
        load_levels(0, cur);
        load_rcx(min(4, jl), nxt);
#pragma unroll 3
        for (; j + 4 <= nv; j += 4) {
          Group nn;
          load_rcx(min(j + 8, jl), nn);
          load_levels(min(j + 4, jl), nxt);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            price(cur.r[u], cur.c[u], cur.x[u], cur.lv[u], cur.sv[u]);
          cur = nxt;
          nxt = nn;
        }
      }
      for (; j < nv; ++j) {                      // the valid slots' last few
        float lv_w, sv_w;
        level_words(rt[j], j, lv_w, sv_w);
        price(rt[j], ct[j], SVC ? 0 : xt[j], lv_w, sv_w);
      }
      if (nv < n) {                              // masked slots: x + 0
        if constexpr ((FMA & 1) == 0) s_rent = s_rent + 0.0f;
        if constexpr ((FMA & 2) == 0) s_fetch = s_fetch + 0.0f;
        s_svc = s_svc + 0.0f;
      }
    }
    be_release(&empty[s], lane);
  }
  if (live) {
    prev_out[row] = prev;
    sums_out[row * 3 + 0] = s_rent;
    sums_out[row * 3 + 1] = s_svc;
    sums_out[row * 3 + 2] = s_fetch;
  }
}

inline unsigned n_blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// ---------------------------------------------------------------------
// G: joint_slab_kernel<SVC>.  No TPU counterpart: the reference reduces
// the joint multi-service slab with XLA ops in services._joint_fns
// (src/repro/core/services.py:251-270).
//
// Instance b's N services are sub-slab rows b * N + n.  Per slot t and
// joint state j, with the state's level idx[b][n][j] of service n:
//   svc[b][t][j] = 0 + term_0 + term_1 + ... (ascending n, each add
//   rounded), term_n = svc_sub[b*N+n][t][idx] on a Model-2 sub-slab
//   (SVC), and under Model 1 the chain acc = fma(float(x_n), g_lane[b][n]
//   [j], acc) that XLA:CPU makes of the reduce of a product;
//   x[b][t] the int32 sum over n, c and side those of service lane 0;
//   at N = 1 only (the DP's w route: a Model-2 slab, its column map as
//   idx), w[b][t][j] = mask[b][j] ? fma(c, lv[b][j], svc) : +inf, the
//   fused D's assembly, for D on a finished w past 16 levels.
// Any output pointer may be NULL (not written).
//
// Design: the simplest that is right (a first kernel): a thread a (b, t,
// j), j fastest, so the svc / w stores and a slot's K-word sub-slab rows
// are read and written in whole lines; the j == 0 thread writes x, c and
// side.  Bound: bytes (the sub-slabs read once, the joint slab written
// once).
// ---------------------------------------------------------------------

struct JointArgs {
  const int* x;              // [B*N, chunk] (NULL: x_out not written)
  const float* c;            // [B*N, chunk]
  const int* side;           // [B*N, chunk] or NULL
  const float* svc;          // [B*N, chunk, K] (SVC)
  const float* g_lane;       // [B, N, J] (Model 1)
  const int* idx;            // [B, N, J]
  const float* lv;           // [B, J] (w only, N = 1)
  const bool* kmask;         // [B, J] (w only, N = 1)
  int* x_out;                // [B, chunk]
  float* c_out;              // [B, chunk]
  int* side_out;             // [B, chunk]
  float* svc_out;            // [B, chunk, J]
  float* w_out;              // [B, chunk, J] (N = 1)
  int B, N, chunk, K, J;
};

constexpr int kJointThreads = 256;

template <bool SVC>
__global__ void __launch_bounds__(kJointThreads)
    joint_slab_kernel(const JointArgs a) {
  const long long i = (long long)blockIdx.x * kJointThreads + threadIdx.x;
  const long long n_out = (long long)a.B * a.chunk * a.J;
  if (i >= n_out) return;
  const int j = (int)(i % a.J);
  const long long bt = i / a.J;                  // b * chunk + t
  const int t = (int)(bt % a.chunk);
  const int b = (int)(bt / a.chunk);
  const long long row0 = (long long)b * a.N;     // service lane 0
  float acc = 0.0f;
  for (int n = 0; n < a.N; ++n) {
    const long long rt = (row0 + n) * a.chunk + t;
    const long long s = (row0 + n) * a.J + j;   // [b][n][j]
    if constexpr (SVC)
      acc = acc + a.svc[rt * a.K + a.idx[s]];
    else
      acc = __fmaf_rn((float)a.x[rt], a.g_lane[s], acc);
  }
  const long long o = bt * a.J + j;
  if (a.svc_out) a.svc_out[o] = acc;
  if (a.w_out) {                                 // N = 1: row0 == b
    const long long bj = (long long)b * a.J + j;
    a.w_out[o] = a.kmask[bj] ? __fmaf_rn(a.c[bt], a.lv[bj], acc)
                             : __int_as_float(0x7f800000);
  }
  if (j == 0) {
    const long long r0 = row0 * a.chunk + t;
    if (a.x_out) {
      int xs = 0;
      for (int n = 0; n < a.N; ++n) xs += a.x[r0 + (long long)n * a.chunk];
      a.x_out[bt] = xs;
    }
    if (a.c_out) a.c_out[bt] = a.c[r0];
    if (a.side_out) a.side_out[bt] = a.side[r0];
  }
}

constexpr int kMaxDevices = 64;

// a fixed property of the current device (positive), queried by
// query(dev, n) on its first use there and then read from cache, a slot a
// device (0: not yet queried)
template <class Query>
cudaError_t per_device(std::atomic<int> (&cache)[kMaxDevices], int* n,
                       Query query) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices &&
      (*n = cache[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  e = query(dev, n);
  if (e == cudaSuccess && dev < kMaxDevices)
    cache[dev].store(*n, std::memory_order_relaxed);
  return e;
}

// the current device's SM count
inline cudaError_t sm_count(int* n) {
  static std::atomic<int> cache[kMaxDevices];
  return per_device(cache, n, [](int dev, int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
  });
}

// the bulk route needs 16-byte aligned row segments
inline int bulk_ok(const void* c, const void* x, int chunk) {
  return chunk % 4 == 0 && (uintptr_t)c % 16 == 0 && (uintptr_t)x % 16 == 0;
}

template <class Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links no libcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static std::atomic<void*> cached{nullptr};
  void* f = cached.load(std::memory_order_relaxed);
  if (!f) {
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !f) return cudaErrorNotSupported;
    cached.store(f, std::memory_order_relaxed);
  }
  *fn = reinterpret_cast<EncodeTiled>(f);
  return cudaSuccess;
}

// a [rows, width] matrix of 32-bit words (16-byte aligned, width % 4 ==
// 0) seen in boxes of kRows rows x box words (box % 4 == 0, <= 256); a box
// past the matrix's edge reads zeros.  bytes: a matrix of bytes instead
// (width % 16 == 0, box % 16 == 0)
inline cudaError_t row_map(CUtensorMap* map, const void* base, int rows,
                           long long width, int box, bool bytes = false) {
  EncodeTiled fn = nullptr;
  const cudaError_t e = encode_tiled(&fn);
  if (e != cudaSuccess) return e;
  const cuuint64_t dim[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)width * (bytes ? 1 : 4)};
  const cuuint32_t boxd[2] = {(cuuint32_t)box, (cuuint32_t)kRows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map,
            bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_INT32,
            2, const_cast<void*>(base),
            dim, stride, boxd, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// D's and S's producer route: bulk copies when the row segments are
// contiguous and 16-byte aligned (Model 1: c and x; SVC: c and svc, and
// the slab's columns fit a bulk stage)
template <bool SVC, int TILE, int K>
int bulk_route(const void* c, const void* x, const void* svc, int Kf,
               int chunk) {
  return SVC ? Kf <= svc_bulk_cols<TILE, K>() && bulk_ok(c, svc, chunk)
             : bulk_ok(c, x, chunk);
}

// the maps of a producer's route 2 for tiles of `tile` slots: c [R,
// chunk], the second array [R, chunk * w] (x, w = 1; or the slab, w =
// Kf) and the observation slab o [R, chunk] (NULL: none), in boxes of
// kRows rows x tile * w + 4 words, the raw stage's padded rows
inline cudaError_t stage_maps(StageMaps* maps, const void* c, const void* x,
                              const void* o, int R, int chunk, int w,
                              int tile) {
  cudaError_t e = row_map(&maps->m[0], c, R, chunk, tile + 4);
  if (e == cudaSuccess)
    e = row_map(&maps->m[1], x, R, (long long)chunk * w, tile * w + 4);
  if (e == cudaSuccess && o) e = row_map(&maps->m[2], o, R, chunk, tile + 4);
  return e;
}

// the fused D's levels, and its Model-2 slab's, at most (kernels/
// hosting.py: DPF_MAX_K); S takes slabs of up to kM2MaxK
constexpr int kDpfMaxK = 16;

// the inputs of the fused D (x, g: Model 1; svc, cols, Kf: SVC)
struct DpfArgs {
  const void *J, *c, *x, *g, *svc, *cols;
  int Kf;
  const void *lv, *kmask, *fetch, *T_len;
  void *Jout, *args;
  int R, chunk, t0;
};

template <int K, bool ARGS, bool SVC>
int launch_dpf(const DpfArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(DpSmem<K, ARGS, SVC>);
  const cudaError_t e = allow_smem(dp_fwd_kernel<K, ARGS, SVC>, bytes);
  if (e != cudaSuccess) return (int)e;
  // the argmin table goes back by bulk copies when its rows' tile
  // segments are 16-byte aligned; the ARGS route stages by tensor copies
  // (route 2) where the bulk route holds and a row of the slab's tile
  // fits a box
  constexpr int TILE = DpSmem<K, ARGS, SVC>::TILE;
  const int abulk = a.chunk % 4 == 0 && (uintptr_t)a.args % 16 == 0;
  int bulk = bulk_route<SVC, TILE, K>(a.c, a.x, a.svc, a.Kf, a.chunk);
  StageMaps maps = {};
  if (ARGS && bulk && (!SVC || a.Kf * TILE + 4 <= kBeMaxBox)) {
    const cudaError_t me = stage_maps(&maps, a.c, SVC ? a.svc : a.x, nullptr,
                                      a.R, a.chunk, SVC ? a.Kf : 1, TILE);
    if (me != cudaSuccess) return (int)me;
    bulk = 2;
  }
  dp_fwd_kernel<K, ARGS, SVC>
      <<<n_blocks(a.R, kRows), kDpThreads<ARGS>, bytes, st>>>(
          (const float*)a.J, (const float*)a.c, (const int*)a.x,
          (const float*)a.g, (const float*)a.svc, (const int*)a.cols, a.Kf,
          (const float*)a.lv, (const bool*)a.kmask, (const float*)a.fetch,
          (const int*)a.T_len, (float*)a.Jout, (int*)a.args, a.R, a.chunk,
          a.t0, bulk, abulk, maps);
  return (int)cudaGetLastError();
}

// the fused D at a runtime K (1..kDpfMaxK), with or without the argmin
// table
template <bool SVC>
int launch_dpf_any(const DpfArgs& a, int K, cudaStream_t st) {
  if (a.R <= 0) return (int)cudaGetLastError();
#define REPRO_DPF_CASE(KK)                                                    \
  case KK:                                                                    \
    return a.args ? launch_dpf<KK, true, SVC>(a, st)                          \
                  : launch_dpf<KK, false, SVC>(a, st);
  switch (K) {
    REPRO_DPF_CASE(1) REPRO_DPF_CASE(2) REPRO_DPF_CASE(3) REPRO_DPF_CASE(4)
    REPRO_DPF_CASE(5) REPRO_DPF_CASE(6) REPRO_DPF_CASE(7) REPRO_DPF_CASE(8)
    REPRO_DPF_CASE(9) REPRO_DPF_CASE(10) REPRO_DPF_CASE(11)
    REPRO_DPF_CASE(12) REPRO_DPF_CASE(13) REPRO_DPF_CASE(14)
    REPRO_DPF_CASE(15) REPRO_DPF_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DPF_CASE
}

// the inputs of D on a finished w
struct DpmArgs {
  const void *J, *w, *fetch, *valid;
  void *Jout, *args;
  int R, chunk, K;
};

// D on a finished w: tensor copies when chunk % 16 == 0 and w, valid and
// args are 16-byte aligned (w's rows, chunk * K words, then are too), else
// the 4-byte route
template <int KB, int CW>
int launch_dpm(const DpmArgs& a, cudaStream_t st) {
  const DpmLayout L = dpm_layout(a.K, KB, CW);
  const cudaError_t e = allow_smem(dp_minplus_kernel<KB, CW>, L.bytes);
  if (e != cudaSuccess) return (int)e;
  const int tma = a.chunk > 0 && a.chunk % 16 == 0
                  && bulk_ok(a.w, a.valid, a.chunk)
                  && (uintptr_t)a.args % 16 == 0;
  StageMaps maps = {};
  if (tma) {
    cudaError_t me = row_map(&maps.m[0], a.w, a.R,
                             (long long)a.chunk * a.K, L.tile * a.K + 4);
    if (me == cudaSuccess)
      me = row_map(&maps.m[1], a.valid, a.R, a.chunk, L.vs, true);
    if (me != cudaSuccess) return (int)me;
  }
  dp_minplus_kernel<KB, CW><<<n_blocks(a.R, kRows), 32 * (CW + 2), L.bytes,
                              st>>>(
      (const float*)a.J, (const float*)a.w, (const float*)a.fetch,
      (const uint8_t*)a.valid, (float*)a.Jout, (int*)a.args, a.R, a.chunk,
      a.K, tma, maps);
  return (int)cudaGetLastError();
}

template <int K, bool SVC, bool TABLE, bool FEW = false>
int launch_sim(const SimArgs& a, cudaStream_t st) {
  using Sm = SimSmemOf<K, SVC, TABLE, FEW>;
  const size_t bytes = sizeof(Sm);
  const cudaError_t e = allow_smem(sim_kernel<K, SVC, TABLE, FEW>, bytes);
  if (e != cudaSuccess) return (int)e;
  // the bulk routes need the observation slab's rows aligned too; then
  // the table variant takes one 2D tensor copy an array and tile (route
  // 2) where a row of the slab's tile fits a box, else one bulk copy a row
  // and array (route 1)
  constexpr int TILE = Sm::TILE;
  int bulk = FEW ? bulk_ok(a.c, a.svc, a.chunk)   // whole slab rows
                 : bulk_route<SVC, TILE, K>(a.c, a.x, a.svc, a.Kf, a.chunk)
                       && (uintptr_t)a.o % 16 == 0;
  StageMaps maps = {};
  if (TABLE && bulk && (!SVC || a.Kf * TILE + 4 <= kBeMaxBox)) {
    const cudaError_t me = stage_maps(&maps, a.c, SVC ? a.svc : a.x, a.o,
                                      a.R, a.chunk, SVC ? a.Kf : 1, TILE);
    if (me != cudaSuccess) return (int)me;
    bulk = 2;
  }
  sim_kernel<K, SVC, TABLE, FEW>
      <<<n_blocks(a.R, kSimRows<K, FEW>), kSimThreads<TABLE>, bytes, st>>>(
      (const float*)a.plv, (const bool*)a.mask, (const float*)a.pM,
      (const int*)a.pi, (const float*)a.thr, (const float*)a.lv,
      (const float*)a.g, (const float*)a.M, (const int*)a.T_len,
      (const int*)a.r_in, (const float*)a.S_in, (const int*)a.age_in,
      (const float*)a.sums_in, (const int*)a.counts_in, (const int*)a.x,
      (const float*)a.c, (const float*)a.svc, (const int*)a.cols,
      (const int*)a.o, a.obs, a.S, a.t0, a.chunk, a.R, a.Kf,
      a.include_final_fetch, (int*)a.r_out, (float*)a.S_out,
      (int*)a.age_out, (float*)a.sums_out, (int*)a.counts_out,
      (int*)a.r_hist, bulk, maps);
  return (int)cudaGetLastError();
}

// alpha-RR's S on few rows of a wide slab (Kf past kDpfMaxK, 4 <= K <=
// 8) takes the FEW instances when their CTAs of kFewRows rows fit one
// wave, one a SM
template <int K>
int sim_few(const SimArgs& a) {
  int n_sm = 0;
  return K >= 4 && K <= 8 && a.Kf > kDpfMaxK
         && sm_count(&n_sm) == cudaSuccess
         && (long long)n_blocks(a.R, kFewRows) <= n_sm;
}

// S at a runtime K (2..16)
template <bool SVC, bool TABLE>
int launch_sim_any(const SimArgs& a, int K, cudaStream_t st) {
  if (a.R <= 0) return (int)cudaGetLastError();
#define REPRO_SIM_CASE(KK)                                         \
  case KK:                                                         \
    if constexpr (SVC && !TABLE && KK >= 4 && KK <= 8)             \
      if (sim_few<KK>(a)) return launch_sim<KK, SVC, TABLE, true>(a, st); \
    return launch_sim<KK, SVC, TABLE>(a, st);
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
}

// the 16-byte store route needs whole, aligned groups of slots
inline int vec_ok(int chunk, int slots, const void* p0, const void* p1) {
  return chunk % slots == 0 && (uintptr_t)p0 % 16 == 0
         && (uintptr_t)p1 % 16 == 0;
}

// a block: up to 256 threads over one row's slots (fewer for a short chunk)
template <int KIND, bool SALT = false>
int launch_stream(StreamArgs a, cudaStream_t st) {
  const int per_row = (a.chunk + kSlots - 1) / kSlots;
  const int threads = per_row >= 256 ? 256 : (per_row + 31) / 32 * 32;
  a.vec = vec_ok(a.chunk, kSlots, a.out, a.out);
  if (n_blocks(per_row, threads) > 65535) return (int)cudaErrorInvalidValue;
  if (a.R > 0 && a.chunk > 0)
    counter_stream_kernel<KIND, SALT>
        <<<dim3(a.R, n_blocks(per_row, threads)), threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// E's inputs (schedule_kernel's arguments)
struct ScheduleArgs {
  const float *lv, *g, *M;
  const int *T_len, *prev_in;
  const float* sums_in;
  const int *counts_in, *r;
  const float* c;
  const int* x;
  const float* svc;
  const int* cols;
  int* prev_out;
  float* sums_out;
  int* counts_out;
  int R, chunk, K, Kf, t0, ts;
};

template <bool SVC, int FMA, bool BULK, bool MAT>
int launch_sched(const ScheduleArgs& a, const CUtensorMap (&maps)[3],
                 cudaStream_t st) {
  const size_t bytes = sc_smem_bytes(a.ts, a.K, a.Kf, SVC);
  const cudaError_t e =
      allow_smem(schedule_kernel<SVC, FMA, BULK, MAT>, bytes);
  if (e != cudaSuccess) return (int)e;
  constexpr int threads = kScThreads<BULK>;
  schedule_kernel<SVC, FMA, BULK, MAT>
      <<<n_blocks(a.R, kRows), threads, bytes, st>>>(
          a.lv, a.g, a.M, a.T_len, a.prev_in, a.sums_in, a.counts_in, a.r,
          a.c, a.x, a.svc, a.cols, a.prev_out, a.sums_out, a.counts_out, a.R,
          a.chunk, a.K, a.Kf, a.t0, a.ts, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

// E's route: tensor copies when every row of r, c and x (or the slab) is
// 16-byte aligned, else 4-byte cp.async
template <bool SVC, int FMA, bool MAT>
int launch_sched_route(const ScheduleArgs& a, cudaStream_t st) {
  const void* xs = SVC ? (const void*)a.svc : (const void*)a.x;
  const int xw = SVC ? a.Kf : 1;
  CUtensorMap maps[3] = {};                      // unused on the 4-byte route
  if (!bulk_ok(a.r, a.c, a.chunk) || (uintptr_t)xs % 16 != 0)
    return launch_sched<SVC, FMA, false, MAT>(a, maps, st);
  cudaError_t e = row_map(&maps[0], a.r, a.R, a.chunk, a.ts);
  if (e == cudaSuccess) e = row_map(&maps[1], a.c, a.R, a.chunk, a.ts);
  if (e == cudaSuccess)
    e = row_map(&maps[2], xs, a.R, (long long)a.chunk * xw, a.ts * xw);
  if (e != cudaSuccess) return (int)e;
  return launch_sched<SVC, FMA, true, MAT>(a, maps, st);
}

// f(std::integral_constant<int, K>) at a run-time K of 1..kDpfMaxK
template <class F>
int with_k(int K, F f) {
  switch (K) {
#define REPRO_K_CASE(KK) \
  case KK:               \
    return f(std::integral_constant<int, KK>{});
    REPRO_K_CASE(1) REPRO_K_CASE(2) REPRO_K_CASE(3) REPRO_K_CASE(4)
    REPRO_K_CASE(5) REPRO_K_CASE(6) REPRO_K_CASE(7) REPRO_K_CASE(8)
    REPRO_K_CASE(9) REPRO_K_CASE(10) REPRO_K_CASE(11) REPRO_K_CASE(12)
    REPRO_K_CASE(13) REPRO_K_CASE(14) REPRO_K_CASE(15) REPRO_K_CASE(16)
#undef REPRO_K_CASE
    default:
      return -1;
  }
}

// S's table variant at K levels: its tile in slots (what = 0) or its
// cooked stages
template <bool SVC>
int sim_table_shape(int K, int what) {
  return with_k(K, [=](auto k) {
    using Sm = SimSmem<decltype(k)::value, SVC, true>;
    return what ? Sm::NC : Sm::TILE;
  });
}

}  // namespace

// The fused D's Model-2 instances, in a translation unit of their own
// (part 7, beside D on a finished w) when the library builds in parts, so
// that no part holds every instance of the fused D: launch_dp_fwd (part
// 3) hands its Model-2 calls here.  Outside the anonymous namespace, and
// of plain argument types, so that the parts link.
int dp_fwd_model2_part(const void* J, const void* c, const void* x,
                       const void* g, const void* svc, const void* cols,
                       const void* lv, const void* kmask, const void* fetch,
                       const void* T_len, void* Jout, void* args, int R,
                       int chunk, int K, int Kf, int t0, cudaStream_t st);
#if REPRO_IN_PART(7)
int dp_fwd_model2_part(const void* J, const void* c, const void* x,
                       const void* g, const void* svc, const void* cols,
                       const void* lv, const void* kmask, const void* fetch,
                       const void* T_len, void* Jout, void* args, int R,
                       int chunk, int K, int Kf, int t0, cudaStream_t st) {
  const DpfArgs a{J, c, x, g, svc, cols, Kf, lv, kmask, fetch,
                  T_len, Jout, args, R, chunk, t0};
  return launch_dpf_any<true>(a, K, st);
}
#endif

extern "C" {

#if REPRO_IN_PART(0)
// kind: a StreamKind; a / b / flip as StreamArgs (NULL where the kind
// reads none); salt < 0: no salt fold (kUniform only)
int launch_counter_stream(int kind, const void* keys, const void* tids,
                          const void* a, const void* b, const void* flip,
                          void* out, int R, int chunk, int salt,
                          int partitionable, void* stream) {
  const StreamArgs args{(const long long*)keys, (const int*)tids,
                        (const float*)a, (const float*)b, (const bool*)flip,
                        out, R, chunk, salt, partitionable, 0, 1u};
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case kUniform:
      return salt >= 0 ? launch_stream<kUniform, true>(args, st)
                       : launch_stream<kUniform>(args, st);
    case kBernoulli: return launch_stream<kBernoulli>(args, st);
    case kUniformRents: return launch_stream<kUniformRents>(args, st);
    case kNaRents: return launch_stream<kNaRents>(args, st);
    case kNormal: return launch_stream<kNormal>(args, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

#if REPRO_IN_PART(0)
// uniform(key, (n,)) of one [2] key in the given layout (n < 2**31)
int launch_shaped_uniform(const void* key, void* out, int n,
                          int partitionable, void* stream) {
  const ShapedArgs args{(const long long*)key, (float*)out, n, partitionable,
                        1u};
  const long long blocks = partitionable ? n : (n + 1LL) / 2;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    shaped_uniform_kernel<<<n_blocks(blocks, 256), 256, 0,
                            (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
#endif

#if REPRO_IN_PART(0)
int launch_ge_chain(const void* keys, const void* tids, const void* s_in,
                    const void* p_hl, const void* p_lh, const void* rate_h,
                    const void* rate_l, void* s_out, void* states, void* x,
                    int R, int chunk, int partitionable, void* stream) {
  GeArgs args{(const long long*)keys, (const int*)tids, (const int*)s_in,
              (const float*)p_hl, (const float*)p_lh, (const float*)rate_h,
              (const float*)rate_l, (int*)s_out, (int*)states, (int*)x,
              R, chunk, partitionable, 0, 1u};
  if (R <= 0) return (int)cudaGetLastError();
  args.vec = vec_ok(chunk, kSlots, states, x);
  if (x)
    ge_chain_kernel<true><<<n_blocks(R, kGeWarps), 32 * kGeWarps, 0,
                            (cudaStream_t)stream>>>(args);
  else
    ge_chain_kernel<false><<<n_blocks(R, kGeWarps), 32 * kGeWarps, 0,
                             (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
#endif

#if REPRO_IN_PART(1)
// the ARMA rents of one chunk (1 <= P <= 8, 1 <= Q <= 8)
int launch_arma_rents(const void* keys, const void* tids, const void* hist_in,
                      const void* eps_in, const void* phi, const void* th,
                      const void* sigma, const void* mean, const void* c_min,
                      const void* c_max, void* hist_out, void* eps_out,
                      void* c, int R, int chunk, int P, int Q,
                      int partitionable, void* stream) {
  if (P < 1 || P > kArmaMaxP || Q < 1 || Q > kArmaMaxQ || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  int n_sm = 0;
  const cudaError_t e = sm_count(&n_sm);
  if (e != cudaSuccess) return (int)e;
  const ArmaArgs args{(const long long*)keys, (const int*)tids,
                      (const float*)hist_in, (const float*)eps_in,
                      (const float*)phi, (const float*)th,
                      (const float*)sigma, (const float*)mean,
                      (const float*)c_min, (const float*)c_max,
                      (float*)hist_out, (float*)eps_out, (float*)c, R, chunk,
                      P, Q, partitionable, vec_ok(chunk, 4, c, c), 1u};
  // 32 rows a block once the slab gives nearly every SM such a block
  // (R = 4,096 on 132 SMs: 128 blocks); else 8, which spreads a small
  // slab's draws over more SMs
  const bool wide = R >= (kArmaWideRows - 2) * n_sm;
  constexpr int W = kArmaWideRows, N = kArmaNarrowRows;
  const dim3 grid(n_blocks(R, wide ? W : N));
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ARMA_ROWS(PP, MA)                                            \
  if (wide)                                                                \
    arma_rents_kernel<PP, MA, W>                                           \
        <<<grid, ArmaShape<W>::kThreads, 0, st>>>(args);                   \
  else                                                                     \
    arma_rents_kernel<PP, MA, N>                                           \
        <<<grid, ArmaShape<N>::kThreads, 0, st>>>(args);
#define REPRO_ARMA_CASE(PP)                                                \
  case PP:                                                                 \
    if (R == 1) {                                                          \
      if (Q == 1)                                                          \
        arma_rents_kernel<PP, kMa1Chain, N>                                \
            <<<grid, ArmaShape<N>::kThreads, 0, st>>>(args);               \
      else                                                                 \
        arma_rents_kernel<PP, kDotChain, N>                                \
            <<<grid, ArmaShape<N>::kThreads, 0, st>>>(args);               \
    } else if (Q == 1) {                                                   \
      REPRO_ARMA_ROWS(PP, kMa1Sum)                                         \
    } else if (Q == 2) {                                                   \
      REPRO_ARMA_ROWS(PP, kDotFma2)                                        \
    } else {                                                               \
      REPRO_ARMA_ROWS(PP, kDotSum)                                         \
    }                                                                      \
    break;
  switch (P) {
    REPRO_ARMA_CASE(1) REPRO_ARMA_CASE(2) REPRO_ARMA_CASE(3)
    REPRO_ARMA_CASE(4) REPRO_ARMA_CASE(5) REPRO_ARMA_CASE(6)
    REPRO_ARMA_CASE(7) REPRO_ARMA_CASE(8)
  }
#undef REPRO_ARMA_CASE
#undef REPRO_ARMA_ROWS
  return (int)cudaGetLastError();
}
#endif

#if REPRO_IN_PART(7)
int launch_dp_minplus(const void* J, const void* wck, const void* fetch,
                      const void* valid, void* Jout, void* args, int R,
                      int chunk, int K, void* stream) {
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  const DpmArgs a{J, wck, fetch, valid, Jout, args, R, chunk, K};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K <= 8 ? K : 6 + (K + 3) / 4) {       // K itself, or its band
    case 1: return launch_dpm<1, 1>(a, st);
    case 2: return launch_dpm<2, 1>(a, st);
    case 3: return launch_dpm<3, 1>(a, st);
    case 4: return launch_dpm<4, 1>(a, st);
    case 5: return launch_dpm<5, 1>(a, st);
    case 6: return launch_dpm<6, 1>(a, st);
    case 7: return launch_dpm<7, 1>(a, st);
    case 8: return launch_dpm<8, 1>(a, st);
    case 9: return launch_dpm<12, 3>(a, st);
    case 10: return launch_dpm<16, 4>(a, st);
    case 11: return launch_dpm<20, 5>(a, st);
    case 12: return launch_dpm<24, 6>(a, st);
    case 13: return launch_dpm<28, 7>(a, st);
    default: return launch_dpm<32, 8>(a, st);
  }
}
#endif

#if REPRO_IN_PART(0)
// D on a finished w at K levels: its tile in slots (-1 past 1..32)
int dp_minplus_tile_slots(int K) { return K < 1 || K > 32 ? -1 : dpm_tile(K); }
#endif

#if REPRO_IN_PART(6)
// B: one chunk's argmin table [R, chunk, K] (1 <= K <= 32) walked back
// from k_in [R]; k_out [R] the level at the chunk's entry, r [R, chunk]
int launch_dp_backtrack(const void* k_in, const void* args, void* k_out,
                        void* r, int R, int chunk, int K, void* stream) {
  if (K < 1 || K > 32 || chunk < 1) return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  const int ts = be_tile(K, chunk, 0);
  const size_t bytes = bt_smem_bytes(ts, K);
  const bool bulk = bulk_ok(args, r, chunk);
  void (*kern)(const int*, const int*, int*, int*, int, int, int, int) =
      bulk ? dp_backtrack_kernel<true> : dp_backtrack_kernel<false>;
  const cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  const int threads = bulk ? kBtThreads<true> : kBtThreads<false>;
  kern<<<n_blocks(R, kRows), threads, bytes, (cudaStream_t)stream>>>(
      (const int*)k_in, (const int*)args, (int*)k_out, (int*)r, R, chunk, K,
      ts);
  return (int)cudaGetLastError();
}
#endif

#if REPRO_IN_PART(6)
// E: given schedules r [R, chunk] priced over one chunk (1 <= K <= 32),
// under Model 1 (x, g; svc and cols NULL) or on a Model-2 slab svc [R,
// chunk, Kf] (1 <= Kf <= 32; x and g NULL) with cols [R, K] (NULL: the
// identity, Kf == K); fma: bit 0 fuses the rent's multiply-add, bit 1
// the fetch's; mat: M is [R, K, K] explicit fetch matrices (the joint
// multi-service grids; the fetch has no product, so fma <= 1)
int launch_schedule(const void* lv, const void* g, const void* M,
                    const void* T_len, const void* prev_in,
                    const void* sums_in, const void* counts_in,
                    const void* r, const void* c, const void* x,
                    const void* svc, const void* cols, void* prev_out,
                    void* sums_out, void* counts_out, int R, int chunk,
                    int K, int Kf, int t0, int fma, int mat, void* stream) {
  if (K < 1 || K > 32 || chunk < 1 || fma < 0 || fma > (mat ? 1 : 3)
      || (svc && (Kf < 1 || Kf > 32)) || (!svc && (!x || !g)))
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  const ScheduleArgs a{(const float*)lv, (const float*)g, (const float*)M,
                       (const int*)T_len, (const int*)prev_in,
                       (const float*)sums_in, (const int*)counts_in,
                       (const int*)r, (const float*)c, (const int*)x,
                       (const float*)svc, (const int*)cols, (int*)prev_out,
                       (float*)sums_out, (int*)counts_out, R, chunk, K,
                       svc ? Kf : K, t0,
                       svc ? be_tile(2 + Kf, chunk, Kf)
                           : be_tile(3, chunk, 1)};
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_SCHED_CASE(FF, MM)                                            \
  case 4 * MM + FF:                                                         \
    return svc ? launch_sched_route<true, FF, MM>(a, st)                    \
               : launch_sched_route<false, FF, MM>(a, st);
  switch (4 * (mat != 0) + fma) {
    REPRO_SCHED_CASE(0, false) REPRO_SCHED_CASE(1, false)
    REPRO_SCHED_CASE(2, false) REPRO_SCHED_CASE(3, false)
    REPRO_SCHED_CASE(0, true) REPRO_SCHED_CASE(1, true)
  }
#undef REPRO_SCHED_CASE
  return (int)cudaErrorInvalidValue;
}
#endif

#if REPRO_IN_PART(6)
// G: the joint slab of B instances' N sub-slab rows each (svc [B*N,
// chunk, K], 1 <= K <= kM2MaxK; or, svc NULL, Model 1's x and g_lane [B,
// N, J]), 1 <= J <= 32; an output NULL is not written (w needs N = 1,
// a Model-2 slab, lv and kmask)
int launch_joint_slab(const void* x, const void* c, const void* side,
                      const void* svc, const void* g_lane, const void* idx,
                      const void* lv, const void* kmask, void* x_out,
                      void* c_out, void* side_out, void* svc_out,
                      void* w_out, int B, int N, int chunk, int K, int J,
                      void* stream) {
  if (J < 1 || J > 32 || N < 1 || chunk < 1 || !c || !idx
      || (svc && (K < 1 || K > kM2MaxK)) || (!svc && (!x || !g_lane))
      || (x_out && !x) || (side_out && !side)
      || (w_out && (N != 1 || !svc || !lv || !kmask)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const JointArgs a{(const int*)x,    (const float*)c,     (const int*)side,
                    (const float*)svc, (const float*)g_lane,
                    (const int*)idx,  (const float*)lv,    (const bool*)kmask,
                    (int*)x_out,      (float*)c_out,       (int*)side_out,
                    (float*)svc_out,  (float*)w_out,       B, N, chunk, K, J};
  const unsigned blocks = n_blocks((long long)B * chunk * J, kJointThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (svc)
    joint_slab_kernel<true><<<blocks, kJointThreads, 0, st>>>(a);
  else
    joint_slab_kernel<false><<<blocks, kJointThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
#endif

#if REPRO_IN_PART(0)
// B's and E's layout, for the checks that pick their edge shapes: the
// slots of a tile (be_tile's words and box), the tiles in the ring, and
// a stage row's words for `words` words of payload (B's rows)
int be_tile_slots(int words, int chunk, int box) {
  return be_tile(words, chunk, box);
}
#endif
#if REPRO_IN_PART(0)
int be_ring_stages() { return kBeStages; }
#endif
#if REPRO_IN_PART(0)
int be_row_stride(int words) { return be_stride(words); }
#endif

#if REPRO_IN_PART(0)
// S's table variant's and D's layout at K levels (1..16; -1 past them),
// for the checks that pick their edge shapes: the table variant's tile in
// slots and its cooked stages (under Model 1 or on a Model-2 slab), D's
// tile and the argmin table's stages on its ARGS route
int sim_tile_slots(int K, int svc) {
  return svc ? sim_table_shape<true>(K, 0) : sim_table_shape<false>(K, 0);
}
#endif
#if REPRO_IN_PART(0)
int sim_ring_stages(int K, int svc) {
  return svc ? sim_table_shape<true>(K, 1) : sim_table_shape<false>(K, 1);
}
#endif
#if REPRO_IN_PART(0)
int dp_tile_slots(int K) {
  return with_k(K, [](auto k) {
    return DpSmem<decltype(k)::value, true, false>::TILE;
  });
}
#endif
#if REPRO_IN_PART(0)
int dp_args_stages(int K, int svc) {
  return with_k(K, [=](auto k) {
    constexpr int KK = decltype(k)::value;
    return svc ? DpSmem<KK, true, true>::NA : DpSmem<KK, true, false>::NA;
  });
}
#endif

#if REPRO_IN_PART(3)
// the fused D under Model 1 (x, g; svc and cols NULL) or on a Model-2
// service slab svc [R, chunk, Kf] (x and g NULL) with cols [R, K] (NULL:
// the identity, Kf == K); args may be NULL: the argmin table is then not
// written at all
int launch_dp_fwd(const void* J, const void* c, const void* x, const void* g,
                  const void* svc, const void* cols, const void* lv,
                  const void* kmask, const void* fetch, const void* T_len,
                  void* Jout, void* args, int R, int chunk, int K, int Kf,
                  int t0, void* stream) {
  if (Kf < 1 || Kf > kDpfMaxK) return (int)cudaErrorInvalidValue;
  if (svc)
    return dp_fwd_model2_part(J, c, x, g, svc, cols, lv, kmask, fetch, T_len,
                              Jout, args, R, chunk, K, Kf, t0,
                              (cudaStream_t)stream);
  const DpfArgs a{J, c, x, g, svc, cols, Kf, lv, kmask, fetch,
                  T_len, Jout, args, R, chunk, t0};
  return launch_dpf_any<false>(a, K, (cudaStream_t)stream);
}
#endif

#if REPRO_IN_PART(4)
// S under Model 1 (x, g; svc and cols NULL) or on a Model-2 service slab
// svc [R, chunk, Kf] (x and g NULL) with cols [R, K] (NULL: the identity,
// Kf == K); r_hist may be NULL
int launch_sim_alpha_rr(const void* plv, const void* mask, const void* pM,
                        const void* lv, const void* g, const void* M,
                        const void* T_len, const void* r_in,
                        const void* S_in, const void* age_in,
                        const void* sums_in, const void* counts_in,
                        const void* x, const void* c, const void* svc,
                        const void* cols, int t0, int chunk, int R, int K,
                        int Kf, int include_final_fetch, void* r_out,
                        void* S_out, void* age_out, void* sums_out,
                        void* counts_out, void* r_hist, void* stream) {
  if (Kf < 1 || Kf > kM2MaxK) return (int)cudaErrorInvalidValue;
  const SimArgs a{plv,     mask,    pM,      nullptr, nullptr, lv,
                  g,       M,       T_len,   r_in,    S_in,    age_in,
                  sums_in, counts_in, x,     c,       svc,     cols,
                  nullptr, kObsNone, 1,      t0,      chunk,   R,
                  Kf,      include_final_fetch, r_out, S_out,  age_out,
                  sums_out, counts_out, r_hist};
  return svc ? launch_sim_any<true, false>(a, K, (cudaStream_t)stream)
             : launch_sim_any<false, false>(a, K, (cudaStream_t)stream);
}
#endif

#if REPRO_IN_PART(5)
// S's table variant: pi [R, S, K] int32 (1 <= S <= 2), thr [R] (ABC,
// else NULL), obs the observation kind (kObsNone / kObsSide / kObsX);
// under Model 1 (x, g; svc and cols NULL) or on a Model-2 slab svc [R,
// chunk, Kf] (x and g NULL) with cols [R, K] (NULL: the identity); o [R,
// chunk] the observation slab (the side channel; the arrivals on a
// Model-2 slab; NULL otherwise); r_hist may be NULL
int launch_sim_table(const void* pi, const void* thr, const void* lv,
                     const void* g, const void* M, const void* T_len,
                     const void* r_in, const void* sums_in,
                     const void* counts_in, const void* x, const void* c,
                     const void* o, const void* svc, const void* cols,
                     int obs, int S, int t0, int chunk, int R, int K, int Kf,
                     int include_final_fetch, void* r_out, void* sums_out,
                     void* counts_out, void* r_hist, void* stream) {
  if (Kf < 1 || Kf > kM2MaxK || S < 1 || S > kTableMaxS || obs < kObsNone
      || obs > kObsX || (obs == kObsSide && !o) || (obs == kObsX && !thr)
      || (svc && obs == kObsX && !o) || (!svc && (!x || !g)))
    return (int)cudaErrorInvalidValue;
  const SimArgs a{nullptr, nullptr, nullptr, pi,     thr,     lv,
                  g,       M,       T_len,   r_in,   nullptr, nullptr,
                  sums_in, counts_in, x,     c,      svc,     cols,
                  o,       obs,     S,       t0,     chunk,   R,
                  Kf,      include_final_fetch, r_out, nullptr, nullptr,
                  sums_out, counts_out, r_hist};
  return svc ? launch_sim_any<true, true>(a, K, (cudaStream_t)stream)
             : launch_sim_any<false, true>(a, K, (cudaStream_t)stream);
}
#endif

#if REPRO_IN_PART(2)
// jax.random.poisson (Knuth below rate 10, Hormann at and above) a (row,
// slot); salt < 0: no salt fold; states / lam_h NULL: the per-row rate
// lam; work: three words of device memory, the ticket counter and the
// launch's Hormann flag (both zeroed here, on the stream, so launches that
// share them on one stream run one after another), then the count of the
// launches that ran a Hormann item (kept)
int launch_poisson(const void* keys, const void* tids, const void* lam,
                   const void* lam_h, const void* states, void* out,
                   void* work, int R, int chunk, int salt, int partitionable,
                   void* stream) {
  if (R <= 0 || chunk <= 0) return (int)cudaGetLastError();
  // the instance, by (STATES, SALT), and the blocks of one wave of it (what
  // the device's SMs hold), queried once a device and instance
  static void (*const kerns[4])(PoissonArgs) = {
      poisson_kernel<false, false>, poisson_kernel<true, false>,
      poisson_kernel<false, true>, poisson_kernel<true, true>};
  static std::atomic<int> waves[4][kMaxDevices];
  const int variant = 2 * (states != nullptr) + (salt >= 0);
  void (*const kern)(PoissonArgs) = kerns[variant];
  int wave_blocks = 0;
  cudaError_t e = per_device(waves[variant], &wave_blocks,
                             [kern](int dev, int* v) {
    int n_sm = 0, per_sm = 0;
    cudaError_t q =
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (q == cudaSuccess)
      q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        32 * kPoisWarps, 0);
    *v = n_sm * std::max(per_sm, 1);
    return q;
  });
  if (e != cudaSuccess) return (int)e;
  // one wave of blocks; the longest ticket that still gives each of its
  // warps two (down to 32 slots), and no more blocks than take a ticket
  const long long wave = wave_blocks;
  int span = kPoisSpan;
  while (span > 32 && (long long)R * ((chunk + span - 1) / span)
                          < 2 * wave * kPoisWarps)
    span /= 2;
  const int spr = (chunk + span - 1) / span;
  const long long n_spans = (long long)R * spr;
  if (n_spans >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks =
      std::min(wave, (n_spans + kPoisWarps - 1) / kPoisWarps);
  const PoissonArgs a{(const long long*)keys, (const int*)tids,
                      (const float*)lam, (const float*)lam_h,
                      (const int*)states, (int*)out, (unsigned*)work, R,
                      chunk, salt, partitionable, span, spr, n_spans, 1u};
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(work, 0, 2 * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)blocks, 32 * kPoisWarps, 0, st>>>(a);
  return (int)cudaGetLastError();
}
#endif

#if REPRO_IN_PART(2)
// the Model-2 service costs of one chunk (1 <= K <= kM2MaxK, 0 <= n_max
// <= 2^23)
int launch_model2_service(const void* keys, const void* tids, const void* x,
                          const void* g, void* out, int R, int chunk, int K,
                          int n_max, int partitionable, void* stream) {
  if (K < 1 || K > kM2MaxK || n_max < 0 || n_max > kM2MaxRequests)
    return (int)cudaErrorInvalidValue;
  if (R <= 0 || chunk <= 0) return (int)cudaGetLastError();
  int n_sm = 0;
  cudaError_t e = sm_count(&n_sm);
  if (e != cudaSuccess) return (int)e;
  // the instance: one a K up to kM2StaticMaxK, else the band of run-time
  // K with its spans in dynamic shared memory sized for K
  using M2Kernel = void (*)(Model2Args);
  static const M2Kernel bands[kM2MaxK / kM2BandStep] = {
      model2_service_kernel<kM2BandStep>,
      model2_service_kernel<2 * kM2BandStep>,
      model2_service_kernel<3 * kM2BandStep>,
      model2_service_kernel<4 * kM2BandStep>};
  M2Kernel kern = nullptr;
  int smem = 0;
  if (K > kM2StaticMaxK) {
    const int band = (K - 1) / kM2BandStep;
    kern = bands[band];
    smem = kM2Warps * m2_band_bytes(K);
    // the band's ceiling: the spans of its largest K
    e = allow_smem(kern, kM2Warps * m2_band_bytes((band + 1) * kM2BandStep));
    if (e != cudaSuccess) return (int)e;
  }
  // the longest span that still gives each SM 32 warps, or as many as it
  // holds of a band at K (down to 32 slots)
  long long sm_warps = 32;
  if (kern) {
    static std::atomic<int> held[kM2MaxK + 1][kMaxDevices];
    int per_sm = 0;
    e = per_device(held[K], &per_sm, [kern, smem](int, int* v) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          v, kern, 32 * kM2Warps, smem);
    });
    if (e != cudaSuccess) return (int)e;
    sm_warps = std::min(sm_warps, (long long)std::max(per_sm, 1) * kM2Warps);
  }
  int span = kM2Span;
  while (span > 32 && (long long)R * ((chunk + span - 1) / span)
                          < sm_warps * n_sm)
    span /= 2;
  const int spr = (chunk + span - 1) / span;
  const long long n_spans = (long long)R * spr;
  const long long blocks = (n_spans + kM2Warps - 1) / kM2Warps;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int vec = chunk % 4 == 0 && (uintptr_t)x % 16 == 0
                  && (uintptr_t)tids % 16 == 0 && (uintptr_t)out % 16 == 0;
  const Model2Args a{(const long long*)keys, (const int*)tids, (const int*)x,
                     (const float*)g, (float*)out, R, chunk, n_max,
                     partitionable, K, span, spr, n_spans, vec, 1u};
  cudaStream_t st = (cudaStream_t)stream;
  if (kern) {
    kern<<<(unsigned)blocks, 32 * kM2Warps, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
#define REPRO_M2_CASE(KK)                                           \
  case KK:                                                          \
    model2_service_kernel<KK>                                       \
        <<<(unsigned)blocks, 32 * kM2Warps, 0, st>>>(a);            \
    break;
  static_assert(kM2StaticMaxK == 5, "one case a static K");
  switch (K) {
    REPRO_M2_CASE(1) REPRO_M2_CASE(2) REPRO_M2_CASE(3) REPRO_M2_CASE(4)
    REPRO_M2_CASE(5)
  }
#undef REPRO_M2_CASE
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
