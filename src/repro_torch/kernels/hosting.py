"""The hosting engine's CUDA kernels, their wrappers and their plain
PyTorch versions.

* Kernel **P**, the port of the Pallas kernel
  ``repro/kernels/hosting.py:slot_uniform_tc`` together with what the
  reference's streams do with its draws: one launch draws and finishes a
  stream's chunk.  ``slot_uniform`` (U(0,1) draws),
  ``bernoulli_arrivals_chunk``, ``uniform_rents_chunk`` and
  ``na_rents_chunk`` (the rents' ``lo + u * (hi - lo)`` one FMA, as
  XLA:CPU fuses it; no float64) run ``counter_stream_kernel``;
  ``ge_bernoulli_chunk`` runs ``ge_chain_kernel`` (the Gilbert-Elliot
  chain as a warp scan of its 2-state maps, with the Bernoulli
  emissions); ``normal_chunk`` (scaled normals, XLA's float32 ``erf_inv``
  transcribed op for op) runs ``counter_stream_kernel`` too, and
  ``arma_rents_chunk`` runs ``arma_rents_kernel`` (the ARMA rents: the
  normals drawn slot-parallel, each row's recursion walked by one thread);
  ``shaped_uniform`` (``jax.random.uniform(key, (n,))`` of one key: the
  draws of ``jax.random.choice`` and of ``model2_service_matrix``) runs
  ``shaped_uniform_kernel``;
  ``poisson_chunk`` (``jax.random.poisson``, Knuth's branch below rate 10
  and Hormann's rejection at and above it, at a per-row rate or the GE
  states' per-slot rates) runs ``poisson_kernel`` and
  ``model2_service_chunk`` (the Model-2 service costs of the live
  requests' coupled uniforms, the requests spread over a warp's lanes)
  ``model2_service_kernel``.
* ``dp_fwd_model1`` (kernel **D**) — one chunk of the offline-OPT
  min-plus recursion with the Model-1 cost assembly ``w = fma(c, lv, x *
  g)`` fused in: the fleet DP's chunk, the port of
  ``repro/kernels/hosting.py:dp_minplus_kc`` and of the assembly before it.
* ``dp_fwd_model2`` (kernel D on a Model-2 service slab) -- the same
  chunk with ``w = fma(c, lv, svc)``, ``svc`` the slab's columns of the
  row's levels (``svc_cols``).
* ``dp_minplus`` (kernel D on a finished ``w``) — the same recursion for
  callers that assemble ``w`` themselves (``offline_opt_batch``) and for K
  up to 32.
* ``dp_backtrack`` (kernel **B**) -- a chunk's argmin table walked back
  from the levels at its end: the backtracked OPT schedule.
* ``schedule_chunk`` (kernel **E**) -- given schedules priced over one
  chunk, fetches charged on entry, under Model 1 or on a Model-2 slab.
* ``sim_chunk_alpha_rr`` (kernel **S**) — one chunk of the per-slot
  alpha-RR simulation, the reference's ``lax.scan`` of
  ``simulator.sim_chunk_core`` over ``alpha_rr_step`` fused into one pass;
  ``sim_chunk_alpha_rr_svc`` the same on a Model-2 service slab;
  ``sim_chunk_table`` / ``sim_chunk_table_svc`` (S's table variant) the
  same chunk stepping a decision table (a lookup a slot; the static, MDP
  and ABC policies in their ``policies.baselines.table_form``) under
  Model 1 / on a Model-2 slab.

Every wrapper follows the same rules: it takes the plain version *only*
for tensors on the CPU; for CUDA tensors it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch was refused, and adds
one to its ``launches`` counter.  There is no fallback from a CUDA tensor
to the plain version.  The kernels (``csrc/hosting.cu``) are built at the
first CUDA call (``_build.py``).

threefry2x32 here works on int64 tensors holding 32-bit words masked with
``& 0xFFFFFFFF`` (torch on the CPU has no uint32 ``+``, ``<<`` or ``>>``).
jax has two layouts for turning a key into random bits, selected by its
``jax_threefry_partitionable`` flag; the port implements both behind
``threefry_partitionable(flag)`` and defaults to jax 0.9's default
(partitionable).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import _build

MASK32 = 0xFFFFFFFF
_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: the largest level count S and the fused D take (a template argument
#: each); D on a finished w takes up to ``DP_MAX_K``
SIM_MAX_K = 16
#: the fused D's levels and its Model-2 slab's (hosting.cu: kDpfMaxK); a
#: Model-2 slab of more levels is wide, and the svc wrappers'
#: ``wide_launches`` count their launches on one
DPF_MAX_K = 16
#: the levels of a Model-2 service slab on the card: P's service draws
#: and the slab that S's svc variants read (hosting.cu: kM2MaxK)
M2_MAX_K = 32
#: model2_service_chunk's n_max at most on the card (hosting.cu:
#: kM2MaxRequests): a span's requests fit an int32, a count a float32
M2_MAX_REQUESTS = 2 ** 23
#: the levels of D on a finished w (``dp_minplus``): an instance a K up to
#: 8, bands of a run-time K above (hosting.cu: dp_minplus_kernel<KB, CW>)
DP_MAX_K = 32


def misaligned(t):
    """A contiguous copy of ``t`` whose storage starts one word past a
    16-byte boundary: on it B and E take their 4-byte cp.async route (the
    card's checks time and hold that route on data that would take the
    bulk one)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    skip = (1 - buf.data_ptr() // t.element_size()) % 4
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    if out.data_ptr() % 16 == 0 or not out.is_contiguous():
        raise RuntimeError("the misaligned copy is aligned")
    return out


# ----------------------------------------------------------------------
# threefry2x32 (plain, int64 words) and the layout flag.
# ----------------------------------------------------------------------

# layout stack; the top is current.  Mirrors jax's context manager of the
# same name, which the tests open beside this one.
_PARTITIONABLE = [True]


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """Draw random bits (and split keys) in jax's partitionable layout
    (``True``, jax 0.9's default) or its original one (``False``)."""
    _PARTITIONABLE.append(bool(flag))
    try:
        yield
    finally:
        _PARTITIONABLE.pop()


def is_partitionable() -> bool:
    """The threefry layout currently in force."""
    return _PARTITIONABLE[-1]


def threefry2x32(k0, k1, x0, x1):
    """One threefry2x32 block: hash counter words ``(x0, x1)`` under key
    ``(k0, k1)``.  Broadcastable int64 tensors of 32-bit words; returns the
    pair of output words.  jax's hash: 20 rounds, 5 key injections."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for r in range(5):
        for rot in _ROTS[r % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << rot) & MASK32) | (x1 >> (32 - rot))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(r + 1) % 3]) & MASK32
        x1 = (x1 + ks[(r + 2) % 3] + (r + 1)) & MASK32
    return x0, x1


def threefry_fold(k0, k1, d):
    """``jax.random.fold_in((k0, k1), d)`` on int64 words: the fold data is
    the counter ``(0, d)``; the output pair is the folded key."""
    return threefry2x32(k0, k1, torch.zeros_like(d), d)


def uniform_from_bits(bits):
    """jax's uint32 -> U(0,1) float32 mapping: the top 23 bits spliced into
    a float in [1, 2), minus 1, clamped at 0 as ``jax.random.uniform``
    does (a no-op on these values, kept op for op)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)   # < 2**31: exact
    u = fb.view(torch.float32) - 1.0
    return torch.clamp_min(u, 0.0)


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once (a fused multiply-add), exactly,
    on any device: the float64 product of two float32s is exact, the
    float64 sum is fixed up to round-to-odd (TwoSum error term), and one
    rounding to float32 then gives the correctly rounded result.  The
    reference's XLA:CPU build contracts ``a * b + c`` into an FMA where a
    product feeds an add (see the call sites); the kernels use
    ``__fmaf_rn`` at the same places.  ``card_calls`` counts its calls on
    the card, where only plain versions call it."""
    a = torch.as_tensor(a)
    a, b, c = (t.to(torch.float64) for t in torch.broadcast_tensors(
        a, torch.as_tensor(b, device=a.device),
        torch.as_tensor(c, device=a.device)))
    if a.is_cuda:
        fma32.card_calls += 1
    p = a * b
    s = p + c
    bp = s - c
    e = (p - bp) + (c - (s - bp))                    # s + e == p + c
    even = (s.view(torch.int64) & 1) == 0
    inexact = (e != 0) & torch.isfinite(e)           # inf operands: exact
    s = torch.where(inexact & even, torch.nextafter(s, s + e), s)
    return s.to(torch.float32)


fma32.card_calls = 0


# ----------------------------------------------------------------------
# P: the counter-keyed stream kernels.
# ----------------------------------------------------------------------

# the kernel's StreamKind (csrc/hosting.cu)
_UNIFORM, _BERNOULLI, _UNIFORM_RENTS, _NA_RENTS, _NORMAL = range(5)


def _layout(partitionable) -> bool:
    return is_partitionable() if partitionable is None else partitionable


def _slot_keys(keys, tids, salt):
    """The [R, chunk] key words ``fold_in(keys[i], tids[j])`` (then
    ``fold_in(., salt)`` when a salt is given)."""
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    t = (tids.to(torch.int64) & MASK32)[None, :]
    a0, a1 = threefry_fold(k0, k1, t)
    if salt is not None:
        a0, a1 = threefry_fold(a0, a1, torch.full_like(a0, int(salt) & MASK32))
    return a0, a1


def _bits32(k0, k1, part: bool):
    """jax's scalar 32-bit draw under the key words ``(k0, k1)``: the bits
    block (counter (0, 0)) and the layout's word."""
    z = torch.zeros_like(k0)
    b0, b1 = threefry2x32(k0, k1, z, z)
    return b0 ^ b1 if part else b0


def _slot_bits(keys, tids, salt, partitionable):
    """[R, chunk] int64: jax's scalar 32-bit draw under ``fold_in(keys[i],
    tids[j])`` (then ``fold_in(., salt)`` when a salt is given), in the
    current (or the given) threefry layout."""
    return _bits32(*_slot_keys(keys, tids, salt), _layout(partitionable))


def slot_uniform_plain(keys, tids, salt: Optional[int] = None,
                       partitionable: Optional[bool] = None):
    """Plain version of kernel P's uniforms: ``[R, chunk]`` float32 U(0,1)
    draws, ``u[i, j]`` from ``fold_in(keys[i], tids[j])`` (then ``fold_in(.,
    salt)`` when a salt is given) and jax's scalar 32-bit draw under the
    current (or the given) threefry layout."""
    return uniform_from_bits(_slot_bits(keys, tids, salt, partitionable))


def _flipped(u, flip):
    return torch.where(flip[:, None], 1.0 - u, u)


def bernoulli_arrivals_chunk_plain(keys, tids, p, flip,
                                   partitionable: Optional[bool] = None):
    """Plain version of kernel P's Bernoulli arrivals: ``[R, chunk]`` int32
    ``x = (flip ? 1 - u : u) < p`` over ``slot_uniform_plain``'s draws;
    ``p`` [R] float32, ``flip`` [R] bool."""
    u = _flipped(slot_uniform_plain(keys, tids, None, partitionable), flip)
    return (u < p[:, None]).to(torch.int32)


def uniform_rents_chunk_plain(keys, tids, lo, hi, flip,
                              partitionable: Optional[bool] = None):
    """Plain version of kernel P's uniform rents: ``[R, chunk]`` float32
    ``fma(flip ? 1 - u : u, hi - lo, lo)``; ``lo``/``hi`` [R] float32,
    ``flip`` [R] bool."""
    u = _flipped(slot_uniform_plain(keys, tids, None, partitionable), flip)
    lo, hi = lo[:, None], hi[:, None]
    return fma32(u, hi - lo, lo)


def na_rents_chunk_plain(keys, tids, lo, hi,
                         partitionable: Optional[bool] = None):
    """Plain version of kernel P's NA-pair rents: slots ``(2m, 2m + 1)``
    share the pair counter ``m = t // 2`` and see ``(u_m, 1 - u_m)``;
    ``[R, chunk]`` float32 ``fma(v, hi - lo, lo)``."""
    u = slot_uniform_plain(keys, tids // 2, None, partitionable)
    v = torch.where((tids % 2 == 0)[None, :], u, 1.0 - u)
    lo, hi = lo[:, None], hi[:, None]
    return fma32(v, hi - lo, lo)


def ge_bernoulli_chunk_plain(keys, tids, s, p_hl, p_lh, rate_h, rate_l,
                             partitionable: Optional[bool] = None,
                             emit: bool = True):
    """Plain version of kernel P's Gilbert-Elliot chunk: the chain draws
    (salt 0) walked slot by slot from ``s`` [R] int32, ``s_t = s_{t-1} == 1
    ? u0 >= p_hl : u0 < p_lh``, then Bernoulli emissions ``x = u1 < (s_t ?
    rate_h : rate_l)`` (salt 1).  Returns ``(s', states [R, chunk] int32,
    x [R, chunk] int32, or None without ``emit``)``.  ``card_calls`` counts
    its calls on the card."""
    if keys.is_cuda:
        ge_bernoulli_chunk_plain.card_calls += 1
    u = slot_uniform_plain(keys, tids, 0, partitionable)
    states = torch.empty_like(u, dtype=torch.int32)
    for j in range(u.shape[1]):
        u_t = u[:, j]
        s = torch.where(s == 1, (u_t >= p_hl).to(torch.int32),
                        (u_t < p_lh).to(torch.int32))
        states[:, j] = s
    if not emit:
        return s, states, None
    rates = torch.where(states == 1, rate_h[:, None], rate_l[:, None])
    u = slot_uniform_plain(keys, tids, 1, partitionable)
    return s, states, (u < rates).to(torch.int32)


ge_bernoulli_chunk_plain.card_calls = 0


def _ptr(t):
    """A tensor's data pointer, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def _row_params(keys, tids, **params):
    """Check the keys, the counters and the [R] params of a stream kernel;
    returns (R, chunk)."""
    R, chunk = keys.shape[0], tids.shape[0]
    _build.check_tensor("keys", keys, torch.int64, (R, 2), keys.device)
    _build.check_tensor("tids", tids, torch.int32, (chunk,), keys.device)
    for name, (t, dtype) in params.items():
        _build.check_tensor(name, t, dtype, (R,), keys.device)
    return R, chunk


def _stream(kind, keys, tids, out_dtype, salt=None, a=None, b=None,
            flip=None, partitionable=None):
    """Launch kernel P's ``kind`` on checked inputs; returns [R, chunk]."""
    part = _layout(partitionable)
    R, chunk = keys.shape[0], tids.shape[0]
    out = torch.empty((R, chunk), dtype=out_dtype, device=keys.device)
    err = _build.library("hosting").launch_counter_stream(
        kind, keys.data_ptr(), tids.data_ptr(), _ptr(a), _ptr(b), _ptr(flip),
        out.data_ptr(), R, chunk, -1 if salt is None else int(salt),
        int(part), _build.stream(keys.device))
    _build.raise_on(err, "counter_stream")
    return out


def slot_uniform(keys, tids, salt: Optional[int] = None,
                 partitionable: Optional[bool] = None):
    """Kernel P's uniforms: ``keys`` [R, 2] int64 key words, ``tids``
    [chunk] int32 global slot counters, ``salt`` an optional static
    sub-stream fold (``0 <= salt < 2**31``) -> [R, chunk] float32, bitwise
    ``slot_uniform_plain``."""
    if keys.device.type == "cpu":
        return slot_uniform_plain(keys, tids, salt, partitionable)
    _row_params(keys, tids)
    if salt is not None and not 0 <= int(salt) < 2 ** 31:
        raise ValueError(f"salt must lie in [0, 2**31), got {salt}")
    out = _stream(_UNIFORM, keys, tids, torch.float32, salt=salt,
                  partitionable=partitionable)
    slot_uniform.launches += 1
    return out


slot_uniform.launches = 0


def bernoulli_arrivals_chunk(keys, tids, p, flip,
                             partitionable: Optional[bool] = None):
    """Kernel P's Bernoulli arrivals (arguments as
    ``bernoulli_arrivals_chunk_plain``), bitwise the plain version."""
    if keys.device.type == "cpu":
        return bernoulli_arrivals_chunk_plain(keys, tids, p, flip,
                                              partitionable)
    _row_params(keys, tids, p=(p, torch.float32), flip=(flip, torch.bool))
    out = _stream(_BERNOULLI, keys, tids, torch.int32, a=p, flip=flip,
                  partitionable=partitionable)
    bernoulli_arrivals_chunk.launches += 1
    return out


bernoulli_arrivals_chunk.launches = 0


def uniform_rents_chunk(keys, tids, lo, hi, flip,
                        partitionable: Optional[bool] = None):
    """Kernel P's uniform rents (arguments as
    ``uniform_rents_chunk_plain``), bitwise the plain version."""
    if keys.device.type == "cpu":
        return uniform_rents_chunk_plain(keys, tids, lo, hi, flip,
                                         partitionable)
    _row_params(keys, tids, lo=(lo, torch.float32), hi=(hi, torch.float32),
                flip=(flip, torch.bool))
    out = _stream(_UNIFORM_RENTS, keys, tids, torch.float32, a=lo, b=hi,
                  flip=flip, partitionable=partitionable)
    uniform_rents_chunk.launches += 1
    return out


uniform_rents_chunk.launches = 0


def na_rents_chunk(keys, tids, lo, hi, partitionable: Optional[bool] = None):
    """Kernel P's NA-pair rents (arguments as ``na_rents_chunk_plain``),
    bitwise the plain version."""
    if keys.device.type == "cpu":
        return na_rents_chunk_plain(keys, tids, lo, hi, partitionable)
    _row_params(keys, tids, lo=(lo, torch.float32), hi=(hi, torch.float32))
    out = _stream(_NA_RENTS, keys, tids, torch.float32, a=lo, b=hi,
                  partitionable=partitionable)
    na_rents_chunk.launches += 1
    return out


na_rents_chunk.launches = 0


def ge_bernoulli_chunk(keys, tids, s, p_hl, p_lh, rate_h, rate_l,
                       partitionable: Optional[bool] = None,
                       emit: bool = True):
    """Kernel P's Gilbert-Elliot chunk, the chain and its emissions in one
    launch (arguments and results as ``ge_bernoulli_chunk_plain``; without
    ``emit`` the kernel neither draws nor stores the emissions), bitwise
    the plain version."""
    if keys.device.type == "cpu":
        return ge_bernoulli_chunk_plain(keys, tids, s, p_hl, p_lh, rate_h,
                                        rate_l, partitionable, emit)
    f32 = torch.float32
    R, chunk = _row_params(keys, tids, s=(s, torch.int32),
                           p_hl=(p_hl, f32), p_lh=(p_lh, f32),
                           rate_h=(rate_h, f32), rate_l=(rate_l, f32))
    part = _layout(partitionable)
    dev = keys.device
    s_out = torch.empty((R,), dtype=torch.int32, device=dev)
    states = torch.empty((R, chunk), dtype=torch.int32, device=dev)
    x = (torch.empty((R, chunk), dtype=torch.int32, device=dev) if emit
         else None)
    err = _build.library("hosting").launch_ge_chain(
        keys.data_ptr(), tids.data_ptr(), s.data_ptr(), p_hl.data_ptr(),
        p_lh.data_ptr(), rate_h.data_ptr(), rate_l.data_ptr(),
        s_out.data_ptr(), states.data_ptr(), _ptr(x), R, chunk,
        int(part), _build.stream(dev))
    _build.raise_on(err, "ge_chain")
    ge_bernoulli_chunk.launches += 1
    return s_out, states, x


ge_bernoulli_chunk.launches = 0


# ----------------------------------------------------------------------
# P: the normal draw (XLA's float32 erf_inv) and the ARMA rents.
# ----------------------------------------------------------------------

def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


# jax.random.normal draws u on [nextafter(-1, 0), 1) and returns
# sqrt(2) * erf_inv(u), both constants rounded to float32
NORMAL_LO = -(1.0 - 2.0 ** -24)        # nextafter(-1, 0) in float32
SQRT2 = _f32(2.0 ** 0.5)
# XLA's float32 log (Cephes logf): the mantissa split at sqrt(1/2), three
# interleaved Horner pairs in x, combined in x**3, and ln 2 in two parts
_LOG_SQRTHF = _f32(0.707106781186547524)
_LOG_P = tuple(tuple(_f32(c) for c in row) for row in (
    (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1),
    (-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1),
    (2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), 0.693359375
# XLA's log1p: a rational approximation where |x| < sqrt(2) - 1, else
# log(1 + x)
_LOG1P_SMALL = _f32(0.41421356237309504880)
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
# XLA's ErfInv32 (Giles): degree-8 polynomials in w - 2.5 (w < 5) and
# sqrt(w) - 3, w = -log1p(-u * u)
_ERFINV_LT5 = tuple(_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _sqrt32(x):
    """Correctly rounded float32 square root (torch's CPU float32 sqrt is
    not; the float64 root rounded once is)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _xla_log(v):
    """XLA:CPU's float32 ``log`` of ``v`` > 0, op for op (the ``log_f32``
    its LLVM IR inlines): ``v`` clamped at FLT_MIN, split into exponent and
    mantissa, the Cephes polynomial; every multiply feeding one add is one
    FMA there (``fma32``); ``v == 0`` gives -inf, ``v == inf`` inf."""
    f32 = torch.float32
    xc = torch.where(v > 2.0 ** -126, v, torch.tensor(2.0 ** -126, dtype=f32,
                                                       device=v.device))
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)
    small = m < _LOG_SQRTHF
    e = e - small.to(f32)
    x = (m + (-1.0)) + torch.where(small, m, 0.0)
    z = x * x
    x3 = z * x
    y1, y2, y3 = (fma32(fma32(x, a, b), x, c) for a, b, c in _LOG_P)
    y = fma32(fma32(fma32(y1, x3, y2), x3, y3), x3, e * _LOG_Q1)
    out = ((x - z * 0.5) + y) + e * _LOG_Q2
    out = torch.where(v == float("inf"), float("inf"), out)
    return torch.where(v == 0, float("-inf"), out)


def _xla_log1p(x):
    """XLA:CPU's float32 ``log1p``, op for op: the rational approximation
    (its Horner steps ``fma32``) where ``|x| < sqrt(2) - 1``, else
    ``_xla_log(x + 1)``."""
    x2 = x * x
    num, den = torch.full_like(x, _LOG1P_NUM[0]), torch.ones_like(x)
    for c in _LOG1P_NUM[1:]:
        num = fma32(num, x, c)
    for c in _LOG1P_DEN:
        den = fma32(den, x, c)
    small = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _xla_log(x + 1.0))


def erf_inv_plain(u):
    """``jax.lax.erf_inv`` on float32 as XLA:CPU computes it, op for op:
    ``w = -log1p(-u * u)`` through XLA's own log1p and log, then Giles's
    polynomial in ``w - 2.5`` or ``sqrt(w) - 3``, times ``u`` (``inf * u``
    at ``|u| == 1``).  The sites where XLA contracts a multiply into the
    add that reads it (every Horner step) are ``fma32``; ``-u * u + 1`` is
    not contracted (its product has several readers)."""
    l1p = _xla_log1p(u * (-u))
    lt = l1p > -5.0
    w = torch.where(lt, -2.5 - l1p, _sqrt32(-l1p) + (-3.0))
    coef = [torch.where(lt, a, b) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = fma32(p, w, c)
    return u * torch.where(u.abs() == 1.0, float("inf"), p)


def normal_from_bits_plain(bits, scale):
    """``scale * jax.random.normal(k, (), float32)`` from the 32 random bits
    jax draws for it (the same bits as the uniform's), as XLA computes it
    inside a jit: the uniform on ``[nextafter(-1, 0), 1)`` (``[1, 2) -
    1``, times 2, plus the low end, clamped there), then ``(scale *
    sqrt(2)) * erf_inv(u)`` -- XLA folds the scale into the ``sqrt(2)``
    first; ``scale = 1`` is ``jax.random.normal`` itself."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = torch.clamp_min((fb.view(torch.float32) - 1.0) * 2.0 + NORMAL_LO,
                        NORMAL_LO)
    return (scale * SQRT2) * erf_inv_plain(u)


def normal_chunk_plain(keys, tids, sigma,
                       partitionable: Optional[bool] = None):
    """Plain version of kernel P's normals: ``[R, chunk]`` float32
    ``(sigma * sqrt(2)) * erf_inv(u)`` under ``fold_in(keys[i], tids[j])``,
    bitwise the reference's ``sigma * jax.random.normal(k, (), float32)``
    on its per-slot keys inside a jit (``sigma`` = 1: ``jax.random.normal``
    itself); ``sigma`` [R] float32."""
    return normal_from_bits_plain(
        _slot_bits(keys, tids, None, partitionable), sigma[:, None])


def _xla_dot(a, b):
    """Row-wise ``a . b`` as XLA:CPU computes the dot inside the ARMA scan.
    On a batch of rows (a small batched dot) two terms are one FMA,
    ``fma(a1, b1, a0 * b0)``, and three or more a left-to-right sum of
    rounded products; on a single row (a dot of two vectors, a loop whose
    multiply-adds LLVM contracts) every term after the first is an FMA
    into the sum, ``fma(a2, b2, fma(a1, b1, a0 * b0))``."""
    chain = a.shape[0] == 1 or a.shape[1] == 2
    x = a[:, 0] * b[:, 0]
    for i in range(1, a.shape[1]):
        x = fma32(a[:, i], b[:, i], x) if chain else x + a[:, i] * b[:, i]
    return x


def arma_rents_chunk_plain(keys, tids, hist, eps, phi, th, sigma, mean,
                           c_min, c_max, partitionable: Optional[bool] = None):
    """Plain version of kernel P's ARMA(p, q) rents over one chunk:
    innovations ``e_t = (sigma * sqrt(2)) * erf_inv(u)`` at counter ``t +
    q``, then per slot ``x = (phi . hist + e_t) + th . eps`` with each dot
    in the order of ``_xla_dot`` (a single row's dots are FMA chains; for
    p = 1 the product is fused into the add: ``fma(phi0, h0, e_t)``; for
    q = 1 the MA term too: ``fma(th0, eps0, phi . hist + e_t)``), the
    histories shifted (newest first),
    and ``clip(mean + x, c_min, c_max)``.  ``hist`` [R, p] and ``eps`` [R,
    q] carry the state in; ``phi`` / ``th`` [R, p] / [R, q] and the [R]
    params are float32.  Returns ``(hist', eps', c [R, chunk])``.
    ``card_calls`` counts its calls on the card (its slot loop is what the
    kernel replaces)."""
    if keys.is_cuda:
        arma_rents_chunk_plain.card_calls += 1
    p, q = phi.shape[1], th.shape[1]
    e = normal_chunk_plain(keys, tids + q, sigma, partitionable)
    devs = torch.empty_like(e)
    for j in range(e.shape[1]):
        x = (fma32(phi[:, 0], hist[:, 0], e[:, j]) if p == 1
             else _xla_dot(phi, hist) + e[:, j])
        x = (fma32(th[:, 0], eps[:, 0], x) if q == 1
             else x + _xla_dot(th, eps))
        hist = torch.cat([x[:, None], hist[:, :p - 1]], dim=1)
        eps = torch.cat([e[:, j:j + 1], eps[:, :q - 1]], dim=1)
        devs[:, j] = x
    c = torch.minimum(torch.maximum(mean[:, None] + devs, c_min[:, None]),
                      c_max[:, None])
    return hist, eps, c


arma_rents_chunk_plain.card_calls = 0
#: the AR and MA orders the ARMA kernel takes
ARMA_MAX_P, ARMA_MAX_Q = 8, 8


def normal_chunk(keys, tids, sigma, partitionable: Optional[bool] = None):
    """Kernel P's normals (arguments as ``normal_chunk_plain``), bitwise the
    plain version."""
    if keys.device.type == "cpu":
        return normal_chunk_plain(keys, tids, sigma, partitionable)
    _row_params(keys, tids, sigma=(sigma, torch.float32))
    out = _stream(_NORMAL, keys, tids, torch.float32, a=sigma,
                  partitionable=partitionable)
    normal_chunk.launches += 1
    return out


normal_chunk.launches = 0


def arma_rents_chunk(keys, tids, hist, eps, phi, th, sigma, mean, c_min,
                     c_max, partitionable: Optional[bool] = None):
    """Kernel P's ARMA rents, the innovations and the recursion in one
    launch (arguments and results as ``arma_rents_chunk_plain``; 1 <= p <=
    8, 1 <= q <= 8), bitwise the plain version.  ``ma1_launches`` counts
    the launches at q = 1."""
    if keys.device.type == "cpu":
        return arma_rents_chunk_plain(keys, tids, hist, eps, phi, th, sigma,
                                      mean, c_min, c_max, partitionable)
    f32 = torch.float32
    R, chunk = _row_params(keys, tids, sigma=(sigma, f32), mean=(mean, f32),
                           c_min=(c_min, f32), c_max=(c_max, f32))
    p, q = phi.shape[1], th.shape[1]
    if not (1 <= p <= ARMA_MAX_P and 1 <= q <= ARMA_MAX_Q):
        raise ValueError(f"arma_rents_chunk takes 1 <= p <= {ARMA_MAX_P} and "
                         f"1 <= q <= {ARMA_MAX_Q}, got p={p}, q={q}")
    dev = keys.device
    for name, t, shape in (("hist", hist, (R, p)), ("eps", eps, (R, q)),
                           ("phi", phi, (R, p)), ("th", th, (R, q))):
        _build.check_tensor(name, t, f32, shape, dev)
    part = _layout(partitionable)
    hist_out, eps_out = torch.empty_like(hist), torch.empty_like(eps)
    c = torch.empty((R, chunk), dtype=f32, device=dev)
    err = _build.library("hosting").launch_arma_rents(
        keys.data_ptr(), tids.data_ptr(), hist.data_ptr(), eps.data_ptr(),
        phi.data_ptr(), th.data_ptr(), sigma.data_ptr(), mean.data_ptr(),
        c_min.data_ptr(), c_max.data_ptr(), hist_out.data_ptr(),
        eps_out.data_ptr(), c.data_ptr(), R, chunk, p, q, int(part),
        _build.stream(dev))
    _build.raise_on(err, "arma_rents")
    arma_rents_chunk.launches += 1
    arma_rents_chunk.ma1_launches += q == 1
    return hist_out, eps_out, c


arma_rents_chunk.launches = 0
arma_rents_chunk.ma1_launches = 0


# ----------------------------------------------------------------------
# P: Poisson draws (Knuth's branch and Hormann's rejection) and the Model-2
# service draws.
# ----------------------------------------------------------------------

#: ``jax.random.poisson`` draws by Knuth's algorithm below this rate (and
#: at NaN) and by Hormann's transformed rejection at and above it
POISSON_KNUTH_MAX = 10.0


def _split2(k0, k1, part: bool):
    """``jax.random.split(key)`` of the key words ``(k0, k1)``: the pairs
    ``(key', subkey)``.  Partitionable: key i hashes the counter (0, i);
    original: the counters (0, 2) and (1, 3) hashed, key' their first
    words, subkey their second."""
    z = torch.zeros_like(k0)
    if part:
        return threefry2x32(k0, k1, z, z), threefry2x32(k0, k1, z, z + 1)
    a0, a1 = threefry2x32(k0, k1, z, z + 2)
    b0, b1 = threefry2x32(k0, k1, z + 1, z + 3)
    return (a0, b0), (a1, b1)


def poisson_knuth_plain(k0, k1, lam, partitionable: Optional[bool] = None):
    """``jax.random.poisson(key, lam, ())`` for every key words ``(k0,
    k1)`` and float32 rate ``lam`` (same shape, ``lam`` < 10), Knuth's
    branch of jax's ``_poisson`` as XLA:CPU computes it: while ``log_prod >
    -lam``, split the key, count the round, add XLA's ``log`` of the
    subkey's uniform (``_xla_log``, as inside the loop's fusion) to
    ``log_prod``; the draw is the rounds less one, and ``lam == 0`` gives
    0.  A lane's loop stops when its own ``log_prod`` falls to ``-lam``
    (vmapped, jax freezes the finished lanes), so the result is per lane.
    Returns int32 of the same shape."""
    part = _layout(partitionable)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=k0.device)
    k0, k1, lam = torch.broadcast_tensors(k0, k1, lam)
    shape = lam.shape
    k0, k1, lam = k0.reshape(-1), k1.reshape(-1), lam.reshape(-1)
    neg = -lam
    rounds = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros_like(lam)
    idx = torch.nonzero(log_prod > neg)[:, 0]         # the lanes still live
    k0, k1, log_prod, neg = k0[idx], k1[idx], log_prod[idx], neg[idx]
    while idx.numel():
        (r0, r1), (s0, s1) = _split2(k0, k1, part)
        log_prod = log_prod + _xla_log(uniform_from_bits(_bits32(s0, s1,
                                                                 part)))
        rounds[idx] += 1
        live = log_prod > neg
        idx, k0, k1, log_prod, neg = (idx[live], r0[live], r1[live],
                                      log_prod[live], neg[live])
    out = torch.where(lam == 0, 0, rounds - 1).to(torch.int32)
    return out.reshape(shape)


def _split3(k0, k1, part: bool):
    """``jax.random.split(key, 3)`` of the key words ``(k0, k1)``: three
    key pairs.  Partitionable: key i hashes the counter (0, i).  Original:
    the counters 0 .. 5 cut in halves (x0 = 0, 1, 2; x1 = 3, 4, 5) and
    hashed pairwise, the output words (all first words, then all second
    ones) regrouped in pairs."""
    z = torch.zeros_like(k0)
    if part:
        return tuple(threefry2x32(k0, k1, z, z + i) for i in range(3))
    a0, a1 = threefry2x32(k0, k1, z, z + 3)
    b0, b1 = threefry2x32(k0, k1, z + 1, z + 4)
    c0, c1 = threefry2x32(k0, k1, z + 2, z + 5)
    return (a0, b0), (c0, a1), (b1, c1)


# XLA's float32 lgamma (Lanczos, g = 7): the base coefficient (1 in
# float32), the eight coefficients, log(g + 1/2), 1 / (g + 1/2) (XLA turns
# the division into this product) and log(sqrt(2 pi)), all float32
_LANCZOS = tuple(_f32(c) for c in (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7))
_LANCZOS_BASE = _f32(0.99999999999980993227684700473478)
_LOG_G_HALF = _f32(2.01490302054226464)
_INV_G_HALF = _f32(1.0 / 7.5)
_LOG_SQRT_2PI = _f32(0.91893853320467274178)


def _rdiv(c: float, t):
    """``c / t`` rounded once (torch computes ``scalar / tensor`` as
    ``scalar * (1 / t)``, two roundings)."""
    return torch.full_like(t, c) / t


def _xla_lgamma(x, z=None):
    """XLA:CPU's float32 ``lgamma`` for ``x >= 0.5``, op for op: ``z = x -
    1`` (or the given ``z``, which the rejection draw passes as its integer
    ``k`` where XLA folds ``(k + 1) - 1``), the Lanczos sum ``1 + sum c_i /
    (z + i + 1)`` in order, ``log_t = log1p(z / 7.5) + log(7.5)`` (XLA's
    log1p of the product by the reciprocal), ``t = z + 7.5``, then
    ``fma((z + 0.5) - t / log_t, log_t, log(sqrt(2 pi))) + log(sum)`` (the
    one FMA XLA contracts there); +inf at +inf.  Below 0.5 XLA reflects
    through its ``sin``, which is not transcribed: the result there is NaN
    (the rejection draw never reads it)."""
    if z is None:
        z = x - 1.0
    s = torch.full_like(z, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        s = s + _rdiv(c, z + float(i + 1))
    log_t = _xla_log1p(z * _INV_G_HALF) + _LOG_G_HALF
    q = (z + 7.5) / log_t
    out = fma32((z + 0.5) - q, log_t, _LOG_SQRT_2PI) + _xla_log(s)
    out = torch.where(x < 0.5, float("nan"), out)
    return torch.where(x.abs() == float("inf"), float("inf"), out)


# Hormann's constants (jax/_src/random.py: _poisson_rejection), float32;
# XLA folds b - 2 and b - 3.4 into the constant of b's FMA
_HOR_B = (_f32(2.53), _f32(0.931))
_HOR_A = (_f32(0.02483), _f32(-0.059))
_HOR_B2, _HOR_B34 = _f32(_HOR_B[1] - 2.0), _f32(_HOR_B[1] - 3.4)
_HOR_INV = (_f32(1.1328), _f32(1.1239))
_HOR_VR = (_f32(3.6224), _f32(0.9277))
_HOR_K0, _HOR_US1, _HOR_US2 = _f32(0.43), _f32(0.07), _f32(0.013)


def poisson_rejection_plain(k0, k1, lam, partitionable: Optional[bool] = None,
                            stats: bool = False):
    """``jax.random.poisson(key, lam, ())`` by Hormann's transformed
    rejection (jax's branch for ``lam >= 10``) for every key words ``(k0,
    k1)`` and float32 rate ``lam`` (same shape), as XLA:CPU computes it.
    Per item, once: ``log_lam = log(lam)``, ``b = fma(sqrt(lam), 2.53,
    0.931)``, ``a = fma(b, 0.02483, -0.059)``, ``inv_alpha = 1.1328 /
    fma(sqrt(lam), 2.53, 0.931 - 3.4) + 1.1239``, ``v_r = 0.9277 - 3.6224
    / fma(sqrt(lam), 2.53, 0.931 - 2)`` (XLA folds ``b - c``).  Each round:
    ``(key, s0, s1) = split(key, 3)``, ``u = uniform(s0) - 0.5``, ``v =
    uniform(s1)``, ``us = 0.5 - |u|``, ``k = floor(fma(2a / us + b, u,
    lam) + 0.43)``, ``s = log(v * inv_alpha / (a / (us * us) + b))``, ``t
    = fma(k, log_lam, -lam) - lgamma(k + 1)``; accept when ``us >= 0.07 &
    v <= v_r``, or when not (``k < 0 | (us < 0.013 & v > us)``) and ``s <=
    t``.  ``sqrt`` is correctly rounded, ``log`` / ``lgamma`` XLA's own;
    the three FMAs are where XLA contracts.  A lane is frozen at its first
    acceptance (vmapped, jax freezes it), so the result is per lane.
    Returns int32 of the same shape; with ``stats`` also the rounds drawn
    and the rounds that reached the ``s <= t`` test (the ones that
    evaluate ``lgamma``), summed over the items (a kernel's work)."""
    part = _layout(partitionable)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=k0.device)
    k0, k1, lam = torch.broadcast_tensors(k0, k1, lam)
    shape = lam.shape
    k0, k1, lam = k0.reshape(-1), k1.reshape(-1), lam.reshape(-1)
    sq = _sqrt32(lam)
    b = fma32(sq, *_HOR_B)
    a = fma32(b, *_HOR_A)
    a2 = a * 2.0
    inv_alpha = (_rdiv(_HOR_INV[0], fma32(sq, _HOR_B[0], _HOR_B34))
                 + _HOR_INV[1])
    v_r = _HOR_VR[1] - _rdiv(_HOR_VR[0], fma32(sq, _HOR_B[0], _HOR_B2))
    log_lam, neg = _xla_log(lam), -lam
    out = torch.full(lam.shape, -1, dtype=torch.int32, device=lam.device)
    idx = torch.arange(lam.numel(), device=lam.device)   # the live lanes
    rounds = slow = 0
    while idx.numel():
        (k0, k1), (s0, s1), (w0, w1) = _split3(k0, k1, part)
        u = uniform_from_bits(_bits32(s0, s1, part)) - 0.5
        v = uniform_from_bits(_bits32(w0, w1, part))
        us = 0.5 - u.abs()
        k = torch.floor(fma32(a2 / us + b, u, lam) + _HOR_K0)
        s = _xla_log(v * inv_alpha / (a / (us * us) + b))
        t = fma32(k, log_lam, neg) - _xla_lgamma(k + 1.0, k)
        accept1 = (us >= _HOR_US1) & (v <= v_r)
        reject = (k < 0) | ((us < _HOR_US2) & (v > us))
        acc = accept1 | (~reject & (s <= t))
        if stats:
            rounds += idx.numel()
            slow += int((~accept1 & ~reject).sum())
        out[idx[acc]] = k[acc].to(torch.int32)
        live = ~acc
        idx, k0, k1 = idx[live], k0[live], k1[live]
        lam, b, a, a2, inv_alpha, v_r, log_lam, neg = (
            p[live] for p in (lam, b, a, a2, inv_alpha, v_r, log_lam, neg))
    out = out.reshape(shape)
    return (out, rounds, slow) if stats else out


def poisson_plain(k0, k1, lam, partitionable: Optional[bool] = None):
    """``jax.random.poisson(key, lam, ())`` for every key words ``(k0,
    k1)`` and float32 rate ``lam``: per item Knuth's branch
    (``poisson_knuth_plain``) where ``isnan(lam) | lam < 10``, Hormann's
    rejection (``poisson_rejection_plain``) elsewhere; ``lam == 0`` gives
    0.  Returns int32 of the broadcast shape."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=k0.device)
    k0, k1, lam = torch.broadcast_tensors(k0, k1, lam)
    knuth = torch.isnan(lam) | (lam < POISSON_KNUTH_MAX)
    out = torch.empty(lam.shape, dtype=torch.int32, device=lam.device)
    out[knuth] = poisson_knuth_plain(k0[knuth], k1[knuth], lam[knuth],
                                     partitionable)
    rej = ~knuth
    out[rej] = poisson_rejection_plain(k0[rej], k1[rej], lam[rej],
                                       partitionable)
    return out


def poisson_chunk_plain(keys, tids, lam, salt: Optional[int] = None,
                        states=None, lam_h=None,
                        partitionable: Optional[bool] = None):
    """Plain version of kernel P's Poisson draws: ``[R, chunk]`` int32
    ``jax.random.poisson`` under ``fold_in(keys[i], tids[j])`` (then
    ``fold_in(., salt)`` when a salt is given) at rate ``lam[i]`` (float32
    [R]), or, given GE ``states`` [R, chunk] int32, at the per-slot rate
    ``states == 1 ? lam_h[i] : lam[i]`` (``_ge_emit``'s Poisson
    emissions): each item by Knuth's branch or Hormann's rejection as its
    rate says (``poisson_plain``).  ``card_calls`` counts its calls on the
    card (its round loops are what the kernel replaces)."""
    if keys.is_cuda:
        poisson_chunk_plain.card_calls += 1
    a0, a1 = _slot_keys(keys, tids, salt)
    rate = (lam[:, None] if states is None
            else torch.where(states == 1, lam_h[:, None], lam[:, None]))
    return poisson_plain(a0, a1, rate.expand(a0.shape).contiguous(),
                         partitionable)


poisson_chunk_plain.card_calls = 0


def shaped_bits(k0, k1, n: int, partitionable: Optional[bool] = None):
    """``[..., n]`` int64: the 32-bit words jax draws for ``uniform(key,
    (n,))`` under each key words ``(k0, k1)``.  Partitionable: word i
    hashes the counter (0, i), xor of the pair.  Original: the counters
    ``0 .. n - 1`` (a 0 appended when n is odd) cut in halves x0 | x1 and
    hashed pairwise, the words the first outputs then the second ones."""
    part = _layout(partitionable)
    k0, k1 = k0[..., None], k1[..., None]
    if part:
        i = torch.arange(n, dtype=torch.int64, device=k0.device)
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
        return y0 ^ y1
    h = (n + 1) // 2
    cnt = torch.arange(2 * h, dtype=torch.int64, device=k0.device)
    cnt[n:] = 0
    y0, y1 = threefry2x32(k0, k1, cnt[:h], cnt[h:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def model2_service_chunk_plain(keys, tids, x, g, n_max: int,
                               partitionable: Optional[bool] = None):
    """Plain version of kernel P's Model-2 service draws: under ``fold_in(
    keys[i], tids[j])`` the slot's ``n_max`` request uniforms ``u =
    uniform(key, (n_max,))``; ``svc[i, j, k] = #{r < min(x[i, j], n_max) :
    u[r] < g[i, k]}`` as float32 (exact).  ``x`` [R, chunk] int32, ``g``
    [R, K] float32 -> [R, chunk, K].  ``card_calls`` counts its calls on
    the card."""
    if keys.is_cuda:
        model2_service_chunk_plain.card_calls += 1
    a0, a1 = _slot_keys(keys, tids, None)
    u = uniform_from_bits(shaped_bits(a0, a1, n_max, partitionable))
    live = torch.arange(n_max, device=x.device) < x[:, :, None]
    fwd = u[:, :, :, None] < g[:, None, None, :]
    return (live[:, :, :, None] & fwd).sum(dim=2).to(torch.float32)


model2_service_chunk_plain.card_calls = 0


def shaped_uniform_plain(key, n: int, partitionable: Optional[bool] = None):
    """Plain version of kernel P's shaped uniform: ``jax.random.uniform(key,
    (n,))`` of one [2] int64 key, [n] float32, in the current (or the
    given) threefry layout (``shaped_bits``' words)."""
    return uniform_from_bits(shaped_bits(key[0], key[1], int(n),
                                         partitionable))


def shaped_uniform(key, n: int, partitionable: Optional[bool] = None):
    """Kernel P's shaped uniform (arguments as ``shaped_uniform_plain``;
    n < 2**31), bitwise the plain version: the draws of
    ``jax.random.choice`` (``combinators.mixture_from_weights``) and of
    ``simulator.model2_service_matrix``."""
    if key.device.type == "cpu":
        return shaped_uniform_plain(key, n, partitionable)
    _build.check_tensor("key", key, torch.int64, (2,), key.device)
    if not 0 <= int(n) < 2 ** 31:
        raise ValueError(f"shaped_uniform takes 0 <= n < 2**31, got {n}")
    out = torch.empty((int(n),), dtype=torch.float32, device=key.device)
    err = _build.library("hosting").launch_shaped_uniform(
        key.data_ptr(), out.data_ptr(), int(n), int(_layout(partitionable)),
        _build.stream(key.device))
    _build.raise_on(err, "shaped_uniform")
    shaped_uniform.launches += 1
    return out


shaped_uniform.launches = 0


# the Poisson kernel's work words a (device, stream): the ticket counter
# and the launch's Hormann flag, which the launcher zeroes on that stream
# before each launch (so the launches that share them run one after
# another), and the count of the launches that drew an item on Hormann's
# branch, which the kernel adds to
_POISSON_TICKETS: dict = {}


def poisson_rejection_launches() -> int:
    """The launches of kernel P's Poisson variant, since the last
    ``reset_poisson_rejection_launches``, in which the kernel drew an item
    on Hormann's branch (a rate of 10 or more); the kernel counts them, so
    reading the count waits for the card."""
    return sum(int(w[2].item()) for w in _POISSON_TICKETS.values())


def reset_poisson_rejection_launches():
    for w in _POISSON_TICKETS.values():
        w[2].zero_()


def poisson_chunk(keys, tids, lam, salt: Optional[int] = None, states=None,
                  lam_h=None, partitionable: Optional[bool] = None):
    """Kernel P's Poisson draws (arguments as ``poisson_chunk_plain``, and
    as there the rates are not checked: the streams check them when they
    are built), bitwise the plain version."""
    if keys.device.type == "cpu":
        return poisson_chunk_plain(keys, tids, lam, salt, states, lam_h,
                                   partitionable)
    f32 = torch.float32
    R, chunk = _row_params(keys, tids, lam=(lam, f32))
    if (states is None) != (lam_h is None):
        raise ValueError("poisson_chunk: states and lam_h go together")
    if states is not None:
        _build.check_tensor("lam_h", lam_h, f32, (R,), keys.device)
        _build.check_tensor("states", states, torch.int32, (R, chunk),
                            keys.device)
    if salt is not None and not 0 <= int(salt) < 2 ** 31:
        raise ValueError(f"salt must lie in [0, 2**31), got {salt}")
    out = torch.empty((R, chunk), dtype=torch.int32, device=keys.device)
    stream = _build.stream(keys.device)
    work = _POISSON_TICKETS.get((keys.device, stream))
    if work is None:
        work = _POISSON_TICKETS.setdefault(
            (keys.device, stream),
            torch.zeros((3,), dtype=torch.int32, device=keys.device))
    err = _build.library("hosting").launch_poisson(
        keys.data_ptr(), tids.data_ptr(), lam.data_ptr(), _ptr(lam_h),
        _ptr(states), out.data_ptr(), work.data_ptr(), R, chunk,
        -1 if salt is None else int(salt), int(_layout(partitionable)),
        stream)
    _build.raise_on(err, "poisson")
    poisson_chunk.launches += 1
    return out


poisson_chunk.launches = 0


def model2_service_chunk(keys, tids, x, g, n_max: int,
                         partitionable: Optional[bool] = None):
    """Kernel P's Model-2 service draws (arguments as
    ``model2_service_chunk_plain``; K <= 32, n_max <= 2**23), bitwise the
    plain version.  ``wide_launches`` counts the launches on a wide slab
    (more than ``DPF_MAX_K`` levels)."""
    if keys.device.type == "cpu":
        return model2_service_chunk_plain(keys, tids, x, g, n_max,
                                          partitionable)
    R, chunk = _row_params(keys, tids)
    K = g.shape[1] if g.dim() == 2 else -1
    if not 1 <= K <= M2_MAX_K or not 0 <= n_max <= M2_MAX_REQUESTS:
        raise ValueError(f"model2_service_chunk takes 1 <= K <= {M2_MAX_K} "
                         f"and 0 <= n_max <= {M2_MAX_REQUESTS}, got K={K}, "
                         f"n_max={n_max}")
    _build.check_tensor("x", x, torch.int32, (R, chunk), keys.device)
    _build.check_tensor("g", g, torch.float32, (R, K), keys.device)
    out = torch.empty((R, chunk, K), dtype=torch.float32, device=keys.device)
    err = _build.library("hosting").launch_model2_service(
        keys.data_ptr(), tids.data_ptr(), x.data_ptr(), g.data_ptr(),
        out.data_ptr(), R, chunk, K, int(n_max), int(_layout(partitionable)),
        _build.stream(keys.device))
    _build.raise_on(err, "model2_service")
    model2_service_chunk.launches += 1
    model2_service_chunk.wide_launches += K > DPF_MAX_K
    return out


model2_service_chunk.launches = 0
model2_service_chunk.wide_launches = 0


# ----------------------------------------------------------------------
# D: dp_minplus.
# ----------------------------------------------------------------------

def dp_minplus_plain(J, wck, fetch, valid):
    """Plain version of kernel D, one chunk of the OPT forward recursion
    for R rows: ``J`` [R, K], ``wck`` [R, chunk, K] (``+inf`` on padded
    levels), ``fetch`` [R, K, K], ``valid`` [R, chunk] bool ->
    ``(J' [R, K], args [R, chunk, K] int32)``.  Per slot
    ``trans = J[:, :, None] + fetch``; ``args`` is the first minimising
    predecessor (an all-``+inf`` column gives 0), ``J = min + w``; invalid
    slots freeze ``J`` and write the identity."""
    R, chunk, K = wck.shape
    iota = torch.arange(K, dtype=torch.int32, device=wck.device)
    args = torch.empty((R, chunk, K), dtype=torch.int32, device=wck.device)
    for t in range(chunk):
        trans = J[:, :, None] + fetch
        arg = torch.argmin(trans, dim=1).to(torch.int32)
        Jn = torch.amin(trans, dim=1) + wck[:, t]
        v = valid[:, t, None]
        J = torch.where(v, Jn, J)
        args[:, t] = torch.where(v, arg, iota)
    return J, args


def dp_minplus(J, wck, fetch, valid):
    """Kernel D (shapes as ``dp_minplus_plain``; K <= 32), bitwise
    ``dp_minplus_plain``."""
    if J.device.type == "cpu":
        return dp_minplus_plain(J, wck, fetch, valid)
    R, chunk, K = wck.shape
    dev = J.device
    if not 1 <= K <= DP_MAX_K:
        raise ValueError(f"dp_minplus takes 1 <= K <= {DP_MAX_K}, got {K}")
    _build.check_tensor("J", J, torch.float32, (R, K), dev)
    _build.check_tensor("wck", wck, torch.float32, (R, chunk, K), dev)
    _build.check_tensor("fetch", fetch, torch.float32, (R, K, K), dev)
    _build.check_tensor("valid", valid, torch.bool, (R, chunk), dev)
    Jout = torch.empty((R, K), dtype=torch.float32, device=dev)
    args = torch.empty((R, chunk, K), dtype=torch.int32, device=dev)
    err = _build.library("hosting").launch_dp_minplus(
        J.data_ptr(), wck.data_ptr(), fetch.data_ptr(), valid.data_ptr(),
        Jout.data_ptr(), args.data_ptr(), R, chunk, K, _build.stream(dev))
    _build.raise_on(err, "dp_minplus")
    dp_minplus.launches += 1
    return Jout, args


dp_minplus.launches = 0


def dp_fwd_model1_plain(J, c, x, g, lv, kmask, fetch, T_len, t0: int,
                        with_args: bool = False):
    """Plain version of the fused kernel D: one DP forward chunk for R rows
    priced under Model 1.  ``J`` [R, K], ``c`` [R, chunk] float32 rents,
    ``x`` [R, chunk] int32 arrivals, ``g``/``lv`` [R, K] float32, ``kmask``
    [R, K] bool, ``fetch`` [R, K, K], ``T_len`` [R] int32, ``t0`` the
    chunk's first global slot.  ``w = kmask ? fma(c, lv, float(x) * g) :
    +inf``, then ``dp_minplus_plain`` over the valid slots ``t0 + j <
    T_len``.  Returns ``(J', args [R, chunk, K] int32 or None)``."""
    svc = x[:, :, None].to(g.dtype) * g[:, None, :]      # Model-1 service
    w = torch.where(kmask[:, None, :],
                    fma32(c[:, :, None], lv[:, None, :], svc), float("inf"))
    tids = torch.arange(t0, t0 + c.shape[1], dtype=torch.int32,
                        device=c.device)
    J, args = dp_minplus_plain(J, w, fetch, tids[None, :] < T_len[:, None])
    return J, (args if with_args else None)


def _dp_fwd(name, J, c, lv, kmask, fetch, T_len, t0, with_args, x=None,
            g=None, svc=None, svc_cols=None):
    """Check the fused D's inputs, under Model 1 (``x``, ``g``) or on a
    Model-2 slab (``svc``, ``svc_cols``), and launch it on the card."""
    R, K = J.shape
    chunk = c.shape[1]
    dev = J.device
    if not 1 <= K <= DPF_MAX_K:
        raise ValueError(f"{name} takes 1 <= K <= {DPF_MAX_K}, got {K}")
    if not 0 <= int(t0) < 2 ** 31:
        raise ValueError(f"t0 must lie in [0, 2**31), got {t0}")
    f32 = torch.float32
    ins = [("J", J, f32, (R, K)), ("c", c, f32, (R, chunk)),
           ("lv", lv, f32, (R, K)), ("kmask", kmask, torch.bool, (R, K)),
           ("fetch", fetch, f32, (R, K, K)),
           ("T_len", T_len, torch.int32, (R,))]
    if svc is None:
        ins += [("x", x, torch.int32, (R, chunk)), ("g", g, f32, (R, K))]
    for arg in ins:
        _build.check_tensor(*arg, dev)
    Kf = K if svc is None else _check_svc(
        name, svc, svc_cols, R, chunk, K, dev, DPF_MAX_K,
        ": wider slabs wait for the joint DP (ROADMAP.md, Queue 1 item 11)")
    Jout = torch.empty((R, K), dtype=f32, device=dev)
    args = (torch.empty((R, chunk, K), dtype=torch.int32, device=dev)
            if with_args else None)
    err = _build.library("hosting").launch_dp_fwd(
        J.data_ptr(), c.data_ptr(), _ptr(x), _ptr(g), _ptr(svc),
        _ptr(svc_cols), lv.data_ptr(), kmask.data_ptr(), fetch.data_ptr(),
        T_len.data_ptr(), Jout.data_ptr(), _ptr(args), R, chunk, K, Kf,
        int(t0), _build.stream(dev))
    _build.raise_on(err, name)
    return Jout, args


def dp_fwd_model1(J, c, x, g, lv, kmask, fetch, T_len, t0: int,
                  with_args: bool = False):
    """Kernel D with the cost assembly fused in (arguments as
    ``dp_fwd_model1_plain``; 1 <= K <= 16), bitwise
    ``dp_fwd_model1_plain``.  The argmin table is written only when
    ``with_args`` (the ``ARGS`` route; ``args_launches`` counts those
    launches); J is the same either way."""
    if J.device.type == "cpu":
        return dp_fwd_model1_plain(J, c, x, g, lv, kmask, fetch, T_len, t0,
                                   with_args)
    out = _dp_fwd("dp_fwd_model1", J, c, lv, kmask, fetch, T_len, t0,
                  with_args, x=x, g=g)
    dp_fwd_model1.launches += 1
    dp_fwd_model1.args_launches += bool(with_args)
    return out


dp_fwd_model1.launches = 0
dp_fwd_model1.args_launches = 0


def gather_svc(svc, svc_cols):
    """``svc`` [R, chunk, K_fleet] restricted to a lane's columns: ``[R,
    chunk, K_lane]`` with ``out[i, j, k] = svc[i, j, svc_cols[i, k]]``
    (``svc_cols`` None: ``svc`` itself) -- the reference's ``jnp.take``
    of a lane's Model-2 columns, exact."""
    if svc_cols is None:
        return svc
    idx = svc_cols.to(torch.int64)[:, None, :].expand(-1, svc.shape[1], -1)
    return torch.gather(svc, 2, idx)


def _check_svc(name, svc, svc_cols, R, chunk, K, dev, kf_max, why=""):
    """Check a Model-2 service slab of at most ``kf_max`` levels and its
    optional column map for a K-level lane; returns the slab's level
    count."""
    Kf = svc.shape[2] if svc.dim() == 3 else -1
    _build.check_tensor("svc", svc, torch.float32, (R, chunk, Kf), dev)
    if svc_cols is None:
        if Kf != K:
            raise ValueError(f"svc has {Kf} levels, the lane {K}: pass "
                             f"svc_cols")
    else:
        _build.check_tensor("svc_cols", svc_cols, torch.int32, (R, K), dev)
    if not 1 <= Kf <= kf_max:
        raise ValueError(f"{name} takes a slab of 1 <= K <= {kf_max} "
                         f"levels, got {Kf}{why}")
    return Kf


def dp_fwd_model2_plain(J, c, svc, lv, kmask, fetch, T_len, t0: int,
                        svc_cols=None, with_args: bool = False):
    """Plain version of the fused kernel D under Model-2 service: one DP
    forward chunk for R rows on a realized service slab.  ``svc`` [R,
    chunk, K_svc] float32, gathered to the row's K levels through
    ``svc_cols`` [R, K] int32 when given; ``w = kmask ? fma(c, lv, svc) :
    +inf`` (one rounding, as the reference's fused drivers contract it),
    then ``dp_minplus_plain`` over the valid slots ``t0 + j < T_len``.
    Other arguments and the result as ``dp_fwd_model1_plain``."""
    s = gather_svc(svc, svc_cols)
    w = torch.where(kmask[:, None, :],
                    fma32(c[:, :, None], lv[:, None, :], s), float("inf"))
    tids = torch.arange(t0, t0 + c.shape[1], dtype=torch.int32,
                        device=c.device)
    J, args = dp_minplus_plain(J, w, fetch, tids[None, :] < T_len[:, None])
    return J, (args if with_args else None)


def dp_fwd_model2(J, c, svc, lv, kmask, fetch, T_len, t0: int, svc_cols=None,
                  with_args: bool = False):
    """Kernel D on a Model-2 service slab, the cost assembly fused in
    (arguments as ``dp_fwd_model2_plain``; 1 <= K <= 16 levels, and the
    slab too), bitwise ``dp_fwd_model2_plain``; ``args_launches`` as in
    ``dp_fwd_model1``."""
    if J.device.type == "cpu":
        return dp_fwd_model2_plain(J, c, svc, lv, kmask, fetch, T_len, t0,
                                   svc_cols, with_args)
    out = _dp_fwd("dp_fwd_model2", J, c, lv, kmask, fetch, T_len, t0,
                  with_args, svc=svc, svc_cols=svc_cols)
    dp_fwd_model2.launches += 1
    dp_fwd_model2.args_launches += bool(with_args)
    return out


dp_fwd_model2.launches = 0
dp_fwd_model2.args_launches = 0


# ----------------------------------------------------------------------
# B: dp_backtrack.
# ----------------------------------------------------------------------

def dp_backtrack_plain(k, args):
    """Plain version of kernel B: walk a chunk's argmin table ``args`` [R,
    chunk, K] int32 back from the levels ``k`` [R] int32 at its end:
    ``r[t] = k; k = args[t, k]`` from the last slot to the first.  Returns
    ``(k at the chunk's entry, r [R, chunk] int32)``.  ``card_calls``
    counts its calls on the card (its slot loop is what B replaces)."""
    if args.is_cuda:
        dp_backtrack_plain.card_calls += 1
    r = torch.empty(args.shape[:2], dtype=torch.int32, device=args.device)
    for t in range(args.shape[1] - 1, -1, -1):
        r[:, t] = k
        k = torch.gather(args[:, t], 1, k[:, None].to(torch.int64))[:, 0]
    return k, r


dp_backtrack_plain.card_calls = 0


def dp_backtrack(k, args):
    """Kernel B (arguments as ``dp_backtrack_plain``; K <= 32), bitwise
    ``dp_backtrack_plain``."""
    if args.device.type == "cpu":
        return dp_backtrack_plain(k, args)
    R, chunk, K = args.shape
    dev = args.device
    if not 1 <= K <= DP_MAX_K:
        raise ValueError(f"dp_backtrack takes 1 <= K <= {DP_MAX_K}, got {K}")
    _build.check_tensor("k", k, torch.int32, (R,), dev)
    _build.check_tensor("args", args, torch.int32, (R, chunk, K), dev)
    k_out = torch.empty_like(k)
    r = torch.empty((R, chunk), dtype=torch.int32, device=dev)
    err = _build.library("hosting").launch_dp_backtrack(
        k.data_ptr(), args.data_ptr(), k_out.data_ptr(), r.data_ptr(), R,
        chunk, K, _build.stream(dev))
    _build.raise_on(err, "dp_backtrack")
    dp_backtrack.launches += 1
    return k_out, r


dp_backtrack.launches = 0


# ----------------------------------------------------------------------
# S: sim_chunk_alpha_rr.
# ----------------------------------------------------------------------

def sim_chunk_alpha_rr_plain(params, lv, g, M, T_len, t0: int, carry, x, c,
                             include_final_fetch: bool = True,
                             collect_trace: bool = True,
                             rent_fma: bool = False):
    """Plain version of kernel S: ``simulator.sim_chunk_core`` stepping
    ``alpha_rr_step`` over slots ``[t0, t0 + chunk)`` of R rows under
    Model-1 service ``x * g``.  ``params`` are the alpha-RR params
    (``levels``, ``mask``, ``M``); ``lv``/``g``/``M`` the accounting grid;
    ``carry = (state, acc)``; ``rent_fma`` accumulates the rent as one FMA
    (``simulator.xla_acc_fma``).  Returns ``(carry', r_hist [R, chunk]
    int32 or None)``."""
    # the plain version IS the simulator's slot loop (imported here: the
    # simulator dispatches to this module, so a top-level import would cycle)
    from repro_torch.core.policies.alpha_rr import alpha_rr_step
    from repro_torch.core.simulator import model1_svc, sim_chunk_core
    carry, r = sim_chunk_core(alpha_rr_step, include_final_fetch, params, lv,
                              M, T_len, t0, carry, x, c, model1_svc(x, g),
                              rent_fma=rent_fma)
    return carry, (r if collect_trace else None)


def _sim_alpha_rr(name, params, lv, M, T_len, t0, carry, c,
                  include_final_fetch, collect_trace, x=None, g=None,
                  svc=None, svc_cols=None):
    """Check kernel S's inputs, under Model 1 (``x``, ``g``) or on a
    Model-2 slab (``svc``, ``svc_cols``), and launch it on the card."""
    state, acc = carry
    R, K = lv.shape
    chunk = c.shape[1]
    dev = c.device
    if not 2 <= K <= SIM_MAX_K:
        raise ValueError(f"{name} takes 2 <= K <= {SIM_MAX_K}, got {K}")
    f32, i32 = torch.float32, torch.int32
    ins = (("levels", params["levels"], f32, (R, K)),
           ("mask", params["mask"], torch.bool, (R, K)),
           ("policy M", params["M"], f32, (R,)),
           ("lv", lv, f32, (R, K)), ("g", g, f32, (R, K)),
           ("M", M, f32, (R,)), ("T_len", T_len, i32, (R,)),
           ("r", state["r"], i32, (R,)), ("S", state["S"], f32, (R, K)),
           ("age", state["age"], i32, (R,)),
           ("sums", acc["sums"], f32, (R, 3)),
           ("counts", acc["counts"], i32, (R, K)),
           ("x", x, i32, (R, chunk)), ("c", c, f32, (R, chunk)))
    for arg in ins:
        if svc is None or arg[0] not in ("g", "x"):
            _build.check_tensor(*arg, dev)
    Kf = K if svc is None else _check_svc(name, svc, svc_cols, R, chunk, K,
                                          dev, M2_MAX_K)
    new_state = {k: torch.empty_like(state[k]) for k in ("r", "S", "age")}
    new_acc = {k: torch.empty_like(acc[k]) for k in ("sums", "counts")}
    r_hist = (torch.empty((R, chunk), dtype=i32, device=dev)
              if collect_trace else None)
    outs = (new_state["r"], new_state["S"], new_state["age"],
            new_acc["sums"], new_acc["counts"], r_hist)
    err = _build.library("hosting").launch_sim_alpha_rr(
        *(_ptr(t) for _, t, _, _ in ins), _ptr(svc), _ptr(svc_cols), int(t0),
        chunk, R, K, Kf, int(include_final_fetch), *(_ptr(t) for t in outs),
        _build.stream(dev))
    _build.raise_on(err, name)
    return (new_state, new_acc), r_hist


def sim_chunk_alpha_rr(params, lv, g, M, T_len, t0: int, carry, x, c,
                       include_final_fetch: bool = True,
                       collect_trace: bool = True, rent_fma: bool = False):
    """Kernel S (arguments as ``sim_chunk_alpha_rr_plain``; 2 <= K <= 16),
    bitwise ``sim_chunk_alpha_rr_plain``."""
    if x.device.type == "cpu":
        return sim_chunk_alpha_rr_plain(params, lv, g, M, T_len, t0, carry,
                                        x, c, include_final_fetch,
                                        collect_trace, rent_fma)
    out = _sim_alpha_rr("sim_chunk_alpha_rr", params, lv, M, T_len, t0,
                        carry, c, include_final_fetch,
                        collect_trace or rent_fma, x=x, g=g)
    sim_chunk_alpha_rr.launches += 1
    return _fused_rent(out, rent_fma, collect_trace, lv, M, T_len, t0,
                       carry[1], c, x=x, g=g)


sim_chunk_alpha_rr.launches = 0


def sim_chunk_alpha_rr_svc_plain(params, lv, M, T_len, t0: int, carry, c,
                                 svc, svc_cols=None,
                                 include_final_fetch: bool = True,
                                 collect_trace: bool = True,
                                 rent_fma: bool = False):
    """Plain version of kernel S under Model-2 service: the same chunk as
    ``sim_chunk_alpha_rr_plain`` on a realized service slab ``svc`` [R,
    chunk, K_svc], gathered to the rows' K levels through ``svc_cols`` [R,
    K] int32 when given: ``w = fma(c, lv, svc)`` and the service cost of
    the held level ``svc[r]``.  Returns ``(carry', r_hist or None)``."""
    from repro_torch.core.policies.alpha_rr import alpha_rr_step
    from repro_torch.core.simulator import sim_chunk_core
    carry, r = sim_chunk_core(alpha_rr_step, include_final_fetch, params, lv,
                              M, T_len, t0, carry, None, c,
                              gather_svc(svc, svc_cols), rent_fma=rent_fma)
    return carry, (r if collect_trace else None)


def sim_chunk_alpha_rr_svc(params, lv, M, T_len, t0: int, carry, c, svc,
                           svc_cols=None, include_final_fetch: bool = True,
                           collect_trace: bool = True,
                           rent_fma: bool = False):
    """Kernel S under Model-2 service (arguments as
    ``sim_chunk_alpha_rr_svc_plain``; 2 <= K <= 16 levels, the slab 1 to
    32), bitwise ``sim_chunk_alpha_rr_svc_plain``.  ``wide_launches``
    counts the launches on a wide slab (more than ``DPF_MAX_K`` levels)."""
    if c.device.type == "cpu":
        return sim_chunk_alpha_rr_svc_plain(params, lv, M, T_len, t0, carry,
                                            c, svc, svc_cols,
                                            include_final_fetch,
                                            collect_trace, rent_fma)
    out = _sim_alpha_rr("sim_chunk_alpha_rr_svc", params, lv, M, T_len, t0,
                        carry, c, include_final_fetch,
                        collect_trace or rent_fma, svc=svc,
                        svc_cols=svc_cols)
    sim_chunk_alpha_rr_svc.launches += 1
    sim_chunk_alpha_rr_svc.wide_launches += svc.shape[2] > DPF_MAX_K
    return _fused_rent(out, rent_fma, collect_trace, lv, M, T_len, t0,
                       carry[1], c, svc=svc, svc_cols=svc_cols)


sim_chunk_alpha_rr_svc.launches = 0
sim_chunk_alpha_rr_svc.wide_launches = 0


# ----------------------------------------------------------------------
# S: the table variant (static, MDP and ABC policies).
# ----------------------------------------------------------------------

# the observation a table step reads (csrc/hosting.cu: TableObs): none
# (static: one table row), the side channel (MDP: the GE chain's state),
# the arrivals (ABC: float32(x) >= the row's threshold)
_OBS_KINDS = {"none": 0, "side": 1, "x": 2}
#: the table rows (observed states) the kernel takes
TABLE_MAX_S = 2


def table_step(params, state, obs):
    """One slot of a table policy as kernel S's table variant steps it:
    ``r' = pi[row, s, r]`` with ``params = {"pi": [R, S, K] int32, "obs":
    kind, "x_threshold": [R] float32 or None}``; ``s`` is 0 (kind
    ``"none"``), the side channel clipped to ``[0, S - 1]`` (``"side"``) or
    ``float32(x) >= x_threshold`` (``"x"``)."""
    pi, kind = params["pi"], params["obs"]
    R, S, K = pi.shape
    if kind == "side":
        s = torch.clamp(obs.side, 0, S - 1)
    elif kind == "x":
        s = (obs.x.to(torch.float32) >= params["x_threshold"]).to(torch.int32)
    else:
        s = torch.zeros_like(state["r"])
    idx = (s.to(torch.int64) * K + state["r"].to(torch.int64))[:, None]
    return {"r": torch.gather(pi.reshape(R, -1), 1, idx)[:, 0]}


def sim_chunk_table_plain(pi, obs, x_threshold, lv, g, M, T_len, t0: int,
                          carry, x, c, side, include_final_fetch: bool = True,
                          collect_trace: bool = True,
                          rent_fma: bool = False, fetch_fma: bool = False):
    """Plain version of kernel S's table variant: ``simulator.
    sim_chunk_core`` stepping ``table_step`` on the table ``pi`` [R, S, K]
    int32 (S = 1 or 2) read at the observation ``obs`` (``"none"``,
    ``"side"``, or ``"x"`` against ``x_threshold`` [R]) over slots ``[t0,
    t0 + chunk)`` of R rows under Model-1 service ``x * g``; ``side`` [R,
    chunk] int32 is the side channel.  Returns ``(carry', r_hist [R,
    chunk] int32 or None)``; ``rent_fma`` / ``fetch_fma`` fuse the rent's
    / the fetch's product into its sum (``simulator.xla_acc_fma``,
    ``xla_fetch_fma``).  ``card_calls`` counts its calls on the card (its
    slot loop is what the kernel replaces)."""
    from repro_torch.core.simulator import model1_svc, sim_chunk_core
    if c.is_cuda:
        sim_chunk_table_plain.card_calls += 1
    params = {"pi": pi, "obs": obs, "x_threshold": x_threshold}
    carry, r = sim_chunk_core(table_step, include_final_fetch, params, lv, M,
                              T_len, t0, carry, x, c, model1_svc(x, g), side,
                              rent_fma, fetch_fma)
    return carry, (r if collect_trace else None)


sim_chunk_table_plain.card_calls = 0


def sim_chunk_table_svc_plain(pi, obs, x_threshold, lv, M, T_len, t0: int,
                              carry, x, c, side, svc, svc_cols=None,
                              include_final_fetch: bool = True,
                              collect_trace: bool = True,
                              rent_fma: bool = False,
                              fetch_fma: bool = False):
    """Plain version of kernel S's table variant on a Model-2 service slab
    ``svc`` [R, chunk, K_svc], gathered to the rows' K levels through
    ``svc_cols`` [R, K] int32 when given (other arguments as
    ``sim_chunk_table_plain``; ``card_calls`` as there)."""
    from repro_torch.core.simulator import sim_chunk_core
    if c.is_cuda:
        sim_chunk_table_svc_plain.card_calls += 1
    params = {"pi": pi, "obs": obs, "x_threshold": x_threshold}
    carry, r = sim_chunk_core(table_step, include_final_fetch, params, lv, M,
                              T_len, t0, carry, x, c,
                              gather_svc(svc, svc_cols), side, rent_fma,
                              fetch_fma)
    return carry, (r if collect_trace else None)


sim_chunk_table_svc_plain.card_calls = 0


def _sim_table(name, pi, obs, thr, lv, M, T_len, t0, carry, x, c, side,
               include_final_fetch, collect_trace, g=None, svc=None,
               svc_cols=None):
    """Check the table variant's inputs, under Model 1 (``g``) or on a
    Model-2 slab (``svc``, ``svc_cols``), and launch it on the card."""
    state, acc = carry
    R, K = lv.shape
    chunk = c.shape[1]
    dev = c.device
    if not 2 <= K <= SIM_MAX_K:
        raise ValueError(f"{name} takes 2 <= K <= {SIM_MAX_K}, got {K}")
    if obs not in _OBS_KINDS:
        raise ValueError(f"{name}: obs must be one of {sorted(_OBS_KINDS)}, "
                         f"got {obs!r}")
    S = pi.shape[1] if pi.dim() == 3 else -1
    if not 1 <= S <= TABLE_MAX_S:
        raise ValueError(f"{name} takes 1 <= S <= {TABLE_MAX_S} table rows, "
                         f"got {S}")
    f32, i32 = torch.float32, torch.int32
    ins = [("pi", pi, i32, (R, S, K)), ("lv", lv, f32, (R, K)),
           ("M", M, f32, (R,)), ("T_len", T_len, i32, (R,)),
           ("r", state["r"], i32, (R,)), ("sums", acc["sums"], f32, (R, 3)),
           ("counts", acc["counts"], i32, (R, K)),
           ("x", x, i32, (R, chunk)), ("c", c, f32, (R, chunk))]
    if svc is None:
        ins.append(("g", g, f32, (R, K)))
    if obs == "side":
        ins.append(("side", side, i32, (R, chunk)))
    if obs == "x":
        ins.append(("x_threshold", thr, f32, (R,)))
    for arg in ins:
        _build.check_tensor(*arg, dev)
    Kf = K if svc is None else _check_svc(name, svc, svc_cols, R, chunk, K,
                                          dev, M2_MAX_K)
    # the observation slab the producer stages besides c and x / svc: the
    # side channel, or the arrivals on a Model-2 slab (Model 1 stages x)
    o = side if obs == "side" else (x if obs == "x" and svc is not None
                                    else None)
    new_state = {"r": torch.empty_like(state["r"])}
    new_acc = {k: torch.empty_like(acc[k]) for k in ("sums", "counts")}
    r_hist = (torch.empty((R, chunk), dtype=i32, device=dev)
              if collect_trace else None)
    err = _build.library("hosting").launch_sim_table(
        pi.data_ptr(), _ptr(thr), lv.data_ptr(), _ptr(g), M.data_ptr(),
        T_len.data_ptr(), state["r"].data_ptr(), acc["sums"].data_ptr(),
        acc["counts"].data_ptr(), _ptr(x if svc is None else None),
        c.data_ptr(), _ptr(o), _ptr(svc), _ptr(svc_cols), _OBS_KINDS[obs], S,
        int(t0), chunk, R, K, Kf, int(include_final_fetch),
        new_state["r"].data_ptr(), new_acc["sums"].data_ptr(),
        new_acc["counts"].data_ptr(), _ptr(r_hist), _build.stream(dev))
    _build.raise_on(err, name)
    return (new_state, new_acc), r_hist


def sim_chunk_table(pi, obs, x_threshold, lv, g, M, T_len, t0: int, carry,
                    x, c, side, include_final_fetch: bool = True,
                    collect_trace: bool = True, rent_fma: bool = False,
                    fetch_fma: bool = False):
    """Kernel S's table variant (arguments as ``sim_chunk_table_plain``; 2
    <= K <= 16, tables of 1 or 2 rows), bitwise ``sim_chunk_table_plain``."""
    if c.device.type == "cpu":
        return sim_chunk_table_plain(pi, obs, x_threshold, lv, g, M, T_len,
                                     t0, carry, x, c, side,
                                     include_final_fetch, collect_trace,
                                     rent_fma, fetch_fma)
    out = _sim_table("sim_chunk_table", pi, obs, x_threshold, lv, M, T_len,
                     t0, carry, x, c, side, include_final_fetch,
                     collect_trace or rent_fma or fetch_fma, g=g)
    sim_chunk_table.launches += 1
    return _fused_rent(out, rent_fma, collect_trace, lv, M, T_len, t0,
                       carry[1], c, x=x, g=g, fetch_fma=fetch_fma,
                       include_final_fetch=include_final_fetch)


sim_chunk_table.launches = 0


def sim_chunk_table_svc(pi, obs, x_threshold, lv, M, T_len, t0: int, carry,
                        x, c, side, svc, svc_cols=None,
                        include_final_fetch: bool = True,
                        collect_trace: bool = True, rent_fma: bool = False,
                        fetch_fma: bool = False):
    """Kernel S's table variant on a Model-2 service slab (arguments as
    ``sim_chunk_table_svc_plain``; 2 <= K <= 16 levels, the slab 1 to 32),
    bitwise ``sim_chunk_table_svc_plain``.  ``wide_launches`` counts the
    launches on a wide slab (more than ``DPF_MAX_K`` levels)."""
    if c.device.type == "cpu":
        return sim_chunk_table_svc_plain(pi, obs, x_threshold, lv, M, T_len,
                                         t0, carry, x, c, side, svc, svc_cols,
                                         include_final_fetch, collect_trace,
                                         rent_fma, fetch_fma)
    out = _sim_table("sim_chunk_table_svc", pi, obs, x_threshold, lv, M,
                     T_len, t0, carry, x, c, side, include_final_fetch,
                     collect_trace or rent_fma or fetch_fma, svc=svc,
                     svc_cols=svc_cols)
    sim_chunk_table_svc.launches += 1
    sim_chunk_table_svc.wide_launches += svc.shape[2] > DPF_MAX_K
    return _fused_rent(out, rent_fma, collect_trace, lv, M, T_len, t0,
                       carry[1], c, svc=svc, svc_cols=svc_cols,
                       fetch_fma=fetch_fma,
                       include_final_fetch=include_final_fetch)


sim_chunk_table_svc.launches = 0
sim_chunk_table_svc.wide_launches = 0


# ----------------------------------------------------------------------
# E: schedule_chunk.
# ----------------------------------------------------------------------

def schedule_chunk_plain(lv, M, T_len, t0: int, carry, r, c, x=None, g=None,
                         svc=None, svc_cols=None, acc_fma: bool = False):
    """Plain version of kernel E: the cost of given schedules ``r`` [R,
    chunk] int32 over slots ``[t0, t0 + chunk)``, entered from ``carry[0]``
    [R] int32 (the level held before the chunk) with ``carry[1] = {"sums":
    [R, 3], "counts": [R, K]}``.  Per slot: the fetch ``M * (lv[r_t] -
    lv[prev])^+`` charged on entry, rent ``c_t * lv[r_t]`` and the service
    of ``r_t`` (Model 1: ``x`` [R, chunk] int32 times ``g`` [R, K]; Model
    2: ``svc`` [R, chunk, K_svc] through ``svc_cols`` [R, K]) added to the
    sums slot by slot, zero past the row's horizon ``T_len`` (``acc_fma``:
    the rent's and the fetch's products fused into their adds,
    ``simulator.xla_acc_fma``).
    Returns the carry'.  ``card_calls`` counts its calls on the card."""
    if c.is_cuda:
        schedule_chunk_plain.card_calls += 1
    # the simulator's one-hot selects (imported here: the simulator
    # dispatches to this module, so a top-level import would cycle)
    from repro_torch.core.simulator import _fetch_between, _select, model1_svc
    s = model1_svc(x, g) if svc is None else gather_svc(svc, svc_cols)
    prev, acc = carry
    sums, counts = acc["sums"], acc["counts"]
    levels = torch.arange(lv.shape[1], device=lv.device)[None, :]
    for j in range(r.shape[1]):
        valid = T_len > t0 + j
        r_t = r[:, j]
        onehot_t = levels == r_t[:, None]
        lv_t = _select(onehot_t, lv)
        lv_prev = _select(levels == prev[:, None], lv)
        fetch_t = _fetch_between(M, lv_prev, lv_t)
        rent_t = c[:, j] * lv_t
        svc_cost_t = _select(onehot_t, s[:, j])
        vec = torch.stack([rent_t, svc_cost_t, fetch_t], dim=1)
        new = sums + torch.where(valid[:, None], vec, 0.0)
        if acc_fma:
            new[:, 0] = torch.where(valid, fma32(c[:, j], lv_t, sums[:, 0]),
                                    sums[:, 0])
            new[:, 2] = torch.where(valid, fma32(
                M, torch.clamp_min(lv_t - lv_prev, 0.0), sums[:, 2]),
                sums[:, 2])
        sums = new
        counts = counts + torch.where(valid[:, None], onehot_t.to(torch.int32),
                                      0)
        prev = torch.where(valid, r_t, prev).to(torch.int32)
    return (prev, {"sums": sums, "counts": counts})


schedule_chunk_plain.card_calls = 0


def schedule_chunk(lv, M, T_len, t0: int, carry, r, c, x=None, g=None,
                   svc=None, svc_cols=None, acc_fma: bool = False):
    """Kernel E (arguments as ``schedule_chunk_plain``; K <= 32 levels, a
    Model-2 slab of up to 32), bitwise ``schedule_chunk_plain``."""
    if c.device.type == "cpu":
        return schedule_chunk_plain(lv, M, T_len, t0, carry, r, c, x, g, svc,
                                    svc_cols, acc_fma)
    return _schedule(lv, M, T_len, t0, carry, r, c, x, g, svc, svc_cols,
                     3 if acc_fma else 0)


def _schedule(lv, M, T_len, t0, carry, r, c, x, g, svc, svc_cols, fma):
    """Check kernel E's inputs and launch it; ``fma``: bit 0 fuses the
    rent's products into its sum, bit 1 the fetch's."""
    prev, acc = carry
    R, K = lv.shape
    chunk = c.shape[1]
    dev = c.device
    if not 1 <= K <= DP_MAX_K:
        raise ValueError(f"schedule_chunk takes 1 <= K <= {DP_MAX_K}, "
                         f"got {K}")
    if not 0 <= int(t0) < 2 ** 31:
        raise ValueError(f"t0 must lie in [0, 2**31), got {t0}")
    f32, i32 = torch.float32, torch.int32
    ins = [("lv", lv, f32, (R, K)), ("M", M, f32, (R,)),
           ("T_len", T_len, i32, (R,)), ("prev", prev, i32, (R,)),
           ("sums", acc["sums"], f32, (R, 3)),
           ("counts", acc["counts"], i32, (R, K)),
           ("r", r, i32, (R, chunk)), ("c", c, f32, (R, chunk))]
    if svc is None:
        ins += [("x", x, i32, (R, chunk)), ("g", g, f32, (R, K))]
    for arg in ins:
        _build.check_tensor(*arg, dev)
    Kf = K if svc is None else _check_svc("schedule_chunk", svc, svc_cols, R,
                                          chunk, K, dev, DP_MAX_K)
    prev_out = torch.empty_like(prev)
    new_acc = {k: torch.empty_like(acc[k]) for k in ("sums", "counts")}
    err = _build.library("hosting").launch_schedule(
        lv.data_ptr(), _ptr(None if svc is not None else g), M.data_ptr(),
        T_len.data_ptr(), prev.data_ptr(), acc["sums"].data_ptr(),
        acc["counts"].data_ptr(), r.data_ptr(), c.data_ptr(),
        _ptr(None if svc is not None else x), _ptr(svc), _ptr(svc_cols),
        prev_out.data_ptr(), new_acc["sums"].data_ptr(),
        new_acc["counts"].data_ptr(), R, chunk, K, Kf, int(t0), fma,
        _build.stream(dev))
    _build.raise_on(err, "schedule_chunk")
    schedule_chunk.launches += 1
    return (prev_out, new_acc)


schedule_chunk.launches = 0


def _fused_rent(out, rent_fma, collect_trace, lv, M, T_len, t0, acc_in, c,
                x=None, g=None, svc=None, svc_cols=None,
                fetch_fma: bool = False, include_final_fetch: bool = True):
    """An S chunk's result ``out`` (run with its trace when ``rent_fma``
    or ``fetch_fma``) with, under ``rent_fma``, the rent sum redone with
    each product fused into its add, as the reference's vmapped scan does
    on a small batch (``simulator.xla_acc_fma``): kernel E over S's trace
    from the carried sums, its rent bit only; and under ``fetch_fma``
    (``xla_fetch_fma``) the fetch sum so redone: S's fetch of slot t
    prices the move from its level to the next, which is E's fetch on
    entry over the trace a slot later (the level after the chunk last),
    entered from the chunk's first level, its fetch bit only, the row's
    last slot dropped with the final fetch.  S's other sums and counts
    stand.  Keeping the fused sums out of S keeps S's own loop as it
    was."""
    if not (rent_fma or fetch_fma):
        return out
    (state, acc), r_hist = out
    if rent_fma:
        prev = torch.zeros_like(r_hist[:, 0])
        _, fused = _schedule(lv, M, T_len, t0, (prev, acc_in), r_hist, c, x,
                             g, svc, svc_cols, 1)
        acc["sums"][:, 0] = fused["sums"][:, 0]
    if fetch_fma:
        nxt = torch.cat([r_hist[:, 1:], state["r"][:, None]], 1).contiguous()
        T = T_len if include_final_fetch else T_len - 1
        _, fused = _schedule(lv, M, T, t0, (r_hist[:, 0].contiguous(),
                                            acc_in), nxt, c, x, g, svc,
                             svc_cols, 2)
        acc["sums"][:, 2] = fused["sums"][:, 2]
    return (state, acc), (r_hist if collect_trace else None)
