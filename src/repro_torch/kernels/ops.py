"""Public entry points over the kernels, in the reference's layouts (the
counterparts of ``repro/kernels/ops.py``).  The Pallas wrappers there pad
to block multiples; the CUDA kernels mask their own ragged edges, so
nothing is padded here.

* ``dp_minplus``, ``counter_uniforms``: batched over a leading [R] row
  axis, the kernels' own (the reference vmapped one-instance kernels).
* ``flash_attention``: q [B,S,Hq,hd], k/v [B,Skv,Hkv,hd] (kernel F).
* ``ssd_scan``: x [b,s,nh,dh], dt [b,s,nh], A [nh], B/C [b,s,ng,ds]
  (kernel M).

``KERNELS`` lists the launcher of every CUDA kernel, whose ``launches``
counters a run reads; ``DISPATCHERS`` the wrappers that pick one of two
kernels (F, M) and count the launches of both; ``WIDE`` those that count
their launches on a Model-2 slab of more than 16 levels too; ``ARGS``
those that count the launches writing D's argmin table too; ``MA1`` those
that count their launches at an MA order of 1 too; ``MATRIX`` those that
count their launches on a matrix-``M`` grid too (E); ``W`` those that
count the launches writing only a DP's ``w`` (G); ``PLAIN_ON_CARD`` the
plain code whose calls on the card a run counts.  ``reset_launches`` sets
every counter to 0.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hosting
from repro_torch.kernels import ssd_scan as _ssd


def dp_minplus(J, wck, fetch, valid):
    """One DP forward chunk: ``J`` [R, K], ``wck`` [R, chunk, K], ``fetch``
    [R, K, K], ``valid`` [R, chunk] -> ``(J', args)`` (kernel D on the
    card)."""
    return hosting.dp_minplus(J, wck, fetch, valid)


def counter_uniforms(keys, tids, salt: Optional[int] = None,
                     partitionable: Optional[bool] = None):
    """Counter-keyed uniforms: ``keys`` [R, 2] int64 words, ``tids`` [chunk]
    int32 -> [R, chunk] float32 (kernel P on the card), under the current
    (or the given) threefry layout."""
    return hosting.slot_uniform(keys, tids, salt, partitionable)


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """q [B,S,Hq,hd]; k/v [B,Skv,Hkv,hd] -> [B,S,Hq,hd] (kernel F on the
    card, its plain version on the CPU)."""
    return _fa.flash_attention(q, k, v, causal, q_offset)


def ssd_scan(x, dt, A, B, C, h0=None, chunk: int = 128):
    """Mamba2 SSD: x [b,s,nh,dh]; dt [b,s,nh]; A [nh]; B/C [b,s,ng,ds];
    h0 [b,nh,dh,ds] or None -> (y [b,s,nh,dh], hT) (kernel M on the card,
    its plain version on the CPU)."""
    return _ssd.ssd_scan(x, dt, A, B, C, h0, chunk)


#: every kernel's launcher: P (uniforms, Bernoulli arrivals, uniform
#: rents, NA rents, normals, the GE chunk, the ARMA chunk, Poisson draws,
#: Model-2 service, the shaped uniform of one key), D (fused under Model
#: 1 and Model 2, and on a finished w), B (the DP's backtrack), S
#: (alpha-RR and the table variant, each under Model 1 and Model 2), E
#: (schedule pricing), G (the joint multi-service slab), F (tensor-core
#: and fma), M (tensor-core and fma)
KERNELS = (hosting.slot_uniform, hosting.bernoulli_arrivals_chunk,
           hosting.uniform_rents_chunk, hosting.na_rents_chunk,
           hosting.normal_chunk, hosting.ge_bernoulli_chunk,
           hosting.arma_rents_chunk, hosting.poisson_chunk,
           hosting.model2_service_chunk, hosting.shaped_uniform,
           hosting.dp_fwd_model1,
           hosting.dp_fwd_model2, hosting.dp_minplus, hosting.dp_backtrack,
           hosting.sim_chunk_alpha_rr, hosting.sim_chunk_alpha_rr_svc,
           hosting.sim_chunk_table, hosting.sim_chunk_table_svc,
           hosting.schedule_chunk, hosting.joint_slab,
           _fa.flash_attention_wgmma, _fa.flash_attention_fma,
           _ssd.ssd_scan_mma, _ssd.ssd_scan_fma)
DISPATCHERS = (_fa.flash_attention, _ssd.ssd_scan)
#: the launchers that also count their launches on a wide Model-2 slab
#: (``wide_launches``: more than ``hosting.DPF_MAX_K`` levels; the fused
#: D on such a slab runs as G's ``w`` and D on a finished w, counted in
#: ``joint_slab.w_launches`` and ``dp_minplus.launches``)
WIDE = (hosting.model2_service_chunk, hosting.sim_chunk_alpha_rr_svc,
        hosting.sim_chunk_table_svc)
#: the launchers that also count their launches that write D's argmin
#: table (``args_launches``: the ``ARGS`` route)
ARGS = (hosting.dp_fwd_model1, hosting.dp_fwd_model2)
#: the launchers that also count their launches at an MA order of 1
#: (``ma1_launches``)
MA1 = (hosting.arma_rents_chunk,)
#: the launchers that also count their launches on a matrix-M grid
#: (``matrix_launches``: E's matrix route)
MATRIX = (hosting.schedule_chunk,)
#: the launchers that also count their launches writing only a DP's w
#: (``w_launches``: G's w route)
W = (hosting.joint_slab,)
#: plain code that counts its calls on the card (``card_calls``): the
#: float64 FMA emulation (every plain D and alpha-RR S calls it), the
#: per-slot GE and ARMA loops, the Poisson rounds, the Model-2 counts,
#: the table policies' slot loops, the backtrack's and the schedule
#: pricing's slot loops, which the card's path replaces with kernels
PLAIN_ON_CARD = (hosting.fma32, hosting.ge_bernoulli_chunk_plain,
                 hosting.arma_rents_chunk_plain, hosting.poisson_chunk_plain,
                 hosting.model2_service_chunk_plain,
                 hosting.sim_chunk_table_plain,
                 hosting.sim_chunk_table_svc_plain,
                 hosting.dp_backtrack_plain, hosting.schedule_chunk_plain)


def reset_launches():
    """Set every launch counter (the Poisson launches on Hormann's branch,
    the wide-slab, the argmin-table and the MA(1) launches too), and every
    ``card_calls`` count, to 0."""
    for k in KERNELS + DISPATCHERS:
        k.launches = 0
    for k in WIDE:
        k.wide_launches = 0
    for k in ARGS:
        k.args_launches = 0
    for k in MA1:
        k.ma1_launches = 0
    for k in MATRIX:
        k.matrix_launches = 0
    for k in W:
        k.w_launches = 0
    hosting.reset_poisson_rejection_launches()
    for f in PLAIN_ON_CARD:
        f.card_calls = 0
