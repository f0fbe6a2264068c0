"""The ARMA rents under the nested service axis (B * N = 1, 2 and 4
rows, both layouts: one row's FMA-chain dots) and the joint OPT on them;
schedule pricing on a matrix grid, which fuses nothing on a small batch
where a scalar grid of the shape would, pinned against the reference's
fleet pricing core and ``evaluate_schedule_batch``; bit for bit."""
import numpy as np
import pytest

from repro.core import services as JSV
from repro.core.costs import HostingCosts as JCosts
from repro.core.costs import ServiceSet as JSet
from repro.core.costs import joint_hosting_grid as jjoint_grid
from repro.core.fleet import evaluate_schedule_fleet as jeval_fleet
from repro.core.scenarios.base import materialize as jmaterialize
from repro.core.simulator import evaluate_schedule_batch as jeval_batch
from repro_torch.core import services as SV
from repro_torch.core.costs import HostingCosts, ServiceSet, joint_hosting_grid
from repro_torch.core.fleet import evaluate_schedule_fleet
from repro_torch.core.scenarios.base import materialize
from repro_torch.core.simulator import evaluate_schedule_batch

import _joint_cases as JC
from _service_ref import CPU, FIELDS, LAYOUTS, _both, _same_opt, _scenarios


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("B_inst,N", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_spot_rents_under_the_service_axis(B_inst, N, partitionable):
    """The joint scenario's rents (lane 0's spot rents, ARMA(4, 2)) ==
    the reference's at B * N = 1 (one row: XLA's FMA-chain dots) and at 2
    and 4 rows, under both layouts; and the joint OPT on them."""
    with _both(partitionable):
        jsets = [JC.joint_set(JCosts, JSet, 6)] * B_inst
        psets = [JC.joint_set(HostingCosts, ServiceSet, 6)] * B_inst
        if N == 1:
            jsets = [JSet((s.services[0],)) for s in jsets]
            psets = [ServiceSet((s.services[0],)) for s in psets]
        jsf, psf = JSV.service_fleet(jsets, 200), SV.service_fleet(psets, 200)
        jsc, psc = _scenarios(None, None, B_inst, seed=21, model2=False,
                              rate_h=5.0)
        want = jmaterialize(JSV.joint_scenario(jsf, jsc), 200, chunk_size=64)
        got = materialize(SV.joint_scenario(psf, psc), 200, chunk_size=64)
        for a, b in zip(got, want):
            assert (a is None and b is None) or np.array_equal(
                a, np.asarray(b))
        opt = SV.offline_opt_services(psf, scenario=psc, chunk_size=64,
                                      device=CPU)
        jopt = JSV.offline_opt_services(jsf, scenario=jsc, chunk_size=64)
    _same_opt(opt, jopt)


@pytest.mark.parametrize("R", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("J", [3, 6, 9, 16])
def test_matrix_grid_pricing_fuses_nothing(J, R):
    """Schedule pricing on a matrix grid: the reference's fleet pricing
    core and ``evaluate_schedule_batch`` fuse no product into its sum on a
    small batch (the rent stays two rounded ops; the matrix entry has no
    product), where a scalar grid of the same shape would (R * (K + 4) <=
    40); pinned on random schedules, and the fused rent would differ on
    some of these shapes (``test_matrix_pricing_pin_is_not_vacuous``)."""
    jsets = [_sized_set(JCosts, JSet, J, b) for b in range(R)]
    psets = [_sized_set(HostingCosts, ServiceSet, J, b) for b in range(R)]
    jsf, psf = JSV.service_fleet(jsets, 300), SV.service_fleet(psets, 300)
    rng = np.random.default_rng(R * 100 + J)
    r = rng.integers(0, J, (R, 300)).astype(np.int32)
    rows = R * jsf.N
    jsc, psc = _scenarios(jsf.lane_grid().g, psf.lane_grid(CPU).g, rows,
                          seed=3)
    want = jeval_fleet(jsf.joint_fleet(), r,
                       scenario=JSV.joint_scenario(jsf, jsc), chunk_size=100)
    got = evaluate_schedule_fleet(psf.joint_fleet(CPU), r,
                                  scenario=SV.joint_scenario(psf, psc),
                                  chunk_size=100, device=CPU)
    for f in FIELDS + ["level_slots"]:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
    x = rng.integers(0, 5, (R, 300))
    c = rng.uniform(0.1, 0.9, (R, 300)).astype(np.float32)
    wb = jeval_batch(jjoint_grid(jsets), r, x, c)
    gb = evaluate_schedule_batch(joint_hosting_grid(psets, device=CPU), r, x,
                                 c)
    for f in FIELDS + ["level_slots"]:
        np.testing.assert_array_equal(getattr(gb, f),
                                      np.asarray(getattr(wb, f)), err_msg=f)


def _sized_set(C, SS, J, b):
    """A set of J states, fetch costs varying with the row ``b``."""
    if J == 3:
        return SS((C.three_level(3.0 + b, 0.3, 0.37),))
    if J == 6:
        return SS((C.three_level(3.0 + b, 0.3, 0.37),
                   C.two_level(2.0 + b)))
    if J == 9:
        return SS((C.three_level(3.0 + b, 0.3, 0.37),
                   C.three_level(4.0, 0.45, 0.2)))
    return SS((C(M=5.0 + b, levels=(0.0, 0.2, 0.45, 1.0),
                 g=(1.0, 0.61, 0.33, 0.0)),
               C(M=6.0, levels=(0.0, 0.2, 0.45, 1.0),
                 g=(1.0, 0.61, 0.33, 0.0))))


def test_matrix_pricing_pin_is_not_vacuous():
    """On a matrix grid where the reference fuses nothing, pricing with the
    rent fused (as a scalar grid of the shape would be) differs: the pin
    above can fail."""
    import torch
    from repro_torch.kernels.hosting import schedule_chunk_plain
    R, J, Tn = 8, 6, 3000
    psets = [_sized_set(HostingCosts, ServiceSet, J, b) for b in range(R)]
    g = joint_hosting_grid(psets, device=CPU)
    rng = np.random.default_rng(1)
    # the states of total level 0.3 and 1.3: every rent product inexact
    r = torch.from_numpy(rng.integers(2, 4, (R, Tn)).astype(np.int32))
    c = torch.from_numpy(rng.uniform(0.1, 0.9, (R, Tn)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 5, (R, Tn)).astype(np.int32))
    T_len = torch.full((R,), Tn, dtype=torch.int32)
    outs = []
    for fma in (False, True):
        carry = (torch.zeros(R, dtype=torch.int32),
                 {"sums": torch.zeros((R, 3)),
                  "counts": torch.zeros((R, J), dtype=torch.int32)})
        outs.append(schedule_chunk_plain(g.levels, g.M, T_len, 0, carry, r,
                                         c, x=x, g=g.g, acc_fma=fma))
    assert not torch.equal(outs[0][1]["sums"][:, 0], outs[1][1]["sums"][:, 0])
    assert torch.equal(outs[0][1]["sums"][:, 2], outs[1][1]["sums"][:, 2])
