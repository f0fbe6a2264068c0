"""The service axis' shared test cases on both packages: the reference's
and the port's scenarios on the same keys, the N = 1 / N = 2 fleets, the
joint-state fleets of ``_joint_cases`` and the comparisons of two joint
OPT results (the JAX side, so ``test_torch_cuda.py`` does not import it)."""
import contextlib

import numpy as np
import jax

from repro.core import scenarios as js
from repro.core import services as JSV
from repro.core.costs import HostingCosts as JCosts
from repro.core.costs import HostingGrid as JGrid
from repro.core.costs import ServiceSet as JSet
from repro.core.fleet import FleetBatch as JFleetBatch
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.core import services as SV
from repro_torch.core.costs import HostingCosts, HostingGrid, ServiceSet
from repro_torch.core.fleet import FleetBatch
from repro_torch.kernels.hosting import threefry_partitionable

import _joint_cases as JC

CPU = "cpu"
LAYOUTS = [True, False]
T = 48
B = 3
HORIZONS = [48, 40, 48]
FIELDS = ["total", "rent", "service", "fetch"]


def _costs(C):
    return [C.two_level(4.0), C.three_level(6.0, 0.3, 0.2),
            C(M=10.0, levels=(0.0, 0.3, 0.4, 0.5, 1.0),
              g=(1.0, 0.4, 0.3, 0.15, 0.0))]


def _pk(key):
    return tree_from_numpy(np.asarray(key), CPU)


def _both(part):
    stack = contextlib.ExitStack()
    stack.enter_context(jax.threefry_partitionable(part))
    stack.enter_context(threefry_partitionable(part))
    return stack


def _scenarios(g_ref, g_port, rows, seed=42, model2=True, rate_h=2.0):
    """The reference's scenario and the port's on the same keys: GE
    arrivals, spot rents and (``model2``) Model-2 service of up to 6
    requests a slot priced on ``g``."""
    k = jax.random.split(jax.random.PRNGKey(seed), rows)
    ref = [js.ge_arrivals(k, 0.3, 0.2, rate_h, 0.2, rows),
           js.spot_rents(jax.random.PRNGKey(seed + 1), 0.5, rows)]
    got = [ps.ge_arrivals(_pk(k), 0.3, 0.2, rate_h, 0.2, rows, device=CPU),
           ps.spot_rents(_pk(jax.random.PRNGKey(seed + 1)), 0.5, rows,
                         device=CPU)]
    if not model2:
        return js.combine(*ref), ps.combine(*got)
    kv = jax.random.PRNGKey(seed + 2)
    return (js.combine(*ref, svc=js.model2_service(kv, g_ref, rows,
                                                   max_per_slot=6)),
            ps.combine(*got, svc=ps.model2_service(_pk(kv), g_port, rows, 6,
                                                   device=CPU)))


def _env():
    """The single-service fleet, its N = 1 service fleet and a mixed-K N =
    2 capacity-bound fleet, reference and port, and their scenarios (the
    current layout's keys)."""
    jc, pc = _costs(JCosts), _costs(HostingCosts)
    jgrid = JGrid.from_costs(jc)
    pgrid = HostingGrid.from_costs(pc, device=CPU)
    e = {"jfleet": JFleetBatch.for_scenario(jgrid, HORIZONS),
         "pfleet": FleetBatch.for_scenario(pgrid, HORIZONS),
         "jsf1": JSV.service_fleet([JSet((cc,)) for cc in jc], HORIZONS),
         "psf1": SV.service_fleet([ServiceSet((cc,)) for cc in pc],
                                  HORIZONS)}
    e["jsc"], e["psc"] = _scenarios(jgrid.g, pgrid.g, B)
    e["jsf2"] = JSV.service_fleet([JSet((jc[0], jc[1]), capacity=1.0),
                                   JSet((jc[1], jc[2]), capacity=1.0)], 32)
    e["psf2"] = SV.service_fleet([ServiceSet((pc[0], pc[1]), capacity=1.0),
                                  ServiceSet((pc[1], pc[2]), capacity=1.0)],
                                 32)
    e["jsc2"], e["psc2"] = _scenarios(e["jsf2"].lane_grid().g,
                                      e["psf2"].lane_grid(CPU).g, 4, seed=11)
    return e


def _equal_fields(got, ref, label=""):
    for f in FIELDS + ["r_hist"]:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{label} {f}")


def _joint_pair(J_list, T_len, model2, seed=7, rate_h=5.0):
    jsets = [JC.joint_set(JCosts, JSet, J) for J in J_list]
    psets = [JC.joint_set(HostingCosts, ServiceSet, J) for J in J_list]
    jsf, psf = (JSV.service_fleet(jsets, T_len),
                SV.service_fleet(psets, T_len))
    rows = jsf.B * jsf.N if model2 else jsf.B
    jsc, psc = _scenarios(jsf.lane_grid().g, psf.lane_grid(CPU).g, rows,
                          seed=seed, model2=model2, rate_h=rate_h)
    return jsf, psf, jsc, psc


def _same_opt(got, want):
    np.testing.assert_array_equal(got.cost, np.asarray(want.cost))
    if want.joint.r_hist is None:
        assert got.joint.r_hist is None
        return
    np.testing.assert_array_equal(got.joint.r_hist, want.joint.r_hist)
    np.testing.assert_array_equal(got.service_schedules(),
                                  want.service_schedules())
    for f in FIELDS + ["level_slots"]:
        np.testing.assert_array_equal(getattr(got.joint.sim, f),
                                      np.asarray(getattr(want.joint.sim, f)),
                                      err_msg=f)


ROUTES = {"materialised": dict(),
          "checkpointed": dict(checkpointed=True),
          "cost-only": dict(checkpointed=True, collect_schedule=False),
          "stream": dict(checkpointed=True, stream=True, n_seeds=2)}
