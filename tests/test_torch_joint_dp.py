"""The joint OPT of a mixed service fleet (J = 6, 16 and 17 padded to
17) == the reference's ``offline_opt_services`` on every DP route
(materialised, checkpointed, cost only, streamed with seed replicas),
Model 1 and Model 2, both threefry layouts, in ``cost``, ``r_hist`` and
``sim``, bit for bit."""
import pytest

from repro.core import services as JSV
from repro_torch.core import services as SV
from _service_ref import CPU, LAYOUTS, ROUTES, _both, _joint_pair, _same_opt


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("model2", [True, False])
@pytest.mark.parametrize("route", list(ROUTES))
def test_joint_dp_matches_the_reference(route, model2, partitionable):
    """``offline_opt_services`` of a mixed fleet (J = 6, 16 and 17 padded
    to 17: the fused D's and the wide route's sides on the card) == the
    reference's in ``cost``, ``r_hist`` and ``sim``."""
    with _both(partitionable):
        jsf, psf, jsc, psc = _joint_pair([6, 16, 17], 40, model2)
        kw = dict(chunk_size=16, **ROUTES[route])
        got = SV.offline_opt_services(psf, scenario=psc, device=CPU, **kw)
        want = JSV.offline_opt_services(jsf, scenario=jsc, **kw)
    _same_opt(got, want)
