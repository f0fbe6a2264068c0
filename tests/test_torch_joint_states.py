"""The joint OPT == the reference's ``offline_opt_services`` at every
joint-state count of ``tests/_joint_cases.py`` (J = 1 to 36: the fused
D's edge at 16 / 17, D on a finished w's at 32 and past it), Model 1 and
Model 2, materialised with its schedule, bit for bit."""
import pytest

from repro.core import services as JSV
from repro_torch.core import services as SV

import _joint_cases as JC
from _service_ref import CPU, _joint_pair, _same_opt


@pytest.mark.parametrize("model2", [True, False])
@pytest.mark.parametrize("J", JC.JS)
def test_joint_dp_matches_the_reference_at_each_j(J, model2):
    """J = 1 to 36 states (one set a fleet of 2): the joint DP == the
    reference's, materialised with its schedule."""
    jsf, psf, jsc, psc = _joint_pair([J, J], 24, model2, seed=J)
    got = SV.offline_opt_services(psf, scenario=psc, chunk_size=10,
                                  device=CPU)
    want = JSV.offline_opt_services(jsf, scenario=jsc, chunk_size=10)
    _same_opt(got, want)
