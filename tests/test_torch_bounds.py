"""The port's numpy copy of ``core/bounds.py`` against the reference on a
handful of costs: every closed form returns the same float."""
import math

import numpy as np
import pytest

from repro.core import bounds as jb
from repro.core.costs import HostingCosts as JCosts
from repro_torch.core import bounds as pb
from repro_torch.core.costs import HostingCosts

CASES = [  # (M, alpha, g(alpha), c_min, c_max)
    (10.0, 0.4, 0.3, 0.07, 1.05), (10.0, 0.239, 0.38, 0.07, 1.05),
    (2.0, 0.5, 0.7, 0.1, 1.5), (40.0, 0.3, 0.4, 1.2, 3.0),
    (5.0, 0.2, 0.9, 0.5, 2.0), (1.5, 0.6, 0.1, 0.01, 0.9)]


@pytest.mark.parametrize("case", CASES)
def test_bounds_match_the_reference(case):
    M, a, g, lo, hi = case
    jc = JCosts.three_level(M, a, g, c_min=lo, c_max=hi)
    pc = HostingCosts.three_level(M, a, g, c_min=lo, c_max=hi)
    assert (pc.alpha, pc.g_alpha) == (jc.alpha, jc.g_alpha)
    assert pc.assumption6_holds() == jc.assumption6_holds()
    for fn in ("thm1_no_partial", "thm2_is_optimal_regime",
               "thm2_ratio_upper", "thm4_lower", "thm4_lower_no_partial"):
        assert getattr(pb, fn)(pc) == getattr(jb, fn)(jc), fn
    if jc.assumption6_holds():
        assert pb.corollary3_six(pc) == jb.corollary3_six(jc)
    for p, c in ((0.35, 0.35), (0.1, 0.6), (0.9, 0.2), (0.42, 0.5)):
        assert pb.lemma14_opt_on_per_slot(pc, p, c) == \
            jb.lemma14_opt_on_per_slot(jc, p, c)
        for den in ("printed", "proof"):
            a_, b_ = (m.thm5_sigma_upper(cc, p, c, denominator=den)
                      for m, cc in ((pb, pc), (jb, jc)))
            assert a_ == b_ or (math.isinf(a_) and math.isinf(b_))
    # a two-level instance has no alpha: both return the same or refuse
    assert _outcome(pb.thm4_lower_no_partial,
                    HostingCosts.two_level(M, lo, hi)) == \
        _outcome(jb.thm4_lower_no_partial, JCosts.two_level(M, lo, hi))


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return str(e)


def test_the_case_functions_match_inside_and_refuse_outside():
    # (lambda, M, p, c, alpha, g, c_min, c_max): each of the three case
    # regions, and points outside them
    for args in ((1.5, 10.0, 0.6, 0.35, 0.4, 0.3, 0.07, 1.05),
                 (1.5, 10.0, 0.9, 0.35, 0.4, 0.3, 0.07, 1.05),
                 (1.5, 10.0, 0.1, 0.35, 0.4, 0.3, 0.07, 1.05),
                 (2.0, 10.0, 0.2, 0.35, 0.4, 0.3, 0.07, 1.05),
                 (1.2, 20.0, 0.3, 0.35, 0.2, 0.4, 0.07, 1.05)):
        for fn in ("f_fn", "q_fn", "h_fn"):
            got = _outcome(getattr(pb, fn), *args)
            assert got == _outcome(getattr(jb, fn), *args), (fn, args)
            assert isinstance(got, str) or np.isfinite(got)
