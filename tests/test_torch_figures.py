"""The port's figure modules against the reference's (``benchmarks/``),
bit for bit in both threefry layouts: every column of every row but the
wall-clock ``_us_per_slot``, the histograms included, at T = 200 with two
seeds; and the port's ``check`` agrees with the reference's on those rows
(both pass or both raise)."""
import importlib

import jax
import pytest

from repro_torch.kernels.hosting import threefry_partitionable

FIGURES = ["fig01_02_alpha_sweep", "fig03_06_m_p_sweeps",
           "fig07_08_multiple_rr", "fig10_11_trace",
           "fig12_15_poisson_model2", "fig17_22_markov_mdp"]


def _check(mod, rows):
    try:
        mod.check(rows)
        return True
    except AssertionError:
        return False


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("name", FIGURES)
def test_figure_rows_match_the_reference(name, partitionable):
    ref = importlib.import_module(f"benchmarks.{name}")
    got = importlib.import_module(f"repro_torch.figures.{name}")
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        want = ref.run(T=200, n_seeds=2)
        rows = got.run(T=200, n_seeds=2, device="cpu")
    assert len(rows) == len(want) > 0
    for r, w in zip(rows, want):
        assert set(r) == set(w)
        for k in w:
            if k != "_us_per_slot":
                assert r[k] == w[k], (k, r[k], w[k])
    assert _check(got, rows) == _check(ref, want)
    assert _check(got, want) == _check(ref, want)
