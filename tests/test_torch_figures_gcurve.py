"""The port's g-curve modules (``fig23_25_geolife``,
``beyond_knapsack_levels``) against the reference's (``benchmarks/``),
bit for bit in both threefry layouts: every column of every row but the
wall-clock ``_us_per_slot``, at T = 200 with two seeds; and the port's
``check`` agrees with the reference's on those rows (both pass or both
raise).  ``beyond_knapsack_levels`` runs on a 31-level Model-2 slab; its
service stream is held at 31 levels on its own too."""
import importlib

import jax
import numpy as np
import pytest

from repro.core import scenarios as js
from repro_torch.convert import tree_from_numpy
from repro_torch.core import scenarios as ps
from repro_torch.kernels.hosting import threefry_partitionable

FIGURES = ["fig23_25_geolife", "beyond_knapsack_levels"]


def _check(mod, rows):
    try:
        mod.check(rows)
        return True
    except AssertionError:
        return False


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("name", FIGURES)
def test_gcurve_rows_match_the_reference(name, partitionable):
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


@pytest.mark.parametrize("partitionable", [True, False])
def test_wide_service_slab_matches_the_reference(partitionable):
    """The Model-2 service stream on 31 unsorted levels (0.0 and 1.0
    among them; row 1 a reversed copy of row 0) at 1 and 3 requests a slot
    at most, materialised in chunks of 64, bitwise the reference's
    ``_model2_chunk_fn`` stream."""
    rng = np.random.default_rng(11)
    g = rng.random((2, 31)).astype(np.float32)
    g[:, 0], g[:, 7] = 1.0, 0.0
    g[1] = g[0, ::-1]
    kx, ks = jax.random.split(jax.random.PRNGKey(4), 2)
    with jax.threefry_partitionable(partitionable), \
            threefry_partitionable(partitionable):
        x, _ = js.materialize_stream(js.poisson_arrivals(kx, 1.5, 2), 150)
        x = np.asarray(x)
        for n_max in (1, 3):
            want = np.asarray(js.materialize_stream(
                js.model2_service(ks, g, 2, n_max), 150, x=x))
            got = ps.materialize_stream(
                ps.model2_service(tree_from_numpy(np.asarray(ks), "cpu"), g,
                                  2, n_max, device="cpu"), 150, 64, x=x)
            assert got.shape == want.shape == (2, 150, 31)
            assert want[0, :, 0].sum() > 0 and want[0, :, 7].sum() == 0
            assert np.array_equal(got, want), n_max
