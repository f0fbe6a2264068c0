"""The port's numpy copy of ``core/geolife.py`` against the reference: the
synthetic city, its shortest-path database, the knapsack order and the
g(alpha) curve of Figs 23-25 and ``beyond_knapsack_levels`` are equal,
element for element."""
import numpy as np
import pytest

from repro.core import geolife as jg
from repro_torch.core import geolife as pg


@pytest.mark.parametrize("seed", [0, 1])
def test_city_and_path_db_match_the_reference(seed):
    want, got = jg.make_city(12, seed=seed), pg.make_city(12, seed=seed)
    assert got.n_nodes == want.n_nodes
    assert got.adj == want.adj
    lm_w = jg.city_landmarks(want, 100, seed=seed + 100)
    lm_g = pg.city_landmarks(got, 100, seed=seed + 100)
    assert np.array_equal(lm_g, lm_w)
    q_w = jg.sample_queries(want, 300, seed=seed + 1, landmarks=lm_w)
    q_g = pg.sample_queries(got, 300, seed=seed + 1, landmarks=lm_g)
    assert np.array_equal(q_g, q_w)
    db_w, db_g = jg.build_path_db(want, q_w), pg.build_path_db(got, q_g)
    assert len(db_g.paths) == len(db_w.paths) > 0
    assert all(np.array_equal(a, b) for a, b in zip(db_g.paths, db_w.paths))
    assert db_g.node_sets == db_w.node_sets
    assert np.array_equal(db_g.sizes, db_w.sizes)
    assert db_g.total_nodes == db_w.total_nodes
    assert np.array_equal(pg.knapsack_order(db_g, q_g),
                          jg.knapsack_order(db_w, q_w))
    s, d = (int(v) for v in q_w[0])
    assert pg.hit(db_g.node_sets, s, d, range(3)) == \
        jg.hit(db_w.node_sets, s, d, range(3))


@pytest.mark.parametrize("seed", [0, 1])
def test_gcurve_from_city_matches_the_reference(seed):
    kw = dict(n_side=12, n_train=1200, n_test=400, seed=seed)
    want, got = jg.gcurve_from_city(**kw), pg.gcurve_from_city(**kw)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)
