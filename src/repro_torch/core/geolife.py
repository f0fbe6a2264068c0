"""Shortest-path query service and its g(alpha) curve (paper §7.2; a numpy
copy of ``repro/core/geolife.py``: the port keeps its own, since it imports
nothing of the JAX package).

The paper builds a navigation service from the Geolife GPS trajectories:
queries are (source, destination) pairs; the service's database is the set
of all shortest paths; hosting a fraction of the database at the edge lets
the edge answer a query iff both endpoints lie on a cached path.  Cache
contents are chosen greedily by *normalised hit rate* (hits per node of
path length) — a fractional-knapsack policy — using the first three years
of queries; the served-fraction curve is evaluated on the fourth year.

The Geolife archive is not available offline, so the pipeline runs on a
synthetic city: a perturbed grid road network with random edge weights
and Zipf-popular landmark endpoints, Dijkstra shortest paths, the same
normalised-hit-rate knapsack, and a train/test split.  It is host code on
purpose (Dijkstra and the greedy knapsack are a host pipeline in the
reference too); every draw is numpy's ``default_rng``, so the port's curve
is the reference's float for float.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class RoadNetwork:
    n_nodes: int
    adj: list                     # adj[u] = list[(v, w)]


def make_city(n_side: int = 20, seed: int = 0, drop: float = 0.1) -> RoadNetwork:
    """Perturbed grid with random weights; ``drop`` fraction of edges removed
    (one-way streets / rivers) while keeping connectivity likely."""
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    adj = [[] for _ in range(n)]

    def nid(i, j):
        return i * n_side + j

    for i in range(n_side):
        for j in range(n_side):
            for di, dj in ((0, 1), (1, 0)):
                ii, jj = i + di, j + dj
                if ii < n_side and jj < n_side and rng.random() > drop:
                    w = float(rng.uniform(0.5, 2.0))
                    adj[nid(i, j)].append((nid(ii, jj), w))
                    adj[nid(ii, jj)].append((nid(i, j), w))
    return RoadNetwork(n, adj)


def dijkstra_path(net: RoadNetwork, src: int, dst: int):
    dist = {src: 0.0}
    prev = {}
    pq = [(0.0, src)]
    seen = set()
    while pq:
        d, u = heapq.heappop(pq)
        if u in seen:
            continue
        seen.add(u)
        if u == dst:
            break
        for v, w in net.adj[u]:
            nd = d + w
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                prev[v] = u
                heapq.heappush(pq, (nd, v))
    if dst not in seen:
        return None
    path = [dst]
    while path[-1] != src:
        path.append(prev[path[-1]])
    return path[::-1]


def city_landmarks(net: RoadNetwork, n_landmarks: int = 30, seed: int = 100):
    """The city's fixed popular places — shared by every 'year' of queries
    (the paper's train/test years see the same city)."""
    rng = np.random.default_rng(seed)
    return rng.choice(net.n_nodes, size=n_landmarks, replace=False)


def sample_queries(net: RoadNetwork, n_queries: int, seed: int = 1,
                   zipf_s: float = 0.8, landmarks=None, n_landmarks: int = 100):
    """Queries with Zipf-popular landmark endpoints (commuting patterns)."""
    rng = np.random.default_rng(seed)
    if landmarks is None:
        landmarks = city_landmarks(net, n_landmarks)
    n_landmarks = len(landmarks)
    p = 1.0 / np.arange(1, n_landmarks + 1) ** zipf_s
    p /= p.sum()
    src = landmarks[rng.choice(n_landmarks, size=n_queries, p=p)]
    dst = landmarks[rng.choice(n_landmarks, size=n_queries, p=p)]
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=1)


@dataclasses.dataclass
class PathDB:
    paths: list                   # list[np.ndarray] of node ids
    node_sets: list               # list[frozenset]
    sizes: np.ndarray             # nodes per path
    total_nodes: int


def build_path_db(net: RoadNetwork, queries: np.ndarray) -> PathDB:
    """One shortest path per distinct query (the service database)."""
    seen = {}
    paths, sets = [], []
    for s, d in queries:
        key = (int(s), int(d))
        if key in seen:
            continue
        p = dijkstra_path(net, int(s), int(d))
        if p is None:
            continue
        seen[key] = len(paths)
        paths.append(np.asarray(p))
        sets.append(frozenset(p))
    sizes = np.array([len(p) for p in paths], np.int64)
    return PathDB(paths, sets, sizes, int(sizes.sum()))


def hit(db_sets, s, d, cached_idx) -> bool:
    for i in cached_idx:
        st = db_sets[i]
        if s in st and d in st:
            return True
    return False


def knapsack_order(db: PathDB, train_queries: np.ndarray) -> np.ndarray:
    """Greedy order by normalised hit rate = (#train hits on path)/(#nodes)."""
    hits = np.zeros(len(db.paths), np.float64)
    for s, d in train_queries:
        for i, st in enumerate(db.node_sets):
            if s in st and d in st:
                hits[i] += 1.0
    score = hits / np.maximum(db.sizes, 1)
    return np.argsort(-score)


def gcurve_from_city(n_side: int = 16, n_train: int = 3000, n_test: int = 1000,
                     alphas=None, seed: int = 0):
    """End-to-end §7.2 pipeline; returns (alphas, g_values, cache order).

    alpha is measured as cached-nodes / total-db-nodes, exactly as the paper
    measures cache size."""
    if alphas is None:
        alphas = np.linspace(0.05, 1.0, 20)
    net = make_city(n_side, seed=seed)
    lm = city_landmarks(net, n_landmarks=100, seed=seed + 100)
    train_q = sample_queries(net, n_train, seed=seed + 1, landmarks=lm)
    test_q = sample_queries(net, n_test, seed=seed + 2, landmarks=lm)
    db = build_path_db(net, train_q)
    order = knapsack_order(db, train_q)
    csize = np.cumsum(db.sizes[order])
    gs = []
    # precompute per-test-query the first cache rank that serves it
    first_rank = np.full(len(test_q), np.inf)
    for qi, (s, d) in enumerate(test_q):
        for rank, i in enumerate(order):
            st = db.node_sets[i]
            if s in st and d in st:
                first_rank[qi] = rank
                break
    for a in alphas:
        budget = a * db.total_nodes
        k = int(np.searchsorted(csize, budget, side="right"))  # paths cached
        served = float(np.mean(first_rank < k))
        gs.append(1.0 - served)
    return np.asarray(alphas), np.asarray(gs), order
