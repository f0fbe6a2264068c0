"""Multi-service sets with a given joint-state count J, for the service
axis' tests: the same set built from either package's ``HostingCosts`` /
``ServiceSet`` (pass the classes), and a numpy-made joint slab case for
kernel G.  J = 1 (only all-off fits), 3 (one service), 6, 16 and 17 (the fused D's edge),
19 (four three-level services at capacity 1, ``chip_smoke.py``'s wide
leg), 27 and 32 (D on a finished w's edge) and 36 (past it)."""
import numpy as np


def _k3(C, M, alpha, g_alpha):
    return C.three_level(M, alpha, g_alpha)


def _k4(C, M):
    return C(M=M, levels=(0.0, 0.2, 0.45, 1.0), g=(1.0, 0.61, 0.33, 0.0))


def _k5(C, M):
    return C(M=M, levels=(0.0, 0.1, 0.3, 0.55, 1.0),
             g=(1.0, 0.8, 0.5, 0.21, 0.0))


# J: (services of the classes C, capacity)
_SETS = {
    1: (lambda C: tuple(C.two_level(2.0 + n) for n in range(4)), 0.75),
    3: (lambda C: (_k3(C, 3.0, 0.3, 0.37),), None),
    6: (lambda C: (_k3(C, 3.0, 0.3, 0.37), _k3(C, 4.0, 0.3, 0.4)), 1.0),
    16: (lambda C: (_k4(C, 5.0), _k4(C, 6.0)), None),
    17: (lambda C: (_k5(C, 5.0), _k5(C, 7.0)), 1.0),
    19: (lambda C: tuple(_k3(C, 4.0 + n, 0.3, 0.4) for n in range(4)), 1.0),
    27: (lambda C: (_k3(C, 3.0, 0.3, 0.37), _k3(C, 4.0, 0.5, 0.2),
                    _k3(C, 5.0, 0.25, 0.6)), None),
    32: (lambda C: tuple(_k3(C, 4.0 + n, 0.3, 0.4) for n in range(4)), 1.5),
    36: (lambda C: (_k3(C, 3.0, 0.3, 0.37), _k4(C, 4.0),
                    _k3(C, 5.0, 0.25, 0.6)), None),
}
JS = tuple(_SETS)


def joint_set(C, SS, J):
    """The ``ServiceSet`` (classes ``SS`` of ``HostingCosts`` ``C``) whose
    joint-state count is J."""
    services, cap = _SETS[J]
    ss = SS(services(C), capacity=cap)
    assert ss.J == J, (J, ss.J)
    return ss


def joint_slab_case(R_inst, N, chunk, K, J, model2, seed, side=True):
    """Kernel G's inputs in numpy: ``x`` [R_inst * N, chunk] int32 (0 ..
    9), ``c`` rents, ``side`` (-1 .. 2, or None), a Model-2 sub-slab
    ``svc`` [R_inst * N, chunk, K] of counts on a half-integer grid (with
    ``model2``; else None and ``g_lane`` [R_inst, N, J] in (0, 1)), and
    ``idx`` [R_inst, N, J] levels in [0, K)."""
    rng = np.random.default_rng(seed)
    BN = R_inst * N
    x = rng.integers(0, 10, (BN, chunk)).astype(np.int32)
    c = rng.random((BN, chunk)).astype(np.float32)
    sd = rng.integers(-1, 3, (BN, chunk)).astype(np.int32) if side else None
    idx = rng.integers(0, K, (R_inst, N, J)).astype(np.int32)
    if model2:
        svc = (rng.integers(0, 13, (BN, chunk, K)) / 2).astype(np.float32)
        return x, c, sd, svc, None, idx
    g_lane = rng.random((R_inst, N, J)).astype(np.float32)
    return x, c, sd, None, g_lane, idx
