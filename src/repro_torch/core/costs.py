"""Cost model for partial service hosting (Section 2.6 of the paper): the
port of ``repro/core/costs.py``.

Levels are a strictly increasing tuple ``levels = (0, a_1, ..., 1)`` with a
matching non-increasing service-cost tuple ``g = (1, g(a_1), ..., 0)``.
Per-slot cost of holding level ``r`` in slot ``t`` and switching to ``r'``:

    C_t = M * (r' - r)^+  +  c_t * r  +  svc_t(r)

``HostingCosts`` is a plain host-side description of one instance;
``HostingGrid`` stacks B of them into float32 tensors on a device, padded
to a common K; the per-slot cost pieces (``fetch_cost`` ..
``per_slot_cost_matrix``) are the reference's, vectorised over the level
axis.

``ServiceSet`` is N services sharing one edge's storage under a capacity on
the sum of their hosted fractions (arXiv 2107.10446): its feasible joint
states become the states of a ``HostingGrid`` whose ``M`` is an explicit
[B, J, J] fetch matrix (``joint_hosting_grid``), which the offline DP and
schedule pricing take as they take a scalar ``M``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device


def default_float_dtype() -> torch.dtype:
    """The float dtype of the cost model: float32.  The reference runs
    float64 under ``jax_enable_x64``; the port has no x64 path yet, so a
    float64 default dtype raises (ROADMAP.md, Queue 1 item 1)."""
    if torch.get_default_dtype() == torch.float64:
        raise NotImplementedError(
            "the port is float32 only; the x64 path comes with ROADMAP.md, "
            "Queue 1 item 1")
    return torch.float32


@dataclasses.dataclass(frozen=True)
class HostingCosts:
    """Static cost parameters of one hosting problem instance.

    Attributes:
      M: fetch cost for the full service (Assumption 5: ``M > 1``).
      levels: hosting levels, ascending, ``levels[0] == 0``, ``levels[-1] == 1``.
      g: service cost per request at each level, ``g[0] == 1``, ``g[-1] == 0``.
      c_min / c_max: rent-cost bounds (Assumption 3).
    """

    M: float
    levels: Tuple[float, ...]
    g: Tuple[float, ...]
    c_min: float = 0.0
    c_max: float = float("inf")

    def __post_init__(self):
        if len(self.levels) != len(self.g):
            raise ValueError("levels and g must have equal length")
        if len(self.levels) < 2:
            raise ValueError("need at least levels (0, 1)")
        lv = np.asarray(self.levels, dtype=np.float64)
        gv = np.asarray(self.g, dtype=np.float64)
        if not (lv[0] == 0.0 and abs(lv[-1] - 1.0) < 1e-12):
            raise ValueError(f"levels must span [0, 1], got {self.levels}")
        if np.any(np.diff(lv) <= 0):
            raise ValueError("levels must be strictly increasing")
        if not (abs(gv[0] - 1.0) < 1e-12 and abs(gv[-1]) < 1e-12):
            raise ValueError("g must have g(0)=1 and g(1)=0")
        if np.any(np.diff(gv) > 1e-12):
            raise ValueError("g must be non-increasing in the hosted fraction")

    @staticmethod
    def three_level(M: float, alpha: float, g_alpha: float,
                    c_min: float = 0.0,
                    c_max: float = float("inf")) -> "HostingCosts":
        """The paper's Assumption-4 setting: r in {0, alpha, 1}."""
        return HostingCosts(M=M, levels=(0.0, float(alpha), 1.0),
                            g=(1.0, float(g_alpha), 0.0), c_min=c_min,
                            c_max=c_max)

    @staticmethod
    def two_level(M: float, c_min: float = 0.0,
                  c_max: float = float("inf")) -> "HostingCosts":
        """No partial hosting (the RR / OPT setting of [22])."""
        return HostingCosts(M=M, levels=(0.0, 1.0), g=(1.0, 0.0),
                            c_min=c_min, c_max=c_max)

    @property
    def K(self) -> int:
        return len(self.levels)

    @property
    def alpha(self) -> float:
        """The (single) intermediate level; only defined for the 3-level
        case."""
        if self.K != 3:
            raise ValueError("alpha only defined for 3-level instances")
        return self.levels[1]

    @property
    def g_alpha(self) -> float:
        if self.K != 3:
            raise ValueError("g_alpha only defined for 3-level instances")
        return self.g[1]

    def assumption6_holds(self) -> bool:
        """M > max{1, (1 - g(alpha)) / alpha} (Assumption 6)."""
        if self.K != 3:
            return self.M > 1.0
        return self.M > max(1.0, (1.0 - self.g_alpha) / self.alpha)


@dataclasses.dataclass(frozen=True)
class HostingGrid:
    """B hosting instances stacked into float32 tensors, padded to a common K.

    Instance ``i`` with ``K_i`` levels occupies columns ``[0, K_i)``; columns
    ``[K_i, K)`` repeat the top level (``levels=1.0, g=0.0``) and are
    ``False`` in ``mask``, so the policies and the DP never select them.

    Attributes:
      M:      [B]    fetch costs -- or [B, K, K] explicit fetch matrices
              (joint multi-service grids).
      levels: [B, K] hosting levels (padded).
      g:      [B, K] service costs per level (padded).
      mask:   [B, K] True on real levels.

    With a matrix ``M``, entry ``M[b, j, j']`` is the fetch cost of the
    transition j -> j' instead of ``M * (lv[j'] - lv[j])^+``: the joint
    grids of ``ServiceSet``, whose ``levels`` hold each joint state's total
    hosted fraction (so the rent ``c_t * levels[j]`` prices the whole
    edge).  The offline DP and schedule pricing take such grids; the
    online policies need the rank-one form and refuse them (run each
    service as its own fleet lane instead, ``core.services``).
    """

    M: torch.Tensor
    levels: torch.Tensor
    g: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def from_costs(costs_list: Sequence[HostingCosts], K: Optional[int] = None,
                   device=None) -> "HostingGrid":
        """Stack per-instance ``HostingCosts``, padding to max K (or to
        ``K=``, which must be >= every instance's K)."""
        if not costs_list:
            raise ValueError("need at least one instance")
        dev = resolve_device(device)
        K_min = max(cc.K for cc in costs_list)
        K = K_min if K is None else int(K)
        if K < K_min:
            raise ValueError(f"K={K} < max instance K {K_min}")
        B = len(costs_list)
        M = np.zeros((B,), np.float64)
        lv = np.ones((B, K), np.float64)
        g = np.zeros((B, K), np.float64)
        mask = np.zeros((B, K), bool)
        for i, cc in enumerate(costs_list):
            M[i] = cc.M
            lv[i, :cc.K] = cc.levels
            g[i, :cc.K] = cc.g
            mask[i, :cc.K] = True
        f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        return HostingGrid(M=f32(M), levels=f32(lv), g=f32(g),
                           mask=torch.from_numpy(mask).to(dev))

    @property
    def B(self) -> int:
        return self.levels.shape[0]

    @property
    def K(self) -> int:
        return self.levels.shape[1]

    @property
    def matrix_m(self) -> bool:
        """Whether ``M`` holds explicit [K, K] fetch matrices."""
        return self.M.dim() > 1

    @property
    def device(self) -> torch.device:
        return self.levels.device

    def to(self, device) -> "HostingGrid":
        return HostingGrid(*(t.to(device) for t in
                             (self.M, self.levels, self.g, self.mask)))

    def repeat_rows(self, S: int) -> "HostingGrid":
        """Each instance's row repeated ``S`` times (instance-major)."""
        return HostingGrid(*(t.repeat_interleave(S, dim=0) for t in
                             (self.M, self.levels, self.g, self.mask)))

    def k_eff(self) -> torch.Tensor:
        """[B] number of real levels per instance."""
        return self.mask.to(torch.int32).sum(dim=1, dtype=torch.int32)

    def top_index(self) -> torch.Tensor:
        """[B] index of each instance's real top level (``levels == 1``)."""
        return self.k_eff() - 1

    def restrict_to_endpoints(self) -> "HostingGrid":
        """The no-partial-hosting (RetroRenting / OPT) view: levels (0, 1)
        for every instance, K == 2, nothing padded."""
        B, dev = self.B, self.device
        lv = torch.tensor([0.0, 1.0], dtype=torch.float32,
                          device=dev).repeat(B, 1)
        g = torch.tensor([1.0, 0.0], dtype=torch.float32,
                         device=dev).repeat(B, 1)
        return HostingGrid(M=self.M, levels=lv, g=g,
                           mask=torch.ones((B, 2), dtype=torch.bool,
                                           device=dev))

    def endpoint_columns(self) -> torch.Tensor:
        """[B, 2] int32 column indices of the endpoint levels (0, top) in
        this grid: the ``PolicyLane.svc_cols`` map that scores a
        no-partial-hosting lane on the service slab generated once on the
        full grid (coupled Model-2 uniforms, so the gathered columns equal
        ``endpoint_service`` and an endpoint grid's own draws bitwise)."""
        zeros = torch.zeros((self.B,), dtype=torch.int32, device=self.device)
        return torch.stack([zeros, self.top_index().to(torch.int32)], dim=1)

    def endpoint_service(self, svc: torch.Tensor) -> torch.Tensor:
        """A stacked [B, T, K] service matrix gathered down to the endpoint
        levels: [B, T, 2] columns (level 0, top level), the realized costs a
        no-partial policy sees on the same sample path."""
        idx = self.endpoint_columns().to(torch.int64)[:, None, :]
        return torch.gather(svc, 2, idx.expand(-1, svc.shape[1], -1))


# ----------------------------------------------------------------------
# Multi-service sets: N services sharing one edge node's storage under a
# capacity on the sum of their hosted fractions (Online Service Caching
# and Routing at the Edge, arXiv 2107.10446).
# ----------------------------------------------------------------------

#: Feasibility slack of the capacity constraint: a state whose hosted
#: fractions sum exactly to the capacity is feasible even when the float64
#: sum lands an ulp above it (0.1 + 0.2 against 0.3); a real excess is not.
CAPACITY_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ServiceSet:
    """N hosting services sharing ONE edge node's storage.

    Each service keeps its own ``HostingCosts``; the edge bounds the sum of
    the hosted fractions by ``capacity`` (None: N, unconstrained).  The
    joint problem's states are the feasible tuples of per-service level
    indices in ``np.ndindex`` order, so state 0 is all-off, the engine's
    start; ``joint_grid`` lowers the problem to a ``HostingGrid`` with a
    matrix ``M``.
    """

    services: Tuple[HostingCosts, ...]
    capacity: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "services", tuple(self.services))
        if not self.services:
            raise ValueError("need at least one service")
        if self.capacity is not None and self.capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {self.capacity}")
        if not self.joint_states().size:
            raise ValueError(
                f"capacity {self.capacity} excludes even the all-off state")

    @property
    def N(self) -> int:
        return len(self.services)

    @property
    def cap(self) -> float:
        """The effective capacity (None means N: unconstrained)."""
        return float(self.N) if self.capacity is None else float(self.capacity)

    def joint_states(self) -> np.ndarray:
        """[J, N] int32 per-service level indices of every feasible joint
        state, row-major (all-off first): feasible iff the float64 sum of
        the hosted fractions is ``<= capacity + CAPACITY_EPS``.  Computed
        once a set and returned read-only (a fleet's grid and scenario
        read it several times a set)."""
        st = self.__dict__.get("_joint_states")
        if st is None:
            Ks = tuple(cc.K for cc in self.services)
            idx = np.array(list(np.ndindex(*Ks)), np.int32).reshape(
                -1, len(Ks))
            frac = np.zeros((idx.shape[0],), np.float64)
            for n, cc in enumerate(self.services):
                frac += np.asarray(cc.levels, np.float64)[idx[:, n]]
            st = idx[frac <= self.cap + CAPACITY_EPS]
            st.flags.writeable = False
            object.__setattr__(self, "_joint_states", st)
        return st

    @property
    def J(self) -> int:
        """The number of feasible joint states."""
        return self.joint_states().shape[0]

    def joint_levels(self) -> np.ndarray:
        """[J] float32 total hosted fraction of each joint state, summed in
        float32 in ascending n (at N = 1 the service's own levels)."""
        idx = self.joint_states()
        tot = np.zeros((idx.shape[0],), np.float32)
        for n, cc in enumerate(self.services):
            tot = tot + np.asarray(cc.levels, np.float32)[idx[:, n]]
        return tot

    def joint_g(self) -> np.ndarray:
        """[J] float32 summed service-cost curve ``sum_n g_n(lv_n[j])``, in
        ascending n: a joint state's Model-1 price under one common
        arrival stream."""
        idx = self.joint_states()
        g = np.zeros((idx.shape[0],), np.float32)
        for n, cc in enumerate(self.services):
            g = g + np.asarray(cc.g, np.float32)[idx[:, n]]
        return g

    def joint_fetch_matrix(self) -> np.ndarray:
        """[J, J] float32 explicit fetch matrix ``sum_n M_n * (lv_n[j'] -
        lv_n[j])^+``: the per-service terms in ascending n, each in float32
        in ``dp_fetch_matrix``'s op order, so at N = 1 it is bitwise the
        rank-one matrix the single-service DP builds."""
        idx = self.joint_states()
        fm = None
        for n, cc in enumerate(self.services):
            lvn = np.asarray(cc.levels, np.float32)[idx[:, n]]
            term = np.float32(cc.M) * np.maximum(
                lvn[None, :] - lvn[:, None], np.float32(0.0))
            fm = term if fm is None else fm + term
        return fm

    def joint_grid(self, device=None) -> "HostingGrid":
        """This set's joint problem as a one-row matrix-``M`` grid."""
        return joint_hosting_grid([self], device=device)


def joint_hosting_grid(sets: Sequence[ServiceSet], J: Optional[int] = None,
                       device=None) -> HostingGrid:
    """B ``ServiceSet`` joint problems stacked into one matrix-``M``
    ``HostingGrid``, mixed state counts padded to a common J (or to
    ``J=``): a padded state repeats its set's last feasible state's level
    and g with ``mask=False`` and zero fetch rows and columns (the DP
    prices it ``+inf``, so it is never reached)."""
    if not sets:
        raise ValueError("need at least one service set")
    dev = resolve_device(device)
    J_min = max(ss.J for ss in sets)
    J = J_min if J is None else int(J)
    if J < J_min:
        raise ValueError(f"J={J} < max set J {J_min}")
    B = len(sets)
    M = np.zeros((B, J, J), np.float32)
    lv = np.ones((B, J), np.float32)
    g = np.zeros((B, J), np.float32)
    mask = np.zeros((B, J), bool)
    for i, ss in enumerate(sets):
        Ji = ss.J
        M[i, :Ji, :Ji] = ss.joint_fetch_matrix()
        lv[i, :Ji] = ss.joint_levels()
        lv[i, Ji:] = lv[i, Ji - 1]
        g[i, :Ji] = ss.joint_g()
        g[i, Ji:] = g[i, Ji - 1]
        mask[i, :Ji] = True
    t = lambda a: torch.from_numpy(a).to(dev)     # noqa: E731
    return HostingGrid(M=t(M), levels=t(lv), g=t(g), mask=t(mask))


# ----------------------------------------------------------------------
# Per-slot cost pieces (vectorised over the level axis K), and the
# per-slot holding-cost matrix of the one-instance DP.
# ----------------------------------------------------------------------

def fetch_cost(levels, r_from, r_to, M):
    """Actual fetch cost ``M * (levels[r_to] - levels[r_from])^+``
    (indices)."""
    return M * torch.clamp_min(levels[r_to] - levels[r_from], 0.0)


def retro_fetch_cost(levels, r_from, M):
    """Algorithm 1's retrospective charge ``M * |levels[j] -
    levels[r_from]|`` for every candidate level j ([K]): evictions are
    charged too, the hysteresis behind RetroRenting's ratio."""
    return M * torch.abs(levels - levels[r_from])


def rent_cost(levels, c_t):
    """Rent at every level for one slot: ``c_t * levels`` ([K])."""
    return c_t * levels


def service_cost_model1(g, x_t):
    """Model-1 service cost at every level: ``g[k] * x_t`` ([K])."""
    return g * x_t


def service_cost_model2_coupled(g, uniforms, x_t):
    """Model-2 realized service cost at every level with coupled
    randomness: request i (of the ``R`` uniforms, the first ``x_t`` live)
    is forwarded at level k iff ``u_i < g[k]``.  Returns [K] float32."""
    R = uniforms.shape[0]
    live = (torch.arange(R, device=uniforms.device) < x_t)[None, :]
    fwd = uniforms[None, :] < g[:, None]
    return torch.where(live & fwd, 1.0, 0.0).sum(dim=1)


def as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array, a sequence or a tensor as a tensor on ``device``
    (cast to ``dtype`` when given: float64 to float32 rounds to nearest, as
    ``jnp.asarray(a, float32)`` does)."""
    t = (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(np.asarray(a))))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def per_slot_cost_matrix(costs: HostingCosts, x, c, svc=None,
                         device=None) -> torch.Tensor:
    """``w[t, k]``, the rent + service cost of holding level k in slot t:
    ``x`` [T] arrivals, ``c`` [T] rents, ``svc`` an optional [T, K]
    Model-2 service matrix (None: Model 1, ``g[k] * x_t``).  Two roundings,
    rent then the add, as the reference's eager ops give; [T, K] float32
    on ``device`` (None: the card)."""
    dev = resolve_device(device)
    f32 = torch.float32
    lv = torch.tensor(costs.levels, dtype=f32, device=dev)
    rentm = as_tensor(c, dev, f32)[:, None] * lv[None, :]
    if svc is None:
        gv = torch.tensor(costs.g, dtype=f32, device=dev)
        svcm = as_tensor(x, dev, torch.int32)[:, None].to(f32) * gv[None, :]
    else:
        svcm = as_tensor(svc, dev, f32)
    return rentm + svcm
