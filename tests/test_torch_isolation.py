"""The port stands alone: it imports neither jax nor the JAX package, its
entry points run on the card unless asked for the CPU, and ``chip_smoke.py``
refuses to report without a card.  The card test holds the CUDA kernels
against their plain versions (it skips without a card)."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_without_jax_or_the_jax_package():
    code = f"""
import sys, importlib, pkgutil
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = [k for k, v in sys.modules.items() if v is not None and
       (k.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not bad, bad
print("isolated")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_no_jax_or_repro_import_in_the_source():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_need_the_card_unless_told_cpu(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import (FleetBatch, HostingCosts, HostingGrid,
                                  offline_opt_fleet, run_fleet)
    from repro_torch.core import scenarios as ps
    from repro_torch.core.policies import AlphaRR
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    costs = [HostingCosts.three_level(3.0, 0.3, 0.6)]
    key = ps.prng_key(0, "cpu")
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: ps.prng_key(0),
                 lambda: HostingGrid.from_costs(costs),
                 lambda: ps.bernoulli_arrivals(key, 0.3, 1),
                 lambda: ps.uniform_rents(key, 0.3, 0.1, 1),
                 lambda: ps.ge_arrivals(key, 0.3, 0.2, 0.9, 0.2, 1,
                                        emission="bernoulli"),
                 lambda: ps.na_rents(key, 0.3, 0.1, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    grid = HostingGrid.from_costs(costs, device="cpu")
    fleet = FleetBatch.for_scenario(grid, 8)
    scen = ps.combine(ps.bernoulli_arrivals(key, 0.3, 1, device="cpu"),
                      ps.uniform_rents(key, 0.3, 0.1, 1, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fleet(AlphaRR.fleet(fleet), fleet, scenario=scen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offline_opt_fleet(fleet, scenario=scen, checkpointed=True,
                          collect_schedule=False)
    assert run_fleet(AlphaRR.fleet(fleet), fleet, scenario=scen,
                     device="cpu").total.shape == (1,)


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_isolation.py)")
    from repro_torch.core import HostingCosts, HostingGrid
    from repro_torch.core.policies import AlphaRR
    from repro_torch.core.policies.alpha_rr import alpha_rr_init
    from repro_torch.core.simulator import sim_acc0
    from repro_torch.kernels import hosting as H
    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    R, chunk, K = 64, 300, 3
    keys = torch.randint(0, 2 ** 32, (R, 2), generator=g).to(dev)
    tids = torch.arange(chunk, dtype=torch.int32, device=dev) + 2 ** 31 - chunk
    for part in (True, False):
        for salt in (None, 1):
            assert torch.equal(H.slot_uniform(keys, tids, salt, part),
                               H.slot_uniform_plain(keys, tids, salt, part))
    J = torch.rand((R, K), generator=g).to(dev)
    J[::5] = float("inf")
    w = torch.round(torch.rand((R, chunk, K), generator=g) * 4).to(dev) / 4
    w[::3, :, 1] = float("inf")
    fetch = torch.round(torch.rand((R, K, K), generator=g) * 4).to(dev) / 4
    valid = (torch.rand((R, chunk), generator=g) < 0.8).to(dev)
    for a, b in zip(H.dp_minplus(J, w, fetch, valid),
                    H.dp_minplus_plain(J, w, fetch, valid)):
        assert torch.equal(a, b)
    grid = HostingGrid.from_costs(
        [HostingCosts.three_level(float(m), 0.3, 0.6)
         for m in np.geomspace(2, 50, R)], device=dev)
    pol = AlphaRR.batch(grid)
    x = (torch.rand((R, chunk), generator=g) < 0.4).to(torch.int32).to(dev)
    c = (torch.rand((R, chunk), generator=g) * 0.8).to(dev)
    T_len = torch.randint(0, 2 * chunk, (R,), generator=g,
                          dtype=torch.int32).to(dev)
    carry = (alpha_rr_init(pol.params), sim_acc0(R, K, dev))
    args = (pol.params, grid.levels, grid.g, grid.M, T_len, 0, carry, x, c)
    (s1, a1), r1 = H.sim_chunk_alpha_rr(*args)
    (s2, a2), r2 = H.sim_chunk_alpha_rr_plain(*args)
    assert torch.equal(r1, r2)
    for k in s1:
        assert torch.equal(s1[k], s2[k])
    for k in a1:
        assert torch.equal(a1[k], a2[k])
