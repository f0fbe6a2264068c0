#!/usr/bin/env python3
"""Registers, shared memory and spills of a kernel library's kernels, as
``nvcc -Xptxas -v`` reports them (a CUDA machine with nvcc).

    python3 tools/ptxas_report.py [LIBRARY] [--match FRAGMENT ...]

Compiles ``src/repro_torch/kernels/csrc/<LIBRARY>.cu`` (default
``hosting``) with the flags ``_build.py`` builds it with, plus ``-Xptxas
-v``, into a temporary directory (the library in ``build/kernels/`` is
not touched), and prints one line per kernel whose demangled name holds
any FRAGMENT (all kernels without ``--match``): registers, spill stores
and loads in bytes, static shared memory in bytes.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def _demangle(names):
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool or not names:
        return dict(zip(names, names))
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out if len(out) == len(names) else names))


def report(lib: str, match=None):
    flags = _build.LIBRARIES[lib][0]
    src = _build._CSRC / f"{lib}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        run = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-o",
                              str(Path(tmp) / f"{lib}.so"), str(src)],
                             capture_output=True, text=True, timeout=1200)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed ({run.returncode}):\n"
                           f"{run.stderr[-4000:]}")
    rows, cur = [], None
    for line in run.stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1), "registers": None, "spill_stores": 0,
                   "spill_loads": 0, "smem": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    names = _demangle([r["name"] for r in rows])
    for r in rows:
        r["name"] = names[r["name"]]
    if match:
        rows = [r for r in rows if any(f in r["name"] for f in match)]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("library", nargs="?", default="hosting")
    ap.add_argument("--match", nargs="*")
    a = ap.parse_args()
    for r in report(a.library, a.match):
        print(f"{r['registers']:>4} registers, spills {r['spill_stores']} / "
              f"{r['spill_loads']} bytes, smem {r['smem']:>6} bytes: "
              f"{r['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
