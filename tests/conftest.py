import os
import sys

# Tests see exactly ONE device by default (the dry-run sets its own
# XLA_FLAGS in a subprocess); make sure nothing leaked into the environment.
# REPRO_FORCE_DEVICES=N is the explicit opt-in the CI multi-device leg uses
# to run the sharding/MC/DP bit-identity suites on a forced-N-CPU-device
# platform directly (not just via their in-test subprocess spawns).
os.environ.pop("XLA_FLAGS", None)
_forced = os.environ.get("REPRO_FORCE_DEVICES")
if _forced:
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={int(_forced)}"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

# Offline containers lack `hypothesis`; install the deterministic shim so the
# property-test modules still collect and run (see _hypothesis_shim.py).
try:
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_shim
    _hypothesis_shim.install()


# pytest re-arms the default warning filters per test, overriding the
# module-level ignore in core/fleet.py; the donation advisory (a donated
# slab whose shape can't alias any output on CPU) is expected and benign.
def pytest_configure(config):
    config.addinivalue_line(
        "filterwarnings", "ignore:Some donated buffers were not usable")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
