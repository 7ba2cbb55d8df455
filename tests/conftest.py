"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (no accelerator required) with
float64 enabled so WCS/resampling parity against scipy can be checked at
full precision.  Production code paths use explicit dtypes, so enabling x64
here does not mask float32 dtype bugs on the device.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# force tests onto the virtual 8-device CPU mesh even where a GPU is
# visible (the JAX_PLATFORMS variable above covers only a fresh import)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _clear_memo_caches():
    """The engine memoizes pure host prep (utils/memo.py) keyed on input
    digests; tests monkeypatch those helpers, so cached results from an
    earlier test must never shadow a patched function."""
    yield
    from euispice_coreg_tpu.utils import memo

    memo.clear_all()


@pytest.fixture(autouse=True)
def _close_matplotlib_figures():
    """Plot tests open figures they never close; cap memory and silence
    matplotlib's >20-open-figures RuntimeWarning."""
    yield
    import sys

    if "matplotlib" in sys.modules:
        import matplotlib.pyplot as plt

        plt.close("all")
