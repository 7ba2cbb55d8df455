"""Runtime plumbing: compile-cache placement, device memory budgets, FFT
sizes, and the GPU smoke script's contract on a machine without a GPU."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from euispice_coreg_tpu.engine import fast_corr, lag_search
from euispice_coreg_tpu.utils import jaxcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def restore_cache_config():
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_placement(monkeypatch, tmp_path, restore_cache_config,
                                 env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; without it
    the cache sits at a fixed path inside the checkout."""
    import jax

    jax.config.update("jax_compilation_cache_dir", None)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = jaxcfg.enable_persistent_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert jaxcfg.enable_persistent_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir is None


@pytest.mark.parametrize("limit", [16e9, 63.76e9])
def test_fleet_budget_follows_device_bytes_limit(limit):
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": int(limit)}

    assert lag_search.fleet_stack_budget_bytes(Dev()) == pytest.approx(
        lag_search._FLEET_STACK_BUDGET_FRACTION * limit)


@pytest.mark.parametrize("n", [2, 39, 257, 2048 + 69, 2160, 2161, 4097])
def test_fft_size_is_smallest_even_7_smooth(n):
    def smooth(k):
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        return k == 1

    m = fast_corr._fft_size(n)
    assert m >= n and m % 2 == 0 and smooth(m)
    assert not any(k % 2 == 0 and smooth(k) for k in range(n, m))


def test_chip_smoke_refuses_cpu_backend():
    """Without a GPU the smoke script exits non-zero before any phase and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_chip_smoke_result_line_schema():
    mod = _load_chip_smoke()
    line = mod.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        jaxcfg.require_gpu()


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke run on the card, in its own process (this test
    process keeps JAX on the CPU, so the child has the card to itself)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs a GPU (no nvidia-smi on this machine)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
    assert np.isfinite(last["device"]["count"])
