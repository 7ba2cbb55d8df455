"""Retry classifier: transient vs persistent runtime errors.

Regression: every FAILED_PRECONDITION was treated as transient, so a
persistent library version mismatch burned retries x backoff before
surfacing.
"""
from euispice_coreg_tpu.utils.jaxcfg import is_transient_runtime_error, with_retries

LIB_MISMATCH = (
    "FAILED_PRECONDITION: DNN library version mismatch: loaded runtime "
    "library 9.1.0 but the source was compiled with 9.8.0."
)
WORKER_CRASH = (
    "UNAVAILABLE: The device runtime appears to have crashed or restarted."
)
GENERIC_PRECONDITION = (
    "FAILED_PRECONDITION: execution aborted: device is being reinitialized."
)
OOM = ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
       "17179869184 bytes.")


def test_version_mismatch_is_persistent():
    assert not is_transient_runtime_error(LIB_MISMATCH)


def test_worker_crash_is_transient():
    assert is_transient_runtime_error(WORKER_CRASH)


def test_generic_precondition_is_transient():
    assert is_transient_runtime_error(GENERIC_PRECONDITION)


def test_oom_is_persistent():
    assert not is_transient_runtime_error(OOM)


def test_unrelated_error_is_not_retried():
    assert not is_transient_runtime_error("INVALID_ARGUMENT: bad shape")


def test_with_retries_does_not_retry_persistent(monkeypatch):
    from jax.errors import JaxRuntimeError

    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        raise JaxRuntimeError(LIB_MISMATCH)

    wrapped = with_retries(boom, retries=3, backoff_s=0.0)
    try:
        wrapped()
    except JaxRuntimeError:
        pass
    assert calls["n"] == 1  # persistent: no retries burned


def test_with_retries_retries_transient_then_succeeds():
    from jax.errors import JaxRuntimeError

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise JaxRuntimeError(WORKER_CRASH)
        return "ok"

    assert with_retries(flaky, retries=3, backoff_s=0.0)() == "ok"
    assert calls["n"] == 3


def test_with_retries_on_retry_callback():
    from jax.errors import JaxRuntimeError

    calls = {"n": 0, "cleared": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise JaxRuntimeError(WORKER_CRASH)
        return "ok"

    def clear():
        calls["cleared"] += 1

    assert with_retries(flaky, retries=2, backoff_s=0.0, on_retry=clear)() == "ok"
    assert calls["cleared"] == 1


TRANSPORT_HICCUP = "UNAVAILABLE: Socket closed while reading the response."


def test_run_chunked_retries_failed_chunk_only():
    """A transient TRANSPORT failure re-enqueues ONLY that chunk."""
    import numpy as np
    from jax.errors import JaxRuntimeError

    from euispice_coreg_tpu.engine import lag_search

    calls = {"dispatch": []}
    fail_once = {1: True}  # chunk index 1 fails on first materialization

    class FlakyResult:
        def __init__(self, value, chunk):
            self.value = value
            self.chunk = chunk

        def __array__(self, dtype=None, copy=None):
            if fail_once.pop(self.chunk, False):
                raise JaxRuntimeError(TRANSPORT_HICCUP)
            return np.asarray(self.value, dtype=dtype)

    def fn(part):
        part = np.asarray(part)
        chunk = int(part[0]) // 4
        calls["dispatch"].append(chunk)
        return FlakyResult(part * 2.0, chunk)

    data = np.arange(10, dtype=np.float64)
    out = lag_search.run_chunked(fn, [data], n_lags=10, chunk_size=4,
                                 backoff_s=0.0)
    np.testing.assert_array_equal(out, data * 2.0)
    # chunk 1 dispatched twice (retry), chunks 0 and 2 once
    assert sorted(calls["dispatch"]) == [0, 1, 1, 2]


def test_run_chunked_worker_restart_escalates():
    """A worker restart must NOT burn chunk retries: the chunk's operand
    buffers died with the worker, so only the whole-call layer (which
    re-uploads) can recover."""
    import numpy as np
    import pytest
    from jax.errors import JaxRuntimeError

    from euispice_coreg_tpu.engine import lag_search

    calls = {"dispatch": 0}

    class DeadResult:
        def __array__(self, dtype=None, copy=None):
            raise JaxRuntimeError(WORKER_CRASH)

    def fn(part):
        calls["dispatch"] += 1
        return DeadResult()

    with pytest.raises(JaxRuntimeError):
        lag_search.run_chunked(fn, [np.arange(4.0)], n_lags=4, chunk_size=4,
                               backoff_s=0.0)
    assert calls["dispatch"] == 1  # no buffer-reusing re-dispatch


def test_run_chunked_persistent_error_propagates():
    import numpy as np
    import pytest
    from jax.errors import JaxRuntimeError

    from euispice_coreg_tpu.engine import lag_search

    class DeadResult:
        def __array__(self, dtype=None, copy=None):
            raise JaxRuntimeError(LIB_MISMATCH)

    def fn(part):
        return DeadResult()

    with pytest.raises(JaxRuntimeError):
        lag_search.run_chunked(fn, [np.arange(4.0)], n_lags=4, chunk_size=4,
                               backoff_s=0.0)


def test_alignment_search_retries_with_cache_clear(tmp_path, monkeypatch):
    """A transient engine failure mid-search re-runs the whole search after
    clearing the device cache; the public call still succeeds."""
    import time

    import numpy as np
    import pytest
    from jax.errors import JaxRuntimeError

    import fixtures as fx
    from euispice_coreg_tpu.engine import lag_search
    from euispice_coreg_tpu.hdrshift.alignment import Alignment
    from euispice_coreg_tpu.utils import devcache

    dl, hl, ds, hs = fx.make_helioprojective_pair(
        true_shift_arcsec=(8.0, -4.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)

    state = {"evals": 0, "cleared": 0}
    real_eval = lag_search.evaluate_lag_grid

    def flaky_eval(*a, **k):
        state["evals"] += 1
        if state["evals"] == 1:
            raise JaxRuntimeError(WORKER_CRASH)
        return real_eval(*a, **k)

    real_clear = devcache.clear

    def spy_clear():
        state["cleared"] += 1
        real_clear()

    monkeypatch.setattr(lag_search, "evaluate_lag_grid", flaky_eval)
    monkeypatch.setattr(devcache, "clear", spy_clear)
    monkeypatch.setattr(time, "sleep", lambda s: None)

    A = Alignment(
        large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
        lag_crval1=np.arange(4.0, 13.0, 2.0),
        lag_crval2=np.arange(-8.0, 1.0, 2.0),
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        small_fov_window=0, large_fov_window=0)
    res = A.align_using_helioprojective()
    assert state["evals"] == 2 and state["cleared"] == 1
    assert res.shift_arcsec[0] == pytest.approx(8.0, abs=1.0)
    assert res.shift_arcsec[1] == pytest.approx(-4.0, abs=1.0)


def test_worker_restart_classifier():
    from euispice_coreg_tpu.utils.jaxcfg import is_worker_restart

    assert is_worker_restart(WORKER_CRASH)
    assert not is_worker_restart(TRANSPORT_HICCUP)
    assert not is_worker_restart(LIB_MISMATCH)
