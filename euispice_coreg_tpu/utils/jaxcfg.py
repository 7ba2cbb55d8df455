"""JAX runtime configuration helpers."""
from __future__ import annotations

import os

# fixed in-checkout location of the persistent compilation cache when
# JAX_COMPILATION_CACHE_DIR is not set (a fixed path: the cache key includes
# it, so a directory that moves between runs never hits)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent); returns the
    cache directory in force.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR` (``.jax_cache`` at the checkout root).
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_CACHE_DIR


# Error classes that retrying can never fix: the same call fails the same
# way until the environment changes.
_PERSISTENT_MARKERS = (
    "version mismatch",          # driver/library skew
    "unimplemented",
    "not implemented",
    "invalid_argument",
    "out of memory",
    "resource_exhausted: error allocating",
)

# Error classes worth retrying: transient runtime failures.
_TRANSIENT_MARKERS = (
    "unavailable",
    "crashed or restarted",
    "deadline_exceeded",
    "failed_precondition",  # generic runtime hiccups — unless persistent above
)


# The device runtime itself restarted: device buffers are gone, so
# re-dispatching a program over the SAME operand buffers cannot succeed —
# only a layer that re-uploads its operands (Alignment._with_engine_retries)
# can recover.
_RESTART_MARKERS = ("crashed or restarted",)


def is_worker_restart(msg: str) -> bool:
    """True when a runtime error indicates the device runtime restarted
    (transient for a full re-run, fatal for buffer-reusing retries)."""
    m = msg.lower()
    return any(r in m for r in _RESTART_MARKERS)


def is_transient_runtime_error(msg: str) -> bool:
    """True when a JaxRuntimeError message describes a transient failure.

    Persistent markers win: an out-of-memory error (``RESOURCE_EXHAUSTED:
    Out of memory ...``) is never retried, and neither is a library version
    mismatch surfacing as FAILED_PRECONDITION.
    """
    m = msg.lower()
    if any(p in m for p in _PERSISTENT_MARKERS):
        return False
    return any(t in m for t in _TRANSIENT_MARKERS)


def with_retries(fn, retries: int = 2, backoff_s: float = 5.0,
                 on_retry=None):
    """Failure-detection wrapper for transient device runtime errors
    (``JaxRuntimeError`` UNAVAILABLE / FAILED_PRECONDITION): retries the
    callable after a short backoff — the persistent compile cache makes the
    retry cheap.  The reference has no failure handling at all (a dead
    worker hangs its process pool, SURVEY.md section 5).

    ``on_retry``: optional zero-arg callback invoked before each retry —
    e.g. ``utils.devcache.clear`` so a re-run re-uploads operands whose
    device buffers died with the runtime.
    """
    import functools
    import time

    from .obs import logger

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from jax.errors import JaxRuntimeError

        last = None
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except JaxRuntimeError as exc:
                msg = str(exc)
                if not is_transient_runtime_error(msg) or attempt == retries:
                    raise
                last = exc
                logger.warning(
                    "transient device runtime error (attempt %d/%d): %s",
                    attempt + 1, retries, msg.splitlines()[0])
                time.sleep(backoff_s)
                if on_retry is not None:
                    on_retry()
        raise last  # unreachable

    return wrapped


def device_memory_bytes(device=None) -> int:
    """Bytes this process may allocate on ``device`` (default: the first
    default-backend device): ``memory_stats()["bytes_limit"]`` where the
    backend reports it (GPU), else the host's physical memory (the CPU
    backend allocates from it and reports no stats)."""
    import jax

    dev = device if device is not None else jax.devices()[0]
    stats = dev.memory_stats() or {}
    if stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them
    ("not available" where nvidia-smi is absent).  Runs a child process
    that does not touch JAX."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return "not available"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else "not available"


def require_gpu() -> dict:
    """The device this process measures on: raises RuntimeError unless
    JAX's default backend is a GPU (no fallback to the CPU).  Returns
    ``{"platform", "kind", "count", "card"}`` — the JAX view of the devices
    plus the nvidia-smi name and power limit of the card."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {backend!r}; this "
            "measurement runs only on a GPU")
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_name_and_power_limit()}
