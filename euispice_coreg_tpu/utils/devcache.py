"""Bounded device-array cache keyed by source-file identity.

Host->device transfers are a fixed cost of every repeat alignment.
Workflows like jitter correction re-use ONE reference image across every
frame of a movie, so the upload is pure waste after the first alignment.

This cache keeps the device copy alive across :class:`Alignment` instances,
keyed by ``(realpath, mtime, size, window)`` of the FITS HDU the array was
loaded from plus the requested compute dtype.  It is the device-side
counterpart of the reference's named POSIX shared-memory blocks, which every
worker process re-attaches by name instead of re-copying
(``/root/reference/euispice_coreg/utils/Util.py:948-967``).

Entries are evicted LRU; the default capacity (8) bounds device-memory use
to a few hundred MB of full-disk images.  Callers must pass ``key=None``
whenever the host array has been modified after loading (thresholds, FOV
masks) — the cache never inspects array contents.
"""
from __future__ import annotations

import collections
import os
import threading

MAX_ENTRIES = 8

_lock = threading.Lock()
_cache: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()


def file_key(path, window) -> tuple | None:
    """Cache key for an HDU of a local FITS file; None when unidentifiable
    (URLs, file objects, raw bytes)."""
    try:
        p = os.fspath(path)
    except TypeError:
        return None
    if str(p).startswith(("http://", "https://")):
        return None
    try:
        st = os.stat(p)
    except OSError:
        return None
    return ("fits", os.path.realpath(p), st.st_mtime_ns, st.st_size, window)


def asarray_cached(arr, dtype, key):
    """``jnp.asarray(arr, dtype)`` with an LRU device cache on ``key``."""
    import jax.numpy as jnp

    if key is None:
        return jnp.asarray(arr, dtype=dtype)
    shape = tuple(getattr(arr, "shape", ()))
    full = (key, str(jnp.dtype(dtype)), shape)
    with _lock:
        hit = _cache.get(full)
        if hit is not None:
            _cache.move_to_end(full)
            return hit
    dev = jnp.asarray(arr, dtype=dtype)
    with _lock:
        _cache[full] = dev
        while len(_cache) > MAX_ENTRIES:
            _cache.popitem(last=False)
    return dev


def clear():
    with _lock:
        _cache.clear()
