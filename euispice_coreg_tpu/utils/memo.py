"""Host-side memoization of pure (arrays, scalars) -> numpy results.

The Carrington engine's per-call host prep — the probe fit, the tile-shape
gate, the per-tile offset bounds — are pure functions of (header scalars,
grid limits, lag set), yet repeated identically on every warm call.  The jit
closures are already memoized on static signatures; this module
extends the same idea to host-side derived values keyed by content digests
of the input arrays.

No counterpart in the reference: it recomputes every transform per lag per
call (``utils/rectify.py:377-423``).

Cached values are treated as immutable — ``FIFOCache.put`` marks numpy
arrays read-only so an accidental in-place edit of a cached result raises
instead of corrupting later calls.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np


def digest(*items) -> tuple:
    """Hashable key from a mix of numpy arrays, bytes, and plain scalars.

    Arrays are keyed by (shape, dtype, blake2b of the raw bytes) — content,
    not identity, so logically-equal inputs hit regardless of provenance.
    Dicts are flattened sorted by key.  Cost: ~1 ms/MB of array input
    (blake2b), negligible against the recomputation it replaces.
    """
    parts = []
    for it in items:
        if isinstance(it, dict):
            for k in sorted(it):
                parts.append(k)
                parts.extend(digest(it[k]))
        elif isinstance(it, np.ndarray):
            a = np.ascontiguousarray(it)
            parts.append((a.shape, str(a.dtype),
                          hashlib.blake2b(a.tobytes(), digest_size=16)
                          .digest()))
        elif isinstance(it, (bytes, str, int, float, bool, type(None))):
            parts.append(it)
        elif isinstance(it, (tuple, list)):
            parts.append(len(it))
            parts.extend(digest(*it))
        elif isinstance(it, np.generic):  # numpy scalar
            parts.append((type(it).__name__, it.item()))
        else:
            # never key by repr(): default reprs embed memory addresses (a
            # recycled id would alias two different values) and array
            # reprs elide content — both are silent-stale-hit hazards
            raise TypeError(
                f"memo.digest cannot key a {type(it).__name__}; pass "
                "plain scalars, numpy arrays, or containers of them")
    return tuple(parts)


# every FIFOCache registers itself here so test isolation can wipe all
# memoized host prep in one call (monkeypatched helpers must not be
# shadowed by results cached in an earlier test)
_REGISTRY: list["FIFOCache"] = []


def clear_all() -> None:
    for c in _REGISTRY:
        c.clear()


class IdentityCache:
    """Bounded cache keyed by object IDENTITY plus an equality key.

    For values derived from device arrays: jax arrays are immutable but
    cannot be content-digested without a device download, so entries
    compare their anchor objects with ``is`` and HOLD REFERENCES to them —
    an ``id()`` can never be reused while its entry lives.  Numpy inputs
    should not be anchored here (callers may mutate them in place)."""

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self._entries: list = []
        _REGISTRY.append(self)

    def clear(self) -> None:
        self._entries.clear()

    def get(self, idents, key=None):
        for e_id, e_key, val in self._entries:
            if (len(e_id) == len(idents) and e_key == key
                    and all(a is b for a, b in zip(e_id, idents))):
                return val
        return None

    def put(self, idents, key, value):
        if len(self._entries) >= self.maxsize:
            self._entries.pop(0)
        self._entries.append((tuple(idents), key, value))
        return value


class FIFOCache:
    """Bounded insert-order cache for memoized host prep.

    FIFO (not LRU) keeps the implementation branch-free; the working sets
    here are tiny (a handful of (grid, lag-set) signatures per run)."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        _REGISTRY.append(self)

    def clear(self) -> None:
        self._d.clear()

    def get(self, key):
        if key in self._d:
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, value):
        def freeze(v):
            if isinstance(v, np.ndarray):
                v.setflags(write=False)
            elif isinstance(v, tuple):
                for x in v:
                    freeze(x)
            return v

        if len(self._d) >= self.maxsize:
            self._d.popitem(last=False)
        self._d[key] = freeze(value)
        return value
