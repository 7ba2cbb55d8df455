"""On-device lag-grid search engine.

This replaces the reference's L3 search driver + L1 multiprocessing runtime
(``/root/reference/euispice_coreg/hdrshift/alignment.py:613-797``: 5-D
meshgrid of header lags -> ``np.array_split`` -> one OS process per chunk with
POSIX shared memory) with a single JAX computation:

* the reference-grid world coordinates are computed ONCE on device,
* each lag candidate is a closed-form perturbation of the small image's WCS
  scalars (`_shift_header` semantics, ``alignment.py:401-468``),
* per lag: shifted world->pixel map + spline gather + masked Pearson
  reduction, all fused by XLA,
* the flattened lag axis is `shard_map`-sharded across the device mesh
  (an all-gather of the score vector is the only collective),
* `lax.map(..., batch_size=...)` streams lag batches so 121x121 x 2048^2
  intermediates never materialize.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import resample, score, wcs

# lag vector layout along the last axis of the (L, 5) lag matrix
D_CRVAL1, D_CRVAL2, D_CDELT1, D_CDELT2, D_CROTA = range(5)

from ..utils import memo as _memo  # noqa: E402

# warm-call memoization of the full-5-vector displacement probe chain
# (pure host prep; see utils/memo.py and fast_corr._DISP_CACHE)
_DISPF_CACHE = _memo.FIFOCache(maxsize=32)

# share of the device's allocatable memory the stacked combo frames (+ ref
# copies) of the mixed-grid fleet route may hold at once; beyond it the
# per-combo route (one warp resident) takes over.  The rest leaves the
# movie program's ~1.4 GB per-frame product stack (2048^2) plus canvases
# comfortable room.
_FLEET_STACK_BUDGET_FRACTION = 0.125


def fleet_stack_budget_bytes(device=None) -> float:
    from ..utils.jaxcfg import device_memory_bytes

    return _FLEET_STACK_BUDGET_FRACTION * device_memory_bytes(device)


def apply_lag_to_params(base: dict, d: jnp.ndarray) -> dict:
    """Shift WCS scalars by one lag vector ``d`` (degrees).

    Reproduces ``Alignment._shift_header`` (``alignment.py:401-468``) with the
    CDELT bookkeeping fixed (the reference never writes the shifted CDELT1
    back into the header and crashes on nonzero CDELT2 lags — documented
    quirk, SURVEY.md 2.3): CRVAL/CDELT shift additively, CROTA shifts in
    degrees, and the PC matrix is rebuilt from (CROTA, CDELT) whenever any of
    CDELT1/CDELT2/CROTA lags is nonzero; otherwise the original PC matrix is
    kept verbatim.
    """
    crval1 = base["crval1"] + d[D_CRVAL1]
    crval2 = base["crval2"] + d[D_CRVAL2]
    cdelt1 = base["cdelt1"] + d[D_CDELT1]
    cdelt2 = base["cdelt2"] + d[D_CDELT2]
    crota = base["crota"] + d[D_CROTA]

    rebuild = (d[D_CDELT1] != 0) | (d[D_CDELT2] != 0) | (d[D_CROTA] != 0)
    rho = crota * wcs.RAD_PER_DEG
    lam = cdelt2 / cdelt1
    cos_r, sin_r = jnp.cos(rho), jnp.sin(rho)
    pc11 = jnp.where(rebuild, cos_r, base["pc11"])
    pc12 = jnp.where(rebuild, -lam * sin_r, base["pc12"])
    pc21 = jnp.where(rebuild, sin_r / lam, base["pc21"])
    pc22 = jnp.where(rebuild, cos_r, base["pc22"])

    return {
        "crval1": crval1,
        "crval2": crval2,
        "crpix1": base["crpix1"],
        "crpix2": base["crpix2"],
        "cdelt1": cdelt1,
        "cdelt2": cdelt2,
        "pc11": pc11,
        "pc12": pc12,
        "pc21": pc21,
        "pc22": pc22,
    }


def _score_one_lag(d, small_img, ref_img, lon, lat, base, order, method, kind):
    params = apply_lag_to_params(base, d)
    x, y = wcs.world_to_pixel(params, lon, lat, kind=kind)
    sampled = resample.sample_image(small_img, x, y, order=order, cval=jnp.nan)
    return score.SCORE_FUNCTIONS[method](ref_img, sampled)


def _score_one_lag_select(d, shift, small_padded, ref_img, lon, lat, base,
                          order, method, kind, residual_bound, pad, h, w):
    """Gather-free per-lag scorer: exact :func:`_score_one_lag` semantics via
    the shift-and-select sampler (per-lag integer shift precomputed on host)."""
    params = apply_lag_to_params(base, d)
    x, y = wcs.world_to_pixel(params, lon, lat, kind=kind)
    sampled = resample.sample_image_select(
        small_padded, x, y, order, shift[0], shift[1],
        residual_bound=residual_bound, pad=pad, h=h, w=w,
    )
    return score.SCORE_FUNCTIONS[method](ref_img, sampled)


@partial(jax.jit, static_argnames=("order", "method", "kind", "batch_size",
                                   "residual_bound", "pad", "h", "w"))
def _evaluate_flat_select(lags, shifts, small_padded, ref_img, lon, lat, base,
                          order, method, kind, batch_size, residual_bound,
                          pad, h, w):
    f = lambda args: _score_one_lag_select(
        args[0], args[1], small_padded, ref_img, lon, lat, base,
        order, method, kind, residual_bound, pad, h, w)
    return jax.lax.map(f, (lags, shifts), batch_size=batch_size)


@partial(jax.jit, static_argnames=("order", "method", "kind", "batch_size"))
def _evaluate_flat(lags, small_img, ref_img, lon, lat, base, order, method, kind, batch_size):
    f = lambda d: _score_one_lag(d, small_img, ref_img, lon, lat, base, order, method, kind)
    return jax.lax.map(f, lags, batch_size=batch_size)


def _sharded_evaluator(mesh, order, method, kind, batch_size):
    from jax import shard_map

    def local_eval(lags, small_img, ref_img, lon, lat, base):
        f = lambda d: _score_one_lag(d, small_img, ref_img, lon, lat, base, order, method, kind)
        return jax.lax.map(f, lags, batch_size=batch_size)

    sharded = shard_map(
        local_eval,
        mesh=mesh,
        in_specs=(P("lags"), P(), P(), P(), P(), P()),
        out_specs=P("lags"),

    )
    return jax.jit(sharded)


def run_chunked(fn, per_lag_arrays, n_lags, chunk_size, label="lag chunks",
                retries: int = 2, backoff_s: float = 5.0):
    """Evaluate a per-lag device function in bounded host-side chunks.

    One giant ``lax.map`` program over >10k lags runs as one opaque device
    call with no progress.  This slices every per-lag operand into
    fixed-size chunks (last chunk padded for a stable jit signature), calls
    ``fn(*chunk_arrays)`` per slice and stitches the results, reporting
    progress between device calls.

    Dispatch is pipelined one chunk ahead: chunk k+1's operands are shipped
    and its program enqueued before blocking on chunk k's result, so the
    host-to-device copies overlap device compute.

    Transient runtime failures (the async dispatch surfaces them at
    materialization) re-enqueue ONLY the failed chunk — completed chunks are
    already host-side.  A runtime RESTART propagates immediately instead:
    the chunk's operand buffers died with it, so re-dispatching them cannot
    succeed — recovery belongs to the whole-call retry that re-uploads
    operands (hdrshift/alignment.py).  Persistent errors propagate as
    well."""
    import time as _time

    from jax.errors import JaxRuntimeError

    from ..utils.jaxcfg import (is_transient_runtime_error,
                                is_worker_restart, with_retries)
    from ..utils.obs import Progress, logger

    # enqueue-time transient errors (rare: most surface at materialization)
    dispatch = with_retries(fn, retries=retries, backoff_s=backoff_s)

    def slice_args(s):
        e = min(s + chunk_size, n_lags)
        args = []
        for a in per_lag_arrays:
            # device-resident operands are sliced/padded ON DEVICE (no
            # host round-trip of e.g. the per-tile shift tables)
            xp = jnp if isinstance(a, jax.Array) else np
            part = a[s:e]
            if e - s < chunk_size:
                fill = xp.repeat(part[-1:], chunk_size - (e - s), axis=0)
                part = xp.concatenate([part, fill], axis=0)
            args.append(part if xp is jnp else jnp.asarray(part))
        return e - s, args

    def materialize(length, args, result):
        for attempt in range(retries + 1):
            try:
                return np.asarray(result)[:length]
            except JaxRuntimeError as exc:
                if (not is_transient_runtime_error(str(exc))
                        or is_worker_restart(str(exc))
                        or attempt == retries):
                    raise
                logger.warning(
                    "transient failure on a lag chunk (attempt %d/%d): %s",
                    attempt + 1, retries, str(exc).splitlines()[0])
                _time.sleep(backoff_s)
                result = dispatch(*args)  # re-enqueue just this chunk
        raise AssertionError("unreachable")

    outs = []
    prog = Progress(total=n_lags, label=label,
                    enabled=n_lags > chunk_size)
    starts = list(range(0, n_lags, chunk_size))
    pending = None  # (length, chunk args, async device result)
    for i, s in enumerate(starts):
        length, args = slice_args(s)
        result = dispatch(*args)  # enqueues; does not block
        if pending is not None:
            outs.append(materialize(*pending))
            prog.step(pending[0])
        pending = (length, args, result)
    outs.append(materialize(*pending))
    prog.step(pending[0])
    return np.concatenate(outs)


# lags per device call of run_chunked: a chunk stays a fraction of a
# second of device work at 2048^2, so a transient failure re-runs one
# chunk and progress is reported between chunks
CHUNK_SELECT = 2048
CHUNK_GATHER = 64


def mesh_put(a, mesh: Mesh, spec: P = P(), dtype=None):
    """Place an operand on the mesh's devices with an explicit NamedSharding.

    Bare ``jnp.asarray`` commits to the DEFAULT device, which may not be a
    mesh device at all (a mesh over a subset of the cards, or on another
    backend).  Every sharded engine path must route its operands through
    this helper so a mesh never round-trips through the default device;
    that is also the correct placement for real multi-host meshes.
    """
    sharding = NamedSharding(mesh, spec)
    if isinstance(a, jax.Array):
        if dtype is not None and a.dtype != jnp.dtype(dtype):
            a = a.astype(dtype)
        return jax.device_put(a, sharding)
    return jax.device_put(np.asarray(a, dtype=dtype), sharding)


def default_mesh(max_devices: int | None = None) -> Mesh | None:
    """1-D ``lags`` mesh over the available devices (None if single device)."""
    devs = jax.devices()
    if max_devices is not None:
        devs = devs[:max_devices]
    if len(devs) <= 1:
        return None
    return Mesh(np.array(devs), axis_names=("lags",))


def evaluate_lag_grid(
    small_img,
    ref_img,
    lon,
    lat,
    base_params: dict,
    lag_crval1,
    lag_crval2,
    lag_cdelt1,
    lag_cdelt2,
    lag_crota,
    *,
    order: int = 2,
    method: str = "correlation",
    kind: str = "tan",
    compute_dtype=jnp.float32,
    batch_size: int = 8,
    mesh: Mesh | None = None,
    allow_fast: bool = True,
) -> np.ndarray:
    """Score the full 5-D lag hypercube; returns shape
    (n_crval1, n_crval2, n_cdelt1, n_cdelt2, n_crota) as float64 numpy.

    All lag arrays and ``base_params`` are in DEGREES.

    When the grid lags only CRVAL1/CRVAL2 (the dominant use and the headline
    benchmark), the FFT correlation-surface fast path scores every lag from a
    fixed set of cross-correlation surfaces instead of one resample per lag
    (see engine/fast_corr.py); it falls back to the general gather engine
    whenever its exactness preconditions fail.
    """
    l1 = np.asarray(lag_crval1, dtype=np.float64)
    l2 = np.asarray(lag_crval2, dtype=np.float64)
    l3 = np.asarray(lag_cdelt1, dtype=np.float64)
    l4 = np.asarray(lag_cdelt2, dtype=np.float64)
    l5 = np.asarray(lag_crota, dtype=np.float64)
    shape = (len(l1), len(l2), len(l3), len(l4), len(l5))

    from ..utils.obs import logger

    if allow_fast and method in ("correlation", "residus_masked"):
        from . import fast_corr

        if fast_corr.fast_path_applicable(l3, l4, l5, order):
            fast = fast_corr.evaluate_crval_grid_fast(
                small_img, ref_img, lon, lat, base_params, l1, l2,
                order=order, kind=kind, compute_dtype=compute_dtype,
                mesh=mesh, method=method,
            )
            if fast is not None:
                logger.info("engine path: FFT fast (crval grid)")
                return fast.reshape(shape)
            logger.info("engine path: FFT fast preconditions failed, "
                        "falling back")
        elif allow_fast == "block" and order in (0, 2):
            fast = _evaluate_block_fast(
                small_img, ref_img, lon, lat, base_params,
                l1, l2, l3, l4, l5,
                order=order, kind=kind, compute_dtype=compute_dtype,
                method=method,
            )
            if fast is not None:
                logger.info("engine path: FFT block fast (mixed grid)")
                return fast

    grids = np.meshgrid(l1, l2, l3, l4, l5, indexing="ij")
    lags = np.stack([g.ravel() for g in grids], axis=-1)  # (L, 5)
    n_lags = lags.shape[0]

    if mesh is not None:
        # explicit mesh placement (never touch the default device; see
        # mesh_put — the mesh may live on a non-default backend)
        small_d = mesh_put(small_img, mesh, dtype=compute_dtype)
        ref_d = mesh_put(ref_img, mesh, dtype=compute_dtype)
        lon_d = mesh_put(lon, mesh, dtype=compute_dtype)
        lat_d = mesh_put(lat, mesh, dtype=compute_dtype)
        base_d = {k: mesh_put(v, mesh, dtype=compute_dtype)
                  for k, v in base_params.items()}
    else:
        small_d = jnp.asarray(small_img, dtype=compute_dtype)
        ref_d = jnp.asarray(ref_img, dtype=compute_dtype)
        lon_d = jnp.asarray(lon, dtype=compute_dtype)
        lat_d = jnp.asarray(lat, dtype=compute_dtype)
        base_d = {k: jnp.asarray(v, dtype=compute_dtype)
                  for k, v in base_params.items()}

    # gather-free select path: exact same numerics as the per-lag gather.
    # Applicable when the per-lag warp is a bounded-residual translation of
    # the grid — true for every helioprojective/CAR header-lag search with
    # same-grid sampling.
    select_cfg = None
    if order in (0, 1, 2) and np.shape(small_img) == np.shape(ref_img):
        c, spread = _displacements_full(
            base_params, lags, np.asarray(lon), np.asarray(lat), kind)
        m_resid = int(np.ceil(spread)) + 1
        shifts = np.floor(c + 0.5).astype(np.int32)
        g_bound = int(np.max(np.abs(shifts))) if shifts.size else 0
        h_img, w_img = np.shape(small_img)
        pad = g_bound + m_resid + 2
        if m_resid <= 16 and pad <= min(h_img, w_img) - 1:
            select_cfg = (shifts, m_resid, pad, h_img, w_img)

    if select_cfg is not None and mesh is None:
        shifts, m_resid, pad, h_img, w_img = select_cfg
        logger.info("engine path: shift-and-select (m=%d)", m_resid)
        small_padded = jnp.pad(small_d, pad, mode="reflect")
        out = run_chunked(
            lambda lg, sh: _evaluate_flat_select(
                lg, sh, small_padded, ref_d, lon_d, lat_d, base_d,
                order=order, method=method, kind=kind,
                batch_size=batch_size, residual_bound=m_resid, pad=pad,
                h=h_img, w=w_img),
            [lags, shifts], n_lags, min(CHUNK_SELECT, max(n_lags, 1)),
            label="select lag search")
    elif mesh is None:
        logger.info("engine path: per-lag gather")
        out = run_chunked(
            lambda lg: _evaluate_flat(
                lg, small_d, ref_d, lon_d, lat_d, base_d,
                order=order, method=method, kind=kind,
                batch_size=batch_size),
            [lags], n_lags, min(CHUNK_GATHER, max(n_lags, 1)),
            label="gather lag search")
    else:
        ndev = mesh.devices.size
        n_pad = math.ceil(n_lags / ndev) * ndev
        lags_p = lags if n_pad == n_lags else np.concatenate(
            [lags, np.zeros((n_pad - n_lags, 5), dtype=lags.dtype)], axis=0)
        lags_d = mesh_put(lags_p, mesh, P("lags"), dtype=compute_dtype)
        fn = _sharded_evaluator(mesh, order, method, kind, batch_size)
        with mesh:
            out = fn(lags_d, small_d, ref_d, lon_d, lat_d, base_d)
        out = np.asarray(out)[:n_lags]

    return out.astype(np.float64).reshape(shape)


def _displacements_full(base: dict, lags: np.ndarray, lon, lat, kind: str):
    """Per-lag pixel displacement (center value + probe spread) under the
    FULL 5-vector lag (crval1/2, cdelt1/2, crota), float64 host math.

    The spread bounds the non-translation residual of the warp — rotation
    and scale lags make it grow with the field of view.  Memoized on the
    (WCS scalars, probe coordinates, lag set) digest like the other pure
    host prep (utils/memo.py)."""
    from ..utils import memo

    pl, pb, px0, py0 = probe_values(lon, lat)
    key = memo.digest({k: np.float64(v) for k, v in base.items()},
                      np.ascontiguousarray(lags), pl, pb, px0, py0, kind)
    hit = _DISPF_CACHE.get(key)
    if hit is not None:
        return hit

    crval1 = base["crval1"] + lags[:, 0]
    crval2 = base["crval2"] + lags[:, 1]
    cdelt1 = base["cdelt1"] + lags[:, 2]
    cdelt2 = base["cdelt2"] + lags[:, 3]
    crota = base["crota"] + lags[:, 4]
    rebuild = (lags[:, 2] != 0) | (lags[:, 3] != 0) | (lags[:, 4] != 0)
    rho = np.deg2rad(crota)
    lam = cdelt2 / cdelt1
    p = {
        "crval1": crval1[:, None], "crval2": crval2[:, None],
        "crpix1": float(base["crpix1"]), "crpix2": float(base["crpix2"]),
        "cdelt1": cdelt1[:, None], "cdelt2": cdelt2[:, None],
        "pc11": np.where(rebuild, np.cos(rho), base["pc11"])[:, None],
        "pc12": np.where(rebuild, -lam * np.sin(rho), base["pc12"])[:, None],
        "pc21": np.where(rebuild, np.sin(rho) / lam, base["pc21"])[:, None],
        "pc22": np.where(rebuild, np.cos(rho), base["pc22"])[:, None],
    }
    bx, by = wcs.world_to_pixel(p, pl[None, :], pb[None, :], kind=kind, xp=np)
    cs = np.stack([bx - px0[None, :], by - py0[None, :]], axis=-1)  # (L, 5, 2)
    center = cs[:, 0, :]
    spread = float(np.max(np.abs(cs - center[:, None, :]))) if cs.size else 0.0
    return _DISPF_CACHE.put(key, (center, spread))


def _apply_lag_to_params_np(base: dict, d5: np.ndarray) -> dict:
    """Host float64 twin of :func:`apply_lag_to_params`."""
    crval1 = base["crval1"] + d5[0]
    crval2 = base["crval2"] + d5[1]
    cdelt1 = base["cdelt1"] + d5[2]
    cdelt2 = base["cdelt2"] + d5[3]
    crota = base["crota"] + d5[4]
    out = dict(base, crval1=crval1, crval2=crval2,
               cdelt1=cdelt1, cdelt2=cdelt2, crota=crota)
    if d5[2] != 0 or d5[3] != 0 or d5[4] != 0:
        rho = np.deg2rad(crota)
        lam = cdelt2 / cdelt1
        out["pc11"] = np.cos(rho)
        out["pc12"] = -lam * np.sin(rho)
        out["pc21"] = np.sin(rho) / lam
        out["pc22"] = np.cos(rho)
    return out


def _evaluate_block_fast(small_img, ref_img, lon, lat, base_params,
                         l1, l2, l3, l4, l5, *, order, kind, compute_dtype,
                         method="correlation"):
    """Block fast path for mixed lag grids.

    For each (cdelt1, cdelt2, crota) combination, the small image is warped
    ONCE onto the comparison grid with the combo's WCS (one general gather),
    after which the crval1/crval2 sub-grid factorizes over FFT correlation
    surfaces exactly as in :mod:`fast_corr`.  The surface builds of ALL
    combos run in ONE device program (the movie fleet path with the combo
    axis as the frame axis, :func:`fast_corr.evaluate_movie_from_displacements`)
    instead of one serial surface build and dispatch chain per combo.
    Reference turf: one full reprojection per
    (cdelt, crota) lag per crval lag (alignment.py:519,1018-1029).

    Numerics note: this applies the spline interpolation twice (pre-warp +
    per-lag tap stencil) where the exact per-lag engine interpolates once —
    a sub-percent smoothing difference on the correlation values.  Alignment
    argmaxes are insensitive to it (tested); pass ``allow_fast=False`` for
    the single-interpolation reference-exact path.
    """
    from ..utils import obs
    from . import fast_corr

    out = np.zeros((len(l1), len(l2), len(l3), len(l4), len(l5)))
    small_d = jnp.asarray(small_img, dtype=compute_dtype)
    lon_d = jnp.asarray(lon, dtype=compute_dtype)
    lat_d = jnp.asarray(lat, dtype=compute_dtype)

    combos = [(i3, i4, i5,
               _apply_lag_to_params_np(base_params,
                                       np.array([0.0, 0.0, d3, d4, d5])))
              for i3, d3 in enumerate(l3)
              for i4, d4 in enumerate(l4)
              for i5, d5 in enumerate(l5)]

    def combo_device_params(combo):
        return {k: jnp.asarray(v, dtype=compute_dtype)
                for k, v in combo.items() if k != "crota"}

    # fleet route: per-combo displacements first (cheap host math, and the
    # spread gate bails before any device work), then all warps, then one
    # batched surface+readout program over the combo axis
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    lags2 = np.stack([g1.ravel(), g2.ravel()], axis=-1)     # (L, 2) deg
    with obs.stage("fast_hostprep_s"):
        cs, spreads = fast_corr.displacement_per_lag_multi(
            [combo for _i3, _i4, _i5, combo in combos], lags2, lon, lat,
            kind, grid=base_params)
        if float(np.max(spreads)) > fast_corr.MAX_DISPLACEMENT_SPREAD_PX:
            cs = None
    def warp_plan(combo):
        # identity of the world grids + the combo's host scalars uniquely
        # determine the warp coordinates (auto-sampler plan memo)
        return ((lon_d, lat_d),
                (sorted((k, float(v)) for k, v in combo.items()), kind))

    # memory guard for the fleet route: it stacks EVERY combo's full-size warp
    # plus a ref copy before the movie program's own per-frame product
    # stack.  Large combo grids (e.g. 5x5x5 = 125 combos at 2048^2 = 4 GB
    # of frames) must keep the old one-warp-resident route — an OOM inside
    # the fleet program would abort the search, not fall back.
    fleet_bytes = (2 * len(combos) * int(np.prod(np.shape(small_img)))
                   * jnp.dtype(compute_dtype).itemsize)
    budget = fleet_stack_budget_bytes()
    if fleet_bytes > budget:
        obs.logger.info(
            "block fleet declined: %d combo frames = %.1f GB of stacked "
            "canvases > %.1f GB budget; per-combo route",
            len(combos), fleet_bytes / 1e9, budget / 1e9)
        cs = None

    if cs is not None:
        with obs.stage("fast_warps_s"):
            warps = [_warp_by_params(small_d, lon_d, lat_d,
                                     combo_device_params(combo), kind, order,
                                     plan=warp_plan(combo))
                     for _i3, _i4, _i5, combo in combos]
        ref_d = jnp.asarray(ref_img, dtype=compute_dtype)
        smalls = jnp.stack(warps)
        refs = jnp.broadcast_to(ref_d[None], smalls.shape)
        with obs.stage("fast_fleet_s"):
            vals = fast_corr.evaluate_movie_from_displacements(
                smalls, refs, cs, order=order,
                compute_dtype=compute_dtype, method=method)
        if vals is not None:
            for k, (i3, i4, i5, _c) in enumerate(combos):
                out[:, :, i3, i4, i5] = vals[k].reshape(len(l1), len(l2))
            return out

    # per-combo fallback (fleet preconditions failed)
    for i3, i4, i5, combo in combos:
        warped = _warp_by_params(small_d, lon_d, lat_d,
                                 combo_device_params(combo), kind, order,
                                 plan=warp_plan(combo))
        block = fast_corr.evaluate_crval_grid_fast(
            warped, ref_img, lon, lat, combo, l1, l2,
            order=order, kind=kind, compute_dtype=compute_dtype,
            grid_params=base_params, method=method,
        )
        if block is None:
            return None
        out[:, :, i3, i4, i5] = block
    return out


@partial(jax.jit, static_argnames=("h", "w", "kind", "wrap"))
def compute_world_grid(small_params, h, w, kind, wrap):
    """Device-side world coordinates of the comparison grid."""
    x = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    y = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    lon, lat = wcs.pixel_to_world(small_params, x, y, kind=kind)
    if wrap:
        lon = wcs.ang2pipi_deg(lon)
        lat = wcs.ang2pipi_deg(lat)
    return lon, lat


world_grid_jit = jax.jit(compute_world_grid,
                         static_argnames=("h", "w", "kind", "wrap"))


@partial(jax.jit, static_argnames=("h", "w", "kind", "wrap", "order", "m", "pad",
                                   "h_src", "w_src"))
def _submap_select_jit(padded_large, small_params, large_params, h, w, kind,
                       wrap, order, sx, sy, m, pad, h_src, w_src):
    """Submap via the gather-free select sampler (same-instrument pairs)."""
    lon, lat = compute_world_grid(small_params, h, w, kind, wrap)
    x, y = wcs.world_to_pixel(large_params, lon, lat, kind=kind)
    ref = resample.sample_image_select(
        padded_large, x, y, order, sx, sy, residual_bound=m, pad=pad,
        h=h_src, w=w_src)
    return lon, lat, ref


@partial(jax.jit, static_argnames=("h", "w", "kind", "wrap", "order"))
def prepare_grid_and_submap(data_large, small_params, large_params, h, w,
                            kind, wrap, order):
    """Device-side pipeline head: build the comparison grid's world
    coordinates from the small header and resample the reference image onto
    it (the submap step, alignment.py:987-1016) — no coordinate fields ever
    cross host<->device.

    Returns (lon, lat, ref_img) as device arrays of shape (h, w)."""
    x = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    y = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    lon, lat = wcs.pixel_to_world(small_params, x, y, kind=kind)
    if wrap:
        lon = wcs.ang2pipi_deg(lon)
        lat = wcs.ang2pipi_deg(lat)
    xg, yg = wcs.world_to_pixel(large_params, lon, lat, kind=kind)
    ref_img = resample.sample_image(data_large, xg, yg, order=order,
                                    cval=jnp.nan)
    return lon, lat, ref_img


# identity-keyed probe cache for DEVICE coordinate fields: the two tiny
# gathers cost a host sync per call, and the same device arrays are probed
# on every warm search.  Numpy inputs skip
# the cache — host indexing is free and the caller may mutate them in
# place (see utils.memo.IdentityCache for the id-safety argument).
_PROBE_CACHE = _memo.IdentityCache(maxsize=4)


def probe_pixel_points(h, w):
    """The 5 standard probe pixels (center + corners) as float64 (x, y)
    arrays — the single source of the convention shared by probe_values,
    seed_probe_values, and the submap flow's host probe math."""
    px0 = np.array([w // 2, 0, w - 1, 0, w - 1], dtype=np.float64)
    py0 = np.array([h // 2, 0, 0, h - 1, h - 1], dtype=np.float64)
    return px0, py0


def seed_probe_values(lon, lat, pl, pb):
    """Pre-populate the probe cache for freshly built DEVICE grids with
    host-computed world values: extracting the 5 probes from a new device
    array costs a host sync, but the grid builder knows the exact WCS the
    grid was computed from and can
    evaluate the probes in host float64 directly (same formula; the f64
    values differ from the device f32 grid by ~1e-9 deg — well under any
    displacement tolerance).  No-op for host arrays."""
    if isinstance(lon, np.ndarray):
        return
    h, w = lon.shape
    px0, py0 = probe_pixel_points(h, w)
    _PROBE_CACHE.put((lon, lat), None,
                     (np.asarray(pl, dtype=np.float64),
                      np.asarray(pb, dtype=np.float64), px0, py0))


def probe_values(lon, lat):
    """World coordinates at the 5 standard probe points (center + corners),
    as float64 numpy — one tiny transfer when lon/lat live on device."""
    h, w = lon.shape
    px0, py0 = probe_pixel_points(h, w)
    pts = [(int(i), int(j)) for i, j in zip(py0, px0)]
    if isinstance(lon, np.ndarray):
        pl = np.array([lon[i, j] for i, j in pts], dtype=np.float64)
        pb = np.array([lat[i, j] for i, j in pts], dtype=np.float64)
    else:
        hit = _PROBE_CACHE.get((lon, lat))
        if hit is not None:
            return hit
        ii = jnp.array([i for i, _ in pts])
        jj = jnp.array([j for _, j in pts])
        vals = np.asarray(jnp.stack([lon[ii, jj], lat[ii, jj]]),
                          dtype=np.float64)
        pl, pb = vals[0], vals[1]
        return _PROBE_CACHE.put((lon, lat), None, (pl, pb, px0, py0))
    return pl, pb, px0, py0


def resample_to_grid(image, x, y, order=2, compute_dtype=jnp.float32):
    """One-shot device resample (used for the reference-image submap,
    ``alignment.py:987-1016``).

    Routes through the gather-free select sampler when the coordinate field
    is a bounded-residual translation (e.g. same-instrument jitter movies),
    falling back to the gather sampler otherwise.  Tiny point counts on
    host-resident images sample on the HOST instead: shipping a multi-MB
    image to the device to read a few thousand slit coordinates costs more
    transfer than the numpy work (synras raster columns, SPICE context
    rasters).
    """
    x = np.asarray(x)
    y = np.asarray(y)
    if (isinstance(image, np.ndarray) and image.ndim == 2
            and x.size * 32 < image.size):
        return resample.sample_image_np(
            image.astype(np.dtype(compute_dtype)), x, y, order=order)
    img = jnp.asarray(image, dtype=compute_dtype)

    cfg = None
    if (order in (0, 1, 2) and x.ndim == 2
            and np.shape(image) == x.shape == y.shape):
        h, w = x.shape
        pr = [(h // 2, w // 2), (0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)]
        cx = np.array([x[i, j] - j for i, j in pr])
        cy = np.array([y[i, j] - i for i, j in pr])
        if np.isfinite(cx).all() and np.isfinite(cy).all():
            sx = int(np.floor(cx[0] + 0.5))
            sy = int(np.floor(cy[0] + 0.5))
            spread = max(np.max(np.abs(cx - cx[0])), np.max(np.abs(cy - cy[0])))
            m = int(np.ceil(spread)) + 1
            pad = max(abs(sx), abs(sy)) + m + 2
            if m <= 16 and pad <= min(h, w) - 1:
                cfg = (sx, sy, m, pad, h, w)
    if cfg is not None:
        sx, sy, m, pad, h, w = cfg
        out = _resample_select_jit(
            jnp.pad(img, pad, mode="reflect"),
            jnp.asarray(x, dtype=compute_dtype),
            jnp.asarray(y, dtype=compute_dtype),
            order, sx, sy, m, pad, h, w,
        )
        return np.asarray(out, dtype=np.float64)

    out = _resample_jit(img, jnp.asarray(x, dtype=compute_dtype),
                        jnp.asarray(y, dtype=compute_dtype), order)
    return np.asarray(out, dtype=np.float64)


@partial(jax.jit, static_argnames=("order", "m", "pad", "h", "w"))
def _resample_select_jit(padded, x, y, order, sx, sy, m, pad, h, w):
    return resample.sample_image_select(
        padded, x, y, order, sx, sy, residual_bound=m, pad=pad, h=h, w=w)


@partial(jax.jit, static_argnames=("order",))
def _resample_jit(img, x, y, order):
    return resample.sample_image(img, x, y, order=order, cval=jnp.nan)


@partial(jax.jit, static_argnames=("kind",))
def _warp_coords(lon, lat, params, kind):
    return wcs.world_to_pixel(params, lon, lat, kind=kind)


def _warp_by_params(img, lon, lat, params, kind, order, plan=None):
    """Warp img onto the (lon, lat) grid through the given WCS, on device.

    Comparison grids oversample the detector, so the gather-free tile
    contraction (resample.sample_image_upsample) usually applies (one warp
    per cdelt/crota combo of the mixed-grid block path).

    ``plan``: optional ``(plan_ident, plan_key)`` forwarded to the auto
    sampler — the warp coordinates are a pure function of (lon, lat,
    params, kind), so callers that can name those let warm repeated warps
    skip the planning sync."""
    x, y = _warp_coords(lon, lat, params, kind)
    if plan is None:
        return resample.sample_image_auto(img, x, y, order=order)
    return resample.sample_image_auto(img, x, y, order=order,
                                      plan_ident=plan[0], plan_key=plan[1])
