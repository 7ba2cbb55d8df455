"""Tile-local FFT factorization of the quadratic-displacement lag search.

The Carrington select path scores L lags by sampling a pre-warped canvas
through per-lag quadratic displacement fields (engine/carrington.py
``_carrington_select``).  The exact evaluator
(``carrington.evaluate_quad_lags``) is inherently per-lag: ~0.12 ms/lag at
2048^2 on an H100, so a 121x121 grid costs ~1.8 s.

This module factorizes the whole lag grid over tile-local FFT correlation
surfaces instead (replacing the reference's one-full-reprojection-per-lag
loop, ``/root/reference/euispice_coreg/hdrshift/alignment.py:889-937``):

* within a tile of size T, each lag's displacement field is approximated by
  its value at the tile center — constant integer shift + constant
  fractional spline weights;
* per tile, every masked-Pearson sum then factorizes over cross-correlation
  surfaces between the ref tile and the (shifted) canvas fields, exactly as
  in engine/fast_corr.py — 58 forward FFTs + 66 box-restricted inverse
  DFTs per tile, evaluated once for ALL lags;
* per (tile, lag): one row-gather of the 66 surface values at the tile's
  integer offset + the fractional tap-weight combination.

Accuracy contract: the within-tile displacement deviation (measured in
DETECTOR pixels — the canvas is typically 10-20x oversampled relative to
the detector, so grid-pixel deviations overstate the sampling error by the
oversampling factor) must stay below ``tol_det``, the same 0.05 px scale
the helioprojective FFT fast path enforces globally
(fast_corr.MAX_DISPLACEMENT_SPREAD_PX).  The tile size is chosen
adaptively; if no size meets the bound the caller falls back to the exact
per-lag evaluator.  Tests pin argmax parity and value agreement against
the exact engine.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import obs

# Within-tile sampling-position tolerance, DETECTOR pixels.  Same role as
# fast_corr.MAX_DISPLACEMENT_SPREAD_PX (which gates the global-constant
# approximation of the helioprojective fast path) but looser: within-tile
# deviations are near-antisymmetric about the tile center, so their net
# effect on the tile's correlation sums cancels to first order.  Empirical
# calibration on the 2048^2 bench config: at 0.12 det-px deviation
# (T=256) the near-peak correlation difference vs the exact per-lag
# evaluator is ~1e-6 — three orders below the value changes the Gaussian
# sub-pixel
# fit responds to — and the total error stays dominated by the select
# path's shared pre-warp double interpolation.
TOL_DET_PX = 0.15

# Largest-first: bigger tiles amortize the per-tile FFT cost (and 384
# typically lands on a power-of-2 transform size); the deviation gate
# rejects sizes whose within-tile displacement variation is too large.
# 1024/768 matter for pick_tile_shape: an anisotropic deviation lets ONE
# axis grow far past the square limit (fewer tiles, same accuracy).
# 96/64 widen the path to WEAKLY-oversampled Carrington grids (the
# coarse-grid fallback regime): their deviation is strongly anisotropic
# (lon-axis dominated), so a narrow-wide rectangle like (384, 64) passes
# the detector-px gate where every >=128 square fails — without them those
# grids pay the exact per-lag evaluator for every lag.
_TILE_SIZES = (1024, 768, 512, 384, 256, 192, 128, 96, 64)
# Weakly-oversampled grids (scale_det_per_grid ~ 0.15-0.3) need 64-px
# tiles to meet the detector-px gate (within-tile deviation halves vs 128),
# which is ~1k tiles at 2048^2 — the stage-1 working set is bounded by the
# memory budget guard below, not by the tile count, so the cap only has to
# stop degenerate thousands-of-tiny-tiles picks.
_MAX_TILES = 1100

# Share of the device's allocatable memory the stage-1 working set may
# use.  The dominant resident terms are the stacked per-tile surface boxes
# (n_tiles x n_surf x by x bx) and the globally padded r field stack.  On
# wide lag grids over strongly oversampled canvases the per-tile offset
# span approaches the LAG span in grid px (e.g. +-121 arcsec at ~0.05
# arcsec/grid-px = +-2470 px), so the dense correlation boxes dwarf the
# tiles themselves: hundreds of GB of surface for ~14k needed offsets.
# The factorization is the wrong shape there (the surface is ~0.3%
# utilized) and must decline to the exact per-lag evaluator instead of
# letting XLA fail the allocation; the remaining share covers the
# canvases, the padded r stack transient and XLA's own slack.
_MEM_BUDGET_FRACTION = 0.375


def _mem_budget_bytes(device=None) -> float:
    from ..utils.jaxcfg import device_memory_bytes

    return _MEM_BUDGET_FRACTION * device_memory_bytes(device)


def _plane_counts(order: int) -> tuple[int, int]:
    """(n_surf, n_rfields): per-tile surface planes emitted by stage 1 and
    padded r field planes (see _tiles_surfaces rsl/_build_fields)."""
    nt = _tap_count(order) ** 2
    npairs = nt * (nt + 1) // 2
    return 3 + 2 * nt + npairs, 1 + nt + npairs


def _mem_group_plan(order, by, bx, Htot, Wtot, itemsize, batch):
    """Shared working-set planner for the evaluator's memory guard and the
    hybrid picker's screen (one source of truth so the two cannot drift).

    The dominant allocations are the padded r stack (n_rf, Htot, Wtot) and
    the resident per-tile surface boxes (group, n_surf, by, bx); stage-1
    transients scale with ``batch`` only and ride the slack the budget
    already reserves (see _MEM_BUDGET_FRACTION).  ``group`` is the
    largest number of tiles whose boxes fit beside the r stack, rounded
    down to a multiple of ``batch`` (the scan step size).

    Returns ``(group, rpad_bytes, box_bytes_per_tile)``: ``group < batch``
    means even one scan step cannot fit (caller declines); a group at or
    above the caller's tile count means single-pass (caller uses
    group=None)."""
    n_surf, n_rf = _plane_counts(order)
    bt = n_surf * by * bx * itemsize
    rpad_bytes = n_rf * Htot * Wtot * itemsize
    budget = _mem_budget_bytes()
    group = int((budget - rpad_bytes) // max(bt, 1))
    group -= group % max(batch, 1)
    return group, rpad_bytes, bt


# Planning cost of the per-tile transforms, seconds per plane-pixel of
# transform area: _est_stage1_seconds counts n_tiles x (n_surf + n_rf + 3)
# planes of my x mx.  Measured on an NVIDIA H100 80GB HBM3 at a 400 W power
# limit: the whole evaluator (stage 1 + stage 2, tile batch 4) scored the
# 0.5-arcsec 121x121 Carrington grid at 2048^2 in 0.136 s over 24 tiles of
# 896x1152 transforms, i.e. 4.4e-11 s per plane-pixel (PERF.md).  Used only
# for host-side PLANNING (the screens against the exact evaluator), never
# for reporting.
_EST_S_PER_PLANE_PX = 4.4e-11

# Planning cost of the exact per-lag evaluator (carrington.evaluate_quad_
# lags) per lag on a 2048^2 canvas: 1.2e-4 s at a 700 W and 1.3e-4 s at a
# 400 W power limit, measured on the coarse 121x121 Carrington grid on an
# NVIDIA H100 80GB HBM3; scaled by canvas area for other shapes.  Used by
# the screens, never for reporting.
_EST_EXACT_S_PER_LAG_2048 = 1.3e-4


def _est_exact_seconds(n_lags: int, h: int, w: int) -> float:
    return n_lags * _EST_EXACT_S_PER_LAG_2048 * (h * w) / 2048.0 ** 2


def _est_stage1_seconds(n_tiles: int, n_planes: int, my: int, mx: int):
    """Estimated wall-clock of the per-tile transforms and readout."""
    return n_tiles * n_planes * my * mx * _EST_S_PER_PLANE_PX


# stage-1 tiles per scan step: on the bench Carrington grid batch 4 took
# 0.136 s against 0.143 s at batch 1 and 0.138 s at batch 8 (H100 at
# 400 W, PERF.md); the transient grows with the batch (~1 GB at 4 on
# 2048^2 shapes)
_TILE_BATCH = 4

from ..utils import memo  # noqa: E402

# warm-call memoization of pure host prep (VERDICT r04 weak #7): the
# tile-shape gate and the per-tile offset bounds are pure functions of the
# (lag set, geometry) signature
_GATE_CACHE = memo.FIFOCache(maxsize=16)
_BOUNDS_CACHE = memo.FIFOCache(maxsize=16)


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _tap_count(order: int) -> int:
    return 1 if order == 0 else 3


def _quad_eval(coeffs, u, v):
    """Evaluate the (L, 6, 2) quadratic displacement maps at points (u, v).

    coeffs columns: [x, y, 1, x^2, y^2, x*y] -> (dx, dy).  Returns (L, P, 2)
    (numpy or jnp depending on inputs)."""
    xp = jnp if isinstance(coeffs, jax.Array) else np
    basis = xp.stack([u, v, xp.ones_like(u), u * u, v * v, u * v], axis=0)
    return xp.einsum("lck,cp->lpk", coeffs, basis)


@partial(jax.jit, static_argnames=("th", "tw", "n_ty", "n_tx"))
def _tile_offset_bounds_jit(coeffs_d, th, tw, n_ty, n_tx):
    """Per-tile [min, max] of the rounded tile-center offsets over all lags,
    computed ON DEVICE: the (L, n_tiles, 2) table never exists on the host
    (no per-tile host einsum loop over ~200 tiles).  +-1 slack covers
    rounding differences vs the
    readout's own floor(c + 0.5) (same dtype, same arithmetic)."""
    dt = coeffs_d.dtype
    t = jnp.arange(n_ty * n_tx, dtype=jnp.int32)
    u = ((t % n_tx) * tw).astype(dt) + (tw - 1) / 2.0
    v = ((t // n_tx) * th).astype(dt) + (th - 1) / 2.0
    o = jnp.floor(_quad_eval(coeffs_d, u, v) + 0.5)     # (L, n_tiles, 2)
    return (jnp.min(o, axis=0) - 1).astype(jnp.int32), \
           (jnp.max(o, axis=0) + 1).astype(jnp.int32)


def _per_tile_offset_bounds(coeffs, th, tw, n_ty, n_tx):
    """Host fallback of :func:`_tile_offset_bounds_jit` (mesh runs, where
    committing to the default device would violate placement discipline).
    Host float64, one (L, 2) temporary per tile — never an (L, n_tiles)
    table."""
    n_tiles = n_ty * n_tx
    o_min_t = np.empty((n_tiles, 2), dtype=np.int64)
    o_max_t = np.empty((n_tiles, 2), dtype=np.int64)
    for t in range(n_tiles):
        u = (t % n_tx) * tw + (tw - 1) / 2.0
        v = (t // n_tx) * th + (th - 1) / 2.0
        c = _quad_eval(coeffs, np.array([u]), np.array([v]))[:, 0, :]  # (L,2)
        o = np.floor(c + 0.5)
        o_min_t[t] = o.min(axis=0) - 1
        o_max_t[t] = o.max(axis=0) + 1
    return o_min_t, o_max_t  # each (n_tiles, 2) in (x, y) order


def _tile_bounds(coeffs, h, w, n_ty, n_tx, th, tw):
    """(dev_x, dev_y): the max over lags of :func:`_tile_bounds_per_lag`,
    via corner/worst-case analysis only (no (L, n_tiles) arrays)."""
    dev_l = _tile_bounds_per_lag(coeffs, h, w, n_ty, n_tx, th=th, tw=tw)
    dev_x = float(np.max(dev_l[:, 0])) if dev_l.size else 0.0
    dev_y = float(np.max(dev_l[:, 1])) if dev_l.size else 0.0
    return dev_x, dev_y


def _corner_centers(h, w, n_ty, n_tx, th, tw):
    """Tile-center coordinates of the four corner tiles, (u, v) each (4,)."""
    u0 = 0.5 * (0 + min(tw - 1, w - 1))
    u1 = 0.5 * ((n_tx - 1) * tw + min(n_tx * tw - 1, w - 1))
    v0 = 0.5 * (0 + min(th - 1, h - 1))
    v1 = 0.5 * ((n_ty - 1) * th + min(n_ty * th - 1, h - 1))
    uu, vv = np.meshgrid([u0, u1], [v0, v1], indexing="ij")
    return uu.ravel(), vv.ravel()


def _tile_bounds_per_lag(coeffs, h, w, n_ty, n_tx, th, tw):
    """Per-lag bound (L, 2), (x, y) order, on how far the displacement
    strays from its tile-center value inside any tile.  It scales ~linearly
    with the lag magnitude, so the inner part of a lag grid usually passes
    the tile-FFT gate even when the corner lags fail it (the hybrid route of
    engine/carrington._carrington_select)."""
    L = coeffs.shape[0]
    uu, vv = _corner_centers(h, w, n_ty, n_tx, th, tw)
    ck = np.ascontiguousarray(coeffs.transpose(0, 2, 1)).reshape(L * 2, 6)
    one = np.ones_like(uu)
    zero = 0 * uu
    basis_gu = np.stack([one, zero, zero, 2.0 * uu, zero, vv])
    basis_gv = np.stack([zero, one, zero, zero, 2.0 * vv, uu])
    hx_m, hy_m = 0.5 * (tw - 1), 0.5 * (th - 1)
    gu = np.abs((ck @ basis_gu).reshape(L, 2, -1))
    gv = np.abs((ck @ basis_gv).reshape(L, 2, -1))
    quad = (np.abs(coeffs[:, 3, :, None]) * (hx_m * hx_m)
            + np.abs(coeffs[:, 4, :, None]) * (hy_m * hy_m)
            + np.abs(coeffs[:, 5, :, None]) * (hx_m * hy_m))
    dev = gu * hx_m + gv * hy_m + quad                        # (L, 2, 4)
    return dev.max(axis=2)                                    # (L, 2) x/y


def pick_tile_size(coeffs, h, w, scale_det_per_grid, tol_det=TOL_DET_PX,
                   tile_sizes=_TILE_SIZES, max_tiles=_MAX_TILES):
    """Largest SQUARE tile size whose within-tile displacement deviation,
    converted to detector pixels, meets ``tol_det``.  Returns (T, dev_det)
    or None.  Kept as the gate probe (a square passing means the path is
    viable); the evaluator itself picks a rectangle (pick_tile_shape)."""
    for T in tile_sizes:
        n_ty = -(-h // T)
        n_tx = -(-w // T)
        if n_ty * n_tx > max_tiles:
            continue
        dev_x, dev_y = _tile_bounds(coeffs, h, w, n_ty, n_tx, th=T, tw=T)
        dev_det = max(dev_x, dev_y) * scale_det_per_grid
        if dev_det <= tol_det:
            return T, dev_det
    return None


def pick_tile_shape(coeffs, h, w, scale_det_per_grid, tol_det=TOL_DET_PX,
                    tile_sizes=_TILE_SIZES, max_tiles=_MAX_TILES):
    """Cheapest RECTANGULAR tile shape meeting the deviation gate.

    The within-tile displacement deviation is typically anisotropic (on the
    2048² bench config dev_x ≈ 4 × dev_y), so rectangles pass where the
    next-larger square fails: (384, 512) gives 24 tiles where the square
    gate stops at 384² = 36 — ~25% less stage-1 transform work and ~33%
    less stage-2 readout.

    Cost model: n_tiles × round128(th + span_y) × round128(tw + span_x),
    with the lag-driven offset span estimated once from the image-center
    offsets (one (L, 2) temporary; the exact per-tile boxes are computed
    later and differ only by the small cross-tile variation).  Returns
    ((th, tw), dev_det) or None when no candidate passes.

    Host-cost discipline: the deviation is a max over ALL lags, but running
    the full-L bound for every (th, tw) candidate costs 49 candidates × a
    (2L, 6) copy + matmuls.  A lag SUBSAMPLE gives a sound rejector — a
    subsample max is a lower bound, so sub-dev > tol already disqualifies
    — and the
    survivors are exact-checked in estimated-cost order until one passes
    (the gate itself stays exact; typically 1-2 full-L calls)."""
    uc = np.array([(w - 1) / 2.0])
    vc = np.array([(h - 1) / 2.0])
    c = _quad_eval(coeffs, uc, vc)[:, 0, :]                     # (L, 2)
    span_x, span_y = (np.ceil(c.max(axis=0)) - np.floor(c.min(axis=0)) + 3)

    L = coeffs.shape[0]
    sub = coeffs[:: max(1, L // 256)] if L > 512 else coeffs

    cands = []
    for th in tile_sizes:
        n_ty = -(-h // th)
        for tw in tile_sizes:
            n_tx = -(-w // tw)
            if n_ty * n_tx > max_tiles:
                continue
            dev_x, dev_y = _tile_bounds(sub, h, w, n_ty, n_tx, th=th,
                                        tw=tw)
            if max(dev_x, dev_y) * scale_det_per_grid > tol_det:
                continue  # sound: the full-lag max can only be larger
            cost = (n_ty * n_tx * _round128(th + span_y + 2 * dev_y)
                    * _round128(tw + span_x + 2 * dev_x))
            cands.append((cost, th, tw, n_ty, n_tx))

    for _cost, th, tw, n_ty, n_tx in sorted(cands):
        dev_x, dev_y = _tile_bounds(coeffs, h, w, n_ty, n_tx, th=th,
                                    tw=tw)
        dev_det = max(dev_x, dev_y) * scale_det_per_grid
        if dev_det <= tol_det:
            return (th, tw), dev_det
    return None


def pick_tile_shape_hybrid(coeffs, h, w, scale_det_per_grid,
                           tol_det=TOL_DET_PX, tile_sizes=_TILE_SIZES,
                           max_tiles=_MAX_TILES, min_pass_frac=0.5,
                           order_hint=2, compute_dtype="float32",
                           mesh=None):
    """Per-lag gate for the hybrid Carrington fallback.

    Called when :func:`pick_tile_shape` rejected the FULL lag set: the
    within-tile deviation grows ~linearly with the lag magnitude, so on
    gradient-dominated coarse grids the inner part of a lag grid usually
    meets ``tol_det`` even when the corner lags force the exact path.
    Finds the tile shape admitting the most lags individually (cost as the
    tiebreak among near-best shapes) so the engine can score the passing
    set via tile-FFT surfaces and only the failing remainder via the exact
    per-lag evaluator.

    Returns ``((th, tw), pass_mask)`` with ``pass_mask`` an exact (L,)
    bool of per-lag gate decisions, or None when fewer than
    ``min_pass_frac`` of the lags pass for every candidate shape (the
    hybrid's fixed stage-1 cost then outweighs the saved exact-path
    time).  Host-cost discipline mirrors pick_tile_shape: candidates are
    ranked on a lag subsample (per-lag bounds are exact per sampled lag),
    and only the leaders pay the full-L bound."""
    L = coeffs.shape[0]
    if L == 0:
        return None
    idx_sub = np.arange(L)[:: max(1, L // 256)] if L > 512 else np.arange(L)
    sub = coeffs[idx_sub]

    cands = []
    for th in tile_sizes:
        n_ty = -(-h // th)
        for tw in tile_sizes:
            n_tx = -(-w // tw)
            if n_ty * n_tx > max_tiles:
                continue
            dev_l = _tile_bounds_per_lag(sub, h, w, n_ty, n_tx,
                                             th=th, tw=tw)
            ok = (dev_l.max(axis=1) * scale_det_per_grid) <= tol_det
            frac = float(ok.mean())
            if frac < min_pass_frac:
                continue
            # cheap cost proxy: tile count x tile area (the offset span is
            # lag-driven and shape-independent, so it drops out of ranking)
            cost = n_ty * n_tx * _round128(th) * _round128(tw)
            cands.append((-frac, cost, th, tw, n_ty, n_tx))

    if not cands:
        return None
    cands.sort()
    best_frac = -cands[0][0]
    # among shapes within 2% of the best subsample pass-rate, try cheapest
    # first; the final mask is exact (full L)
    leaders = [c for c in cands if -c[0] >= best_frac - 0.02]
    leaders.sort(key=lambda c: c[1])
    for _nf, _cost, th, tw, n_ty, n_tx in leaders[:4]:
        dev_l = _tile_bounds_per_lag(coeffs, h, w, n_ty, n_tx,
                                         th=th, tw=tw)
        mask = (dev_l.max(axis=1) * scale_det_per_grid) <= tol_det
        if float(mask.mean()) < min_pass_frac:
            continue
        # working-set screen (mirrors evaluate_select_tile_fft's memory
        # guard): the per-tile box span across the PASSING lags is
        # lag-driven and near-identical for every tile, so five
        # representative tile centers bound it well.  Without this the
        # hybrid would hand back shapes whose evaluation declines anyway
        # (wide spans on oversampled canvases need dense surfaces that
        # dwarf device memory).
        cm = coeffs[mask]
        uu = np.array([0.5 * (tw - 1), (n_tx - 0.5) * tw - 0.5,
                       0.5 * (tw - 1), (n_tx - 0.5) * tw - 0.5,
                       0.5 * n_tx * tw])
        vv = np.array([0.5 * (th - 1), 0.5 * (th - 1),
                       (n_ty - 0.5) * th - 0.5, (n_ty - 0.5) * th - 0.5,
                       0.5 * n_ty * th])
        o = np.floor(_quad_eval(cm, uu, vv) + 0.5)       # (Lm, 5, 2)
        span = (o.max(axis=0) - o.min(axis=0)).max(axis=0)  # (2,) x/y
        bx_e, by_e = int(span[0]) + 3, int(span[1]) + 3
        # same planner as the evaluator's guard (tiles run in GROUPS, so
        # only one scan step's boxes + the r stack need fit): a shape the
        # evaluator would run must never be screened out here — including
        # the per-device batch clamp the evaluator applies on a mesh
        max_batch = n_ty * n_tx
        if mesh is not None and mesh.devices.size > 1:
            max_batch = -(-max_batch // mesh.devices.size)
        batch = max(1, min(_TILE_BATCH, max_batch))
        item = jnp.dtype(compute_dtype).itemsize
        group, rpad_bytes, bt = _mem_group_plan(
            order_hint, by_e, bx_e,
            n_ty * th + by_e - 1, n_tx * tw + bx_e - 1, item, batch)
        if group < batch:
            obs.logger.info(
                "hybrid tile-FFT screen: shape (%d, %d) minimal working "
                "set %.1f GB (r stack %.1f GB + %d x %.0f MB boxes) > "
                "budget, skipping", th, tw,
                (rpad_bytes + batch * bt) / 1e9, rpad_bytes / 1e9, batch,
                bt / 1e6)
            continue
        # stage-1 cost screen AGAINST THE ALTERNATIVE: a hybrid shape is
        # only worth returning when its tile transforms are cheaper than
        # the exact per-lag evaluator on the lags it displaces.  On coarse
        # wide grids (the ±121-arcsec bench grid: ±1215 px offset span)
        # every shape fails this — the per-lag-pass leader needs hundreds
        # of tiles of ~2k-px transforms — and the hybrid declines rather
        # than hand back a shape whose evaluation would be abandoned (or
        # worse, run).  The 0.25 s floor keeps small-canvas hybrids (the
        # gradient-dominated regime this picker was built for) viable.
        n_surf, n_rf = _plane_counts(order_hint)
        est = _est_stage1_seconds(
            n_ty * n_tx, n_surf + n_rf + 3,
            _round128(th + by_e - 1), _round128(tw + bx_e - 1))
        n_pass = int(mask.sum())
        exact_s = _est_exact_seconds(n_pass, h, w)
        if est > max(0.25, exact_s):
            obs.logger.info(
                "hybrid tile-FFT screen: shape (%d, %d) est stage-1 "
                "%.1f s > exact per-lag alternative ~%.1f s for %d "
                "passing lags, skipping", th, tw, est, exact_s, n_pass)
            continue
        return (th, tw), mask
    return None


def _pair_indices(nt: int):
    """Upper-triangle (i, j) pairs and their multiplicity (1 diag, 2 off)."""
    ii, jj, mult = [], [], []
    for i in range(nt):
        for j in range(i, nt):
            ii.append(i)
            jj.append(j)
            mult.append(1.0 if i == j else 2.0)
    return np.array(ii), np.array(jj), np.array(mult)


def _shift2(x, ty, tx, fill):
    out = jnp.roll(x, (-ty, -tx), axis=(0, 1))
    h, w = x.shape
    if ty > 0:
        out = out.at[h - ty:, :].set(fill)
    elif ty < 0:
        out = out.at[:-ty, :].set(fill)
    if tx > 0:
        out = out.at[:, w - tx:].set(fill)
    elif tx < 0:
        out = out.at[:, :-tx].set(fill)
    return out


@partial(jax.jit, static_argnames=("order", "score", "hp", "wp"))
def _build_fields(warped, ref, order, score, hp, wp):
    """Global g fields (ref side) and r fields (canvas side), padded with
    empty (masked-out) borders to the tile-multiple frame (hp, wp).

    Layout matches fast_corr._build_surfaces exactly (pearson:
    g = [M, M a, M a2]; r = [A] + [A s_t]*nt + [A s_t s_u]*(t<=u);
    residus: g = [F, F a'/sqrt a, F a'^2/a, F/sqrt a, F a'/a, F/a], same r).
    Global mean-centering (exact for Pearson; the residue identity holds for
    any constant shift c)."""
    h, w = ref.shape
    pad = ((0, hp - h), (0, wp - w))
    refp = jnp.pad(ref, pad, constant_values=jnp.nan)
    wrpp = jnp.pad(warped, pad, constant_values=jnp.nan)

    taps = [0] if order == 0 else [-1, 0, 1]
    nt = len(taps) ** 2

    if score == "pearson":
        mask_ref = jnp.isfinite(refp)
        amean = jnp.sum(jnp.where(mask_ref, refp, 0.0)) / jnp.maximum(
            jnp.sum(mask_ref), 1)
        a = jnp.where(mask_ref, refp - amean, 0.0)
        mf = mask_ref.astype(refp.dtype)
        g_list = [mf, mf * a, mf * a * a]
        cshift = amean  # unused for pearson's s (own mean below)
        center_small = True
    else:  # residus
        F = jnp.isfinite(refp) & (refp > 0)
        a = jnp.where(F, refp, 1.0)
        Ff = F.astype(refp.dtype)
        cshift = jnp.sum(Ff * a) / jnp.maximum(jnp.sum(Ff), 1)
        ap = jnp.where(F, a - cshift, 0.0)
        sqa = jnp.sqrt(a)
        g_list = [Ff, Ff * ap / sqa, Ff * ap * ap / a, Ff / sqa,
                  Ff * ap / a, Ff / a]
        center_small = False

    sfin = jnp.isfinite(wrpp)
    if center_small:
        s0 = jnp.where(sfin, wrpp, 0.0)
        smean = jnp.sum(s0) / jnp.maximum(jnp.sum(sfin), 1)
        s = jnp.where(sfin, wrpp - smean, 0.0)
    else:
        s = jnp.where(sfin, wrpp - cshift, 0.0)

    valid = sfin
    A = jnp.ones_like(valid)
    for ty in taps:
        for tx in taps:
            A = A & _shift2(valid, ty, tx, fill=False)
    Af = A.astype(refp.dtype)

    s_t = []
    for ty in taps:
        for tx in taps:
            s_t.append(_shift2(s, ty, tx, fill=0.0))

    r_list = [Af]
    for st in s_t:
        r_list.append(Af * st)
    for i in range(nt):
        for j in range(i, nt):
            r_list.append(Af * s_t[i] * s_t[j])

    return jnp.stack(g_list), jnp.stack(r_list)


def _weights_1d(frac, order):
    if order == 0:
        return jnp.ones(frac.shape + (1,), dtype=frac.dtype)
    return jnp.stack([
        0.5 * (0.5 - frac) ** 2,
        0.75 - frac * frac,
        0.5 * (0.5 + frac) ** 2,
    ], axis=-1)


# Algorithm of the float32 partial-inverse DFT matmuls, pinned: on the GPU
# the default (and Precision.HIGH) lowers float32 dots to TF32, ~2.6e-4
# relative error per product, which moved the Carrington argmax on the
# bench grid.  Three bf16 passes (~4e-6 relative) ran the evaluator in
# 0.136 s against 0.168 s at HIGHEST, with a near-peak error of 4.3e-6
# (HIGHEST 1.3e-6) against a float64 run (H100, PERF.md).  Float64 inputs
# always run at HIGHEST.
_INV_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def _tiles_sum(g_stack, r_pad, coeffs_d, o_tab, o_min_g, tile_ids, order,
               score, th, tw, n_ty, n_tx, my, mx, by, bx, batch=1, group=None):
    """Two stages.  Stage 1 scans ``tile_ids``: per tile build the 58
    surface FFTs and evaluate the 66 correlation surfaces on the tile's own
    offset box (anchor ``o_tab[t]``, static size (by, bx)) with two partial
    matmul-DFTs; the scan emits the (66, by, bx) boxes.  Stage 2 combines
    per-lag values for MANY tiles in one batched computation with the lag
    axis minor — per-tile combination inside the scan runs as many
    small-shape ops.  Ids >= n_ty*n_tx are padding (multi-device round-up)
    and contribute zero.  Transform sizes (my, mx) are rectangular: each
    only needs to cover T + its own axis span.  ``batch`` processes that
    many tiles per scan step with the transforms batched (the transient
    memory scales with it).

    ``group`` (None = all tiles at once) bounds how many tiles' surface
    boxes are ever RESIDENT: tiles are processed in groups of ``group``
    through stage 1 + stage 2 with an (L, 6) running sum carried between
    groups.  On weakly-oversampled wide-lag grids the full (Tn, 66, by,
    bx) stack reaches tens of GB while one group stays ~100s of MB; a
    group of >= ~24 tiles keeps stage 2's batched shapes as large as the
    whole-stack path."""
    n_real = n_ty * n_tx
    Tn = tile_ids.shape[0]
    if group is None or group >= Tn:
        S_stack = _tiles_surfaces(g_stack, r_pad, o_tab, o_min_g, tile_ids,
                                  order, score, th, tw, n_ty, n_tx, my, mx,
                                  by, bx, batch)
        return _combine_lags(S_stack, coeffs_d, o_tab, tile_ids, order,
                             th, tw, n_tx, n_real, by, bx, g_stack.dtype)

    group = max(batch, -(-group // batch) * batch)
    pad = (-Tn) % group
    ids = tile_ids
    if pad:
        ids = jnp.concatenate(
            [tile_ids, jnp.full((pad,), n_real, dtype=tile_ids.dtype)])

    def body(acc, gids):
        S = _tiles_surfaces(g_stack, r_pad, o_tab, o_min_g, gids, order,
                            score, th, tw, n_ty, n_tx, my, mx, by, bx,
                            batch)
        comp = _combine_lags(S, coeffs_d, o_tab, gids, order,
                             th, tw, n_tx, n_real, by, bx, g_stack.dtype)
        return acc + comp, None

    acc0 = jnp.zeros((coeffs_d.shape[0], 6), dtype=g_stack.dtype)
    acc, _ = jax.lax.scan(body, acc0, ids.reshape(-1, group))
    return acc


def _inverse_box_mats(my, mx, by, bx, np_dt):
    """Real-folded partial-inverse DFT matrices for one tile chunk (host
    float64 numpy, trace-time constants): folding the real/imag planes into
    block matrices makes each inverse stage ONE real matmul.

    Returns (Iy2, Ix2):
      Iy2 (2by, 2my) partial inverse y-stage on stacked [Pr; Pi]
      Ix2 (2, K, bx) partial inverse x-stage (real part only), hermitian
                     half-spectrum weights and 1/(my*mx) folded in
    """
    K = mx // 2 + 1
    b = np.arange(by)[:, None] * np.arange(my)[None, :] * (2 * np.pi / my)
    EyR, EyI = np.cos(b), np.sin(b)
    Iy2 = np.block([[EyR, -EyI], [EyI, EyR]])
    kx = np.arange(K)
    whalf = np.where((kx == 0) | ((mx % 2 == 0) & (kx == mx // 2)), 1.0, 2.0)
    scale = (whalf / (my * mx))[:, None]
    c = kx[:, None] * np.arange(bx)[None, :] * (2 * np.pi / mx)
    Ix2 = np.stack([np.cos(c) * scale, -np.sin(c) * scale])
    return jnp.asarray(Iy2, dtype=np_dt), jnp.asarray(Ix2, dtype=np_dt)


def _tiles_surfaces(g_stack, r_pad, o_tab, o_min_g, tile_ids, order,
                    score, th, tw, n_ty, n_tx, my, mx, by, bx, batch=1):
    """Stage 1: scan tile chunks, emit the stacked (Tn, 66, by, bx) boxes."""
    nt = _tap_count(order) ** 2
    npairs = nt * (nt + 1) // 2
    K = mx // 2 + 1
    dt = g_stack.dtype

    # static inverse matrices (see _inverse_box_mats); built in the compute
    # dtype so float64 runs keep float64 factors
    np_dt = np.float64 if dt == jnp.float64 else np.float32
    Iy2, Ix2 = _inverse_box_mats(my, mx, by, bx, np_dt)
    prec = _INV_PRECISION if dt == jnp.float32 else jax.lax.Precision.HIGHEST

    span_y = by - 1
    span_x = bx - 1
    n_real = n_ty * n_tx
    nG = g_stack.shape[0]
    nR = r_pad.shape[0]

    def embed_one(t):
        """(nG, my, mx) g and (nR, my, mx) r embeddings of one tile."""
        t = jnp.minimum(t, n_real - 1)
        ty = t // n_tx
        tx = t % n_tx
        y0 = (ty * th).astype(jnp.int32)
        x0 = (tx * tw).astype(jnp.int32)
        zero = jnp.int32(0)
        o_t = o_tab[t]                       # (2,) int32, (x, y) anchor
        rel_x = o_t[0] - o_min_g[0]          # >= 0: box inside global frame
        rel_y = o_t[1] - o_min_g[1]

        g_tile = jax.lax.dynamic_slice(
            g_stack, (zero, y0, x0), (nG, th, tw))
        g_emb = jnp.zeros((nG, my, mx), dtype=dt)
        g_emb = g_emb.at[:, :th, :tw].set(g_tile)
        # r slice starts at (tile0 + o_tab[t]); r_pad is the global r stack
        # pre-padded by (-o_min_g, +o_max_g) so this start is always >= 0
        r_tile = jax.lax.dynamic_slice(
            r_pad, (zero, y0 + rel_y, x0 + rel_x),
            (nR, th + span_y, tw + span_x))
        r_emb = jnp.zeros((nR, my, mx), dtype=dt)
        r_emb = r_emb.at[:, : th + span_y, : tw + span_x].set(r_tile)
        return g_emb, r_emb

    def one_chunk(carry, ts):
        # embeddings stay per-tile (B static unroll of the dynamic slices);
        # the transforms and inverse contractions run batched over the
        # chunk axis c
        embs = [embed_one(ts[b]) for b in range(batch)]
        g_emb = jnp.stack([e[0] for e in embs])     # (B, nG, my, mx)
        r_emb = jnp.stack([e[1] for e in embs])     # (B, nR, my, mx)

        Gc = jnp.fft.rfft2(g_emb, s=(my, mx))
        Rc = jnp.fft.rfft2(r_emb, s=(my, mx))
        Gr, Gi = jnp.real(Gc), jnp.imag(Gc)
        Rr, Ri = jnp.real(Rc), jnp.imag(Rc)

        # products conj(G)*R, kept as separate real/imag planes:
        # Pr = Gr Rr + Gi Ri, Pi = Gr Ri - Gi Rr
        gsel = ((0, 1, 2, 0, 1, 0) if score == "pearson"
                else (0, 1, 2, 3, 4, 5))
        rsl = ((0, 1), (0, 1), (0, 1), (1, 1 + nt), (1, 1 + nt),
               (1 + nt, 1 + nt + npairs))
        parts_r, parts_i = [], []
        for g, (r0, r1) in zip(gsel, rsl):
            gr = Gr[:, g: g + 1]
            gi = Gi[:, g: g + 1]
            parts_r.append(gr * Rr[:, r0:r1] + gi * Ri[:, r0:r1])
            parts_i.append(gr * Ri[:, r0:r1] - gi * Rr[:, r0:r1])
        # stacked [Pr; Pi] along the y axis, (B, 66, 2my, K)
        Pstk = jnp.concatenate(
            [jnp.concatenate(parts_r, axis=1),
             jnp.concatenate(parts_i, axis=1)], axis=2)

        # partial inverse on the box: S[c, s, oy, ox] = corr at offset
        # (o_tab[t_c] + (oy, ox)).  Contract the Y axis FIRST (by < my, so
        # the intermediate is the smaller (B, 66, 2by, K)); the folded Iy2
        # emits [ZYr; ZYi] in one matmul.  The X stage computes only the
        # REAL part — Ix2 carries [Exr; -Exi] with the hermitian
        # half-spectrum weights and 1/(my*mx) folded in, so
        # S = ZYr @ Exr - ZYi @ Exi is again ONE matmul (contraction
        # (s, k) = (2, K)).
        Z = jnp.einsum("zy,csyk->cszk", Iy2, Pstk,
                       precision=prec)              # (B, 66, 2by, K)
        Zs = Z.reshape(batch, Z.shape[1], 2, by, K)
        S_box = jnp.einsum("cspyk,pkx->csyx", Zs, Ix2,
                           precision=prec)          # (B, 66, by, bx)
        return carry, S_box

    Tn = tile_ids.shape[0]
    pad = (-Tn) % batch
    ids = tile_ids
    if pad:
        # pad ids are clamped to a real tile in embed_one and their boxes
        # sliced away below; stage 2 masks by the caller's tile_ids anyway
        ids = jnp.concatenate(
            [tile_ids, jnp.full((pad,), n_real, dtype=tile_ids.dtype)])
    _, S = jax.lax.scan(one_chunk, jnp.int32(0), ids.reshape(-1, batch))
    return S.reshape(-1, S.shape[2], by, bx)[:Tn]


def _combine_lags(S_stack, coeffs_d, o_tab, tile_ids, order,
                  th, tw, n_tx, n_real, by, bx, dt):
    """Batched per-lag readout + fractional-tap weighting over all tiles.

    Layouts keep the lag axis L minor so every elementwise op runs with
    full lanes: vals (Tn, 66, L), weights (Tn, nt, L).  Returns (L, 6)."""
    nt = _tap_count(order) ** 2
    npairs = nt * (nt + 1) // 2
    L = coeffs_d.shape[0]
    Tn = tile_ids.shape[0]

    pi, pj, pmult = _pair_indices(nt)
    pi_d = jnp.asarray(pi)
    pj_d = jnp.asarray(pj)
    pmult_d = jnp.asarray(pmult, dtype=dt)

    valid_t = (tile_ids < n_real).astype(dt)                    # (Tn,)
    tt = jnp.minimum(tile_ids, n_real - 1)
    u = ((tt % n_tx) * tw).astype(dt) + (tw - 1) / 2.0          # (Tn,)
    v = ((tt // n_tx) * th).astype(dt) + (th - 1) / 2.0
    c = _quad_eval(coeffs_d, u, v)                              # (L, Tn, 2)
    o = jnp.floor(c + 0.5)
    frac = c - o
    oi = o.astype(jnp.int32)
    anchors = o_tab[tt]                                         # (Tn, 2)
    iy = oi[..., 1] - anchors[None, :, 1]                       # (L, Tn)
    ix = oi[..., 0] - anchors[None, :, 0]
    inb = ((iy >= 0) & (iy <= by - 1) & (ix >= 0) & (ix <= bx - 1))
    idx = jnp.clip(iy, 0, by - 1) * bx + jnp.clip(ix, 0, bx - 1)

    flat = S_stack.reshape(Tn, S_stack.shape[1], by * bx)       # (Tn, 66, P)
    mask = inb.T[:, None, :].astype(dt) * valid_t[:, None, None]
    vals = jnp.take_along_axis(
        flat, idx.T[:, None, :], axis=2) * mask                 # (Tn, 66, L)

    wx = _weights_1d(frac[..., 0], order)                       # (L, Tn, nta)
    wy = _weights_1d(frac[..., 1], order)
    w2 = (wy[..., :, None] * wx[..., None, :]).reshape(L, Tn, nt)
    w2t = jnp.moveaxis(w2, 0, 2)                                # (Tn, nt, L)
    pair_w = (w2t[:, pi_d, :] * w2t[:, pj_d, :]
              * pmult_d[None, :, None])                         # (Tn, np, L)

    comp = jnp.stack([
        jnp.sum(vals[:, 0, :], axis=0),
        jnp.sum(vals[:, 1, :], axis=0),
        jnp.sum(vals[:, 2, :], axis=0),
        jnp.sum(w2t * vals[:, 3: 3 + nt, :], axis=(0, 1)),
        jnp.sum(w2t * vals[:, 3 + nt: 3 + 2 * nt, :], axis=(0, 1)),
        jnp.sum(pair_w * vals[:, 3 + 2 * nt: 3 + 2 * nt + npairs, :],
                axis=(0, 1)),
    ], axis=-1)                                                 # (L, 6)
    return comp


@partial(jax.jit, static_argnames=(
    "order", "score", "th", "tw", "n_ty", "n_tx", "my", "mx", "by", "bx",
    "batch", "group"))
def _evaluate_tiles(g_stack, r_pad, coeffs_d, o_tab, o_min_g, order, score,
                    th, tw, n_ty, n_tx, my, mx, by, bx, batch=1, group=None):
    """Single-device evaluation over all tiles."""
    ids = jnp.arange(n_ty * n_tx, dtype=jnp.int32)
    return _tiles_sum(g_stack, r_pad, coeffs_d, o_tab, o_min_g, ids, order,
                      score, th, tw, n_ty, n_tx, my, mx, by, bx, batch,
                      group)


from functools import lru_cache


@lru_cache(maxsize=16)
def _sharded_tiles_fn(mesh, order, score, th, tw, n_ty, n_tx, my, mx, by, bx,
                      batch=1, group=None):
    """Memoized jit(shard_map) evaluator (a fresh closure per call would
    re-trace the 58-FFT scan body on every alignment)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(tile_ids, g, r, cf, otab, omg):
        s = _tiles_sum(g, r, cf, otab, omg, tile_ids, order, score,
                       th, tw, n_ty, n_tx, my, mx, by, bx, batch, group)
        return jax.lax.psum(s, "lags")

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("lags"), P(), P(), P(), P(), P()),
        out_specs=P()))


def _evaluate_tiles_sharded(mesh, g_stack, r_pad, coeffs_d, o_tab, o_min_g,
                            order, score, th, tw, n_ty, n_tx, my, mx, by, bx,
                            batch=1, group=None):
    """Multi-device evaluation: the tile axis is sharded over the mesh's
    ``lags`` axis (fields replicated on every device — the device form of
    the reference's process fan-out); each device scans its tile subset
    and the (L, 6) partial sums are combined with one psum."""
    from jax.sharding import PartitionSpec as P

    from .lag_search import mesh_put

    ndev = mesh.devices.size
    n_tiles = n_ty * n_tx
    n_pad = -(-n_tiles // ndev) * ndev
    ids = np.arange(n_pad, dtype=np.int32)  # >= n_tiles pad -> zero update

    fn = _sharded_tiles_fn(mesh, order, score, th, tw, n_ty, n_tx, my, mx,
                           by, bx, batch, group)
    with mesh:
        return fn(mesh_put(ids, mesh, P("lags")),
                  mesh_put(g_stack, mesh),
                  mesh_put(r_pad, mesh),
                  mesh_put(coeffs_d, mesh),
                  mesh_put(o_tab, mesh),
                  mesh_put(o_min_g, mesh))


def evaluate_select_tile_fft(coeffs, warped, ref_img, *, order, h, w,
                             method="correlation", scale_det_per_grid=1.0,
                             tol_det=TOL_DET_PX, compute_dtype=jnp.float32,
                             tile_size=None, mesh=None, tile_batch=None):
    """Score ``L`` quadratic-displacement lags via tile-local FFT surfaces.

    Same inputs/semantics as carrington.evaluate_quad_lags; returns (L,)
    float64 scores, or None when preconditions fail (odd
    spline order, unsupported method, within-tile deviation above the
    detector-pixel tolerance).  ``scale_det_per_grid`` converts grid-pixel
    deviations to detector pixels (the canvas oversampling factor's
    inverse); pass 1.0 when unknown (conservative).

    ``tile_batch``: tiles per scan step in stage 1 (transforms batched
    over the chunk; the transient memory scales with it); defaults to
    ``_TILE_BATCH``.

    ``tile_size``: int for square tiles, (th, tw) for rectangular ones, or
    None to auto-pick the cheapest rectangle meeting the deviation gate
    (pick_tile_shape — within-tile deviation is typically anisotropic).
    """
    if method not in ("correlation", "residus_masked") or order not in (0, 2):
        return None
    coeffs = np.asarray(coeffs, dtype=np.float64)
    L = coeffs.shape[0]
    if L == 0:
        return np.zeros(0)

    if tile_size is None:
        # memoized: the gate is a pure function of (lag set, geometry) and
        # repeats identically on warm calls (VERDICT r04 weak #7)
        with obs.stage("carr_tilefft_gate_s"):
            gate_key = memo.digest(coeffs, h, w, float(scale_det_per_grid),
                                   float(tol_det))
            gate_hit = _GATE_CACHE.get(gate_key)
            if gate_hit is None:
                gate_hit = _GATE_CACHE.put(
                    gate_key, (pick_tile_shape(coeffs, h, w,
                                               scale_det_per_grid,
                                               tol_det),))
        pick = gate_hit[0]
        if pick is None:
            return None
        (th, tw), _dev = pick
    elif np.ndim(tile_size) == 0:
        th = tw = int(tile_size)
    else:
        th, tw = (int(tile_size[0]), int(tile_size[1]))
    n_ty = -(-h // th)
    n_tx = -(-w // tw)
    hp, wp = n_ty * th, n_tx * tw

    # per-tile offset boxes: exact rounded-offset range of each tile, a
    # common static size (by, bx) = the largest per-tile span, anchored at
    # each tile's own minimum.  The global frame [o_min, o_max] (the union)
    # only sizes the padded r stack; the correlation boxes — and hence the
    # transform sizes and partial-inverse cost — stay per-tile small.
    with obs.stage("carr_tilefft_hostprep_s"):
        # memoized on the lag-set digest: the bounds repeat identically on
        # warm calls, and each costs a device dispatch + device_get
        # round-trip (VERDICT r04 weak #7)
        b_key = memo.digest(coeffs, th, tw, n_ty, n_tx, str(compute_dtype),
                            mesh is None)
        b_hit = _BOUNDS_CACHE.get(b_key)
        if b_hit is None:
            if mesh is None:
                # device path: must use the SAME dtype as the readout's own
                # floor(c + 0.5) (compute_dtype) so the +-1 anchor slack
                # holds
                o_min_d, o_max_d = _tile_offset_bounds_jit(
                    jnp.asarray(coeffs, dtype=compute_dtype), th, tw, n_ty,
                    n_tx)
                o_min_t = np.asarray(o_min_d, dtype=np.int64)
                o_max_t = np.asarray(o_max_d, dtype=np.int64)
            else:
                o_min_t, o_max_t = _per_tile_offset_bounds(coeffs, th, tw,
                                                           n_ty, n_tx)
            b_hit = _BOUNDS_CACHE.put(b_key, (o_min_t, o_max_t))
        o_min_t, o_max_t = b_hit
    o_min = o_min_t.min(axis=0)
    o_max = o_max_t.max(axis=0)
    span_t = (o_max_t - o_min_t).max(axis=0)        # (2,) in (x, y)
    bx, by = int(span_t[0]) + 1, int(span_t[1]) + 1
    # pull anchors back so every (by, bx) box stays inside the global frame
    o_min_t = np.minimum(o_min_t, o_max - np.array([bx - 1, by - 1]))
    my = _round128(th + by - 1)
    mx = _round128(tw + bx - 1)
    # the GLOBAL union sizes the padded r frame (Htot, Wtot below): guard it,
    # not just the per-tile spans — strong cross-tile displacement gradients
    # would otherwise allocate an unbounded r_pad on device
    if int((o_max - o_min).max()) > 2 * max(hp, wp):
        return None  # offsets far beyond the image extent: not worth it

    # working-set planning: the stacked surface boxes dominate.  On
    # wide lag spans (weakly-oversampled grids) the full (Tn, n_surf, by,
    # bx) stack reaches tens-to-hundreds of GB, so tiles are processed in
    # GROUPS through stage 1+2 (see _tiles_sum) sized to fill the budget
    # left after the padded r stack; decline outright only when even one
    # scan step (the CLAMPED batch — per-device shard on a mesh) cannot
    # fit, or when the estimated stage-1 transform time is beyond any sane
    # use of this path.
    if tile_batch is None:
        tile_batch = _TILE_BATCH
    n_tiles = n_ty * n_tx
    max_batch = n_tiles
    if mesh is not None and mesh.devices.size > 1:
        # Clamp to the per-device shard: each device scans only
        # ceil(n_tiles/ndev) tiles, and a wider batch would pad every
        # chunk with clamped duplicate tiles (wasted stage-1 FFTs).
        max_batch = -(-n_tiles // mesh.devices.size)
    batch = max(1, min(int(tile_batch), max_batch))
    n_surf, n_rf = _plane_counts(order)
    item = jnp.dtype(compute_dtype).itemsize
    group, rpad_bytes, bt = _mem_group_plan(
        order, by, bx, hp + int(o_max[1] - o_min[1]),
        wp + int(o_max[0] - o_min[0]), item, batch)
    if group < batch:
        obs.logger.info(
            "tile-FFT declined: minimal working set %.1f GB (r stack "
            "%.1f GB + %d x %.0f MB boxes) > %.1f GB budget",
            (rpad_bytes + batch * bt) / 1e9, rpad_bytes / 1e9, batch,
            bt / 1e6, _mem_budget_bytes() / 1e9)
        return None
    if group >= n_tiles:
        group = None                                   # single-pass path
    # the exact per-lag evaluator is the alternative: decline when the tile
    # transforms are estimated to cost more (wide lag spans need huge
    # per-tile boxes; the 0.25 s floor keeps small problems here)
    est_s = _est_stage1_seconds(n_tiles, n_surf + n_rf + 3, my, mx)
    exact_s = _est_exact_seconds(L, h, w)
    if est_s > max(0.25, exact_s):
        obs.logger.info(
            "tile-FFT declined: est stage-1 transform time %.1f s "
            "(%d tiles, %dx%d transforms) > exact per-lag ~%.1f s",
            est_s, n_tiles, my, mx, exact_s)
        return None

    score = "pearson" if method == "correlation" else "residus"
    if mesh is not None:
        # explicit mesh placement: never round-trip through the default
        # device (see lag_search.mesh_put)
        from .lag_search import mesh_put

        warped_d = mesh_put(warped, mesh, dtype=compute_dtype)
        ref_d = mesh_put(ref_img, mesh, dtype=compute_dtype)
    else:
        warped_d = jnp.asarray(warped, dtype=compute_dtype)
        ref_d = jnp.asarray(ref_img, dtype=compute_dtype)

    g_stack, r_stack = _build_fields(warped_d, ref_d, order, score, hp, wp)
    # shifted r frame: r_pad[i, j] = r_global[i + o_min_y, j + o_min_x]
    # (zero outside), sized over the GLOBAL offset union so every tile's
    # slice [tile0 + o_tab[t] .. + T + per-tile span) is in-bounds
    span_y, span_x = int(o_max[1] - o_min[1]), int(o_max[0] - o_min[0])
    o_min_y, o_min_x = int(o_min[1]), int(o_min[0])
    Htot, Wtot = hp + span_y, wp + span_x
    r_pad = jnp.zeros((r_stack.shape[0], Htot, Wtot), dtype=r_stack.dtype)
    sy0, sy1 = max(o_min_y, 0), min(o_min_y + Htot, hp)
    sx0, sx1 = max(o_min_x, 0), min(o_min_x + Wtot, wp)
    if sy1 > sy0 and sx1 > sx0:
        dy0, dx0 = sy0 - o_min_y, sx0 - o_min_x
        r_pad = r_pad.at[:, dy0: dy0 + (sy1 - sy0),
                         dx0: dx0 + (sx1 - sx0)].set(
            r_stack[:, sy0:sy1, sx0:sx1])

    if mesh is not None:
        from .lag_search import mesh_put

        coeffs_d = mesh_put(coeffs, mesh, dtype=compute_dtype)
        o_tab_d = mesh_put(o_min_t.astype(np.int32), mesh)
        o_min_d = mesh_put(o_min.astype(np.int32), mesh)
    else:
        coeffs_d = jnp.asarray(coeffs, dtype=compute_dtype)
        o_tab_d = jnp.asarray(o_min_t, dtype=jnp.int32)
        o_min_d = jnp.asarray(o_min, dtype=jnp.int32)

    with obs.stage("carr_tilefft_eval_s"):
        if mesh is not None and mesh.devices.size > 1:
            sums = _evaluate_tiles_sharded(
                mesh, g_stack, r_pad, coeffs_d, o_tab_d, o_min_d, order,
                score, th, tw, n_ty, n_tx, my, mx, by, bx, batch, group)
        else:
            sums = _evaluate_tiles(g_stack, r_pad, coeffs_d, o_tab_d,
                                   o_min_d, order, score, th, tw, n_ty,
                                   n_tx, my, mx, by, bx, batch,
                                   group=group)
        S = np.asarray(sums, dtype=np.float64)  # (L, 6)

    n = S[:, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        if score == "pearson":
            Sa, Saa, Sb, Sab, Sbb = S[:, 1], S[:, 2], S[:, 3], S[:, 4], S[:, 5]
            num = Sab - Sa * Sb / n
            den = np.sqrt((Saa - Sa * Sa / n) * (Sbb - Sb * Sb / n))
            return num / den
        Ssqa, Sa_, Sbosq, Sb_, Sb2oa = (S[:, 1], S[:, 2], S[:, 3], S[:, 4],
                                        S[:, 5])
        Sd = Ssqa - Sbosq
        Sdd = Sa_ - 2.0 * Sb_ + Sb2oa
        mean = Sd / n
        var = Sdd / n - mean * mean
        return np.sqrt(np.maximum(var, 0.0))
