"""FFT correlation-surface fast path for CRVAL-only lag grids.

The key observation (not present in the reference, which brute-forces one
reprojection per lag; ``alignment.py:509-549``): when only CRVAL1/CRVAL2 are
lagged, the per-lag resampling map is the *identity plus a per-lag constant
pixel displacement* ``c_l`` — the comparison grid IS the small image's own
grid (the submap step sets hdr_large := hdr_small), and shifting the TAN/CAR
reference point moves every sample coordinate by the same vector up to a
curvature term that is orders of magnitude below a millipixel over solar
fields of view (checked numerically at runtime; the engine falls back to the
general gather path if the bound is exceeded).

With ``c_l = dint + dfrac``, B-spline sampling of the small image becomes a
fixed tap stencil with per-lag constant weights:

    s_l(p) = sum_t w_t(dfrac) small[p + dint + t]

and every sum in the masked Pearson r factorizes over cross-correlation
surfaces evaluated at integer offsets ``dint``:

    n(d)   = XC(M, A)            Sb(d)  = sum_t   w_t      XC(M,  A.small_t)
    Sa(d)  = XC(M.a, A)          Sab(d) = sum_t   w_t      XC(M.a, A.small_t)
    Saa(d) = XC(M.a^2, A)        Sbb(d) = sum_t,u w_t w_u  XC(M,  A.small_t.small_u)

where ``M`` is the finite mask of the reference image, ``A`` the tap-validity
mask of the small image (erosion of its finite mask by the stencil footprint)
and ``small_t`` the small image shifted by tap ``t``.  All surfaces are
computed with zero-padded real FFTs — O(taps^2) FFTs total instead of
O(n_lags) serial resamples of the whole frame.

Numerics: both images are globally mean-centered before building the fields
(masked Pearson is exactly invariant under constant shifts), which removes
the catastrophic cancellation of ``Sab - Sa.Sb/n`` in float32.

Boundary semantics: tap validity requires all taps inside the image (no
mirror extension).  This differs from the general engine only on the 1-2 px
source border (scipy's mirror rule, see core/resample.py), a <=0.2% change in
the pixel count that perturbs correlations at the 1e-5 level; tests assert
argmax parity with the general engine.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import wcs
from ..utils import memo, obs
from . import lag_search

MAX_DISPLACEMENT_SPREAD_PX = 0.05  # fall back if curvature exceeds this

# warm-call memoization of the per-lag displacement chain (pure in the WCS
# scalars, probe world coordinates and lag set): the host float64 WCS math
# repeats identically across warm searches (same discipline as the
# Carrington probe fit)
_DISP_CACHE = memo.FIFOCache(maxsize=32)


def _fft_size(n: int) -> int:
    """Smallest even 7-smooth size >= n (2^a 3^b 5^c 7^d: the radices the
    FFT library runs fastest)."""
    m = max(int(n), 2)
    while True:
        if m % 2 == 0:
            k = m
            for p in (2, 3, 5, 7):
                while k % p == 0:
                    k //= p
            if k == 1:
                return m
        m += 1


def displacement_per_lag(base: dict, lags_deg: np.ndarray, lon, lat, kind: str,
                         grid: dict | None = None):
    """Per-lag pixel displacement c_l at probe points.

    ``base`` is the WCS the crval lags perturb.  When ``grid`` is given (the
    comparison grid's own WCS), displacements are conjugated into grid-pixel
    space — the sampling offsets into an image already pre-warped through
    ``base`` (block fast path): c = W2P_grid(P2W_base(W2P_{base+d}(w))) - p.
    With ``grid=None`` (pure crval path, base == grid WCS) this reduces to
    c = W2P_{base+d}(w) - p.

    Returns (c, spread): c (L, 2) at the grid center; spread = max over probe
    points and lags of |c(probe) - c(center)| (constancy check).
    """
    pl, pb, px0, py0 = lag_search.probe_values(lon, lat)

    lags_deg = np.asarray(lags_deg, dtype=np.float64)
    key = memo.digest(
        {k: np.float64(v) for k, v in base.items()}, lags_deg, pl, pb,
        px0, py0, kind,
        None if grid is None
        else {k: np.float64(v) for k, v in grid.items()})
    hit = _DISP_CACHE.get(key)
    if hit is not None:
        return hit

    # batch all lags at once: WCS params broadcast as (L, 1) against (probes,)
    p = {k: np.float64(v) for k, v in base.items()}
    p["crval1"] = (base["crval1"] + lags_deg[:, 0])[:, None]
    p["crval2"] = (base["crval2"] + lags_deg[:, 1])[:, None]
    bx, by = wcs.world_to_pixel(p, pl[None, :], pb[None, :], kind=kind, xp=np)
    if grid is not None:
        base64 = {k: np.float64(v) for k, v in base.items()}
        grid64 = {k: np.float64(v) for k, v in grid.items()}
        lon2, lat2 = wcs.pixel_to_world(base64, bx, by, kind=kind, xp=np)
        bx, by = wcs.world_to_pixel(grid64, lon2, lat2, kind=kind, xp=np)
    cs = np.stack([bx - px0[None, :], by - py0[None, :]], axis=-1)  # (L, 5, 2)
    center = cs[:, 0, :]
    spread = np.max(np.abs(cs - center[:, None, :])) if cs.size else 0.0
    return _DISP_CACHE.put(key, (center, float(spread)))


def displacement_per_lag_multi(combos_params, lags_deg, lon, lat, kind: str,
                               grid: dict | None = None):
    """Batched :func:`displacement_per_lag` over C WCS param dicts sharing
    one lag set: ONE vectorized WCS chain on (C, L, probes) arrays instead
    of C serial calls.  Returns ``(cs, spreads)`` with ``cs`` (C, L, 2) and
    ``spreads`` (C,)."""
    pl, pb, px0, py0 = lag_search.probe_values(lon, lat)
    lags_deg = np.asarray(lags_deg, dtype=np.float64)

    key = memo.digest(
        [sorted((k, float(v)) for k, v in cp.items())
         for cp in combos_params],
        lags_deg, pl, pb, px0, py0, kind,
        None if grid is None
        else {k: np.float64(v) for k, v in grid.items()})
    hit = _DISP_CACHE.get(key)
    if hit is not None:
        return hit

    keys = set().union(*[set(p) for p in combos_params])
    p_base = {k: np.array([np.float64(cp[k]) for cp in combos_params])[
        :, None, None] for k in keys}
    p = dict(p_base)
    p["crval1"] = p_base["crval1"] + lags_deg[None, :, 0, None]
    p["crval2"] = p_base["crval2"] + lags_deg[None, :, 1, None]
    bx, by = wcs.world_to_pixel(p, pl[None, None, :], pb[None, None, :],
                                kind=kind, xp=np)
    if grid is not None:
        # conjugate into the comparison grid's own pixel space (block
        # path): back to world through the UNLAGGED combo WCS, then into
        # grid pixels — c = W2P_grid(P2W_base(W2P_{base+d}(w))) - p
        grid64 = {k: np.float64(v) for k, v in grid.items()}
        lon2, lat2 = wcs.pixel_to_world(p_base, bx, by, kind=kind, xp=np)
        bx, by = wcs.world_to_pixel(grid64, lon2, lat2, kind=kind, xp=np)
    cs = np.stack([bx - px0[None, None, :], by - py0[None, None, :]],
                  axis=-1)                                   # (C, L, 5, 2)
    center = cs[:, :, 0, :]
    if cs.size:
        spreads = np.max(np.abs(cs - center[:, :, None, :]), axis=(1, 2, 3))
    else:
        spreads = np.zeros(len(combos_params))
    return _DISP_CACHE.put(key, (center, spreads))


def fast_path_applicable(l3, l4, l5, order: int) -> bool:
    """Static preconditions: crval-only grid, even spline order."""
    return (
        len(l3) == 1 and len(l4) == 1 and len(l5) == 1
        and float(l3[0]) == 0.0 and float(l4[0]) == 0.0 and float(l5[0]) == 0.0
        and order in (0, 2)
    )


def _tap_offsets(order: int):
    if order == 0:
        return [0]
    return [-1, 0, 1]  # order 2


@partial(jax.jit, static_argnames=("order", "m", "score"))
def _build_surfaces(small, ref, order, m, constraint=None, score="pearson"):
    """Frequency-domain cross-correlation products, shape (n_pairs, m, m//2+1)
    (callers apply the inverse FFT, possibly chunked).

    ``score="pearson"`` layout (order 2, taps T = 3 offsets/axis, nt = 9,
    npair = 45):
      [0]                 XC(M,   A)
      [1]                 XC(M a, A)
      [2]                 XC(M a2,A)
      [3 : 3+nt]          XC(M,   A small_t)
      [3+nt : 3+2nt]      XC(M a, A small_t)
      [3+2nt : 3+2nt+np]  XC(M,   A small_t small_u), (t<=u upper triangle)

    ``score="residus"`` factorizes the masked residue std of
    d = (a - b)/sqrt(a) (core/score.residus_masked; reference
    alignment.py:544-548).  The residue is not shift-invariant, but
    d = ((a - c) - (b - c))/sqrt(a) holds EXACTLY for any constant c; using
    c = the masked mean of a keeps every factorized term at variance scale
    instead of field scale (~1000x better conditioning against float32 FFT
    error).  With
    F = [a finite & a > 0], a' = a - c, b' = b - c:
      Sd  = sum F a'/sqrt(a) - sum F b'/sqrt(a)
      Sdd = sum F a'^2/a - 2 sum F a' b'/a + sum F b'^2/a
    layout:
      [0]                 XC(F,           A)      n
      [1]                 XC(F a'/sqrt a, A)
      [2]                 XC(F a'^2/a,    A)
      [3 : 3+nt]          XC(F/sqrt a,    A small'_t)   (b'/sqrt a terms)
      [3+nt : 3+2nt]      XC(F a'/a,      A small'_t)   (a'b'/a terms)
      [3+2nt : 3+2nt+np]  XC(F/a,         A small'_t small'_u)
    """
    taps = _tap_offsets(order)
    nt = len(taps) ** 2

    if score == "pearson":
        mask_ref = jnp.isfinite(ref)
        # global centering for conditioning (exact: Pearson shift-invariance)
        amean = jnp.sum(jnp.where(mask_ref, ref, 0.0)) / jnp.maximum(
            jnp.sum(mask_ref), 1)
        a = jnp.where(mask_ref, ref - amean, 0.0)
        mf = mask_ref.astype(ref.dtype)
        g_list = [mf, mf * a, mf * a * a]
        center_small = True
    else:  # residus
        F = jnp.isfinite(ref) & (ref > 0)
        a = jnp.where(F, ref, 1.0)  # safe denominator under the mask
        Ff = F.astype(ref.dtype)
        cshift = jnp.sum(Ff * a) / jnp.maximum(jnp.sum(Ff), 1)
        ap = jnp.where(F, a - cshift, 0.0)
        sqa = jnp.sqrt(a)
        g_list = [Ff, Ff * ap / sqa, Ff * ap * ap / a, Ff / sqa,
                  Ff * ap / a, Ff / a]
        center_small = False

    sfin = jnp.isfinite(small)
    s0 = jnp.where(sfin, small, 0.0)
    if center_small:
        smean = jnp.sum(s0) / jnp.maximum(jnp.sum(sfin), 1)
        s = jnp.where(sfin, small - smean, 0.0)
    else:
        s = jnp.where(sfin, small - cshift, 0.0)

    # tap-validity mask A: all stencil taps finite and inside the image
    valid = sfin
    h, w = small.shape
    A = jnp.ones_like(valid)
    for ty in taps:
        for tx in taps:
            A = A & _shift2(valid, ty, tx, fill=False)
    Af = A.astype(ref.dtype)

    # shifted small fields
    s_t = []
    for ty in taps:
        for tx in taps:
            s_t.append(_shift2(s, ty, tx, fill=0.0))

    g_fields = jnp.stack(g_list)
    r_fields = [Af]
    for st in s_t:
        r_fields.append(Af * st)
    for i in range(nt):
        for j in range(i, nt):
            r_fields.append(Af * s_t[i] * s_t[j])
    r_fields = jnp.stack(r_fields)  # (1 + nt + nt(nt+1)/2, h, w)
    if constraint is not None:
        # multi-chip: shard the field batch across the mesh
        r_fields = jax.lax.with_sharding_constraint(r_fields, constraint)

    G = jnp.fft.rfft2(g_fields, s=(m, m))
    R = jnp.fft.rfft2(r_fields, s=(m, m))

    npairs = nt * (nt + 1) // 2
    if score == "pearson":
        prods = jnp.concatenate([
            jnp.conj(G[0:1]) * R[0:1],            # n
            jnp.conj(G[1:2]) * R[0:1],            # Sa
            jnp.conj(G[2:3]) * R[0:1],            # Saa
            jnp.conj(G[0:1]) * R[1 : 1 + nt],     # Sb terms
            jnp.conj(G[1:2]) * R[1 : 1 + nt],     # Sab terms
            jnp.conj(G[0:1]) * R[1 + nt : 1 + nt + npairs],  # Sbb terms
        ])
    else:
        prods = jnp.concatenate([
            jnp.conj(G[0:1]) * R[0:1],            # n
            jnp.conj(G[1:2]) * R[0:1],            # sum F a'/sqrt(a)
            jnp.conj(G[2:3]) * R[0:1],            # sum F a'^2/a
            jnp.conj(G[3:4]) * R[1 : 1 + nt],     # b'/sqrt(a) terms
            jnp.conj(G[4:5]) * R[1 : 1 + nt],     # a'b'/a terms
            jnp.conj(G[5:6]) * R[1 + nt : 1 + nt + npairs],  # b'^2/a terms
        ])
    if constraint is not None:
        prods = jax.lax.with_sharding_constraint(prods, constraint)
    return prods


def _phase_matrix(rows, cols, m, dtype):
    """(cos, sin) of 2 pi (rows x cols) / m, with the phase index reduced
    mod m in exact int32 arithmetic first: the float32 angle of the raw
    product (up to ~2 pi m rad) would carry ~1e-3 rad of rounding."""
    p = (jnp.mod(rows, m)[:, None] * jnp.mod(cols, m)[None, :]) % m
    ang = (2.0 * np.pi / m) * p.astype(dtype)
    return jnp.cos(ang), jnp.sin(ang)


# Algorithm of the float32 box-inverse matmuls, pinned (float64 inputs run
# at HIGHEST).  On the 121x121 core grid at 2048^2 (H100, 700 W, PERF.md):
# six bf16 passes 16.3 ms with max |corr error| 9.2e-7 against a float64
# run; HIGHEST 13.0 ms but 8.9e-6 (most of the 1e-5 budget, against a
# 2.29e-5 top-2 margin); the full inverse FFTs 26.6 ms with 5.1e-7.  The
# GPU default (TF32) is far outside the budget.
_BOX_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6


@partial(jax.jit, static_argnames=("m", "by", "bx"))
def _box_inverse(prods, m, y0, x0, by, bx):
    """Evaluate the correlation surfaces directly on the offset box
    ``[y0, y0+by) x [x0, x0+bx)`` (indices mod m) with partial inverse
    DFTs, instead of full (m, m) inverse FFTs.

    The lag offsets of a whole 121x121 CRVAL grid span only a ~100-200 px
    box, so the partial inverse costs ~b*m*(m/2+1) MACs per surface vs the
    full m^2 transform.  Numerically this IS the inverse DFT restricted to
    the box.  It runs as six REAL matmuls at ``_BOX_PRECISION`` (the x
    stage on the real/imag planes, then only the real part of the y
    stage): a complex64 einsum measured ~1.8e-5 of correlation error on
    the GPU.  Engine-level argmax parity and value agreement with the full
    inverse are pinned by tests.
    """
    if m >= 46341:
        raise ValueError(f"transform size {m}: (m-1)^2 overflows int32")
    K = m // 2 + 1
    dt = prods.real.dtype
    hi = _BOX_PRECISION if dt == jnp.float32 else jax.lax.Precision.HIGHEST
    ky = jnp.arange(m, dtype=jnp.int32)
    kx = jnp.arange(K, dtype=jnp.int32)
    # y0/x0 are traced (dynamic) so a new pointing offset does not trigger
    # a recompile
    yy = jnp.asarray(y0, dtype=jnp.int32) + jnp.arange(by, dtype=jnp.int32)
    xx = jnp.asarray(x0, dtype=jnp.int32) + jnp.arange(bx, dtype=jnp.int32)
    cy, sy = _phase_matrix(yy, ky, m, dt)                   # (by, m)
    cx, sx = _phase_matrix(kx, xx, m, dt)                   # (K, bx)
    # hermitian half-spectrum weights: kx = 0 and (m/2 if m even) count once
    w = jnp.where((kx == 0) | ((m % 2 == 0) & (kx == m // 2)), 1.0, 2.0)
    pr = jnp.real(prods) * w.astype(dt)
    pi = jnp.imag(prods) * w.astype(dt)
    # Z = P . (cx + i sx) over kx
    zr = (jnp.einsum("skx,xb->skb", pr, cx, precision=hi)
          - jnp.einsum("skx,xb->skb", pi, sx, precision=hi))
    zi = (jnp.einsum("skx,xb->skb", pr, sx, precision=hi)
          + jnp.einsum("skx,xb->skb", pi, cx, precision=hi))
    # Re[(cy + i sy) . Z] over ky
    S = (jnp.einsum("yk,skb->syb", cy, zr, precision=hi)
         - jnp.einsum("yk,skb->syb", sy, zi, precision=hi))
    return S / (m * m)


@partial(jax.jit, static_argnames=("order", "m", "score"))
def _surfaces_at(small, ref, iy, ix, order, m, score="pearson"):
    """Surface values at the per-lag integer offsets: (n_surf, L) — only this
    small array ever leaves the device.

    The inverse FFTs run in chunks so the full (n_surf, m, m) surface stack
    (>1 GB at 2k^2) never materializes in device memory at once."""
    prods = _build_surfaces(small, ref, order, m, score=score)
    n_surf = prods.shape[0]
    chunk = 8
    vals = []
    for k in range(0, n_surf, chunk):
        surf = jnp.fft.irfft2(prods[k : k + chunk], s=(m, m))
        vals.append(surf[:, iy, ix])
    return jnp.concatenate(vals, axis=0)


def surfaces_at_sharded(small, ref, iy, ix, order, m, mesh, score="pearson"):
    """Multi-chip variant: the surface batch (58 field FFTs + 66 inverse
    transforms) is sharded across the mesh's ``lags`` axis; images are
    replicated.  XLA inserts the (tiny) all-gather of the (n_surf, L)
    values."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard = NamedSharding(mesh, P("lags"))
    repl = NamedSharding(mesh, P())

    @partial(jax.jit, static_argnames=("order", "m", "score"))
    def run(small_, ref_, iy_, ix_, order, m, score):
        prods = _build_surfaces.__wrapped__(small_, ref_, order, m,
                                            constraint=shard, score=score)
        surfaces = jnp.fft.irfft2(prods, s=(m, m))
        return surfaces[:, iy_, ix_]

    small_ = jax.device_put(small, repl)
    ref_ = jax.device_put(ref, repl)
    return run(small_, ref_, iy, ix, order, m, score)


def _shift2(x, ty, tx, fill):
    """x shifted so that out[q] = x[q + (ty, tx)], constant fill."""
    out = jnp.roll(x, (-ty, -tx), axis=(0, 1))
    h, w = x.shape
    if ty > 0:
        out = out.at[h - ty :, :].set(fill)
    elif ty < 0:
        out = out.at[: -ty, :].set(fill)
    if tx > 0:
        out = out.at[:, w - tx :].set(fill)
    elif tx < 0:
        out = out.at[:, : -tx].set(fill)
    return out


def pearson_integer_shifts(fixed_img, moving_img, dxs, dys, *,
                           compute_dtype=jnp.float32):
    """Masked Pearson r between ``fixed`` and ``moving`` shifted by every
    integer offset (dx, dy): r[i, j] = pearson(fixed(p), moving(p + (dx_i, dy_j))).

    Exact counterpart of the pxlshift sliding-window correlation
    (``/root/reference/euispice_coreg/pxlshift/alignment_pixels.py:38-55``),
    computed for the whole offset grid from FFT correlation surfaces.
    Both images must share a shape; NaNs define the masks.
    """
    dxs = np.asarray(dxs, dtype=np.int64)
    dys = np.asarray(dys, dtype=np.int64)
    h, w = np.shape(fixed_img)
    # same transform size and inverse route as the movie path
    # (evaluate_movie_from_displacements), so a per-rotation loop and the
    # rotation fleet run identical numerics
    m = _fft_size(max(h, w) + int(max(np.max(np.abs(dxs)),
                                      np.max(np.abs(dys)))) + 4)

    gx, gy = np.meshgrid(dxs, dys, indexing="ij")
    dy, dx = gy.ravel(), gx.ravel()
    y_min, x_min = int(dy.min()), int(dx.min())
    by, bx = _box_size(dy, m), _box_size(dx, m)
    moving = jnp.asarray(moving_img, dtype=compute_dtype)
    fixed = jnp.asarray(fixed_img, dtype=compute_dtype)
    if use_box_inverse(by, bx, m):
        box = _box_inverse(_build_surfaces(moving, fixed, 0, m), m, y_min,
                           x_min, by, bx)
        S = box[:, jnp.asarray(dy - y_min), jnp.asarray(dx - x_min)]
    else:
        S = _surfaces_at(moving, fixed, jnp.asarray(np.mod(dy, m)),
                         jnp.asarray(np.mod(dx, m)), 0, m)
    S = np.asarray(S, dtype=np.float64)
    # order-0 layout: [n, Sa, Saa, Sb, Sab, Sbb]
    n, Sa, Saa, Sb, Sab, Sbb = S
    with np.errstate(invalid="ignore", divide="ignore"):
        num = Sab - Sa * Sb / n
        den = np.sqrt((Saa - Sa * Sa / n) * (Sbb - Sb * Sb / n))
        r = num / den
    return r.reshape(len(dxs), len(dys))


def evaluate_crval_grid_fast(
    small_img,
    ref_img,
    lon,
    lat,
    base_params: dict,
    lag_crval1_deg,
    lag_crval2_deg,
    *,
    order: int = 2,
    kind: str = "tan",
    compute_dtype=jnp.float32,
    grid_params: dict | None = None,
    mesh=None,
    method: str = "correlation",
):
    """Scores (masked Pearson or residue, see
    :func:`evaluate_from_displacements`) for a crval1 x crval2 lag grid.

    Returns (n1, n2) float64 array, or None if the constant-displacement
    bound is violated (caller falls back to the general engine).
    ``grid_params``: see :func:`displacement_per_lag` (block fast path).
    """
    l1 = np.asarray(lag_crval1_deg, dtype=np.float64)
    l2 = np.asarray(lag_crval2_deg, dtype=np.float64)
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    lags = np.stack([g1.ravel(), g2.ravel()], axis=-1)

    with obs.stage("fast_hostprep_s"):
        c, spread = displacement_per_lag(base_params, lags, lon, lat, kind,
                                         grid=grid_params)
    r = evaluate_from_displacements(
        small_img, ref_img, c, spread,
        order=order, compute_dtype=compute_dtype, mesh=mesh, method=method,
    )
    if r is None:
        return None
    return r.reshape(len(l1), len(l2))


def _box_size(offsets, m: int) -> int:
    """Side of the offset box along one axis: the integer offsets' span,
    64-rounded for stable program shapes, never beyond the transform."""
    span = int(np.max(offsets)) - int(np.min(offsets)) + 1
    return min(-(-span // 64) * 64, m)


def use_box_inverse(by: int, bx: int, m: int) -> bool:
    """Route choice between the box-restricted matmul inverse and full
    inverse FFTs: the box wins while it covers at most a quarter of the
    (m, m) surface (measured at the core bench shapes, PERF.md)."""
    return by * bx <= (m * m) // 4


def evaluate_from_displacements(small_img, ref_img, c, spread, *,
                                order: int = 2, compute_dtype=jnp.float32,
                                mesh=None, method: str = "correlation"):
    """Scores for a list of constant pixel displacements ``c`` ((L, 2), x/y
    order) of the moving image relative to the comparison grid.

    ``method``: ``"correlation"`` (masked Pearson) or ``"residus_masked"``
    (masked residue std).  The reference's raw ``"residus"`` is NOT
    factorizable faithfully: its NaN propagation (alignment.py:544-548)
    depends on every grid pixel being valid, which the surface masks (tap
    validity erodes a border) and f32 counts cannot reproduce — raw residus
    always takes the exact per-lag engine.
    Residue numerics: exact to ~1e-6 in float64 (CPU tests); in float32 the
    factorized Sdd can carry ~1% relative error from intrinsic cancellation
    (residue std << field std) — argmin parity with the exact engine is
    pinned, use ``lag_search_mode="exact"`` when tight residue VALUES
    matter.

    Returns the (L,) score vector, or None when the spread bound or the
    frame-size precondition fails.  Shared core of the crval fast path, the
    block fast path and the Carrington fast path.
    """
    if method not in ("correlation", "residus_masked"):
        return None
    score = "pearson" if method == "correlation" else "residus"
    if spread > MAX_DISPLACEMENT_SPREAD_PX:
        return None

    c = np.asarray(c, dtype=np.float64)
    L = c.shape[0]
    # stencil base convention must match the resampler: k = floor(c + 0.5)
    dint = np.floor(c + 0.5).astype(np.int64)
    dfrac = c - dint  # in [-0.5, 0.5)

    h, w = np.shape(small_img)
    if np.max(np.abs(dint)) + 2 >= min(h, w) // 4:
        return None  # shifts too large relative to the frame

    m = _fft_size(max(h, w) + int(np.max(np.abs(dint))) + 4)

    if mesh is not None and mesh.devices.size > 1:
        # place on the mesh devices, never the default device (the mesh may
        # live on a non-default backend; see lag_search.mesh_put)
        from .lag_search import mesh_put

        small_d = mesh_put(small_img, mesh, dtype=compute_dtype)
        ref_d = mesh_put(ref_img, mesh, dtype=compute_dtype)
    else:
        small_d = jnp.asarray(small_img, dtype=compute_dtype)
        ref_d = jnp.asarray(ref_img, dtype=compute_dtype)

    y_min, x_min = int(dint[:, 1].min()), int(dint[:, 0].min())
    by, bx = _box_size(dint[:, 1], m), _box_size(dint[:, 0], m)

    if mesh is not None and mesh.devices.size > 1:
        from .lag_search import mesh_put

        iy = mesh_put(np.mod(dint[:, 1], m), mesh)
        ix = mesh_put(np.mod(dint[:, 0], m), mesh)
        S = np.asarray(surfaces_at_sharded(small_d, ref_d, iy, ix, order, m,
                                           mesh, score=score),
                       dtype=np.float64)
    elif use_box_inverse(by, bx, m):
        # evaluate the surfaces only on the offsets' bounding box with two
        # partial matmul-DFTs instead of full inverse FFTs
        with obs.stage("fast_surfaces_s"):
            prods = _build_surfaces(small_d, ref_d, order, m, score=score)
            S_box = _box_inverse(prods, m, y_min, x_min, by, bx)
            if obs.stages_active():
                # sync so the surface/readout boundary is real (bench only)
                S_box.block_until_ready()
        with obs.stage("fast_readout_s"):
            iyr = jnp.asarray(dint[:, 1] - y_min)
            ixr = jnp.asarray(dint[:, 0] - x_min)
            T = np.asarray(
                _readout_contract(S_box, iyr, ixr, jnp.asarray(dfrac),
                                  order=order, score=score),
                dtype=np.float64)
        with obs.stage("fast_combine_s"):
            return _scores_from_sums(T, score)
    else:
        iy = jnp.asarray(np.mod(dint[:, 1], m))
        ix = jnp.asarray(np.mod(dint[:, 0], m))
        S = np.asarray(_surfaces_at(small_d, ref_d, iy, ix, order, m,
                                    score=score),
                       dtype=np.float64)

    with obs.stage("fast_combine_s"):
        return _combine_scores(S, dfrac, order, score)


def _pair_index_matrix(nt: int) -> np.ndarray:
    """Static (nt, nt) map from tap-pair (i, j) to its upper-triangle slot."""
    pidx = np.zeros((nt, nt), dtype=np.int32)
    k = 0
    for i in range(nt):
        for j in range(i, nt):
            pidx[i, j] = pidx[j, i] = k
            k += 1
    return pidx


@partial(jax.jit, static_argnames=("order", "score"))
def _readout_contract(S_box, iyr, ixr, dfrac, order: int, score: str):
    """Fused surface readout + tap-weight contraction ON DEVICE.

    Gathers the per-lag surface values and contracts them with the
    fractional B-spline tap weights in one jit, so only the six combined
    sums (6, L) reach the host instead of the raw (n_surf, L) readout
    (~3.4 MB at the 121x121 bench grid).  The weight contractions are
    cancellation-free (positive
    weights); the sensitive final arithmetic (num/den, sqrt) stays on the
    host in float64 (:func:`_scores_from_sums`)."""
    taps = _tap_offsets(order)
    nt = len(taps) ** 2
    prec = jax.lax.Precision.HIGHEST
    S = S_box[:, iyr, ixr]                                 # (n_surf, L)
    t = dfrac.astype(S.dtype)

    def weights_1d(fr):
        if order == 0:
            return jnp.ones(fr.shape + (1,), dtype=S.dtype)
        return jnp.stack([0.5 * (0.5 - fr) ** 2,
                          0.75 - fr * fr,
                          0.5 * (0.5 + fr) ** 2], axis=-1)

    wx = weights_1d(t[:, 0])
    wy = weights_1d(t[:, 1])
    w2 = (wy[:, :, None] * wx[:, None, :]).reshape(-1, nt)  # (L, nt)
    P = S[3 + 2 * nt:][_pair_index_matrix(nt)]              # (nt, nt, L)
    C1 = jnp.einsum("lt,tl->l", w2, S[3: 3 + nt], precision=prec)
    C2 = jnp.einsum("lt,tl->l", w2, S[3 + nt: 3 + 2 * nt], precision=prec)
    C3 = jnp.einsum("li,lj,ijl->l", w2, w2, P, precision=prec)
    return jnp.stack([S[0], S[1], S[2], C1, C2, C3])


def _scores_from_sums(T, score: str):
    """Host float64 finisher: the six combined sums (..., 6, L) -> scores
    (..., L).  The only cancellation-sensitive arithmetic of the combine."""
    n = T[..., 0, :]
    with np.errstate(invalid="ignore", divide="ignore"):
        if score == "pearson":
            Sa, Saa, Sb, Sab, Sbb = (T[..., 1, :], T[..., 2, :], T[..., 3, :],
                                     T[..., 4, :], T[..., 5, :])
            num = Sab - Sa * Sb / n
            den = np.sqrt((Saa - Sa * Sa / n) * (Sbb - Sb * Sb / n))
            return num / den
        Ssqa, Sa_, Sbosq, Sb_, Sb2oa = (T[..., 1, :], T[..., 2, :],
                                        T[..., 3, :], T[..., 4, :],
                                        T[..., 5, :])
        Sd = Ssqa - Sbosq
        Sdd = Sa_ - 2.0 * Sb_ + Sb2oa
        mean = Sd / n
        var = Sdd / n - mean * mean
        return np.sqrt(np.maximum(var, 0.0))


def _combine_scores(S, dfrac, order: int, score: str):
    """Combine surface values ``S`` (..., n_surf, L) with per-lag fractional
    displacements ``dfrac`` (..., L, 2) into scores (..., L).

    Host numpy; shared by the single-pair and movie paths (any leading batch
    axes broadcast through).  The tap weights are the same B-spline weights
    as ``core/resample._taps_and_weights`` (frac in [-0.5, 0.5), stencil
    base floor(q + frac + 0.5) == q)."""
    taps = _tap_offsets(order)
    nt = len(taps) ** 2
    npairs = nt * (nt + 1) // 2

    def weights_1d(frac):
        t = np.asarray(frac, dtype=np.float64)
        if order == 0:
            return np.ones(t.shape + (1,))
        return np.stack([
            0.5 * (0.5 - t) ** 2,
            0.75 - t * t,
            0.5 * (0.5 + t) ** 2,
        ], axis=-1)

    wx = weights_1d(dfrac[..., 0])  # (..., L, ntap)
    wy = weights_1d(dfrac[..., 1])
    w2 = (wy[..., :, None] * wx[..., None, :]).reshape(
        dfrac.shape[:-1] + (nt,))  # (..., L, nt)

    pair_w = np.zeros(dfrac.shape[:-1] + (npairs,))
    k = 0
    for i in range(nt):
        for j in range(i, nt):
            pair_w[..., k] = w2[..., i] * w2[..., j] * (1.0 if i == j else 2.0)
            k += 1

    # residue combination (c-centered exact identity, see _build_surfaces):
    # Sd = sum a'/sqrt(a) - sum b'/sqrt(a);
    # Sdd = sum a'^2/a - 2 sum a'b'/a + sum b'^2/a  (over the joint mask)
    C1 = np.einsum("...lt,...tl->...l", w2, S[..., 3 : 3 + nt, :])
    C2 = np.einsum("...lt,...tl->...l", w2, S[..., 3 + nt : 3 + 2 * nt, :])
    C3 = np.einsum("...lp,...pl->...l", pair_w,
                   S[..., 3 + 2 * nt : 3 + 2 * nt + npairs, :])
    T = np.stack([S[..., 0, :], S[..., 1, :], S[..., 2, :], C1, C2, C3],
                 axis=-2)
    return _scores_from_sums(T, score)


# ---------------------------------------------------------------------------
# Batched movie path: data parallelism over a fleet of image pairs
# ---------------------------------------------------------------------------

from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=8)
def _movie_eval_fn(mesh, axis, order, m, by, bx, score, use_box):
    """Memoized evaluator for :func:`evaluate_movie_from_displacements`.

    ``mesh=None`` returns a plain jitted sequential map on the default
    device; otherwise a ``jit(shard_map)`` with the FRAME axis sharded over
    the mesh (each device builds the correlation surfaces of its own frame
    subset — the fleet-of-pairs data parallelism SURVEY.md section 2.2 marks
    as the natural multi-chip extension of the reference's single-pair
    process fan-out, alignment.py:667-721).

    ``use_box`` mirrors the single-pair route choice in
    :func:`evaluate_from_displacements` (:func:`use_box_inverse`): box
    matmul-DFT readout, otherwise the chunked full inverse
    (``_surfaces_at``) — keeping the two paths numerically twinned."""

    def local_eval(small_blk, ref_blk, iyr_blk, ixr_blk, y0, x0):
        def one(args):
            small, ref, iy_, ix_ = args
            if use_box:
                prods = _build_surfaces.__wrapped__(
                    small, ref, order, m, score=score)
                box = _box_inverse.__wrapped__(prods, m, y0, x0, by, bx)
                return box[:, iy_, ix_]
            return _surfaces_at.__wrapped__(small, ref, iy_, ix_, order, m,
                                            score=score)

        # sequential over local frames: one frame's (n_surf, m, m//2+1)
        # product stack in device memory at a time (same ceiling as the
        # single-pair path), not the whole fleet's
        return jax.lax.map(one, (small_blk, ref_blk, iyr_blk, ixr_blk))

    if mesh is None:
        return jax.jit(local_eval)

    from jax import shard_map

    shard = lag_search.P(axis)
    repl = lag_search.P()
    return jax.jit(shard_map(
        local_eval, mesh=mesh,
        in_specs=(shard, shard, shard, shard, repl, repl),
        out_specs=shard))


def evaluate_movie_from_displacements(smalls, refs, cs, *, order: int = 2,
                                      compute_dtype=jnp.float32, mesh=None,
                                      method: str = "correlation"):
    """Scores for F constant-displacement pair searches evaluated together.

    The reference aligns a movie frame-by-frame, each frame fanned out over
    OS processes (``alignment.py:667-721``); the fleet form shards the
    FRAME axis over the device mesh instead — every device builds the full
    FFT correlation surfaces of its own frames and only the tiny
    (F, n_surf, L) readout crosses between devices and to the host.

    Args:
      smalls: (F, h, w) moving images (one per frame); numpy or a
        device-resident jax array (device arrays are never round-tripped
        through the host).
      refs:   (F, h, w) comparison canvases (the reference image resampled
        on each frame's own grid — the per-frame submap); numpy or jax.
      cs:     (F, L, 2) per-frame constant pixel displacements (x/y order),
        one row per lag, from :func:`displacement_per_lag` per frame.
      mesh: optional 1-axis ``jax.sharding.Mesh``; frames are sharded over
        it (padding F up to a device multiple with dummy frames).  Without a
        mesh the frames run sequentially on the default device in ONE
        dispatch.

    Returns the (F, L) float64 score array, or None when a precondition
    fails (caller falls back to the per-frame path).  Semantics per frame
    are identical to :func:`evaluate_from_displacements` (same box-vs-full
    inverse route choice; all frames share one offset bounding box).
    """
    if method not in ("correlation", "residus_masked"):
        return None
    score = "pearson" if method == "correlation" else "residus"

    cs = np.asarray(cs, dtype=np.float64)
    if cs.ndim != 3 or cs.shape[-1] != 2:
        return None
    F, L, _ = cs.shape
    smalls_st = smalls if isinstance(smalls, jax.Array) else np.asarray(smalls)
    refs_st = refs if isinstance(refs, jax.Array) else np.asarray(refs)
    if smalls_st.shape != refs_st.shape or len(smalls_st.shape) != 3 \
            or smalls_st.shape[0] != F or F == 0:
        return None
    h, w = smalls_st.shape[1:]

    dint = np.floor(cs + 0.5).astype(np.int64)
    dfrac = cs - dint
    maxd = int(np.max(np.abs(dint)))
    if maxd + 2 >= min(h, w) // 4:
        return None
    m = _fft_size(max(h, w) + maxd + 4)

    # one offset bounding box for the whole fleet (static shapes -> one
    # compiled program; per-frame pointing only moves the readout indices)
    y_min, x_min = int(dint[..., 1].min()), int(dint[..., 0].min())
    by, bx = _box_size(dint[..., 1], m), _box_size(dint[..., 0], m)

    use_mesh = mesh is not None and mesh.devices.size > 1
    if use_mesh:
        n_dev = int(mesh.devices.size)
        Fp = -(-F // n_dev) * n_dev
    else:
        Fp = F

    # same route choice as the single-pair path (evaluate_from_displacements)
    use_box = use_box_inverse(by, bx, m)
    if use_box:
        iyr = (dint[..., 1] - y_min).astype(np.int32)  # (F, L)
        ixr = (dint[..., 0] - x_min).astype(np.int32)
    else:
        iyr = np.mod(dint[..., 1], m).astype(np.int32)
        ixr = np.mod(dint[..., 0], m).astype(np.int32)
        # the full-inverse program never reads the box size: zero it out of
        # the evaluator cache key (a new 64-rounded box must not recompile
        # an identical program)
        by = bx = 0

    if Fp != F:
        zpad = ((0, Fp - F), (0, 0), (0, 0))
        xp_s = jnp if isinstance(smalls_st, jax.Array) else np
        xp_r = jnp if isinstance(refs_st, jax.Array) else np
        smalls_st = xp_s.pad(smalls_st, zpad)
        refs_st = xp_r.pad(refs_st, zpad)
        iyr = np.pad(iyr, ((0, Fp - F), (0, 0)))
        ixr = np.pad(ixr, ((0, Fp - F), (0, 0)))

    if use_mesh:
        axis = mesh.axis_names[0]
        shard = lag_search.P(axis)
        put = lambda a, sp, dt=None: lag_search.mesh_put(a, mesh, spec=sp,
                                                         dtype=dt)
        smalls_d = put(smalls_st, shard, compute_dtype)
        refs_d = put(refs_st, shard, compute_dtype)
        iyr_d = put(iyr, shard)
        ixr_d = put(ixr, shard)
        y0 = put(np.int32(y_min), lag_search.P())
        x0 = put(np.int32(x_min), lag_search.P())
        fn = _movie_eval_fn(mesh, axis, order, m, by, bx, score, use_box)
    else:
        smalls_d = jnp.asarray(smalls_st, dtype=compute_dtype)
        refs_d = jnp.asarray(refs_st, dtype=compute_dtype)
        iyr_d = jnp.asarray(iyr)
        ixr_d = jnp.asarray(ixr)
        y0 = jnp.int32(y_min)
        x0 = jnp.int32(x_min)
        fn = _movie_eval_fn(None, None, order, m, by, bx, score, use_box)

    S = np.asarray(fn(smalls_d, refs_d, iyr_d, ixr_d, y0, x0),
                   dtype=np.float64)[:F]  # (F, n_surf, L)
    return _combine_scores(S, dfrac, order, score)
