"""Closed-form celestial WCS transforms as JAX functions.

The reference calls astropy/WCSLIB ``pixel_to_world`` / ``world_to_pixel``
twice per lag-grid point on the CPU
(``/root/reference/euispice_coreg/hdrshift/alignment.py:1038-1069``).  Here the
TAN (gnomonic) projection and the PC-matrix affine are implemented directly in
``jax.numpy`` (Calabretta & Greisen 2002 conventions: 1-based CRPIX,
LONPOLE=180 for zenithal projections), so the per-lag world->pixel map runs
on-device, vmapped over the whole lag hypercube.

All angles are in DEGREES.  Functions are dtype-polymorphic (float32 on device,
float64 on CPU for parity tests) and broadcast over batched WCS parameters,
so ``jax.vmap`` over a lag axis works out of the box.

``params`` is a dict with keys
``crval1 crval2 crpix1 crpix2 cdelt1 cdelt2 pc11 pc12 pc21 pc22``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

RAD_PER_DEG = float(np.pi / 180.0)
DEG_PER_RAD = float(180.0 / np.pi)


def _native_to_celestial(phi, theta, alpha_p, delta_p, phi_p, xp=jnp):
    """Rotate native spherical (phi, theta) to celestial (alpha, delta).

    C&G (2002) eq. (2). All angles in radians.
    """
    sin_t, cos_t = xp.sin(theta), xp.cos(theta)
    sin_dp, cos_dp = xp.sin(delta_p), xp.cos(delta_p)
    dphi = phi - phi_p
    sin_dphi, cos_dphi = xp.sin(dphi), xp.cos(dphi)

    sin_delta = sin_t * sin_dp + cos_t * cos_dp * cos_dphi
    delta = xp.arcsin(xp.clip(sin_delta, -1.0, 1.0))
    alpha = alpha_p + xp.arctan2(
        -cos_t * sin_dphi,
        sin_t * cos_dp - cos_t * sin_dp * cos_dphi,
    )
    return alpha, delta


def _celestial_to_native(alpha, delta, alpha_p, delta_p, phi_p, xp=jnp):
    """Inverse rotation, C&G (2002) eq. (5). All angles in radians."""
    sin_d, cos_d = xp.sin(delta), xp.cos(delta)
    sin_dp, cos_dp = xp.sin(delta_p), xp.cos(delta_p)
    dalpha = alpha - alpha_p
    sin_da, cos_da = xp.sin(dalpha), xp.cos(dalpha)

    sin_theta = sin_d * sin_dp + cos_d * cos_dp * cos_da
    theta = xp.arcsin(xp.clip(sin_theta, -1.0, 1.0))
    phi = phi_p + xp.arctan2(
        -cos_d * sin_da,
        sin_d * cos_dp - cos_d * sin_dp * cos_da,
    )
    return phi, theta


def tan_pixel_to_world(params, px, py, xp=jnp):
    """0-based pixel coords -> world (lon, lat) in degrees, TAN projection."""
    q1 = px + 1.0 - params["crpix1"]
    q2 = py + 1.0 - params["crpix2"]
    # intermediate world coordinates, degrees
    x = params["cdelt1"] * (params["pc11"] * q1 + params["pc12"] * q2)
    y = params["cdelt2"] * (params["pc21"] * q1 + params["pc22"] * q2)

    r = xp.hypot(x, y)  # deg
    # theta = atan(180 / (pi * R)); atan2 handles R == 0 -> pi/2
    theta = xp.arctan2(DEG_PER_RAD, r)
    phi = xp.arctan2(x, -y)

    alpha, delta = _native_to_celestial(
        phi,
        theta,
        params["crval1"] * RAD_PER_DEG,
        params["crval2"] * RAD_PER_DEG,
        xp.pi,  # LONPOLE = 180 deg for zenithal projections
        xp=xp,
    )
    return alpha * DEG_PER_RAD, delta * DEG_PER_RAD


def tan_world_to_pixel(params, lon_deg, lat_deg, xp=jnp):
    """World (lon, lat) in degrees -> 0-based pixel coords, TAN projection.

    Points on or behind the tangent-plane horizon (theta <= 0) map to NaN,
    like astropy's ``world_to_pixel`` for unprojectable sky positions.

    Uses the direct gnomonic form (x = cos(d) sin(da) / sin(theta), etc.),
    which is numerically stable near the tangent point where the
    rotate-then-arcsin path loses ~sqrt(eps) of precision.
    """
    alpha_p = params["crval1"] * RAD_PER_DEG
    delta_p = params["crval2"] * RAD_PER_DEG
    delta = lat_deg * RAD_PER_DEG
    dalpha = lon_deg * RAD_PER_DEG - alpha_p

    sin_d, cos_d = xp.sin(delta), xp.cos(delta)
    sin_dp, cos_dp = xp.sin(delta_p), xp.cos(delta_p)
    sin_da, cos_da = xp.sin(dalpha), xp.cos(dalpha)

    sin_t = sin_d * sin_dp + cos_d * cos_dp * cos_da  # cos of angular distance
    valid = sin_t > 0
    denom = xp.where(valid, sin_t, 1.0)
    x = DEG_PER_RAD * (cos_d * sin_da) / denom
    y = DEG_PER_RAD * (sin_d * cos_dp - cos_d * sin_dp * cos_da) / denom
    x = xp.where(valid, x, xp.nan)
    y = xp.where(valid, y, xp.nan)
    return _intermediate_to_pixel(params, x, y, xp=xp)


def _intermediate_to_pixel(params, x, y, xp=jnp):
    """Invert CDELT/PC: intermediate world coords (deg) -> 0-based pixels."""
    u = x / params["cdelt1"]
    v = y / params["cdelt2"]
    det = params["pc11"] * params["pc22"] - params["pc12"] * params["pc21"]
    q1 = (params["pc22"] * u - params["pc12"] * v) / det
    q2 = (-params["pc21"] * u + params["pc11"] * v) / det
    return q1 + params["crpix1"] - 1.0, q2 + params["crpix2"] - 1.0


# ---------------------------------------------------------------------------
# CAR (plate carree) - used for initial-Carrington alignment
# ---------------------------------------------------------------------------

def car_pixel_to_world(params, px, py, xp=jnp):
    """Linear CAR projection (valid for CRVAL2 == 0, the solar convention)."""
    q1 = px + 1.0 - params["crpix1"]
    q2 = py + 1.0 - params["crpix2"]
    x = params["cdelt1"] * (params["pc11"] * q1 + params["pc12"] * q2)
    y = params["cdelt2"] * (params["pc21"] * q1 + params["pc22"] * q2)
    return params["crval1"] + x, params["crval2"] + y


def car_world_to_pixel(params, lon_deg, lat_deg, xp=jnp):
    x = lon_deg - params["crval1"]
    y = lat_deg - params["crval2"]
    return _intermediate_to_pixel(params, x, y, xp=xp)


def pixel_to_world(params, px, py, kind="tan", xp=jnp):
    if kind == "tan":
        return tan_pixel_to_world(params, px, py, xp=xp)
    elif kind == "car":
        return car_pixel_to_world(params, px, py, xp=xp)
    raise ValueError(f"unknown projection kind: {kind}")


def world_to_pixel(params, lon_deg, lat_deg, kind="tan", xp=jnp):
    if kind == "tan":
        return tan_world_to_pixel(params, lon_deg, lat_deg, xp=xp)
    elif kind == "car":
        return car_world_to_pixel(params, lon_deg, lat_deg, xp=xp)
    raise ValueError(f"unknown projection kind: {kind}")


def ang2pipi_deg(ang_deg, xp=jnp):
    """Wrap degrees into ]-180, 180] (JAX version of Util.ang2pipi)."""
    return -((-ang_deg + 180.0) % 360.0 - 180.0)
