"""Sharded engine paths on a NON-default-device mesh.

Regression: the sharded paths materialized operands with bare
``jnp.asarray`` (default device) before resharding onto the mesh, so a mesh
living on different devices than the default device round-tripped through
device 0 — and crashed outright when the default backend was unhealthy.
These tests build the mesh from CPU devices
EXCLUDING device 0 (the default), so any default-device materialization
shows up as a placement mismatch, and pin parity with the unsharded path.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

import fixtures as fx
from euispice_coreg_tpu.core.header import pc_from_crota
from euispice_coreg_tpu.engine import carrington, fast_corr, lag_search
from euispice_coreg_tpu.utils import coords
from euispice_coreg_tpu.core import wcs as _wcs


def nondefault_mesh(n=4):
    devs = jax.devices()
    if len(devs) < n + 1:
        pytest.skip("needs >= %d virtual devices" % (n + 1))
    return Mesh(np.array(devs[1 : n + 1]), axis_names=("lags",))


def synthetic_inputs(n=48, n_lags=8):
    rng = np.random.default_rng(3)
    small = rng.normal(size=(n, n)).astype(np.float32) + 100.0
    ref = rng.normal(size=(n, n)).astype(np.float32) + 100.0
    pc11, pc12, pc21, pc22 = pc_from_crota(0.4, 5.0, 5.0)
    base = {
        "crval1": 100.0 / 3600.0, "crval2": 50.0 / 3600.0,
        "crpix1": (n + 1) / 2, "crpix2": (n + 1) / 2,
        "cdelt1": 5.0 / 3600.0, "cdelt2": 5.0 / 3600.0,
        "pc11": pc11, "pc12": pc12, "pc21": pc21, "pc22": pc22,
        "crota": 0.4,
    }
    x, y = coords.pixel_grid(n, n)
    lon, lat = _wcs.tan_pixel_to_world(base, x, y, xp=np)
    l1 = np.arange(n_lags) * (2.0 / 3600.0)
    return small, ref, lon.astype(np.float32), lat.astype(np.float32), base, l1


def test_general_engine_on_nondefault_mesh():
    small, ref, lon, lat, base, l1 = synthetic_inputs()
    mesh = nondefault_mesh(4)
    # unsharded reference: the same per-lag gather evaluator the mesh path
    # shards (the mesh=None route would pick the select sampler, whose
    # boundary-validity band legitimately perturbs near-zero Pearson values
    # on pure-noise fixtures)
    lags = np.zeros((len(l1), 5), dtype=np.float32)
    lags[:, 0] = l1
    base_d = {k: jnp.float32(v) for k, v in base.items()}
    ref_out = np.asarray(lag_search._evaluate_flat(
        jnp.asarray(lags), jnp.asarray(small), jnp.asarray(ref),
        jnp.asarray(lon), jnp.asarray(lat), base_d,
        2, "correlation", "tan", 2))
    out = lag_search.evaluate_lag_grid(
        small, ref, lon, lat, base, l1, [0.0], [0.0], [0.0], [0.0],
        mesh=mesh, order=2, method="correlation", kind="tan", batch_size=2,
        allow_fast=False)
    np.testing.assert_allclose(out.ravel(), ref_out, rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_fft_fast_path_on_nondefault_mesh():
    small, ref, lon, lat, base, l1 = synthetic_inputs()
    mesh = nondefault_mesh(4)
    l2 = np.array([0.0, 2.0 / 3600.0])
    ref_out = fast_corr.evaluate_crval_grid_fast(
        small, ref, lon, lat, base, l1, l2, order=2, mesh=None)
    out = fast_corr.evaluate_crval_grid_fast(
        small, ref, lon, lat, base, l1, l2, order=2, mesh=mesh)
    assert out is not None and ref_out is not None
    np.testing.assert_allclose(out, ref_out, rtol=1e-4, atol=1e-6)


def test_quad_eval_on_nondefault_mesh():
    rng = np.random.default_rng(5)
    n = 64
    small = rng.normal(size=(n, n)).astype(np.float32) + 10.0
    ref = rng.normal(size=(n, n)).astype(np.float32) + 10.0
    L = 8
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-3.0, 3.0, L)
    coeffs[:, 2, 1] = np.linspace(2.0, -2.0, L)
    ref_out = carrington.evaluate_quad_lags(coeffs, small, ref, order=2)
    mesh = nondefault_mesh(4)
    out = carrington.evaluate_quad_lags(coeffs, small, ref, order=2,
                                        mesh=mesh)
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-7)


def test_mesh_put_places_on_mesh_devices():
    mesh = nondefault_mesh(4)
    arr = lag_search.mesh_put(np.ones((8, 5)), mesh,
                              lag_search.P("lags"), dtype=jnp.float32)
    assert set(arr.sharding.device_set) == set(mesh.devices.ravel())
    default = jax.devices()[0]
    assert default not in arr.sharding.device_set
