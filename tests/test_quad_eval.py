"""Exact quadratic-displacement evaluator (carrington.evaluate_quad_lags)
against the reference gather sampler + score, and the host-side tile bounds
the tile-FFT gate relies on."""
import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.core import resample, score
from euispice_coreg_tpu.engine import carrington as carr
from euispice_coreg_tpu.engine import lag_search, tile_fft


def quad_field(cf, h, w):
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    dx = (cf[0, 0] * jj + cf[1, 0] * ii + cf[2, 0]
          + cf[3, 0] * jj * jj + cf[4, 0] * ii * ii + cf[5, 0] * jj * ii)
    dy = (cf[0, 1] * jj + cf[1, 1] * ii + cf[2, 1]
          + cf[3, 1] * jj * jj + cf[4, 1] * ii * ii + cf[5, 1] * jj * ii)
    return jj + dx, ii + dy


def expected_scores(coeffs, warped, ref, order, method="correlation"):
    """Reference values: one plain gather-sampled field per lag, scored by
    the reference score function, all in float64."""
    import jax.numpy as jnp

    vals = []
    for cf in coeffs:
        x, y = quad_field(cf, *warped.shape)
        sampled = resample.sample_image(
            jnp.asarray(warped, dtype=jnp.float64), jnp.asarray(x),
            jnp.asarray(y), order=order)
        vals.append(float(score.SCORE_FUNCTIONS[method](
            jnp.asarray(ref, dtype=jnp.float64), sampled)))
    return np.array(vals)


def make_scene(h=256, w=200, seed=0, with_nans=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    warped = (np.sin(xx / 9.0) * np.cos(yy / 13.0)
              + 0.1 * rng.standard_normal((h, w)))
    ref = (np.roll(warped, (3, -5), axis=(0, 1))
           + 0.05 * rng.standard_normal((h, w)))
    if with_nans:
        warped = warped.copy()
        warped[40:55, 20:60] = np.nan
        ref = ref.copy()
        ref[100:120, 150:190] = np.nan
    return warped, ref


def scene_coeffs():
    """Large translations of both signs, affine and genuinely quadratic
    fields, on a non-square image."""
    coeffs = np.zeros((4, 6, 2))
    coeffs[0, 2] = (37.0 + 0.3, -141.0 + 0.6)
    coeffs[1, 2] = (-129.4, 8.2)
    coeffs[2, 2] = (5.3, -2.1)
    coeffs[2, 0, 0] = 4e-3
    coeffs[2, 1, 1] = -6e-3
    coeffs[2, 3, 0] = 3e-6
    coeffs[2, 4, 1] = -4e-6
    coeffs[3, 5] = (2e-6, -1.5e-6)
    return coeffs


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("with_nans", [False, True])
def test_quad_eval_matches_gather(order, with_nans):
    warped, ref = make_scene(with_nans=with_nans)
    coeffs = scene_coeffs()
    got = carr.evaluate_quad_lags(coeffs, warped, ref, order=order,
                                  compute_dtype="float64")
    want = expected_scores(coeffs, warped, ref, order)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_quad_eval_float32_matches_gather(order):
    """The device dtype: float32 fields and sums agree with the float64
    reference to float32 rounding."""
    warped, ref = make_scene(with_nans=True)
    coeffs = scene_coeffs()
    got = carr.evaluate_quad_lags(coeffs, warped, ref, order=order)
    want = expected_scores(coeffs, warped, ref, order)
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_quad_eval_residus_masked():
    warped, ref = make_scene(with_nans=True)
    # residus divides by sqrt(ref): keep it positive like real intensities
    ref = np.abs(ref) + 50.0
    warped = np.abs(warped) + 50.0
    coeffs = np.zeros((3, 6, 2))
    coeffs[0, 2] = (7.3, -24.6)
    coeffs[1, 2] = (-3.1, 9.9)
    coeffs[1, 0, 0] = -3e-3
    coeffs[2, 2] = (140.8, 33.2)
    got = carr.evaluate_quad_lags(coeffs, warped, ref, order=2,
                                  method="residus_masked",
                                  compute_dtype="float64")
    want = expected_scores(coeffs, warped, ref, 2, method="residus_masked")
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("chunk", [2, 3, 4096])
def test_quad_eval_chunk_padding(monkeypatch, chunk):
    """Lag chunks (including a padded tail chunk) reproduce the one-chunk
    run: the padding lags are dropped, never scored into the result."""
    warped, ref = make_scene(h=96, w=80)
    L = 5
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-6.0, 6.0, L)
    coeffs[:, 2, 1] = np.linspace(4.0, -4.0, L)
    want = expected_scores(coeffs, warped, ref, 2)
    monkeypatch.setattr(lag_search, "CHUNK_SELECT", chunk)
    got = carr.evaluate_quad_lags(coeffs, warped, ref, order=2,
                                  batch_size=2, compute_dtype="float64")
    assert got.shape == (L,)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_quad_eval_empty_lag_set():
    warped, ref = make_scene(h=32, w=32)
    out = carr.evaluate_quad_lags(np.zeros((0, 6, 2)), warped, ref, order=2)
    assert out.shape == (0,)


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_quad_eval_sharded_matches_single_device(n_dev):
    """Lag axis sharded over an n-device mesh (3 does not divide the 16
    lags: padded shards) reproduces the single-device scores."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:n_dev]), axis_names=("lags",))
    warped, ref = make_scene(h=128, w=128)
    coeffs = np.zeros((16, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-20, 20, 16)
    coeffs[:, 2, 1] = np.linspace(12, -12, 16)
    coeffs[:, 0, 0] = 2e-3
    single = carr.evaluate_quad_lags(coeffs, warped, ref, order=2)
    sharded = carr.evaluate_quad_lags(coeffs, warped, ref, order=2,
                                      mesh=mesh)
    np.testing.assert_allclose(sharded, single, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("th,tw", [(128, 128), (64, 96), (96, 64)])
def test_tile_bounds_are_rigorous(th, tw):
    """The host tile bounds (tile_fft._tile_bounds corner analysis) must
    cover the true within-tile deviation of the displacement from its
    tile-center value."""
    rng = np.random.default_rng(3)
    h, w = 300, 260
    n_ty, n_tx = -(-h // th), -(-w // tw)
    jj, ii = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    for _ in range(10):
        coeffs = np.zeros((1, 6, 2))
        coeffs[0, 0:2] = rng.uniform(-6e-3, 6e-3, (2, 2))
        coeffs[0, 2] = rng.uniform(-80, 80, 2)
        coeffs[0, 3:6] = rng.uniform(-8e-6, 8e-6, (3, 2))
        dev_x, dev_y = tile_fft._tile_bounds(
            coeffs, h, w, n_ty, n_tx, th=th, tw=tw)
        x, y = quad_field(coeffs[0], h, w)
        cf = coeffs[0]
        for ty in range(n_ty):
            for tx in range(n_tx):
                sl = np.s_[ty * th: min((ty + 1) * th, h),
                           tx * tw: min((tx + 1) * tw, w)]
                uc = 0.5 * (tx * tw + min((tx + 1) * tw - 1, w - 1))
                vc = 0.5 * (ty * th + min((ty + 1) * th - 1, h - 1))
                cdx, cdy = (cf[0, k] * uc + cf[1, k] * vc + cf[2, k]
                            + cf[3, k] * uc * uc + cf[4, k] * vc * vc
                            + cf[5, k] * uc * vc for k in (0, 1))
                assert np.max(np.abs((x - jj)[sl] - cdx)) <= dev_x + 1e-9
                assert np.max(np.abs((y - ii)[sl] - cdy)) <= dev_y + 1e-9


def _carrington_pair_inputs():
    from euispice_coreg_tpu.utils import timeutils

    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    lonlims, latlims, shape = (115.0, 125.0), (-2.0, 8.0), (128, 128)
    ref_img = carr.reproject_to_carrington(
        dl, hl, lonlims, latlims, shape, d_solar_r=1.004,
        reference_date=hl["DATE-OBS"], rate_wave="171",
        compute_dtype="float32")
    sc = carr.header_spherical_scalars(hs, 1.004)
    delta_t = timeutils.time_diff_days(str(hs["DATE-OBS"]),
                                       str(hl["DATE-OBS"]))
    return ds, ref_img, sc, delta_t, lonlims, latlims, shape, hs, hl


def test_carrington_select_tile_fft_matches_quad_eval():
    """The Carrington select path scored through tile-FFT surfaces vs the
    exact quadratic evaluator on the same pre-warp and quadratic fit:
    argmax equal, values within the tile approximation budget."""
    ds, ref_img, sc, delta_t, lonlims, latlims, shape, _hs, _hl = \
        _carrington_pair_inputs()
    l1 = np.arange(0.0, 41.0, 10.0) / 3600.0
    l2 = np.arange(-30.0, 11.0, 10.0) / 3600.0
    common = dict(
        delta_t=delta_t, rate_wave="171",
        lonlims=lonlims, latlims=latlims, shape=shape,
        l1=l1, l2=l2, l3=np.array([0.0]), l4=np.array([0.0]),
        l5=np.array([0.0]), order=2, method="correlation",
        compute_dtype="float32", batch_size=4)
    quad = carr._carrington_select(ds, ref_img, sc, use_tile_fft=False,
                                   **common)
    tile = carr._carrington_select(ds, ref_img, sc, use_tile_fft=True,
                                   **common)
    assert quad is not None and tile is not None
    np.testing.assert_allclose(tile, quad, atol=1e-2)
    assert np.unravel_index(np.nanargmax(tile), tile.shape) == \
        np.unravel_index(np.nanargmax(quad), quad.shape)


def test_carrington_select_quad_matches_exact_engine():
    """The select path's exact quadratic evaluator vs the reference-exact
    per-lag gather engine (single interpolation): the same argmax, values
    within the pre-warp double-interpolation difference."""
    ds, ref_img, sc, delta_t, lonlims, latlims, shape, hs, hl = \
        _carrington_pair_inputs()
    l1 = np.arange(0.0, 41.0, 10.0) / 3600.0
    l2 = np.arange(-30.0, 11.0, 10.0) / 3600.0
    quad = carr._carrington_select(
        ds, ref_img, sc, delta_t=delta_t, rate_wave="171",
        lonlims=lonlims, latlims=latlims, shape=shape, l1=l1, l2=l2,
        l3=np.array([0.0]), l4=np.array([0.0]), l5=np.array([0.0]),
        order=2, method="correlation", compute_dtype="float32",
        batch_size=4, use_tile_fft=False)
    exact = carr.evaluate_lag_grid_carrington(
        ds, ref_img, hs, lonlims, latlims, shape, l1, l2, [0.0], [0.0],
        [0.0], d_solar_r=1.004, reference_date=hl["DATE-OBS"],
        rate_wave="171", order=2, compute_dtype="float32",
        lag_mode="exact")
    assert np.unravel_index(np.nanargmax(quad), quad.shape) == \
        np.unravel_index(np.nanargmax(exact), exact.shape)
    np.testing.assert_allclose(quad, exact, atol=2e-2)


def test_lag_search_mode_pallas_raises(tmp_path):
    """The Pallas modes are gone: asking for one is an unknown mode."""
    from euispice_coreg_tpu.hdrshift.alignment import Alignment

    with pytest.raises(ValueError, match="unknown lag_search_mode"):
        Alignment(large_fov_known_pointing="a.fits",
                  small_fov_to_correct="b.fits", lag_search_mode="pallas")
