"""FFT fast-path vs general gather engine parity."""
import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.core.header import get_crota, wcs_params_from_header
from euispice_coreg_tpu.engine import fast_corr, lag_search
from euispice_coreg_tpu.utils import coords


def build_inputs(nan_border=True, crota=0.75, seed=0):
    """Self-aligned pair on the small grid (identity base map) plus a ref
    image resampled from a larger frame — the engine's actual geometry."""
    dl, hl, ds, hs = fx.make_helioprojective_pair(
        true_shift_arcsec=(8.0, -4.0), small_crota=crota, seed=seed
    )
    if nan_border:
        # NaN out the source border so both engines share identical boundary
        # semantics (fast path has no mirror extension; see fast_corr.py)
        ds[:2, :] = np.nan
        ds[-2:, :] = np.nan
        ds[:, :2] = np.nan
        ds[:, -2:] = np.nan
    lon, lat = coords.header_world_grid(hs)
    xg, yg = coords.world_to_pixel_of_header(hl, lon, lat)
    ref_img = lag_search.resample_to_grid(dl, xg, yg, order=2,
                                          compute_dtype="float64")
    base = {**wcs_params_from_header(hs).as_dict(), "crota": get_crota(hs)}
    return ds, ref_img, lon, lat, base


@pytest.mark.parametrize("order", [0, 2])
def test_fast_matches_general_exactly_with_nan_border(order):
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 2.0) / 3600.0
    l2 = np.arange(-14, 7, 2.0) / 3600.0

    general = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], [0.0],
        order=order, compute_dtype="float64", allow_fast=False,
    )[:, :, 0, 0, 0]
    fast = fast_corr.evaluate_crval_grid_fast(
        ds, ref_img, lon, lat, base, l1, l2, order=order,
        compute_dtype="float64",
    )
    assert fast is not None
    np.testing.assert_allclose(fast, general, rtol=1e-8, atol=1e-10)


def test_fast_matches_general_without_nan_border():
    """Without the NaN border the engines differ only in the 2-px boundary
    treatment: values agree to ~1e-4, argmax exactly."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=False)
    l1 = np.arange(-2, 19, 2.0) / 3600.0
    l2 = np.arange(-14, 7, 2.0) / 3600.0
    general = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], [0.0],
        order=2, compute_dtype="float64", allow_fast=False,
    )[:, :, 0, 0, 0]
    fast = fast_corr.evaluate_crval_grid_fast(
        ds, ref_img, lon, lat, base, l1, l2, order=2, compute_dtype="float64",
    )
    np.testing.assert_allclose(fast, general, atol=2e-3)
    assert np.unravel_index(np.nanargmax(fast), fast.shape) == \
        np.unravel_index(np.nanargmax(general), general.shape)


def test_fast_path_gating():
    assert fast_corr.fast_path_applicable([0.0], [0.0], [0.0], 2)
    assert not fast_corr.fast_path_applicable([0.0, 1e-5], [0.0], [0.0], 2)
    assert not fast_corr.fast_path_applicable([0.0], [0.0], [0.5], 2)
    assert not fast_corr.fast_path_applicable([0.0], [0.0], [0.0], 1)


def test_engine_auto_uses_fast_and_matches(tmp_path):
    """evaluate_lag_grid with allow_fast=True must agree with the explicit
    general path on argmax for a plain crval grid."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 2.0) / 3600.0
    l2 = np.arange(-14, 7, 2.0) / 3600.0
    auto = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], [0.0],
        order=2, compute_dtype="float64", allow_fast=True,
    )
    general = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], [0.0],
        order=2, compute_dtype="float64", allow_fast=False,
    )
    np.testing.assert_allclose(auto, general, rtol=1e-8, atol=1e-10)


def test_fast_path_float32_argmax():
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 2.0) / 3600.0
    l2 = np.arange(-14, 7, 2.0) / 3600.0
    f64 = fast_corr.evaluate_crval_grid_fast(
        ds, ref_img, lon, lat, base, l1, l2, order=2, compute_dtype="float64")
    f32 = fast_corr.evaluate_crval_grid_fast(
        ds, ref_img, lon, lat, base, l1, l2, order=2, compute_dtype="float32")
    assert np.unravel_index(np.nanargmax(f32), f32.shape) == \
        np.unravel_index(np.nanargmax(f64), f64.shape)
    np.testing.assert_allclose(f32, f64, atol=5e-3)


def test_block_fast_matches_general_with_crota_lags():
    """Mixed grid (crval x crota): block fast path must agree with the exact
    engine on argmax and closely on values (double-interpolation smoothing)."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 4.0) / 3600.0
    l2 = np.arange(-14, 7, 4.0) / 3600.0
    l5 = np.array([-0.5, 0.0, 0.5])

    general = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], l5,
        order=2, compute_dtype="float64", allow_fast=False,
    )
    block = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], l5,
        order=2, compute_dtype="float64", allow_fast="block",
    )
    assert block is not None
    assert np.unravel_index(np.nanargmax(block), block.shape) == \
        np.unravel_index(np.nanargmax(general), general.shape)
    np.testing.assert_allclose(block, general, atol=0.02)


def test_displacement_per_lag_multi_matches_single():
    """Batched multi-combo displacements == C serial displacement_per_lag
    calls (same WCS chain, vectorized over the combo axis)."""
    ds, ref_img, lon, lat, base = build_inputs()
    l1 = np.arange(-2, 19, 4.0) / 3600.0
    l2 = np.arange(-14, 7, 4.0) / 3600.0
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    lags = np.stack([g1.ravel(), g2.ravel()], axis=-1)

    combos = [lag_search._apply_lag_to_params_np(
        base, np.array([0.0, 0.0, 0.0, 0.0, d5]))
        for d5 in (-0.5, 0.0, 0.5)]
    cs_m, spreads_m = fast_corr.displacement_per_lag_multi(
        combos, lags, lon, lat, "tan", grid=base)
    for k, combo in enumerate(combos):
        c1, s1 = fast_corr.displacement_per_lag(combo, lags, lon, lat,
                                                "tan", grid=base)
        np.testing.assert_allclose(cs_m[k], c1, rtol=0, atol=1e-12)
        np.testing.assert_allclose(spreads_m[k], s1, rtol=1e-12, atol=1e-15)


def test_block_fast_fleet_matches_per_combo(monkeypatch):
    """The block path scores all (cdelt, crota) combos in ONE fleet program
    (movie path, combo axis = frame axis); its values must match the
    per-combo serial route bit-closely (same surfaces, different combine
    arithmetic only) and the fleet route must actually fire."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 4.0) / 3600.0
    l2 = np.arange(-14, 7, 4.0) / 3600.0
    l5 = np.array([-0.5, 0.0, 0.5])

    called = {}
    orig = fast_corr.evaluate_movie_from_displacements

    def spy(*a, **k):
        r = orig(*a, **k)
        called["fleet"] = r is not None
        return r

    monkeypatch.setattr(fast_corr, "evaluate_movie_from_displacements", spy)
    fleet = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], l5,
        order=2, compute_dtype="float64", allow_fast="block",
    )
    assert called.get("fleet") is True

    # force the per-combo fallback by making the fleet preconditions fail
    monkeypatch.setattr(fast_corr, "evaluate_movie_from_displacements",
                        lambda *a, **k: None)
    combo = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], l5,
        order=2, compute_dtype="float64", allow_fast="block",
    )
    np.testing.assert_allclose(fleet, combo, rtol=1e-8, atol=1e-10)


def test_block_fast_with_constant_nonzero_crota():
    """The reference golden configs use a constant crota lag (e.g. [0.75]):
    block path handles the non-identity base map via the pre-warp."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 2.0) / 3600.0
    l2 = np.arange(-14, 7, 2.0) / 3600.0
    l5 = np.array([0.75])
    general = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], l5,
        order=2, compute_dtype="float64", allow_fast=False,
    )
    block = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], l5,
        order=2, compute_dtype="float64", allow_fast="block",
    )
    assert np.unravel_index(np.nanargmax(block), block.shape) == \
        np.unravel_index(np.nanargmax(general), general.shape)
    np.testing.assert_allclose(block, general, atol=0.02)


def test_carrington_fast_matches_general():
    from euispice_coreg_tpu.engine import carrington as carr

    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    lonlims, latlims, shape = (115.0, 125.0), (-2.0, 8.0), (128, 128)
    ref_img = carr.reproject_to_carrington(
        dl, hl, lonlims, latlims, shape, d_solar_r=1.004,
        reference_date=hl["DATE-OBS"], rate_wave="171",
        compute_dtype="float64")
    l1 = np.arange(0.0, 41.0, 5.0) / 3600.0
    l2 = np.arange(-30.0, 11.0, 5.0) / 3600.0
    kwargs = dict(d_solar_r=1.004, reference_date=hl["DATE-OBS"],
                  rate_wave="171", order=2, compute_dtype="float64")
    general = carr.evaluate_lag_grid_carrington(
        ds, ref_img, hs, lonlims, latlims, shape,
        l1, l2, [0.0], [0.0], [0.0], allow_fast=False, **kwargs)
    fast = carr.evaluate_lag_grid_carrington(
        ds, ref_img, hs, lonlims, latlims, shape,
        l1, l2, [0.0], [0.0], [0.0], allow_fast=True, **kwargs)
    assert np.unravel_index(np.nanargmax(fast), fast.shape) == \
        np.unravel_index(np.nanargmax(general), general.shape)
    np.testing.assert_allclose(fast, general, atol=0.05)


def test_select_engine_matches_gather_engine():
    """The gather-free select path must agree with the gather engine exactly
    (same boundary semantics, incl. mirror taps) for a mixed lag grid."""
    from euispice_coreg_tpu.engine import lag_search as ls

    ds, ref_img, lon, lat, base = build_inputs(nan_border=False)
    l1 = np.arange(-2, 19, 4.0) / 3600.0
    l2 = np.arange(-14, 7, 4.0) / 3600.0
    l5 = np.array([-0.5, 0.75])

    # force gather by making the select precondition fail (shape mismatch
    # is the guard): instead call the internal evaluators directly
    import jax.numpy as jnp

    lags = []
    g = np.meshgrid(l1, l2, [0.0], [0.0], l5, indexing="ij")
    lags = np.stack([x.ravel() for x in g], axis=-1)

    base_d = {k: jnp.asarray(v, dtype="float64") for k, v in base.items()}
    gather = np.asarray(ls._evaluate_flat(
        jnp.asarray(lags, dtype="float64"), jnp.asarray(ds), jnp.asarray(ref_img),
        jnp.asarray(lon), jnp.asarray(lat), base_d,
        order=2, method="correlation", kind="tan", batch_size=8))

    select = ls.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], l5,
        order=2, compute_dtype="float64", allow_fast=False,
    ).ravel()
    np.testing.assert_allclose(select, gather, rtol=1e-10, atol=1e-12)


@pytest.mark.slow
def test_fast_path_sharded_matches_single_device():
    """FFT fast path with the field batch sharded over the 8-device mesh."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 2.0) / 3600.0
    l2 = np.arange(-14, 7, 2.0) / 3600.0
    single = fast_corr.evaluate_crval_grid_fast(
        ds, ref_img, lon, lat, base, l1, l2, order=2, compute_dtype="float64")
    mesh = lag_search.default_mesh()
    assert mesh is not None and mesh.devices.size == 8
    sharded = fast_corr.evaluate_crval_grid_fast(
        ds, ref_img, lon, lat, base, l1, l2, order=2, compute_dtype="float64",
        mesh=mesh)
    np.testing.assert_allclose(sharded, single, rtol=1e-10, atol=1e-12)


def test_carrington_select_matches_general():
    """Linearized-conjugation select path vs the per-lag gather engine."""
    from euispice_coreg_tpu.engine import carrington as carr
    from euispice_coreg_tpu.utils import timeutils

    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    lonlims, latlims, shape = (115.0, 125.0), (-2.0, 8.0), (128, 128)
    ref_img = carr.reproject_to_carrington(
        dl, hl, lonlims, latlims, shape, d_solar_r=1.004,
        reference_date=hl["DATE-OBS"], rate_wave="171", compute_dtype="float64")
    l1 = np.arange(0.0, 41.0, 10.0) / 3600.0
    l2 = np.arange(-30.0, 11.0, 10.0) / 3600.0
    kwargs = dict(d_solar_r=1.004, reference_date=hl["DATE-OBS"],
                  rate_wave="171", order=2, compute_dtype="float64")
    general = carr.evaluate_lag_grid_carrington(
        ds, ref_img, hs, lonlims, latlims, shape,
        l1, l2, [0.0], [0.0], [0.0], allow_fast=False, **kwargs)

    # call the select path directly (the FFT fast path would otherwise win)
    sc = carr.header_spherical_scalars(hs, 1.004)
    delta_t = timeutils.time_diff_days(str(hs["DATE-OBS"]), str(hl["DATE-OBS"]))
    sel = carr._carrington_select(
        ds, ref_img, sc, delta_t=delta_t, rate_wave="171",
        lonlims=lonlims, latlims=latlims, shape=shape,
        l1=l1, l2=l2, l3=np.array([0.0]), l4=np.array([0.0]),
        l5=np.array([0.0]), order=2, method="correlation",
        compute_dtype="float64", batch_size=4)
    assert sel is not None
    assert np.unravel_index(np.nanargmax(sel), sel.shape) == \
        np.unravel_index(np.nanargmax(general), general.shape)
    np.testing.assert_allclose(sel, general, atol=0.05)


@pytest.mark.parametrize("order", [0, 2])
def test_residus_masked_fast_matches_general(order):
    """The residue-score FFT factorization matches the exact gather engine
    (method='residus_masked': Sd/Sdd surface decomposition)."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 2.0) / 3600.0
    l2 = np.arange(-14, 7, 2.0) / 3600.0

    general = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], [0.0],
        order=order, compute_dtype="float64", allow_fast=False,
        method="residus_masked",
    )
    fast = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], [0.0],
        order=order, compute_dtype="float64", allow_fast=True,
        method="residus_masked",
    )
    # the factorized Sdd uses the E[x^2] - E[x]^2 form (vs the exact
    # engine's two-pass variance): ~1e-6 relative f64 cancellation
    np.testing.assert_allclose(fast, general, rtol=1e-5, atol=1e-9)
    assert np.unravel_index(np.nanargmin(fast), fast.shape) == \
        np.unravel_index(np.nanargmin(general), general.shape)


def test_residus_raw_never_routes_through_fast_paths():
    """Raw 'residus' (NaN-poisoning, alignment.py:544-548) is NOT
    factorizable faithfully (surface tap masks erode a border; f32 counts
    are inexact), so allow_fast must return the exact per-lag engine's
    result bit-for-bit, including its NaN pattern."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=False)
    l1 = np.arange(-2.0, 9.0, 2.0) / 3600.0
    l2 = np.arange(-6.0, 3.0, 2.0) / 3600.0

    general = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], [0.0],
        order=2, compute_dtype="float64", allow_fast=False, method="residus",
    )
    fast = lag_search.evaluate_lag_grid(
        ds, ref_img, lon, lat, base, l1, l2, [0.0], [0.0], [0.0],
        order=2, compute_dtype="float64", allow_fast=True, method="residus",
    )
    np.testing.assert_array_equal(np.isnan(fast), np.isnan(general))
    fin = np.isfinite(general)
    np.testing.assert_array_equal(fast[fin], general[fin])

    # and evaluate_from_displacements refuses raw residus outright
    assert fast_corr.evaluate_from_displacements(
        ds, np.asarray(ref_img), np.zeros((4, 2)), 0.0, order=2,
        method="residus") is None


@pytest.mark.parametrize("m,n,nsurf", [(384, 256, 3), (2160, 2048, 1)])
def test_box_inverse_matches_full_irfft2(m, n, nsurf):
    """Partial matmul-DFT box evaluation equals the full inverse transform
    on the box, at a bench-scale transform size too (where float32 phase
    angles of the raw index product would be off by ~1e-3 rad)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    fields = rng.normal(size=(nsurf, n, n))
    prods = np.fft.rfft2(fields, s=(m, m))
    full = np.fft.irfft2(prods, s=(m, m))

    y0, x0, by, bx = -70, -40, 128, 128
    box = np.asarray(fast_corr._box_inverse(
        jnp.asarray(prods, dtype=jnp.complex64), m, y0, x0, by, bx))
    want = full[:, (y0 + np.arange(by)) % m][:, :, (x0 + np.arange(bx)) % m]
    scale = np.max(np.abs(full))
    # one-level float32 direct DFT with exact (int) phase reduction
    assert np.max(np.abs(box - want)) < 5e-6 * scale


def test_fast_path_box_vs_full_surfaces():
    """evaluate_from_displacements through the float32 box path matches
    the float64 full-surface path."""
    ds, ref_img, lon, lat, base = build_inputs(nan_border=True)
    l1 = np.arange(-2, 19, 2.0) / 3600.0
    l2 = np.arange(-14, 7, 2.0) / 3600.0
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    lags = np.stack([g1.ravel(), g2.ravel()], axis=-1)
    c, spread = fast_corr.displacement_per_lag(base, lags, lon, lat, "tan")

    import unittest.mock as mock

    with mock.patch.object(fast_corr, "use_box_inverse", return_value=True):
        boxed = fast_corr.evaluate_from_displacements(
            ds, np.asarray(ref_img), c, spread, order=2,
            compute_dtype="float32")
    with mock.patch.object(fast_corr, "use_box_inverse", return_value=False):
        plain = fast_corr.evaluate_from_displacements(
            ds, np.asarray(ref_img), c, spread, order=2,
            compute_dtype="float64")
    assert boxed is not None and plain is not None
    assert np.unravel_index(np.nanargmax(boxed), (len(l1), len(l2))) == \
        np.unravel_index(np.nanargmax(plain), (len(l1), len(l2)))
    np.testing.assert_allclose(boxed, plain, atol=3e-3)


# ---------------------------------------------------------------------------
# batched movie path (fleet data parallelism over frame pairs)
# ---------------------------------------------------------------------------

def _movie_inputs(F=5, L=11, h=96, w=96, seed=3):
    rng = np.random.default_rng(seed)
    smalls = rng.normal(size=(F, h, w)) + 100.0
    refs = rng.normal(size=(F, h, w)) + 100.0
    refs[1, 10:20, 30:40] = np.nan  # masked blob in one frame
    smalls[2, 50:60, 5:15] = np.nan
    cs = rng.uniform(-6.0, 6.0, size=(F, L, 2))
    return smalls, refs, cs


@pytest.mark.parametrize("method", ["correlation", "residus_masked"])
def test_movie_batched_matches_per_frame(method):
    """evaluate_movie_from_displacements == per-frame
    evaluate_from_displacements, both without a mesh and with the frame
    axis sharded over the 8-device CPU mesh (F=5 exercises padding)."""
    import jax
    from jax.sharding import Mesh

    smalls, refs, cs = _movie_inputs()
    F = smalls.shape[0]
    singles = np.stack([
        fast_corr.evaluate_from_displacements(
            smalls[f], refs[f], cs[f], 0.0, order=2,
            compute_dtype="float64", method=method)
        for f in range(F)])
    scale = np.nanmax(np.abs(singles))

    batched = fast_corr.evaluate_movie_from_displacements(
        smalls, refs, cs, order=2, compute_dtype="float64", method=method)
    assert batched is not None and batched.shape == singles.shape
    # same inverse route + shared _combine_scores -> near-bit parity on CPU
    np.testing.assert_allclose(batched, singles, atol=1e-12 * scale)

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("lags",))
    sharded = fast_corr.evaluate_movie_from_displacements(
        smalls, refs, cs, order=2, compute_dtype="float64", method=method,
        mesh=mesh)
    np.testing.assert_allclose(sharded, singles, atol=1e-12 * scale)
    if method == "correlation":
        for f in range(F):
            assert np.nanargmax(sharded[f]) == np.nanargmax(singles[f])


def test_movie_batched_preconditions():
    smalls, refs, cs = _movie_inputs()
    # unsupported method -> None (caller falls back)
    assert fast_corr.evaluate_movie_from_displacements(
        smalls, refs, cs, method="residus") is None
    # displacements too large relative to the frame -> None
    big = cs.copy()
    big[0, 0] = (40.0, 40.0)
    assert fast_corr.evaluate_movie_from_displacements(
        smalls, refs, big) is None
    # mismatched stacks -> None
    assert fast_corr.evaluate_movie_from_displacements(
        smalls[:-1], refs, cs) is None
