"""Crota-lag argmax recovery across every non-default engine path.

The crval-grid fast paths had crota coverage only through parity pins; these
tests inject a REAL roll error and require each mode — helioprojective
auto/fast/exact, Carrington auto/tile_fft/fast — to recover it (tile_fft
spied to prove its own evaluator ran, not a fallback).
"""
import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.core.header import Header, pc_from_crota
from euispice_coreg_tpu.engine import carrington as carr
from euispice_coreg_tpu.hdrshift.alignment import Alignment


@pytest.mark.parametrize("mode", ["auto", "fast", "exact"])
def test_helioprojective_crota_recovery_modes(tmp_path, mode):
    """A 1-degree roll error recovered through each helioprojective engine
    mode."""
    dl, hl, ds, hs = fx.make_helioprojective_pair(
        true_shift_arcsec=(0.0, 0.0), true_dcrota_deg=1.0)
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    A = Alignment(
        large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
        lag_crval1=np.array([0.0]), lag_crval2=np.array([0.0]),
        lag_crota=np.arange(-2.0, 2.5, 0.5),
        small_fov_window=0, large_fov_window=0, lag_search_mode=mode,
    )
    corr = A.align_using_helioprojective(return_type="corr")
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    assert A.lag_crota[mi[4]] == pytest.approx(1.0)


def _carrington_roll_config(d_roll_true):
    """Oversampled Carrington window OFF the detector rotation center, so a
    roll error displaces the scene measurably (~1 px/deg at 50 px lever
    arm), rendered through the TRUE (rolled) pointing."""
    n = 256
    extra = {"DSUN_OBS": 0.5 * 1.496e11, "CRLN_OBS": 120.0, "CRLT_OBS": 3.0,
             "DATE-OBS": "2022-03-17T09:50:45", "WAVELNTH": 174}

    def make_hdr(crota):
        pc = pc_from_crota(crota, 2.0, 2.0)
        return Header({
            "NAXIS1": n, "NAXIS2": n, "CRVAL1": 150.0, "CRVAL2": 100.0,
            "CRPIX1": (n + 1) / 2, "CRPIX2": (n + 1) / 2,
            "CDELT1": 2.0, "CDELT2": 2.0,
            "CUNIT1": "arcsec", "CUNIT2": "arcsec", "CROTA": crota,
            "PC1_1": pc[0], "PC1_2": pc[1], "PC2_1": pc[2], "PC2_2": pc[3],
            **extra,
        })

    def scene(lo, la):
        out = np.full(lo.shape, 100.0)
        rng = np.random.default_rng(11)
        for _ in range(25):
            cx = rng.uniform(119, 124)
            cy = rng.uniform(0, 6)
            w_ = rng.uniform(0.1, 0.6)
            out += rng.uniform(0.5, 3) * np.exp(
                -(((lo - cx) ** 2) + ((la - cy) ** 2)) / (2 * w_ * w_))
        return out

    hdr_true = make_hdr(0.3 + d_roll_true)
    sc = carr.header_spherical_scalars(hdr_true, 1.004)
    px, py = np.meshgrid(np.arange(n, dtype=np.float64),
                         np.arange(n, dtype=np.float64))
    lon_c, lat_c = carr.spherical_unproject(px, py, sc)
    small = np.where(np.isfinite(lon_c),
                     scene(np.nan_to_num(lon_c), np.nan_to_num(lat_c)),
                     np.nan)
    hdr_given = make_hdr(0.3)

    # window ~3 deg of longitude away from disk center: ~50 detector px
    # lever arm from CRPIX
    lonlims, latlims, shape = (122.7, 123.3), (2.7, 3.3), (256, 256)
    lon_g, lat_g = carr.carrington_grid(lonlims, latlims, shape)
    ref = scene(lon_g, lat_g)
    return hdr_given, small, ref, lonlims, latlims, shape


@pytest.mark.parametrize("mode", ["auto", "tile_fft", "fast"])
def test_carrington_crota_recovery_modes(mode):
    """A 1-degree roll error recovered through the Carrington select engine
    in each lag mode; for tile_fft the spied tile-FFT evaluator must have
    produced the result (not the gated fallback)."""
    from euispice_coreg_tpu.engine import tile_fft

    d_true = 1.0
    hdr, small, ref, lonlims, latlims, shape = _carrington_roll_config(d_true)
    lrot = np.array([-1.0, 0.0, 1.0])

    ran = {"tile_fft": []}
    orig_t = tile_fft.evaluate_select_tile_fft

    def spy_t(*a, **k):
        r = orig_t(*a, **k)
        ran["tile_fft"].append(r is not None)
        return r

    tile_fft.evaluate_select_tile_fft = spy_t
    try:
        corr = carr.evaluate_lag_grid_carrington(
            small, ref, hdr, lonlims, latlims, shape,
            [0.0], [0.0], [0.0], [0.0], lrot,
            d_solar_r=1.004, reference_date=hdr["DATE-OBS"],
            rate_wave="171", order=2, compute_dtype="float64",
            lag_mode=mode)
    finally:
        tile_fft.evaluate_select_tile_fft = orig_t

    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    assert lrot[mi[4]] == pytest.approx(d_true), f"{mode}: {corr.ravel()}"
    if mode in ran:
        assert ran[mode] and all(ran[mode]), \
            f"{mode} evaluator did not carry the search"
