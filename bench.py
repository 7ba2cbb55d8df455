"""Benchmark: 121x121 CRVAL lag-grid alignment of a 2048^2 pair (BASELINE.md).

Runs on one GPU, in one process, and fails when JAX finds no GPU.  Prints
ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count", "card"}, ...}

The baseline is the reference algorithm's per-lag CPU cost measured here with
the same numerics the reference uses (scipy map_coordinates order-2 resample +
full-frame Pearson on one core), scaled to the reference's documented 20-core
fan-out (README example, counts_cpu_max=20).  The reference publishes no
numbers of its own (BASELINE.md), so this measured-equivalent is the honest
comparison point.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

N_SMALL = 2048
N_REF = 2048
GRID = 121
CPU_BASELINE_PROCS = 20
CPU_PROBE_LAGS = 5

# long engine timed() labels -> short bench stage keys
_STAGE_KEYS = {
    "carrington pre-warp (small -> grid)": "prewarp_s",
    "carrington tile-FFT select evaluation": "tilefft_total_s",
    "carrington hybrid tile-FFT evaluation": "hybrid_tilefft_s",
    "carrington exact quad evaluation": "quad_s",
    "carrington lon/lat grid (host)": "hostgrid_s",
    "submap (reference image -> comparison grid)": "submap_s",
}


def timed_best(run, n=2):
    """Warm once (compile), then best-of-n with a per-run stage breakdown.

    Returns (best_seconds, stages_of_best_run, last_result).  The stage
    dict holds the engine's obs.stage()/timed() wall-clocks for the BEST
    run only — attribution of the same number the leg reports, so
    host-vs-device swings separate mechanically (VERDICT r03 weak #3).
    Stage sums can exceed the leg total only by the bench-only syncs
    obs.stages_active() enables inside the engine."""
    from euispice_coreg_tpu.utils import obs

    result = run()  # warm compile, uncollected
    t_best, st_best = None, {}
    for _ in range(n):
        with obs.collect_stages() as st:
            t0 = time.perf_counter()
            result = run()
            dt = time.perf_counter() - t0
        if t_best is None or dt < t_best:
            t_best, st_best = dt, dict(st)
    stages = {_STAGE_KEYS.get(k, k): round(v, 4) for k, v in st_best.items()}
    return t_best, stages, result


def synthesize_pair():
    """Deterministic smooth 'sun' pair with a known 8 arcsec shift."""
    from euispice_coreg_tpu.core.header import pc_from_crota
    from euispice_coreg_tpu.core import wcs as _wcs
    from euispice_coreg_tpu.utils import coords

    def scene(lon, lat):
        out = np.full(lon.shape, 100.0)
        rng = np.random.default_rng(7)
        for _ in range(40):
            cx, cy = rng.uniform(-0.1, 0.1, size=2)
            w = rng.uniform(0.004, 0.02)
            a = rng.uniform(0.5, 3.0)
            out += a * np.exp(-(((lon - cx) ** 2) + ((lat - cy) ** 2)) / (2 * w * w))
        return out

    cdelt = 0.492 / 3600.0  # HRI pixel, deg
    pc = pc_from_crota(0.75, cdelt, cdelt)
    base = {
        "crval1": 120.0 / 3600.0, "crval2": 80.0 / 3600.0,
        "crpix1": (N_SMALL + 1) / 2, "crpix2": (N_SMALL + 1) / 2,
        "cdelt1": cdelt, "cdelt2": cdelt,
        "pc11": pc[0], "pc12": pc[1], "pc21": pc[2], "pc22": pc[3],
        "crota": 0.75,
    }
    x, y = coords.pixel_grid(N_REF, N_REF)
    lon_true, lat_true = _wcs.tan_pixel_to_world(base, x, y, xp=np)

    # render the small image through its TRUE pointing, then hand the engine
    # a header mispointed by -8 arcsec: the search must find +8
    true_shift = 8.0 / 3600.0
    small_img = scene(lon_true, lat_true)
    small_base = dict(base)
    small_base["crval1"] = base["crval1"] - true_shift

    # comparison grid = the small header's OWN pixel grid (exactly what the
    # public API's submap step builds, alignment.py:987-1016); the reference
    # leg is the scene sampled at those world coordinates.  The engine's
    # fast paths (incl. the per-combo block path) rely on this invariant.
    lon, lat = _wcs.tan_pixel_to_world(small_base, x, y, xp=np)
    ref_img = scene(lon, lat)
    return small_img, ref_img, lon, lat, small_base


def run_core(small_img, ref_img, lon, lat, base):
    """The headline leg: 121x121 CRVAL grid on the device-resident pair."""
    import jax.numpy as jnp

    from euispice_coreg_tpu.engine import lag_search

    step = 0.5 / 3600.0
    lag1 = (np.arange(GRID) - GRID // 2) * step
    lag2 = (np.arange(GRID) - GRID // 2) * step

    # device-resident image pair + comparison grid (loaded once, like any
    # production pipeline; probe extraction pulls 10 scalars in 1 transfer)
    small_d = jnp.asarray(small_img)
    ref_d = jnp.asarray(ref_img)
    lon_d = jnp.asarray(lon)
    lat_d = jnp.asarray(lat)

    def run():
        return lag_search.evaluate_lag_grid(
            small_d, ref_d, lon_d, lat_d, base,
            lag1, lag2, [0.0], [0.0], [0.0],
            order=2, method="correlation", kind="tan",
            compute_dtype="float32", batch_size=16,
            mesh=None,
        )

    # best-of-2: host load noise
    t_best, stages, corr = timed_best(run)
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    err = (None if abs(lag1[mi[0]] * 3600.0 - 8.0) < 1.0
           else f"argmax off: {lag1[mi[0]] * 3600}")
    return t_best, stages, err


def cpu_reference_per_lag(small_img, ref_img, lon, lat, base):
    """One lag step the reference way: astropy-equivalent WCS (numpy),
    scipy map_coordinates order=2, numba-equivalent Pearson (numpy).

    All multi-MB buffers are allocated and touched ONCE before timing, so
    first-touch page faults of fresh allocations stay out of the measured
    baseline (and out of the reported speedup)."""
    from scipy.ndimage import map_coordinates

    from euispice_coreg_tpu.core import wcs as _wcs

    out = np.empty(lon.size)
    coords_arr = np.empty((2, lon.size))
    ref_flat = np.ascontiguousarray(ref_img.ravel())
    out[:] = 0.0
    coords_arr[:] = 0.0

    def one_lag(k):
        p = dict(base)
        p["crval1"] = base["crval1"] + k * 0.5 / 3600.0
        x, y = _wcs.tan_world_to_pixel(p, lon, lat, xp=np)
        coords_arr[0] = y.ravel()
        coords_arr[1] = x.ravel()
        map_coordinates(small_img, coords_arr, order=2, mode="constant",
                        cval=np.nan, output=out, prefilter=False)
        mask = np.isfinite(ref_flat) & np.isfinite(out)
        a = ref_flat[mask]
        b = out[mask]
        ca, cb = a - a.mean(), b - b.mean()
        return np.sum(ca * cb) / np.sqrt(np.sum(ca * ca) * np.sum(cb * cb))

    one_lag(0)  # warm every internal buffer once (first-touch page faults)
    times = []
    for k in range(CPU_PROBE_LAGS):
        t0 = time.perf_counter()
        one_lag(k)
        times.append(time.perf_counter() - t0)
    return min(times)


def write_helio_pair(tmp_dir, small_img, ref_img, base):
    """FITS pair of :func:`synthesize_pair`: (reference path, small path)."""
    from euispice_coreg_tpu.core.header import Header
    from euispice_coreg_tpu.io import fits

    def make_hdr(params):
        pc = (params["pc11"], params["pc12"], params["pc21"], params["pc22"])
        return Header({
            "NAXIS1": N_SMALL, "NAXIS2": N_SMALL,
            "CRVAL1": params["crval1"] * 3600.0, "CRVAL2": params["crval2"] * 3600.0,
            "CRPIX1": params["crpix1"], "CRPIX2": params["crpix2"],
            "CDELT1": params["cdelt1"] * 3600.0, "CDELT2": params["cdelt2"] * 3600.0,
            "CUNIT1": "arcsec", "CUNIT2": "arcsec",
            "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN",
            "CROTA": params["crota"],
            "PC1_1": pc[0], "PC1_2": pc[1], "PC2_1": pc[2], "PC2_2": pc[3],
        })

    # ref_img is the scene sampled on the small header's own grid
    # (synthesize_pair), i.e. a correctly-pointed image UNDER THAT WCS:
    # its header is the same WCS it was rendered through
    ref_params = dict(base)
    p_large = f"{tmp_dir}/bench_large.fits"
    p_small = f"{tmp_dir}/bench_small.fits"
    fits.write(p_large, [fits.PrimaryHDU(data=ref_img.astype(np.float32),
                                         header=make_hdr(ref_params))])
    fits.write(p_small, [fits.PrimaryHDU(data=small_img.astype(np.float32),
                                         header=make_hdr(base))])
    return p_large, p_small


def run_full_api(tmp_dir, small_img, ref_img, base):
    """End-to-end through the public Alignment API: FITS read, submap,
    121x121 lag search, results object."""
    from euispice_coreg_tpu.hdrshift import Alignment

    p_large, p_small = write_helio_pair(tmp_dir, small_img, ref_img, base)
    step = 0.5
    lag = (np.arange(GRID) - GRID // 2) * step

    def run():
        A = Alignment(
            large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
            lag_crval1=lag, lag_crval2=lag,
            lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
            small_fov_window=0, large_fov_window=0,
        )
        return A.align_using_helioprojective(return_type="corr")

    t_best, stages, corr = timed_best(run)
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    err = (None if abs(lag[mi[0]] - 8.0) < 1.0
           else f"API argmax off: {lag[mi[0]]}")
    return t_best, stages, err


def mixed_lags():
    """21x21 CRVAL x 3 CROTA grid in degrees: (crval1, crval2, crota)."""
    step = 1.0 / 3600.0  # +-10" span: must cover the injected 8" shift
    lag = (np.arange(21) - 10) * step
    return lag, lag.copy(), np.array([-0.05, 0.0, 0.05])


def run_mixed_grid(small_img, ref_img, lon, lat, base):
    """Mixed-grid leg: 21x21 CRVAL x 3 CROTA on the 2048^2 pair — exercises
    the per-combo block fast path (one warp + FFT surfaces per combo), which
    the headline CRVAL-only metric never touches."""
    import jax.numpy as jnp

    from euispice_coreg_tpu.engine import lag_search

    lag1, lag2, lag5 = mixed_lags()

    small_d = jnp.asarray(small_img)
    ref_d = jnp.asarray(ref_img)
    lon_d = jnp.asarray(lon)
    lat_d = jnp.asarray(lat)

    def run():
        return lag_search.evaluate_lag_grid(
            small_d, ref_d, lon_d, lat_d, base,
            lag1, lag2, [0.0], [0.0], lag5,
            order=2, method="correlation", kind="tan",
            compute_dtype="float32", batch_size=16, mesh=None,
            allow_fast="block",
        )

    t_best, stages, corr = timed_best(run)
    # sanity on the crota=0 plane (the smooth synthetic scene is nearly
    # crota-flat, so the 5-D argmax can drift a lag step between planes)
    plane = corr[:, :, 0, 0, 1]
    mi = np.unravel_index(np.nanargmax(plane), plane.shape)
    err = (None if abs(lag1[mi[0]] * 3600.0 - 8.0) < 1.5
           else f"mixed argmax: {lag1[mi[0]] * 3600}")
    return t_best, stages, err


SYNRAS_LAG1 = np.arange(2.0, 15.0, 1.0)
SYNRAS_LAG2 = np.arange(-10.0, 3.0, 1.0)


def write_synras_inputs(tmp_dir):
    """Imager time series + SPICE L2 cube mispointed by (-8, +4) arcsec:
    (imager paths, SPICE path)."""
    import sys as _sys

    _sys.path.insert(0, "tests")
    import fixtures as fx
    from euispice_coreg_tpu.io import fits
    from euispice_coreg_tpu.utils import timeutils

    paths = []
    t0p = timeutils.parse_fits_time("2022-03-17T09:45:00")
    for k in range(5):
        hdr = fx.make_header((1024, 1024), (2.4, 2.4), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0p + 90.0 * k)
        data = fx.render_helioprojective(hdr, seed=0)  # static sun
        p = f"{tmp_dir}/bench_imager_{k}.fits"
        fits.write(p, [fits.PrimaryHDU(data=data.astype(np.float32),
                                       header=hdr)])
        paths.append(p)

    hdr_true = fx.make_spice_l2_header(nx=96, ny=128,
                                      crval_arcsec=(120.0, 80.0))
    cube = fx.render_spice_l2_cube(hdr_true)
    hdr_given = fx.make_spice_l2_header(nx=96, ny=128,
                                        crval_arcsec=(112.0, 84.0))
    p_spice = f"{tmp_dir}/solo_L2_bench_spice.fits"
    fits.write(p_spice, [fits.PrimaryHDU(data=cube.astype(np.float32),
                                         header=hdr_given)])
    return paths, p_spice


def synras_alignment(tmp_dir, paths, p_spice):
    """Build the synthetic raster from the imager series and return the
    AlignmentSpice object that aligns the SPICE cube against it."""
    from euispice_coreg_tpu.hdrshift.alignment_spice import AlignmentSpice
    from euispice_coreg_tpu.synras.map_builder import SPICEComposedMapBuilder

    builder = SPICEComposedMapBuilder(
        path_to_spectro=p_spice,
        list_imager_paths=paths,
        threshold_time=900.0,
        window_imager=0,
        window_spectro=0,
    )
    raster = builder.process(folder_path_output=tmp_dir, level=2,
                             print_filename=False,
                             return_synras_name=True)
    return AlignmentSpice(
        large_fov_known_pointing=raster,
        small_fov_to_correct=p_spice,
        lag_crval1=SYNRAS_LAG1,
        lag_crval2=SYNRAS_LAG2,
        large_fov_window=0, small_fov_window=0,
    )


def run_synras_spice(tmp_dir):
    """SPICE/synras leg: build a synthetic raster from an imager time series
    and align a SPICE L2 cube against it through the public API (the flows
    of synras/map_builder.py + hdrshift/alignment_spice.py)."""
    paths, p_spice = write_synras_inputs(tmp_dir)

    def run():
        return synras_alignment(tmp_dir, paths, p_spice) \
            .align_using_helioprojective(return_type="corr")

    t_best, _stages, corr = timed_best(run)
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    # truth: given header is (112, 84), true pointing (120, 80) -> (+8, -4)
    got1 = SYNRAS_LAG1[mi[0]]
    err = None if abs(got1 - 8.0) < 1.5 else f"synras argmax: {got1}"
    return t_best, err


def run_iterative_spice(tmp_dir):
    """Iterative context-raster leg (VERDICT r03 #6): the reference's most
    expensive path (alignment_spice.py:357-469 — per lag, re-shift BOTH
    SPICE headers, rebuild the synthetic raster from the imager series,
    and re-correlate).  5x5 CRVAL grid, 1024^2 imager frames, batched lag
    evaluation (one resample per imager frame for ALL lags + one vmapped
    score); a (+2, -2) arcsec pointing error is injected and recovered."""
    import sys as _sys

    _sys.path.insert(0, "tests")
    import fixtures as fx
    from euispice_coreg_tpu.hdrshift.alignment_spice import (
        AlignementSpiceIterativeContextRaster,
    )
    from euispice_coreg_tpu.io import fits
    from euispice_coreg_tpu.utils import timeutils

    paths = []
    t0p = timeutils.parse_fits_time("2022-03-17T09:45:00")
    for k in range(2):
        hdr = fx.make_header((1024, 1024), (2.4, 2.4), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0p + 150.0 * k)
        data = fx.render_helioprojective(hdr, seed=0)
        p = f"{tmp_dir}/bench_it_imager_{k}.fits"
        fits.write(p, [fits.PrimaryHDU(data=data.astype(np.float32),
                                       header=hdr)])
        paths.append(p)

    hdr_true = fx.make_spice_l2_header(crval_arcsec=(122.0, 78.0))
    cube = fx.render_spice_l2_cube(hdr_true)
    hdr_given = fx.make_spice_l2_header(crval_arcsec=(120.0, 80.0))
    p_spice = f"{tmp_dir}/solo_L2_bench_it_spice.fits"
    fits.write(p_spice, [fits.PrimaryHDU(data=cube.astype(np.float32),
                                         header=hdr_given)])

    lag = np.arange(-2.0, 3.0, 1.0)

    def run():
        A = AlignementSpiceIterativeContextRaster(
            large_fov_list_paths=paths,
            small_fov_to_correct=p_spice,
            threshold_time=600.0,
            lag_crval1=lag, lag_crval2=lag,
            large_fov_window=0, small_fov_window=0,
        )
        return A.align_using_helioprojective(return_type="corr")

    t_best, stages, corr = timed_best(run)
    plane = corr[:, :, 0, 0, 0, 0]
    mi = np.unravel_index(np.nanargmax(plane), plane.shape)
    err = (None
           if abs(lag[mi[0]] - 2.0) < 1.1 and abs(lag[mi[1]] + 2.0) < 1.1
           else f"iterative argmax: ({lag[mi[0]]}, {lag[mi[1]]})")
    return t_best, stages, err


CARR_LONLIMS, CARR_LATLIMS = (117.0, 123.0), (-1.0, 7.0)

_CARR_EXTRA = {
    "DSUN_OBS": 0.5 * 1.496e11, "CRLN_OBS": 120.0, "CRLT_OBS": 3.0,
    "DATE-OBS": "2022-03-17T09:50:45", "WAVELNTH": 174,
}


def _carr_scene(lon_c, lat_c):
    """Deterministic smooth blob field on the Carrington sphere."""
    out = np.full(lon_c.shape, 100.0)
    rng = np.random.default_rng(11)
    for _ in range(30):
        cx = rng.uniform(116, 124)
        cy = rng.uniform(-3, 7)
        w_ = rng.uniform(0.3, 1.5)
        out += rng.uniform(0.5, 3) * np.exp(
            -(((lon_c - cx) ** 2) + ((lat_c - cy) ** 2)) / (2 * w_ * w_))
    return out


def _carr_header(n, cdelt, crval1, crval2, crota=0.3):
    from euispice_coreg_tpu.core.header import Header, pc_from_crota

    pc = pc_from_crota(crota, cdelt, cdelt)
    return Header({
        "NAXIS1": n, "NAXIS2": n,
        "CRVAL1": crval1, "CRVAL2": crval2,
        "CRPIX1": (n + 1) / 2, "CRPIX2": (n + 1) / 2,
        "CDELT1": cdelt, "CDELT2": cdelt,
        "CUNIT1": "arcsec", "CUNIT2": "arcsec",
        "CROTA": crota, "PC1_1": pc[0], "PC1_2": pc[1],
        "PC2_1": pc[2], "PC2_2": pc[3], **_CARR_EXTRA,
    })


def _carr_render(hdr, d_solar_r=1.004):
    """Render the Carrington scene through a helioprojective header."""
    from euispice_coreg_tpu.engine import carrington as carr

    sc = carr.header_spherical_scalars(hdr, d_solar_r)
    n1, n2 = int(hdr["NAXIS1"]), int(hdr["NAXIS2"])
    px, py = np.meshgrid(np.arange(n1, dtype=np.float64),
                         np.arange(n2, dtype=np.float64))
    lon_c, lat_c = carr.spherical_unproject(px, py, sc)
    return np.where(np.isfinite(lon_c),
                    _carr_scene(np.nan_to_num(lon_c), np.nan_to_num(lat_c)),
                    np.nan)


def run_carrington(lon, lat):
    """BASELINE config 2: Carrington-frame 121x121 search on a 2048^2 grid."""
    from euispice_coreg_tpu.engine import carrington as carr

    scene = _carr_scene
    hdr = _carr_header(N_SMALL, 2.0, 150.0, 100.0)
    sc = carr.header_spherical_scalars(hdr, 1.004)
    px, py = np.meshgrid(np.arange(N_SMALL, dtype=np.float64),
                         np.arange(N_SMALL, dtype=np.float64))
    lon_c, lat_c = carr.spherical_unproject(px, py, sc)
    small = np.where(np.isfinite(lon_c), scene(np.nan_to_num(lon_c),
                                               np.nan_to_num(lat_c)), np.nan)

    lonlims, latlims = CARR_LONLIMS, CARR_LATLIMS
    shape = (N_SMALL, N_SMALL)
    lon_g, lat_g = carr.carrington_grid(lonlims, latlims, shape)
    ref = scene(lon_g, lat_g)

    step = 0.5 / 3600.0
    l1 = (np.arange(GRID) - GRID // 2) * step

    # device-resident inputs, like the core leg (run_core): the metric
    # measures the search, not the uploads (covered by end_to_end_api_s)
    import jax.numpy as jnp

    small_d = jnp.asarray(small, dtype=jnp.float32)
    ref_d = jnp.asarray(ref, dtype=jnp.float32)

    def run():
        return carr.evaluate_lag_grid_carrington(
            small_d, ref_d, hdr, lonlims, latlims, shape,
            l1, l1, [0.0], [0.0], [0.0],
            d_solar_r=1.004, reference_date=hdr["DATE-OBS"], rate_wave="171",
            order=2, compute_dtype="float32",
        )

    t_best, stages, _corr = timed_best(run)
    return t_best, stages, None  # no injected-shift recovery on this leg


def coarse_inputs():
    """Inputs of the coarse Carrington leg: (small, ref, given header,
    lonlims, latlims, shape, lag grid in degrees), +24 arcsec CRVAL1
    error."""
    from euispice_coreg_tpu.engine import carrington as carr

    # CRVAL here is in ARCSEC (CUNIT1, _carr_header): a +24 arcsec injection
    # is literally +24.0 (VERDICT r04 weak #1)
    hdr_true = _carr_header(N_SMALL, 2.0, 150.0 + 24.0, 100.0)
    hdr_given = _carr_header(N_SMALL, 2.0, 150.0, 100.0)
    small = _carr_render(hdr_true)
    shape = (N_SMALL, N_SMALL)
    lon_g, lat_g = carr.carrington_grid(CARR_LONLIMS, CARR_LATLIMS, shape)
    ref = _carr_scene(lon_g, lat_g)
    l1 = (np.arange(GRID) - GRID // 2) * (2.0 / 3600.0)
    return small, ref, hdr_given, CARR_LONLIMS, CARR_LATLIMS, shape, l1


def run_carrington_coarse():
    """Coarse/wide Carrington regime (VERDICT r03 #3): a ±121-arcsec
    121x121 grid whose corner lags exceed the full-set tile-FFT gate, so
    the per-lag HYBRID carries it — the passing majority through tile-FFT
    surfaces, the outer ring through the exact per-lag evaluator (which
    takes every lag when the hybrid's cost screen declines).  A +24 arcsec
    CRVAL1 error is injected and its recovery asserted."""
    from euispice_coreg_tpu.engine import carrington as carr

    small, ref, hdr_given, lonlims, latlims, shape, l1 = coarse_inputs()

    import jax.numpy as jnp

    small_d = jnp.asarray(small, dtype=jnp.float32)
    ref_d = jnp.asarray(ref, dtype=jnp.float32)

    def run():
        return carr.evaluate_lag_grid_carrington(
            small_d, ref_d, hdr_given, lonlims, latlims, shape,
            l1, l1, [0.0], [0.0], [0.0],
            d_solar_r=1.004, reference_date=hdr_given["DATE-OBS"],
            rate_wave="171", order=2, compute_dtype="float32",
        )

    t_best, stages, corr = timed_best(run)
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    err = (None if abs(l1[mi[0]] * 3600.0 - 24.0) < 3.0
           else f"coarse argmax off: {l1[mi[0]] * 3600}")
    return t_best, stages, err


def run_carrington_api(tmp_dir):
    """Carrington leg through the PUBLIC API (`align_using_carrington`):
    FITS read, thresholds, large-image reprojection onto the Carrington
    grid, 121x121 search, with argmax recovery of an injected 8 arcsec
    CRVAL1 error.  Catches API-level regressions (grid setup, retries
    wrapper, header plumbing) the engine-level `run_carrington` timing
    cannot see."""
    from euispice_coreg_tpu.hdrshift import Alignment

    p_large, p_small = write_carrington_pair(tmp_dir)
    lag = (np.arange(GRID) - GRID // 2) * 0.5

    def run():
        A = Alignment(
            large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
            lag_crval1=lag, lag_crval2=lag,
            small_fov_window=0, large_fov_window=0,
        )
        return A.align_using_carrington(
            lonlims=CARR_LONLIMS, latlims=CARR_LATLIMS,
            shape=(N_SMALL, N_SMALL),
            reference_date=_CARR_EXTRA["DATE-OBS"], return_type="corr")

    t_best, stages, corr = timed_best(run)
    plane = corr[:, :, 0, 0, 0, 0]
    mi = np.unravel_index(np.nanargmax(plane), plane.shape)
    err = (None if abs(lag[mi[0]] - 8.0) < 1.0
           else f"carrington API argmax: {lag[mi[0]]}")
    return t_best, stages, err



def write_carrington_pair(tmp_dir):
    """Carrington FITS pair with a -8 arcsec CRVAL1 pointing error on the
    small image: (reference path, small path)."""
    from euispice_coreg_tpu.io import fits

    # render the small image through its TRUE pointing, hand the API a
    # header mispointed by -8 arcsec in CRVAL1: the search must find +8
    hdr_true = _carr_header(N_SMALL, 2.0, 150.0, 100.0)
    small = _carr_render(hdr_true)
    hdr_given = _carr_header(N_SMALL, 2.0, 142.0, 100.0)
    # reference: a second vantage of the same scene (coarser pitch, no
    # roll) with correct pointing; the API reprojects it onto the grid
    hdr_large = _carr_header(N_SMALL, 2.4, 148.0, 98.0, crota=0.0)
    large = _carr_render(hdr_large)

    p_large = f"{tmp_dir}/bench_carr_large.fits"
    p_small = f"{tmp_dir}/bench_carr_small.fits"
    fits.write(p_large, [fits.PrimaryHDU(data=large.astype(np.float32),
                                         header=hdr_large)])
    fits.write(p_small, [fits.PrimaryHDU(data=small.astype(np.float32),
                                         header=hdr_given)])
    return p_large, p_small


def main():
    import tempfile

    from euispice_coreg_tpu.utils import jaxcfg

    jaxcfg.enable_persistent_compile_cache()
    device = jaxcfg.require_gpu()
    print(f"# {device['card']}", file=sys.stderr)
    small_img, ref_img, lon, lat, base = synthesize_pair()
    small32 = small_img.astype(np.float32)
    ref32 = ref_img.astype(np.float32)
    lon32 = lon.astype(np.float32)
    lat32 = lat.astype(np.float32)

    from euispice_coreg_tpu.utils.jaxcfg import with_retries

    # Bench protocol (VERDICT r04 weak #6): a measurement once paid for is
    # NEVER discarded.  Legs time first and validate recovery after,
    # returning (seconds, [stages,] err); a failed recovery still records
    # the seconds, with the failure in leg_errors.  Only a real exception
    # (worker crash, config bug) leaves a leg null — with its message.
    stages = {}
    leg_errors = {}

    def note(leg, err):
        if err is not None:
            leg_errors[leg] = str(err)
            print(f"# {leg} recovery failed: {err}", file=sys.stderr)

    t_core, stages["core"], err = with_retries(run_core, retries=2)(
        small32, ref32, lon32, lat32, base)
    note("core", err)
    n_lags = GRID * GRID
    evals_per_sec = n_lags / t_core

    # a failing secondary leg must not kill the primary metric
    t_api = None
    try:
        with tempfile.TemporaryDirectory() as td:
            t_api, stages["api"], err = run_full_api(td, small_img, ref_img,
                                                     base)
            note("api", err)
    except Exception as exc:  # noqa: BLE001
        note("api", exc)

    t_carr = None
    try:
        t_carr, stages["carr"], err = with_retries(
            run_carrington, retries=2)(lon, lat)
        note("carr", err)
    except Exception as exc:  # noqa: BLE001
        note("carr", exc)

    t_carr_api = None
    try:
        with tempfile.TemporaryDirectory() as td:
            t_carr_api, stages["carr_api"], err = with_retries(
                run_carrington_api, retries=2)(td)
            note("carr_api", err)
    except Exception as exc:  # noqa: BLE001
        note("carr_api", exc)

    t_carr_coarse = None
    try:
        t_carr_coarse, stages["carr_coarse"], err = with_retries(
            run_carrington_coarse, retries=2)()
        note("carr_coarse", err)
    except Exception as exc:  # noqa: BLE001
        note("carr_coarse", exc)

    t_mixed = None
    try:
        t_mixed, stages["mixed"], err = with_retries(
            run_mixed_grid, retries=2)(small32, ref32, lon32, lat32, base)
        note("mixed", err)
    except Exception as exc:  # noqa: BLE001
        note("mixed", exc)

    t_synras = None
    try:
        with tempfile.TemporaryDirectory() as td:
            t_synras, err = run_synras_spice(td)
            note("synras", err)
    except Exception as exc:  # noqa: BLE001
        note("synras", exc)

    t_iter = None
    try:
        with tempfile.TemporaryDirectory() as td:
            t_iter, stages["iterative"], err = run_iterative_spice(td)
            note("iterative", err)
    except Exception as exc:  # noqa: BLE001
        note("iterative", exc)

    t_cpu_lag = cpu_reference_per_lag(small_img, ref_img, lon, lat, base)
    t_cpu_total = t_cpu_lag * n_lags / CPU_BASELINE_PROCS
    speedup = t_cpu_total / t_core

    print(json.dumps({
        "metric": "lag-grid correlation evals/sec (2048^2 pair, 121x121 crval grid)",
        "value": round(evals_per_sec, 2),
        "unit": "evals/s",
        "vs_baseline": round(speedup, 2),
        "device": device,
        "wall_clock_s": round(t_core, 4),
        "end_to_end_api_s": round(t_api, 4) if t_api is not None else None,
        "carrington_121x121_2048_s": round(t_carr, 4) if t_carr is not None else None,
        "carrington_api_s": round(t_carr_api, 4) if t_carr_api is not None else None,
        "carrington_coarse_121x121_s": round(t_carr_coarse, 4) if t_carr_coarse is not None else None,
        "mixed_grid_21x21x3_2048_s": round(t_mixed, 4) if t_mixed is not None else None,
        "synras_spice_e2e_s": round(t_synras, 4) if t_synras is not None else None,
        "iterative_spice_5x5_s": round(t_iter, 4) if t_iter is not None else None,
        "cpu_baseline_s_20core_est": round(t_cpu_total, 2),
        # recovery/exception status per leg: absent key = leg ok.  A timed
        # leg whose recovery assert failed keeps its seconds above and
        # reports the failure here instead of nulling the number.
        "leg_errors": leg_errors or None,
        # per-leg stage attribution of the BEST run (engine obs.stage/timed
        # wall-clocks): separates host prep / pre-warp / device eval /
        # readout so leg-level swings can be attributed, not guessed
        "stages": {k: v for k, v in stages.items() if v},
    }))


if __name__ == "__main__":
    sys.exit(main())
