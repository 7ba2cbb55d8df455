"""Smoke run of the coalignment engine on the GPU.

Drives every main path once through the public entry points at bench
widths (2048^2 frames, 121x121 lag grids), checks each result, and compares
the device routes with the repo's plain references:

  1. device check (no CPU fallback)
  2. helioprojective public API: FITS pair -> Alignment -> shift ->
     corrected FITS header
  3. Carrington public API, 0.5-arcsec 121x121 grid (tile-FFT surfaces)
  4. coarse Carrington, +-121-arcsec 121x121 grid (exact quad evaluator)
  5. mixed 21x21x3 CRVAL x CROTA grid, synthetic raster + AlignmentSpice
  6. parity on the card: FFT fast path vs the exact engine, quad evaluator
     vs the plain per-lag reference, tile-FFT vs the quad evaluator

    python chip_smoke.py           # one GPU, phases 1-6
    python chip_smoke.py --four    # four GPUs: the multi-device paths and
                                   # their single-device references only

Runs in one process.  Each phase prints its path and warm wall time; any
failure exits non-zero, and without a GPU it exits before any phase.  The
last line of stdout is the JSON result.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def result_line(platform: str, kind: str, count: int) -> str:
    """The final stdout line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": int(count)}})


class PathLog(logging.Handler):
    """Collects the engine's path log lines ("engine path: ...",
    "carrington select: ...") of the phase in progress."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if "engine path" in msg or "carrington select" in msg:
            self.lines.append(msg)


class Smoke:
    def __init__(self, card: str):
        from euispice_coreg_tpu.utils.obs import logger

        self.card = card
        self.paths = PathLog()
        logger.addHandler(self.paths)
        logger.setLevel(logging.INFO)

    def phase(self, name, fn, expect_path=None):
        """Run ``fn`` cold (compile) and warm; check the engine path of the
        warm run contains ``expect_path``; print the warm wall time."""
        fn()
        self.paths.lines.clear()
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        taken = "; ".join(dict.fromkeys(self.paths.lines)) or "-"
        print(f"phase {name}: path [{taken}]", flush=True)
        if expect_path is not None and not any(
                expect_path in ln for ln in self.paths.lines):
            raise AssertionError(
                f"{name}: expected engine path containing "
                f"{expect_path!r}, got [{taken}]")
        print(f"phase {name}: warm {dt:.4f} s ({self.card})", flush=True)
        return out


def check_shift(name, got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    print(f"  {name}: recovered {np.round(got, 4).tolist()} arcsec, "
          f"injected {list(want)}", flush=True)
    if not np.all(np.abs(got - np.asarray(want)) <= tol):
        raise AssertionError(f"{name}: shift {got} != {want} (tol {tol})")


def top2(v):
    """(argmax index, runner-up index) of a flat score array."""
    order = np.argsort(np.nan_to_num(v.ravel(), nan=-np.inf))[::-1]
    return int(order[0]), int(order[1])


def run_single(sm, tmp):
    import bench
    import jax.numpy as jnp

    from euispice_coreg_tpu.engine import carrington as carr
    from euispice_coreg_tpu.engine import fast_corr, lag_search, tile_fft
    from euispice_coreg_tpu.hdrshift import Alignment
    from euispice_coreg_tpu.io import fits

    n = bench.N_SMALL
    # --- 2. helioprojective public API ---------------------------------
    small, ref, lon, lat, base = bench.synthesize_pair()
    p_large, p_small = bench.write_helio_pair(tmp, small, ref, base)
    lag = (np.arange(121) - 60) * 0.5

    def helio():
        A = Alignment(large_fov_known_pointing=p_large,
                      small_fov_to_correct=p_small,
                      lag_crval1=lag, lag_crval2=lag, lag_cdelt1=None,
                      lag_cdelt2=None, lag_crota=None,
                      small_fov_window=0, large_fov_window=0)
        return A.align_using_helioprojective()

    res = sm.phase("helioprojective_api", helio, "FFT fast (crval grid)")
    check_shift("helioprojective", res.shift_arcsec[:2], (8.0, 0.0), 0.25)
    p_out = os.path.join(tmp, "corrected.fits")
    res.write_corrected_fits([0], p_out)
    h_in = fits.open(p_small)[0].header
    h_out = fits.open(p_out)[0].header
    for key, k in (("CRVAL1", 0), ("CRVAL2", 1)):
        if abs(h_out[key] - (h_in[key] + res.shift_arcsec[k])) > 1e-9:
            raise AssertionError(f"corrected {key} {h_out[key]} != "
                                 f"{h_in[key]} + {res.shift_arcsec[k]}")
    print(f"  corrected header CRVAL1 {h_in['CRVAL1']:.4f} -> "
          f"{h_out['CRVAL1']:.4f}", flush=True)
    core_fast = res.corr[:, :, 0, 0, 0, 0]

    # --- 3. Carrington public API (tile-FFT) ----------------------------
    pc_large, pc_small = bench.write_carrington_pair(tmp)
    captured = {}
    orig_tile = tile_fft.evaluate_select_tile_fft

    def spy_tile(coeffs, warped, ref_img, **kw):
        captured.update(coeffs=np.asarray(coeffs), warped=warped,
                        ref=ref_img, scale=kw["scale_det_per_grid"])
        return orig_tile(coeffs, warped, ref_img, **kw)

    def carrington():
        A = Alignment(large_fov_known_pointing=pc_large,
                      small_fov_to_correct=pc_small,
                      lag_crval1=lag, lag_crval2=lag,
                      small_fov_window=0, large_fov_window=0)
        return A.align_using_carrington(
            lonlims=bench.CARR_LONLIMS, latlims=bench.CARR_LATLIMS,
            shape=(n, n), reference_date=bench._CARR_EXTRA["DATE-OBS"])

    tile_fft.evaluate_select_tile_fft = spy_tile
    try:
        res_c = sm.phase("carrington_api", carrington,
                         "carrington select: tile-FFT surfaces")
    finally:
        tile_fft.evaluate_select_tile_fft = orig_tile
    check_shift("carrington", res_c.shift_arcsec[:1], (8.0,), 0.5)

    # --- 4. coarse Carrington (exact quad evaluator) -----------------------
    c_small, c_ref, c_hdr, lonlims, latlims, shape, l1c = \
        bench.coarse_inputs()
    c_small_d = jnp.asarray(c_small, dtype=jnp.float32)
    c_ref_d = jnp.asarray(c_ref, dtype=jnp.float32)
    quad_in = {}
    orig_quad = carr.evaluate_quad_lags

    def spy_quad(coeffs, warped, ref_img, **kw):
        quad_in.update(coeffs=np.asarray(coeffs), warped=warped,
                       ref=ref_img)
        return orig_quad(coeffs, warped, ref_img, **kw)

    def coarse():
        return carr.evaluate_lag_grid_carrington(
            c_small_d, c_ref_d, c_hdr, lonlims, latlims, shape,
            l1c, l1c, [0.0], [0.0], [0.0], d_solar_r=1.004,
            reference_date=c_hdr["DATE-OBS"], rate_wave="171", order=2,
            compute_dtype="float32")

    carr.evaluate_quad_lags = spy_quad
    try:
        corr_coarse = sm.phase("coarse_carrington", coarse,
                               "carrington select: exact quad evaluator")
    finally:
        carr.evaluate_quad_lags = orig_quad
    mi = np.unravel_index(np.nanargmax(corr_coarse), corr_coarse.shape)
    check_shift("coarse carrington", (l1c[mi[0]] * 3600.0,), (24.0,), 2.0)

    # --- 5. mixed grid + synthetic raster / SPICE ------------------------
    small_d, ref_d = jnp.asarray(small, jnp.float32), jnp.asarray(
        ref, jnp.float32)
    lon_d, lat_d = jnp.asarray(lon, jnp.float32), jnp.asarray(
        lat, jnp.float32)
    lm1, lm2, lm5 = bench.mixed_lags()

    def mixed():
        return lag_search.evaluate_lag_grid(
            small_d, ref_d, lon_d, lat_d, base, lm1, lm2, [0.0], [0.0], lm5,
            order=2, method="correlation", kind="tan",
            compute_dtype="float32", batch_size=16, allow_fast="block")

    corr_mixed = sm.phase("mixed_grid", mixed, "FFT block fast (mixed grid)")
    plane = corr_mixed[:, :, 0, 0, 1]
    mi = np.unravel_index(np.nanargmax(plane), plane.shape)
    check_shift("mixed", (lm1[mi[0]] * 3600.0, lm2[mi[1]] * 3600.0),
                (8.0, 0.0), 1.0)

    paths, p_spice = bench.write_synras_inputs(tmp)
    res_s = sm.phase(
        "synras_spice",
        lambda: bench.synras_alignment(tmp, paths, p_spice)
        .align_using_helioprojective(), "engine path")
    check_shift("synras + SPICE", res_s.shift_arcsec[:2], (8.0, -4.0), 1.0)

    # --- 6. parity on the card ------------------------------------------
    print("phase parity: FFT fast path vs exact engine (121x121 core grid); "
          "fast: float32 cuFFT forward + box inverse matmul at "
          f"{fast_corr._BOX_PRECISION}; exact: float32 per-lag select "
          "sampler", flush=True)
    lag_deg = lag / 3600.0

    def core_exact():
        return lag_search.evaluate_lag_grid(
            small_d, ref_d, lon_d, lat_d, base, lag_deg, lag_deg, [0.0],
            [0.0], [0.0], order=2, method="correlation", kind="tan",
            compute_dtype="float32", batch_size=16, allow_fast=False)

    exact = sm.phase("core_exact", core_exact,
                     "shift-and-select")[:, :, 0, 0, 0]
    i1, i2 = top2(exact)
    d_core = float(np.nanmax(np.abs(core_fast - exact)))
    margin = core_fast.ravel()[i1] - core_fast.ravel()[i2]
    print(f"  argmax fast {top2(core_fast)[0]} exact {i1}; top-2 margin "
          f"exact {exact.ravel()[i1] - exact.ravel()[i2]:.3e} fast "
          f"{margin:.3e}; max|dcorr| {d_core:.3e} (tolerance 2e-4: "
          f"border-semantics difference of the fast path, budget of the "
          f"float32 arithmetic ~1e-5)", flush=True)
    if top2(core_fast)[0] != i1 or margin <= 0 or d_core > 2e-4:
        raise AssertionError("core fast path disagrees with the exact engine")

    print("phase parity: quad evaluator vs plain per-lag reference "
          "(coarse grid, 16 shared lags, float32, gathers + masked "
          "Pearson)", flush=True)
    from euispice_coreg_tpu.core import resample, score

    cf_all = quad_in["coeffs"]
    flat = corr_coarse.reshape(-1)
    pick = np.unique(np.linspace(0, cf_all.shape[0] - 1, 16).astype(int))
    got = orig_quad(cf_all[pick], quad_in["warped"], quad_in["ref"],
                    order=2)
    warped = jnp.asarray(quad_in["warped"], jnp.float32)
    ref_q = jnp.asarray(quad_in["ref"], jnp.float32)
    jj = jnp.arange(n, dtype=jnp.float32)[None, :]
    ii = jnp.arange(n, dtype=jnp.float32)[:, None]
    want = []
    for cf in cf_all[pick].astype(np.float32):
        dx = (cf[0, 0] * jj + cf[1, 0] * ii + cf[2, 0] + cf[3, 0] * jj * jj
              + cf[4, 0] * ii * ii + cf[5, 0] * jj * ii)
        dy = (cf[0, 1] * jj + cf[1, 1] * ii + cf[2, 1] + cf[3, 1] * jj * jj
              + cf[4, 1] * ii * ii + cf[5, 1] * jj * ii)
        s = resample.sample_image(warped, jj + dx, ii + dy, order=2)
        want.append(float(score.masked_pearson(ref_q, s)))
    want = np.asarray(want)
    rng = float(np.nanmax(flat) - np.nanmin(flat))
    d_quad = float(np.nanmax(np.abs(got - want))) / rng
    print(f"  max|dcorr| / peak range {d_quad:.3e} (tolerance 1e-5)",
          flush=True)
    if not d_quad <= 1e-5:
        raise AssertionError("quad evaluator disagrees with the reference")

    print("phase parity: tile-FFT vs quad evaluator (0.5-arcsec Carrington "
          "grid, all 14641 lags); tile-FFT: float32 cuFFT + partial "
          f"inverse at {tile_fft._INV_PRECISION}", flush=True)
    cf = captured["coeffs"]
    tile = orig_tile(cf, captured["warped"], captured["ref"], order=2,
                     h=n, w=n, scale_det_per_grid=captured["scale"])
    quad = orig_quad(cf, captured["warped"], captured["ref"], order=2)
    rng = float(np.nanmax(quad) - np.nanmin(quad))
    d_tile = float(np.nanmax(np.abs(tile - quad))) / rng
    near = np.argsort(quad)[::-1][:50]
    d_near = float(np.max(np.abs(tile[near] - quad[near]))) / rng
    print(f"  argmax tile {int(np.nanargmax(tile))} quad "
          f"{int(np.nanargmax(quad))}; max|dcorr| / peak range {d_tile:.3e} "
          f"(tolerance 2e-3), near the peak {d_near:.3e} (tolerance 2e-4)",
          flush=True)
    if (int(np.nanargmax(tile)) != int(np.nanargmax(quad)) or d_tile > 2e-3
            or d_near > 2e-4):
        raise AssertionError("tile-FFT disagrees with the quad evaluator")


def run_four(sm, tmp):
    import bench

    from euispice_coreg_tpu.engine import lag_search
    from euispice_coreg_tpu.hdrshift import Alignment
    from euispice_coreg_tpu.jitter_correction import align_movie_to_reference

    n = bench.N_SMALL
    mesh = lag_search.default_mesh()
    if mesh is None or mesh.devices.size != 4:
        raise AssertionError(f"--four needs 4 devices, mesh {mesh}")
    small, ref, lon, lat, base = bench.synthesize_pair()
    p_large, p_small = bench.write_helio_pair(tmp, small, ref, base)
    lag = (np.arange(121) - 60) * 0.5

    def helio(use_mesh):
        A = Alignment(large_fov_known_pointing=p_large,
                      small_fov_to_correct=p_small,
                      lag_crval1=lag, lag_crval2=lag, lag_cdelt1=None,
                      lag_cdelt2=None, lag_crota=None,
                      small_fov_window=0, large_fov_window=0,
                      use_device_mesh=use_mesh)
        return A.align_using_helioprojective(return_type="corr")

    print("four: helioprojective 121x121 search on the 4-card mesh vs one "
          "card; float32, tolerance 1e-5 (full inverse FFT vs box inverse)",
          flush=True)
    c4 = sm.phase("helio_mesh4", lambda: helio(True))
    c1 = sm.phase("helio_single", lambda: helio(False))
    _compare("helio", c4, c1, 1e-5)

    # movie: >= 8 frames, each with its own pointing error
    frames = []
    for k in range(8):
        b = dict(base)
        b["crval1"] = base["crval1"] + 0.5 * k / 3600.0
        d = os.path.join(tmp, f"frame{k}")
        os.makedirs(d, exist_ok=True)
        frames.append(bench.write_helio_pair(d, small, ref, b)[1])
    lag_m = np.arange(-10.0, 10.5, 0.5)

    def movie(m):
        kw = {} if m is not None else {"use_device_mesh": False}
        return align_movie_to_reference(
            frames, p_large, lag_crval1=lag_m, lag_crval2=lag_m,
            window_files_input=0, reference_window=0, mesh=m, **kw)

    print("four: 8-frame movie, frame axis over the 4-card mesh vs one "
          "card; float32, tolerance 1e-5", flush=True)
    r4 = sm.phase("movie_mesh4", lambda: movie(mesh))
    r1 = sm.phase("movie_single", lambda: movie(None))
    for k in range(8):
        _compare(f"movie frame {k}", r4[k].corr, r1[k].corr, 1e-5)
        check_shift(f"movie frame {k}", r4[k].shift_arcsec[:1],
                    (8.0 - 0.5 * k,), 0.25)

    pc_large, pc_small = bench.write_carrington_pair(tmp)

    def carrington(use_mesh):
        A = Alignment(large_fov_known_pointing=pc_large,
                      small_fov_to_correct=pc_small,
                      lag_crval1=lag, lag_crval2=lag,
                      small_fov_window=0, large_fov_window=0,
                      use_device_mesh=use_mesh)
        return A.align_using_carrington(
            lonlims=bench.CARR_LONLIMS, latlims=bench.CARR_LATLIMS,
            shape=(n, n), reference_date=bench._CARR_EXTRA["DATE-OBS"],
            return_type="corr")

    print("four: Carrington tile-FFT, tile axis over the 4-card mesh vs one "
          "card; float32, tolerance 1e-5 (summation order of the per-device "
          "partial sums)", flush=True)
    k4 = sm.phase("carrington_mesh4", lambda: carrington(True),
                  "carrington select: tile-FFT surfaces")
    k1 = sm.phase("carrington_single", lambda: carrington(False),
                  "carrington select: tile-FFT surfaces")
    _compare("carrington", k4, k1, 1e-5)


def _compare(name, a, b, tol):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = float(np.nanmax(np.abs(a - b)))
    ia, ib = int(np.nanargmax(a)), int(np.nanargmax(b))
    print(f"  {name}: argmax {ia} vs {ib}, max|d| {d:.3e} (tolerance "
          f"{tol:g})", flush=True)
    if ia != ib or not d <= tol:
        raise AssertionError(f"{name}: multi-device result differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths and their references")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from euispice_coreg_tpu.utils import jaxcfg

    jaxcfg.enable_persistent_compile_cache()
    try:
        dev = jaxcfg.require_gpu()
    except RuntimeError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    import jax

    print(f"devices: {jax.devices()}", flush=True)
    print(f"device_kind: {dev['kind']}", flush=True)
    print(dev["card"], flush=True)
    if args.four and dev["count"] != 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {dev['count']}",
              file=sys.stderr)
        return 2
    sm = Smoke(dev["card"])
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        (run_four if args.four else run_single)(sm, tmp)
    print(result_line(dev["platform"], dev["kind"], dev["count"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
