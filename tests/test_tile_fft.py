"""Tile-local FFT Carrington evaluator: parity with the exact engine.

The tile-FFT path approximates the per-lag displacement as constant within
each tile, gated on the deviation in DETECTOR pixels (tile_fft.TOL_DET_PX).
On oversampled grids it must match the select path to ~1e-3 and the exact
engine at the argmax; on coarse (non-oversampled) grids the gate must
reject and fall back.
"""
import numpy as np
import pytest

from euispice_coreg_tpu.core.header import Header, pc_from_crota
from euispice_coreg_tpu.engine import carrington as carr


def bench_like_config(n=256, grid=9, cdelt=16.0):
    """Oversampled Carrington config shaped like the benchmark leg."""
    extra = {"DSUN_OBS": 0.5 * 1.496e11, "CRLN_OBS": 120.0, "CRLT_OBS": 3.0,
             "DATE-OBS": "2022-03-17T09:50:45", "WAVELNTH": 174}
    pc = pc_from_crota(0.3, cdelt, cdelt)
    hdr = Header({
        "NAXIS1": n, "NAXIS2": n, "CRVAL1": 150.0, "CRVAL2": 100.0,
        "CRPIX1": (n + 1) / 2, "CRPIX2": (n + 1) / 2,
        "CDELT1": cdelt, "CDELT2": cdelt,
        "CUNIT1": "arcsec", "CUNIT2": "arcsec", "CROTA": 0.3,
        "PC1_1": pc[0], "PC1_2": pc[1], "PC2_1": pc[2], "PC2_2": pc[3],
        **extra,
    })
    sc = carr.header_spherical_scalars(hdr, 1.004)
    px, py = np.meshgrid(np.arange(n, dtype=np.float64),
                         np.arange(n, dtype=np.float64))
    lon_c, lat_c = carr.spherical_unproject(px, py, sc)

    def scene(lo, la):
        out = np.full(lo.shape, 100.0)
        rng = np.random.default_rng(11)
        for _ in range(25):
            cx = rng.uniform(116, 124)
            cy = rng.uniform(-3, 7)
            w_ = rng.uniform(0.3, 1.5)
            out += rng.uniform(0.5, 3) * np.exp(
                -(((lo - cx) ** 2) + ((la - cy) ** 2)) / (2 * w_ * w_))
        return out

    small = np.where(np.isfinite(lon_c),
                     scene(np.nan_to_num(lon_c), np.nan_to_num(lat_c)),
                     np.nan)
    lonlims, latlims, shape = (117.0, 123.0), (-1.0, 7.0), (n, n)
    lon_g, lat_g = carr.carrington_grid(lonlims, latlims, shape)
    ref = scene(lon_g, lat_g)
    step = 2.0 / 3600.0
    l1 = (np.arange(grid) - grid // 2) * step
    return hdr, small, ref, lonlims, latlims, shape, l1


def run_mode(cfg, mode, method="correlation"):
    hdr, small, ref, lonlims, latlims, shape, l1 = cfg
    return carr.evaluate_lag_grid_carrington(
        small, ref, hdr, lonlims, latlims, shape,
        l1, l1, [0.0], [0.0], [0.0],
        d_solar_r=1.004, reference_date=hdr["DATE-OBS"], rate_wave="171",
        order=2, method=method, compute_dtype="float64", lag_mode=mode)


@pytest.fixture(scope="module")
def cfg():
    return bench_like_config()


def test_tile_fft_argmax_matches_exact(cfg):
    c_e = run_mode(cfg, "exact")
    c_t = run_mode(cfg, "tile_fft")
    mi_e = np.unravel_index(np.nanargmax(c_e), c_e.shape)
    mi_t = np.unravel_index(np.nanargmax(c_t), c_t.shape)
    assert mi_e == mi_t
    # peak value agreement (double interpolation bounds off-peak values)
    assert abs(np.nanmax(c_t) - np.nanmax(c_e)) < 1e-3


@pytest.mark.slow
def test_tile_fft_matches_select_values(cfg):
    """The tile approximation's marginal error vs the same-prewarp select
    evaluator must be far below the double-interpolation difference."""
    c_t = run_mode(cfg, "tile_fft")
    c_f = run_mode(cfg, "fast")
    np.testing.assert_allclose(c_t, c_f, atol=2e-3)
    mi = np.unravel_index(np.nanargmax(c_f), c_f.shape)
    near = np.abs(c_t - c_f)[max(mi[0]-2, 0): mi[0]+3,
                             max(mi[1]-2, 0): mi[1]+3]
    assert np.nanmax(near) < 2e-4


def test_tile_fft_residus_mode(cfg):
    c_t = run_mode(cfg, "tile_fft", method="residus_masked")
    c_f = run_mode(cfg, "fast", method="residus_masked")
    mi_t = np.unravel_index(np.nanargmin(c_t), c_t.shape)
    mi_f = np.unravel_index(np.nanargmin(c_f), c_f.shape)
    assert mi_t == mi_f
    np.testing.assert_allclose(c_t, c_f, atol=1e-3)


def _coarse_pair_alignment(tmp_path, fx):
    from euispice_coreg_tpu.hdrshift.alignment import Alignment

    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    return Alignment(
        large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
        lag_crval1=np.arange(0.0, 41.0, 10.0),
        lag_crval2=np.arange(-30.0, 11.0, 10.0),
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        small_fov_window=0, large_fov_window=0, lag_search_mode="tile_fft")


def test_coarse_grid_takes_tile_fft(tmp_path):
    """Weakly-oversampled (near detector-scale) grids pass the gate via the
    small rectangular tile shapes (96/64 in _TILE_SIZES): their within-tile
    deviation is anisotropic, so a narrow-wide rectangle meets TOL_DET_PX
    where every large square fails.  Accuracy on this config matches the
    exact engine to the shared-prewarp double-interpolation level
    (~7e-3)."""
    import fixtures as fx
    from euispice_coreg_tpu.engine import tile_fft

    A = _coarse_pair_alignment(tmp_path, fx)
    calls = []
    orig = tile_fft.evaluate_select_tile_fft

    def spy(*a, **k):
        r = orig(*a, **k)
        calls.append(r is not None)
        return r

    tile_fft.evaluate_select_tile_fft = spy
    try:
        corr = A.align_using_carrington(
            lonlims=(115.0, 125.0), latlims=(-2.0, 8.0), shape=(128, 128),
            return_type="corr")
    finally:
        tile_fft.evaluate_select_tile_fft = orig
    assert calls and all(calls), "tile-FFT gate rejected the coarse grid"
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    assert A.lag_crval1[mi[0]] == pytest.approx(20.0)
    assert A.lag_crval2[mi[1]] == pytest.approx(-10.0)


def test_gate_reject_falls_back(tmp_path, monkeypatch):
    """When the deviation gate rejects (evaluate returns None) the engine
    must fall through to the exact evaluator and still recover the
    argmax."""
    import fixtures as fx
    from euispice_coreg_tpu.engine import tile_fft

    A = _coarse_pair_alignment(tmp_path, fx)
    monkeypatch.setattr(tile_fft, "pick_tile_shape",
                        lambda *a, **k: None)
    monkeypatch.setattr(tile_fft, "pick_tile_shape_hybrid",
                        lambda *a, **k: None)
    calls = []
    orig = tile_fft.evaluate_select_tile_fft

    def spy(*a, **k):
        r = orig(*a, **k)
        calls.append(r is None)
        return r

    tile_fft.evaluate_select_tile_fft = spy
    try:
        corr = A.align_using_carrington(
            lonlims=(115.0, 125.0), latlims=(-2.0, 8.0), shape=(128, 128),
            return_type="corr")
    finally:
        tile_fft.evaluate_select_tile_fft = orig
    # the gate fired (returned None) and the engine still produced a result
    assert calls and all(calls)
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    assert A.lag_crval1[mi[0]] == pytest.approx(20.0)
    assert A.lag_crval2[mi[1]] == pytest.approx(-10.0)


def test_tile_fft_rotation_lags_via_combo_rewarp():
    """Rotation lags through the public Carrington engine on a strongly
    oversampled window: the engine re-warps per (cdelt, crota) combo, so the
    tile path sees translation-only lag sets per combo — this pins that the
    combo factorization + tile-FFT composition matches the same-prewarp
    select evaluator.  (Distinct per-tile anchors are exercised directly in
    ``test_per_tile_boxes_match_global_box``.)"""
    from euispice_coreg_tpu.engine import tile_fft

    hdr, small, ref, _, _, _, _ = bench_like_config()
    # ~0.12 deg window over 256 px -> grid px ~1.7 arcsec vs 16 arcsec
    # detector px: scale_det_per_grid ~0.1, so the gate admits rotations
    # large enough to split the per-tile integer anchors
    lonlims, latlims, shape = (119.94, 120.06), (2.44, 2.56), (256, 256)
    lon_g, lat_g = carr.carrington_grid(lonlims, latlims, shape)

    def scene(lo, la):
        out = np.full(lo.shape, 100.0)
        rng = np.random.default_rng(11)
        for _ in range(25):
            cx = rng.uniform(116, 124)
            cy = rng.uniform(-3, 7)
            w_ = rng.uniform(0.3, 1.5)
            out += rng.uniform(0.5, 3) * np.exp(
                -(((lo - cx) ** 2) + ((la - cy) ** 2)) / (2 * w_ * w_))
        return out

    ref_img = scene(lon_g, lat_g)
    l1 = (np.arange(3) - 1) * (2.0 / 3600.0)
    lrot = np.array([-0.5, 0.0, 0.5])

    calls = []
    orig = tile_fft.evaluate_select_tile_fft

    def spy(*a, **k):
        r = orig(*a, **k)
        calls.append(r is not None)
        return r

    def run(mode):
        return carr.evaluate_lag_grid_carrington(
            small, ref_img, hdr, lonlims, latlims, shape,
            l1, l1, [0.0], [0.0], lrot,
            d_solar_r=1.004, reference_date=hdr["DATE-OBS"],
            rate_wave="171", order=2, compute_dtype="float64",
            lag_mode=mode)

    tile_fft.evaluate_select_tile_fft = spy
    try:
        c_t = run("tile_fft")
    finally:
        tile_fft.evaluate_select_tile_fft = orig
    assert calls and all(calls), "tile-FFT path did not run (gate rejected)"
    c_f = run("fast")
    assert c_t.shape == c_f.shape
    scale = np.nanmax(np.abs(c_f)) + 1e-30
    np.testing.assert_allclose(c_t, c_f, atol=5e-3 * scale)


def test_per_tile_boxes_match_global_box():
    """Per-tile offset boxes (anchored at each tile's own offset range) must
    reproduce the global-union-box evaluation bit-for-bit in semantics:
    handcrafted coeffs with a strong linear displacement gradient force the
    per-tile anchors apart by several pixels, so the per-tile rel-slicing of
    the padded r frame is genuinely exercised."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    T = 128
    rng = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    ref[:6, :] = np.nan       # masked border + interior NaN block
    warped[40:44, 80:90] = np.nan

    # coeffs columns [u, v, 1, u^2, v^2, u*v] -> (dx, dy); linear gradient
    # 0.02 px/px => ~2.6 px anchor difference between adjacent tile centers
    L = 5
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-3.0, 3.0, L)       # per-lag dx constant
    coeffs[:, 2, 1] = np.linspace(2.0, -2.0, L)       # per-lag dy constant
    coeffs[:, 0, 0] = 0.02                            # dx grows with u
    coeffs[:, 1, 1] = -0.015                          # dy shrinks with v

    n_ty = n_tx = 2
    o_min_t, _ = tile_fft._per_tile_offset_bounds(coeffs, T, T, n_ty, n_tx)
    spread = o_min_t.max(axis=0) - o_min_t.min(axis=0)
    assert spread.max() >= 2, f"anchors degenerate: spread={spread}"

    kw = dict(order=2, h=h, w=w, method="correlation",
              compute_dtype="float64", tile_size=T)
    got = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, **kw)

    orig_bounds = tile_fft._per_tile_offset_bounds

    def global_bounds(cf, th_, tw_, n_ty_, n_tx_):
        omin, omax = orig_bounds(cf, th_, tw_, n_ty_, n_tx_)
        n = n_ty_ * n_tx_
        return (np.tile(omin.min(axis=0), (n, 1)),
                np.tile(omax.max(axis=0), (n, 1)))

    tile_fft._per_tile_offset_bounds = global_bounds
    try:
        want = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, **kw)
    finally:
        tile_fft._per_tile_offset_bounds = orig_bounds

    assert got is not None and want is not None
    # the two runs use different transform sizes (per-tile boxes are
    # smaller), so complex64 partial-DFT rounding differs at ~1e-7; an
    # anchor/slicing bug would show at the 1e-2 level (wrong offset read)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_tile_batch_matches_unbatched():
    """tile_batch > 1 (batched stage-1 DFT matmuls, including a chunk-pad
    remainder: 4 tiles with batch 3) must reproduce tile_batch=1."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    rng = np.random.default_rng(9)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    ref[:6, :] = np.nan
    warped[40:44, 80:90] = np.nan

    L = 7
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-3.0, 3.0, L)
    coeffs[:, 2, 1] = np.linspace(2.0, -2.0, L)
    coeffs[:, 0, 0] = 0.02
    coeffs[:, 1, 1] = -0.015

    kw = dict(order=2, h=h, w=w, method="correlation",
              compute_dtype="float64", tile_size=128)
    base = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, **kw)
    assert base is not None
    for b in (2, 3, 4):
        got = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref,
                                                tile_batch=b, **kw)
        np.testing.assert_allclose(got, base, rtol=1e-10, atol=1e-12)


def test_rectangular_tiles_match_square():
    """Rectangular tile shapes (th != tw, the auto-pick default when the
    within-tile deviation is anisotropic) must reproduce square-tile values;
    covers both axis orders and a non-dividing shape with edge tiles."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    rng = np.random.default_rng(21)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    ref[:6, :] = np.nan
    warped[40:44, 80:90] = np.nan

    L = 7
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-3.0, 3.0, L)
    coeffs[:, 2, 1] = np.linspace(2.0, -2.0, L)
    coeffs[:, 0, 0] = 0.02
    coeffs[:, 1, 1] = -0.015

    kw = dict(order=2, h=h, w=w, method="correlation",
              compute_dtype="float64")
    base = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref,
                                             tile_size=128, **kw)
    assert base is not None

    # gradient-free coeffs: the per-tile-center constant-shift approximation
    # is independent of the tiling, so every shape must agree to rounding
    cflat = coeffs.copy()
    cflat[:, 0, 0] = 0.0
    cflat[:, 1, 1] = 0.0
    base_flat = tile_fft.evaluate_select_tile_fft(cflat, warped, ref,
                                                  tile_size=128, **kw)
    for shape in ((128, 64), (64, 128), (128, 96)):
        got = tile_fft.evaluate_select_tile_fft(cflat, warped, ref,
                                                tile_size=shape, **kw)
        np.testing.assert_allclose(got, base_flat, rtol=1e-8, atol=1e-10)
        # with a displacement gradient the tile centers move, so values
        # differ at the approximation level — but the ranking must hold
        got_g = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref,
                                                  tile_size=shape, **kw)
        assert np.argmax(got_g) == np.argmax(base)
        np.testing.assert_allclose(got_g, base, atol=5e-3)


def test_pick_tile_shape_prefers_cheap_rectangle():
    """Anisotropic deviation (strong x-gradient of dx only) must steer the
    auto-pick to a rectangle that is tall where the deviation allows and
    pass the same gate pick_tile_size enforces."""
    from euispice_coreg_tpu.engine import tile_fft

    L = 5
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-30.0, 30.0, L)
    coeffs[:, 2, 1] = np.linspace(20.0, -20.0, L)
    coeffs[:, 0, 0] = 1.5e-3     # dx grows with u: tall tiles stay cheap
    h = w = 2048
    pick = tile_fft.pick_tile_shape(coeffs, h, w, 1.0, tol_det=0.5)
    assert pick is not None
    (th, tw), dev = pick
    assert dev <= 0.5
    # the deviation budget is consumed along x only -> th should exceed tw
    assert th > tw, (th, tw)

    # a gate-failing config must return None from both pickers
    coeffs_bad = coeffs.copy()
    coeffs_bad[:, 0, 0] = 1.0
    coeffs_bad[:, 1, 1] = 1.0
    assert tile_fft.pick_tile_shape(coeffs_bad, h, w, 1.0) is None
    assert tile_fft.pick_tile_size(coeffs_bad, h, w, 1.0) is None


def test_float32_matches_float64():
    """float32 tile-FFT scores (the device dtype; partial inverse pinned at
    _INV_PRECISION) against the float64 run of the same factorization,
    unbatched and with a batched chunk + pad remainder (4 tiles, batch 3):
    float32 rounding only, far inside the 1e-5 budget of this path."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    rng = np.random.default_rng(13)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    ref[:6, :] = np.nan
    warped[40:44, 80:90] = np.nan

    L = 7
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-3.0, 3.0, L)
    coeffs[:, 2, 1] = np.linspace(2.0, -2.0, L)
    coeffs[:, 0, 0] = 0.02
    coeffs[:, 1, 1] = -0.015

    for method in ("correlation", "residus_masked"):
        kw = dict(order=2, h=h, w=w, method=method, tile_size=128)
        base = tile_fft.evaluate_select_tile_fft(
            coeffs, warped, ref, compute_dtype="float64", **kw)
        assert base is not None
        for b in (1, 3):
            got = tile_fft.evaluate_select_tile_fft(
                coeffs, warped, ref, compute_dtype="float32", tile_batch=b,
                **kw)
            np.testing.assert_allclose(got, base, rtol=1e-4, atol=1e-5)


def test_tile_fft_sharded_matches_single_device():
    """Tile axis sharded over a NON-default-device mesh: one psum combines
    the per-device partial sums; values must match the unsharded run.

    Calls the tile-FFT evaluator DIRECTLY (like ``dryrun_multichip``): the
    public Carrington dispatch routes small/smooth configs to the
    block-fast path first, so a public-API version of this test silently
    stops exercising the sharded evaluator (caught in review: the shrunken
    128^2 config's displacement spread sits under the block-fast gate).
    A 3-device mesh over 4 tiles also exercises the tile padding (ids >=
    n_tiles contribute zero through the psum)."""
    import jax
    from jax.sharding import Mesh

    from euispice_coreg_tpu.engine import tile_fft

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs >= 4 virtual devices")
    mesh = Mesh(np.array(devs[1:4]), axis_names=("lags",))

    h = w = 256
    T = 128  # 2x2 tiles over a 3-device mesh -> padded to 6 tile ids
    rng = np.random.default_rng(3)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    ref[:6, :] = np.nan
    warped[40:44, 80:90] = np.nan

    L = 7
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-3.0, 3.0, L)
    coeffs[:, 2, 1] = np.linspace(2.0, -2.0, L)
    coeffs[:, 0, 0] = 0.02
    coeffs[:, 1, 1] = -0.015

    kw = dict(order=2, h=h, w=w, method="correlation",
              compute_dtype="float64", tile_size=T)
    want = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, **kw)
    got = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, mesh=mesh,
                                            **kw)
    assert want is not None and got is not None
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("limit_gb", [16.0, 63.76])
def test_mem_budget_follows_device_bytes_limit(monkeypatch, limit_gb):
    """The stage-1 budget is a fixed share of what the device lets this
    process allocate (memory_stats()["bytes_limit"]), not a constant."""
    from euispice_coreg_tpu.engine import tile_fft

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": int(limit_gb * 1e9)}

    got = tile_fft._mem_budget_bytes(Dev())
    assert got == pytest.approx(tile_fft._MEM_BUDGET_FRACTION * limit_gb * 1e9)


def test_mem_budget_without_device_stats_uses_host_memory():
    """Backends that report no memory stats (the CPU) budget against the
    host's physical memory."""
    import os

    from euispice_coreg_tpu.engine import tile_fft

    class Dev:
        def memory_stats(self):
            return None

    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert tile_fft._mem_budget_bytes(Dev()) == pytest.approx(
        tile_fft._MEM_BUDGET_FRACTION * host)


def test_tile_batch_clamped_to_per_device_shard(monkeypatch):
    """On a mesh, tile_batch is clamped to the per-device shard size: with
    4 tiles on a 3-device mesh each chip scans ceil(4/3)=2 ids, so a batch
    of 16 would make every chunk mostly clamped-duplicate padding (stage-1
    FFT work x8 for nothing).  Captures the batch actually handed to the
    sharded evaluator."""
    import jax

    from euispice_coreg_tpu.engine import tile_fft

    devs = jax.devices()
    if len(devs) < 3:
        pytest.skip("needs >= 3 virtual devices")
    from jax.sharding import Mesh

    mesh = Mesh(np.array(devs[:3]), axis_names=("lags",))

    h = w = 256
    rng = np.random.default_rng(3)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    L = 3
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-2.0, 2.0, L)
    coeffs[:, 0, 0] = 0.02

    seen = {}
    orig = tile_fft._evaluate_tiles_sharded

    def spy(mesh_, g, r, cf, otab, omg, order, score, th, tw, n_ty, n_tx,
            my, mx, by, bx, batch=1, group=None):
        seen["batch"] = batch
        return orig(mesh_, g, r, cf, otab, omg, order, score, th, tw, n_ty,
                    n_tx, my, mx, by, bx, batch, group)

    monkeypatch.setattr(tile_fft, "_evaluate_tiles_sharded", spy)
    got = tile_fft.evaluate_select_tile_fft(
        coeffs, warped, ref, order=2, h=h, w=w, method="correlation",
        compute_dtype="float64", tile_size=128, tile_batch=16, mesh=mesh)
    assert got is not None
    assert seen["batch"] == 2  # ceil(4 tiles / 3 devices)

def test_per_lag_hybrid_splits_and_matches_exact():
    """Gradient-dominated lag sets (within-tile deviation ~linear in the
    per-lag gradient) must REJECT the full-set gate, yet the per-lag hybrid
    scores the passing majority via tile-FFT and the remainder via the
    exact per-lag evaluator — merged values match the all-exact run to
    the tile approximation level on the passing lags and exactly on the
    rest."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    rng = np.random.default_rng(17)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    ref[:6, :] = np.nan
    warped[40:44, 80:90] = np.nan

    # per-lag dx gradient grows with the lag index: at the smallest tile
    # width (64) dev ~= g * 31.5, so with tol 0.15 lags with g < ~0.0048
    # pass and the rest fail for EVERY shape
    L = 9
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-2.0, 2.0, L)
    coeffs[:, 2, 1] = np.linspace(1.5, -1.5, L)
    coeffs[:, 0, 0] = np.linspace(0.0, 0.009, L)

    assert tile_fft.pick_tile_shape(coeffs, h, w, 1.0) is None
    hyb = tile_fft.pick_tile_shape_hybrid(coeffs, h, w, 1.0)
    assert hyb is not None
    (th, tw), mask = hyb
    assert 0 < mask.sum() < L
    # the gradient is monotone in the lag index -> the mask is a prefix
    assert mask[:int(mask.sum())].all() and not mask[int(mask.sum()):].any()

    # the engine-dispatch merge: tile-FFT on the passing subset (explicit
    # tile_size skips the full gate), exact evaluator on the remainder
    vals_t = tile_fft.evaluate_select_tile_fft(
        coeffs[mask], warped, ref, order=2, h=h, w=w, method="correlation",
        compute_dtype="float64", tile_size=(th, tw))
    vals_p = carr.evaluate_quad_lags(
        coeffs[~mask], warped, ref, order=2, method="correlation",
        compute_dtype="float64")
    assert vals_t is not None
    got = np.empty(L)
    got[mask] = vals_t
    got[~mask] = vals_p

    want = carr.evaluate_quad_lags(
        coeffs, warped, ref, order=2, method="correlation",
        compute_dtype="float64")
    # failing lags ride the same exact evaluator -> tight; passing lags carry
    # the bounded tile approximation
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert np.argmax(got) == np.argmax(want)

@pytest.mark.slow
def test_hybrid_dispatch_end_to_end():
    """Wide-lag grids through the real _carrington_select dispatch: the
    full-set gate rejects, the per-lag hybrid scores the passing majority
    via tile-FFT, the remainder rides the exact evaluator, and the
    merged surface ranks like the all-select twin.  (±160 arcsec corners on
    the 256² bench-like geometry: 79 of 81 lags pass per-lag.)"""
    hdr, small, ref, lonlims, latlims, shape, _ = bench_like_config()
    sc = carr.header_spherical_scalars(hdr, 1.004)
    step = 40.0 / 3600.0
    l1 = (np.arange(9) - 4) * step

    from euispice_coreg_tpu.engine import tile_fft

    seen = {}
    orig = tile_fft.pick_tile_shape_hybrid

    def spy(*a, **k):
        r = orig(*a, **k)
        seen["hyb"] = None if r is None else (r[0], int(r[1].sum()),
                                              len(r[1]))
        return r

    tile_fft.pick_tile_shape_hybrid = spy
    try:
        got = carr._carrington_select(
            small, ref, sc, 0.0, "171", lonlims, latlims, shape,
            l1, l1, [0.0], [0.0], [0.0],
            order=2, method="correlation", compute_dtype="float64",
            batch_size=8, use_tile_fft=True)
    finally:
        tile_fft.pick_tile_shape_hybrid = orig
    assert got is not None
    assert seen.get("hyb") is not None, "hybrid picker did not fire"
    _shape, n_pass, n_all = seen["hyb"]
    assert 0 < n_pass < n_all, seen["hyb"]

    want = carr._carrington_select(
        small, ref, sc, 0.0, "171", lonlims, latlims, shape,
        l1, l1, [0.0], [0.0], [0.0],
        order=2, method="correlation", compute_dtype="float64",
        batch_size=8, use_tile_fft=False)
    assert want is not None
    # tile approximation at the 0.15-det-px gate edge moves off-peak
    # values by up to ~0.03 here; the ranking (and the argmax) must hold
    assert np.nanargmax(got) == np.nanargmax(want)
    np.testing.assert_allclose(got, want, atol=0.05)


def test_mem_guard_declines_wide_span(monkeypatch):
    """Wide per-lag offset spans need dense surface boxes whose stacked
    size dwarfs device memory (the coarse bench grid would need a ~400 GB
    stage-1 allocation): both the evaluator and the hybrid picker must
    decline BEFORE any device work, and the same geometry must run under a
    budget that admits it."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    rng = np.random.default_rng(3)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = 100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
    warped = np.roll(ref, (2, -3), axis=(0, 1)) + rng.normal(size=(h, w))

    # pure translations spread over +-80 px: zero within-tile deviation
    # (every gate passes) but a ~160 px per-tile box span
    L = 25
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-80.0, 80.0, L)
    coeffs[:, 2, 1] = np.linspace(60.0, -60.0, L)

    monkeypatch.setattr(tile_fft, "_mem_budget_bytes", lambda *a: 0.002e9)
    out = tile_fft.evaluate_select_tile_fft(
        coeffs, warped, ref, order=2, h=h, w=w, method="correlation",
        compute_dtype="float64", tile_size=64)
    assert out is None
    assert tile_fft.pick_tile_shape_hybrid(coeffs, h, w, 1.0) is None

    monkeypatch.setattr(tile_fft, "_mem_budget_bytes", lambda *a: 8e9)
    out = tile_fft.evaluate_select_tile_fft(
        coeffs, warped, ref, order=2, h=h, w=w, method="correlation",
        compute_dtype="float64", tile_size=64)
    assert out is not None and np.isfinite(out).all()
    hyb = tile_fft.pick_tile_shape_hybrid(coeffs, h, w, 1.0)
    assert hyb is not None and hyb[1].all()


def test_hybrid_screen_declines_when_kernel_is_cheaper(monkeypatch):
    """The hybrid picker's stage-1-cost screen: when the estimated tile
    transforms cost more than scoring the passing lags on the exact per-lag
    evaluator, every candidate is skipped and the hybrid declines — the
    coarse wide-grid regime."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    L = 9
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-2.0, 2.0, L)
    coeffs[:, 2, 1] = np.linspace(1.5, -1.5, L)
    coeffs[:, 0, 0] = np.linspace(0.0, 0.009, L)

    assert tile_fft.pick_tile_shape_hybrid(coeffs, h, w, 1.0) is not None
    # collapse the planning throughput: every shape's est now dwarfs the
    # exact alternative, so the screen must reject them all
    monkeypatch.setattr(tile_fft, "_EST_S_PER_PLANE_PX", 1.0)
    assert tile_fft.pick_tile_shape_hybrid(coeffs, h, w, 1.0) is None


def test_grouped_scan_matches_single_pass(monkeypatch):
    """Memory-bounded GROUP scan parity: with a budget that only admits part
    of the tile set at once, _tiles_sum must chunk the tiles through
    stage 1+2 with a running (L, 6) sum — and produce the same scores as
    the single-pass path (the only difference is float summation order)."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    rng = np.random.default_rng(11)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    ref[:6, :] = np.nan
    warped[40:44, 80:90] = np.nan

    L = 7
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-2.0, 2.0, L)
    coeffs[:, 2, 1] = np.linspace(1.5, -1.5, L)
    coeffs[:, 0, 0] = 0.004

    kw = dict(order=2, h=h, w=w, method="correlation",
              compute_dtype="float64", tile_size=64,   # 4x4 = 16 tiles
              tile_batch=1)

    plan = {}
    orig_plan = tile_fft._mem_group_plan

    def cap(*a):
        g, rpad, bt = orig_plan(*a)
        plan.update(group=g, rpad=rpad, bt=bt)
        return g, rpad, bt

    monkeypatch.setattr(tile_fft, "_mem_group_plan", cap)
    want = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, **kw)
    assert want is not None
    assert plan["group"] >= 16  # baseline ran single-pass over all 16 tiles

    # budget that fits the r stack + exactly 5 tiles' boxes -> group=5,
    # 16 tiles scan as 4 groups (last one padded)
    monkeypatch.setattr(tile_fft, "_mem_budget_bytes",
                        lambda *a: plan["rpad"] + 5 * plan["bt"] + 1)
    seen = {}
    orig_eval = tile_fft._evaluate_tiles

    def spy(*a, **k):
        seen["group"] = k.get("group", a[17] if len(a) > 17 else None)
        return orig_eval(*a, **k)

    monkeypatch.setattr(tile_fft, "_evaluate_tiles", spy)
    got = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, **kw)
    assert got is not None
    assert seen["group"] == 5
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_hybrid_interior_nan_bands_match_exact():
    """SPICE-dumbbell hazard class: full-width interior NaN BANDS (not just
    off-disk fringes) on both canvases, with a gradient-dominated lag set
    that forces the per-lag hybrid split.  The tile-FFT side carries the
    NaN masking through its surface planes (M, M a, ...), so the merged
    hybrid scores must match the all-exact evaluator on values and argmax
    — weight-plane mixing's failure mode (0 * NaN = NaN infection beyond
    the tap footprint) must not appear."""
    from euispice_coreg_tpu.engine import tile_fft

    h = w = 256
    rng = np.random.default_rng(29)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(h, w)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(h, w)))
    # dumbbell-like interior bands: full-width on the small image (the
    # canvas the select taps sample), plus a block on the reference
    warped[96:112, :] = np.nan
    warped[200:206, 30:220] = np.nan
    ref[150:158, :] = np.nan

    L = 9
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-2.0, 2.0, L)
    coeffs[:, 2, 1] = np.linspace(1.5, -1.5, L)
    coeffs[:, 0, 0] = np.linspace(0.0, 0.009, L)

    assert tile_fft.pick_tile_shape(coeffs, h, w, 1.0) is None
    hyb = tile_fft.pick_tile_shape_hybrid(coeffs, h, w, 1.0,
                                          compute_dtype="float64")
    assert hyb is not None
    (th, tw), mask = hyb
    assert 0 < mask.sum() < L  # genuine split

    vals_t = tile_fft.evaluate_select_tile_fft(
        coeffs[mask], warped, ref, order=2, h=h, w=w, method="correlation",
        compute_dtype="float64", tile_size=(th, tw))
    vals_p = carr.evaluate_quad_lags(
        coeffs[~mask], warped, ref, order=2, method="correlation",
        compute_dtype="float64")
    assert vals_t is not None
    got = np.empty(L)
    got[mask] = vals_t
    got[~mask] = vals_p

    want = carr.evaluate_quad_lags(
        coeffs, warped, ref, order=2, method="correlation",
        compute_dtype="float64")
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert np.argmax(got) == np.argmax(want)
