"""Transform framework, matrix transforms, and Util-compat surface tests."""
import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.core import transforms
from euispice_coreg_tpu.core.score import c_correlate3d
from euispice_coreg_tpu.utils.matrix_transform import MatrixTransform
from euispice_coreg_tpu.utils.util_compat import (
    AlignCommonUtil,
    AlignEUIUtil,
    AlignSpiceUtil,
    PlotFits,
)


def test_euclidian_roundtrip():
    t = transforms.EuclidianTransform(dx=3.0, dy=-2.0, theta=30.0, scale=1.5)
    x = np.linspace(0, 10, 7)
    y = np.linspace(-5, 5, 7)
    fx_, fy_ = t.forward(x, y, xp=np)
    bx, by = t.inverse(fx_, fy_, xp=np)
    np.testing.assert_allclose(bx, x, atol=1e-12)
    np.testing.assert_allclose(by, y, atol=1e-12)


def test_composite_transform_order():
    shift = transforms.EuclidianTransform(dx=1.0, dy=0.0, theta=0.0, scale=1.0)
    scale = transforms.EuclidianTransform(dx=0.0, dy=0.0, theta=0.0, scale=2.0)
    comp = shift + scale  # shift first, then scale
    x, y = comp(np.array([1.0]), np.array([0.0]), xp=np)
    assert float(x[0]) == pytest.approx(4.0)


def test_differential_rotation_inverse():
    t = transforms.DifferentialRotationTransform(delta_t_days=2.0, rate_wave="171")
    lon = np.array([120.0, 130.0])
    lat = np.array([0.0, 30.0])
    fx_, fy_ = t.forward(lon, lat, xp=np)
    # equator moves faster than Carrington rate for the 171 band
    assert fx_[0] < lon[0]
    bx, _ = t.inverse(fx_, fy_, xp=np)
    np.testing.assert_allclose(bx, lon, atol=1e-12)


def test_carrington_transform_matches_engine():
    """CarringtonTransform must agree with the engine's decomposed math."""
    from euispice_coreg_tpu.engine import carrington as carr

    hdr = fx.make_header((80, 80), (8.0, 8.0), (150.0, 100.0), 0.3,
                         extra=fx.CARR_EXTRA)
    t = transforms.CarringtonTransform(hdr, radius_correction=1.004,
                                       reference_date=hdr["DATE-OBS"],
                                       rate_wave="171")
    lon, lat = carr.carrington_grid((115, 125), (-2, 8), (32, 32))
    nx1, ny1 = t(lon, lat, xp=np)

    sc = carr.header_spherical_scalars(hdr, 1.004)
    x3, yy, zz = carr.observer_geometry(lon, lat, sc["obs_lon"], sc["obs_lat"])
    x0, y0 = carr._pixel_origin(sc["crval1_arcsec"], sc["crval2_arcsec"],
                                sc["crpix1"], sc["crpix2"], sc["roll"],
                                sc["cdelt1_arcsec"], sc["cdelt2_arcsec"], xp=np)
    nx2, ny2 = carr.spherical_project(x3, yy, zz, sc["dist"], sc["roll"],
                                      x0, y0, sc["cdelt1_arcsec"],
                                      sc["cdelt2_arcsec"], xp=np)
    np.testing.assert_allclose(nx1, nx2, atol=1e-9, equal_nan=True)
    np.testing.assert_allclose(ny1, ny2, atol=1e-9, equal_nan=True)


def test_rectifier_samples_image():
    ident = transforms.EuclidianTransform(dx=0.0, dy=0.0, theta=0.0, scale=1.0)
    rect = transforms.Rectifier(ident)
    img = np.arange(100, dtype=np.float64).reshape(10, 10)
    out = rect(img, shape=(5, 5), xlims=(0, 8), ylims=(0, 8), order=1)
    assert out.shape == (5, 5)
    assert out[0, 0] == pytest.approx(0.0)
    assert out[0, 1] == pytest.approx(2.0)  # x=2 -> img[0, 2]


def test_polynomial_distortion_roundtrip():
    cx = np.zeros((3, 3))
    cx[1, 0] = 1e-3  # dx = 1e-3 * x
    cy = np.zeros((3, 3))
    cy[0, 1] = -5e-4
    t = transforms.PolynomialDistortion(cx, cy)
    x = np.linspace(0, 2000, 11)
    y = np.linspace(0, 2000, 11)
    fx_, fy_ = t.forward(x, y, xp=np)
    assert fx_[10] == pytest.approx(2000 + 2.0)
    bx, by = t.inverse(fx_, fy_, xp=np)
    np.testing.assert_allclose(bx, x, atol=1e-3)
    np.testing.assert_allclose(by, y, atol=1e-3)


def test_polyfit2d_recovers_coeffs():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, 200)
    y = rng.uniform(0, 10, 200)
    f = 2.0 + 0.5 * x - 0.25 * y + 0.1 * x * y
    c = transforms.polyfit2d(x, y, f, deg=1)
    assert c[0, 0] == pytest.approx(2.0, abs=1e-8)
    assert c[1, 0] == pytest.approx(0.5, abs=1e-8)
    assert c[1, 1] == pytest.approx(0.1, abs=1e-8)


def test_matrix_transform_polar_rotation():
    xx, yy = np.meshgrid(np.arange(11, dtype=float), np.arange(11, dtype=float))
    nx, ny = MatrixTransform.polar_transform(xx, yy, theta=90, units="degree", xp=np)
    # the rotation center (round(11/2) = 6) is a fixed point
    assert nx[6, 6] == pytest.approx(6.0)
    assert ny[6, 6] == pytest.approx(6.0)
    # a point one step +x of the center maps to one step +y
    assert nx[6, 7] == pytest.approx(6.0, abs=1e-9)
    assert ny[6, 7] == pytest.approx(7.0, abs=1e-9)


def test_c_correlate3d_matches_1d():
    rng = np.random.default_rng(1)
    s1 = rng.normal(size=(2, 3, 50))
    s2 = np.roll(s1, 2, axis=-1)
    lags = [-2, 0, 2]
    out = np.asarray(c_correlate3d(s1, s2, lags))
    assert out.shape == (2, 3, 3)
    from euispice_coreg_tpu.core.score import c_correlate

    ref = np.asarray(c_correlate(s1[1, 2], s2[1, 2], lags))
    np.testing.assert_allclose(out[1, 2], ref, rtol=1e-10)
    assert np.argmax(out[0, 0]) == 2  # lag +2 wins


def test_util_compat_surface(tmp_path):
    assert AlignCommonUtil.ang2pipi(190.0) == pytest.approx(-170.0)
    # diff_rot at equator for 195: 14.50 - 14.184... > 0
    assert AlignEUIUtil.diff_rot(0.0) > 0
    hdr = fx.make_spice_l2_header()
    assert AlignSpiceUtil.vertical_edges_limits(hdr) == (3, 563)

    lon, lat, dsun = AlignEUIUtil.extract_EUI_coordinates(
        fx.make_header(extra={"DSUN_OBS": 1.0e11}))
    assert lon.shape == (128, 128)
    assert dsun == 1.0e11

    norm = PlotFits.get_range(np.random.default_rng(0).uniform(1, 10, (32, 32)))
    assert norm.vmin is not None

    idx, dt = AlignCommonUtil.find_closest_dict_index(
        "2022-03-17T10:00:00",
        {"date-avg": ["2022-03-17T09:00:00", "2022-03-17T10:00:30"],
         "dsun-obs": [1e11, 1e11]},
        threshold_time=60.0,
    )
    assert idx == 1 and dt == pytest.approx(30.0)
    with pytest.raises(ValueError, match="Delta time"):
        AlignCommonUtil.find_closest_dict_index(
            "2022-03-17T20:00:00",
            {"date-avg": ["2022-03-17T09:00:00"], "dsun-obs": [1e11]},
            threshold_time=60.0,
        )


def test_extend_regular_grid():
    lon, lat = np.meshgrid(np.arange(0.0, 1.0, 0.1), np.arange(0.0, 1.0, 0.1))
    lon2, lat2 = PlotFits.extend_regular_grid(lon, lat, 0.4, 0.2)
    assert lon2.min() < lon.min() and lon2.max() > lon.max()
    assert lon2.shape[1] > lon.shape[1]


def test_load_distortion_ini(tmp_path):
    ini = tmp_path / "dist.ini"
    ini.write_text(
        "[distortion]\ndegree = 2\ncx_1_0 = 1e-3\ncy_0_1 = -5e-4\n")
    t = transforms.load_distortion_ini(str(ini))
    fx_, fy_ = t.forward(np.array([1000.0]), np.array([1000.0]), xp=np)
    assert fx_[0] == pytest.approx(1001.0)
    assert fy_[0] == pytest.approx(999.5)


def test_plot_style_loads():
    from euispice_coreg_tpu.plot import plot as plotmod

    plotmod.use_style()


def test_with_retries_transient_then_success():
    from jax.errors import JaxRuntimeError

    from euispice_coreg_tpu.utils.jaxcfg import with_retries

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise JaxRuntimeError("UNAVAILABLE: device runtime crashed")
        return 42

    assert with_retries(flaky, retries=2, backoff_s=0.0)() == 42
    assert calls["n"] == 2


def test_with_retries_non_transient_raises():
    from jax.errors import JaxRuntimeError

    from euispice_coreg_tpu.utils.jaxcfg import with_retries

    def broken():
        raise JaxRuntimeError("INVALID_ARGUMENT: bad shapes")

    with pytest.raises(JaxRuntimeError, match="INVALID_ARGUMENT"):
        with_retries(broken, retries=3, backoff_s=0.0)()
