"""Public coalignment API: the ``Alignment`` class.

API-compatible rebuild of the reference's flagship class
(``/root/reference/euispice_coreg/hdrshift/alignment.py:45-1131``) on the
device engine:

* FITS I/O and header math stay on host (float64 numpy),
* the reference image is resampled onto the comparison grid ONCE on device
  (the reference's ``_create_submap_of_large_data``, alignment.py:987-1016),
* the whole 5-D lag hypercube is evaluated as a single vmapped/sharded JAX
  computation instead of a multiprocessing pool
  (``_find_best_header_parameters``, alignment.py:613-797).

Known reference quirks handled deliberately (SURVEY.md 2.3):

* CDELT lags are implemented *correctly* here (the reference never writes the
  shifted CDELT1 back and crashes on nonzero CDELT2 lags);
* min/max thresholds apply to the absolute pixel value, as in the reference
  (alignment.py:876-887);
* the serial-mode "submap never built" bug (alignment.py:765) is not
  reproduced — this engine always builds the submap, matching the reference's
  parallel mode (the mode its golden tests exercise);
* more than one ``lag_solar_r`` value works here (the reference crashes,
  alignment.py:660-665).

``parallelism``/``counts_cpu_max``/``display_progress_bar`` are accepted for
API compatibility; parallelism is always on-device (lag axis sharded over the
device mesh).
"""
from __future__ import annotations

import os
import sys
import warnings

import numpy as np

from ..core import wcs as wcs_mod
from ..core.header import Header, ensure_pcij, get_crota, wcs_params_from_header
from ..engine import carrington as carr_engine
from ..engine import lag_search
from ..utils import coords, units
from .results import AlignmentResults


class HiddenPrints:
    """Context manager silencing stdout (alignment.py:29-36); the reference
    wraps sunpy reprojection chatter with it."""

    def __enter__(self):
        self._original_stdout = sys.stdout
        sys.stdout = open(os.devnull, "w")

    def __exit__(self, exc_type, exc_val, exc_tb):
        sys.stdout.close()
        sys.stdout = self._original_stdout


def divide_chunks(l, n):  # noqa: E741 - reference signature
    """Yield successive n-sized chunks of l (alignment.py:39-42)."""
    for i in range(0, len(l), n):
        yield l[i:i + n]


class Alignment:
    """Co-alignment of a small-FOV image against a reference with known
    pointing, over a 5-D lag hypercube (crval1/2, cdelt1/2, crota).

    Same constructor surface and entry points as the reference ``Alignment``
    (``hdrshift/alignment.py:47-121``); the search itself runs on the device
    lag-search engine (see PARITY.md engine-path table).  ``lag_search_mode``
    picks the path: ``auto`` (default), ``exact`` (reference-exact
    single-interpolation gather engine), ``fast`` (FFT surfaces),
    ``tile_fft``.
    """

    def __init__(
        self,
        large_fov_known_pointing: str,
        small_fov_to_correct: str,
        lag_crval1=None,
        lag_crval2=None,
        lag_cdelt1=None,
        lag_cdelt2=None,
        lag_crota=None,
        lag_solar_r=None,
        small_fov_value_min=None,
        parallelism=False,
        display_progress_bar: bool = False,
        small_fov_value_max=None,
        counts_cpu_max: int = 40,
        large_fov_window=-1,
        small_fov_window=-1,
        path_save_figure: str | None = None,
        reprojection_order: int = 2,
        force_crota_0: bool = False,
        unit_lag: str = "arcsec",
        # device-engine extensions
        compute_dtype="float32",
        batch_size_lags: int = 8,
        use_device_mesh: bool = True,
        lag_search_mode: str = "auto",
    ):
        """``lag_search_mode``:
        * "auto" (default): CRVAL-only grids use the exact FFT fast path;
          mixed grids use the per-combo block fast path when the grid is
          large (> 2000 candidates), the reference-exact gather engine
          otherwise; curved Carrington grids score through tile-local FFT
          surfaces where the tile gate admits them and the exact
          quadratic-displacement evaluator elsewhere;
        * "exact": always the per-lag gather engine;
        * "fast": always the FFT/block fast paths where applicable; curved
          Carrington grids on the exact quadratic-displacement evaluator;
        * "tile_fft": as "auto" for Carrington searches, without the
          per-combo block path.
        """
        self.large_fov_known_pointing = large_fov_known_pointing
        self.small_fov_to_correct = small_fov_to_correct

        def _lag(v):
            if v is None:
                return np.array([0.0])
            return np.atleast_1d(np.asarray(v, dtype=np.float64))

        self.lag_crval1 = _lag(lag_crval1)
        self.lag_crval2 = _lag(lag_crval2)
        self.lag_cdelt1 = _lag(lag_cdelt1)
        self.lag_cdelt2 = _lag(lag_cdelt2)
        self.lag_crota = _lag(lag_crota)
        self.lag_solar_r = (
            np.atleast_1d(np.asarray(lag_solar_r, dtype=np.float64))
            if lag_solar_r is not None
            else np.array([1.004])  # alignment.py:841-842
        )
        self.unit_lag = unit_lag

        self.small_fov_value_min = small_fov_value_min
        self.small_fov_value_max = small_fov_value_max
        self.large_fov_window = large_fov_window
        self.small_fov_window = small_fov_window
        self.path_save_figure = path_save_figure
        if reprojection_order not in (0, 1, 2, 3):
            raise ValueError(
                f"reprojection_order must be 0..3 (scipy map_coordinates "
                f"spline orders the resampler implements), got "
                f"{reprojection_order!r}")
        self.order = reprojection_order
        self.force_crota_0 = force_crota_0
        self.parallelism = parallelism
        self.counts = counts_cpu_max
        self.display_progress_bar = display_progress_bar

        import jax.numpy as jnp

        self.compute_dtype = jnp.dtype(compute_dtype)
        self.batch_size_lags = batch_size_lags
        self.mesh = lag_search.default_mesh() if use_device_mesh else None
        if lag_search_mode not in ("auto", "exact", "fast", "tile_fft"):
            raise ValueError(f"unknown lag_search_mode: {lag_search_mode!r}")
        self.lag_search_mode = lag_search_mode

        self.data_large = None
        self.data_small = None
        self.hdr_large = None
        self.hdr_small = None
        self.method = None
        self.coordinate_frame = None
        self.lonlims = None
        self.latlims = None
        self.shape = None
        self.reference_date = None
        self.rat_wave = dict(carr_engine.RAT_WAVE)

    # ------------------------------------------------------------------
    # data loading / preprocessing (host)
    # ------------------------------------------------------------------
    def _load_pair(self, dtype=np.float64):
        from ..utils.obs import stage

        with stage("api_fits_load_s"):
            self._load_pair_body(dtype)

    def _load_pair_body(self, dtype=np.float64):
        from ..io import fits
        from ..utils import devcache

        f_large = fits.open(self.large_fov_known_pointing)
        f_small = fits.open(self.small_fov_to_correct)
        hdu_l = f_large[self.large_fov_window]
        hdu_s = f_small[self.small_fov_window]
        self.data_large = np.asarray(hdu_l.data, dtype=dtype)
        self.hdr_large = hdu_l.header.copy()
        self.data_small = np.asarray(hdu_s.data, dtype=dtype)
        self.hdr_small = hdu_s.header.copy()
        ensure_pcij(self.hdr_small, self.force_crota_0)
        ensure_pcij(self.hdr_large, self.force_crota_0)
        # device-upload cache keys; invalidated (None) whenever the host
        # array is modified after loading (utils/devcache.py)
        self._large_key = devcache.file_key(
            self.large_fov_known_pointing, self.large_fov_window)
        self._small_key = devcache.file_key(
            self.small_fov_to_correct, self.small_fov_window)

    def _small_dev(self):
        """Device copy of the (possibly masked) small image, cached across
        Alignment instances when loaded unmodified from a local file."""
        from ..utils import devcache

        return devcache.asarray_cached(
            self.data_small, self.compute_dtype,
            getattr(self, "_small_key", None))

    def _large_dev(self):
        from ..utils import devcache

        return devcache.asarray_cached(
            self.data_large, self.compute_dtype,
            getattr(self, "_large_key", None))

    def _apply_thresholds(self):
        """Min/max thresholds on |value| -> NaN (alignment.py:876-887)."""
        if self.small_fov_value_min is not None:
            self.data_small[np.abs(self.data_small) < self.small_fov_value_min] = np.nan
            self._small_key = None
        if self.small_fov_value_max is not None:
            self.data_small[np.abs(self.data_small) > self.small_fov_value_max] = np.nan
            self._small_key = None

    def _apply_remove_fov(self, remove_fov_limits, unit="arcsec"):
        """NaN out a world-coordinate box (alignment.py:863-874)."""
        self._small_key = None
        lon, lat = coords.header_world_grid(self.hdr_small)
        lonlims = units.to_deg(np.asarray(remove_fov_limits[0], dtype=np.float64), unit)
        latlims = units.to_deg(np.asarray(remove_fov_limits[1], dtype=np.float64), unit)
        inside = (
            (lon >= lonlims[0]) & (lon <= lonlims[1])
            & (lat >= latlims[0]) & (lat <= latlims[1])
        )
        self.data_small[inside] = np.nan

    def _apply_fov_limits(self, fov_limits, unit="arcsec"):
        """Crop the small image to a world-coordinate box by resampling it
        onto a fresh regular grid and replacing its header
        (alignment.py:1082-1127; axis bookkeeping fixed, see SURVEY.md 2.3).
        """
        lon, lat = coords.header_world_grid(self.hdr_small)
        lonlims = units.to_deg(np.asarray(fov_limits[0], dtype=np.float64), unit)
        latlims = units.to_deg(np.asarray(fov_limits[1], dtype=np.float64), unit)
        long, latg, dlon, dlat = coords.build_regular_grid(
            lon, lat, lonlims_deg=lonlims, latlims_deg=latlims
        )
        mid_r, mid_c = long.shape[0] // 2, long.shape[1] // 2
        cunit1 = self.hdr_small.get("CUNIT1", "deg")
        cunit2 = self.hdr_small.get("CUNIT2", "deg")
        hdrg = self.hdr_small.copy()
        hdrg["CRVAL1"] = units.from_deg(long[mid_r, mid_c], cunit1)
        hdrg["CRVAL2"] = units.from_deg(latg[mid_r, mid_c], cunit2)
        hdrg["CRPIX1"] = mid_c + 1
        hdrg["CRPIX2"] = mid_r + 1
        hdrg["CDELT1"] = units.from_deg(dlon, cunit1)
        hdrg["CDELT2"] = units.from_deg(dlat, cunit2)
        hdrg["PC1_1"], hdrg["PC1_2"] = 1.0, 0.0
        hdrg["PC2_1"], hdrg["PC2_2"] = 0.0, 1.0
        hdrg["CROTA"] = 0.0
        hdrg["CROTA2"] = 0.0
        hdrg["NAXIS1"] = long.shape[1]
        hdrg["NAXIS2"] = long.shape[0]

        xg, yg = coords.world_to_pixel_of_header(self.hdr_small, long, latg)
        self.data_small = lag_search.resample_to_grid(
            self.data_small, xg, yg, order=self.order, compute_dtype=self.compute_dtype
        )
        self.hdr_small = hdrg
        self._small_key = None

    def _lags_deg(self, wrap=True):
        """Lag arrays in degrees (reference converts lags to CUNIT units with
        an ang2pipi wrap; alignment.py:819-837)."""
        conv = (lambda v: units.ang2pipi(units.to_deg(v, self.unit_lag), "deg")) if wrap \
            else (lambda v: units.to_deg(v, self.unit_lag))
        return (
            conv(self.lag_crval1),
            conv(self.lag_crval2),
            conv(self.lag_cdelt1),
            conv(self.lag_cdelt2),
            self.lag_crota,  # always degrees
        )

    def _make_results(self, corr):
        return AlignmentResults(
            corr=corr,
            lag_crval1=self.lag_crval1,
            lag_crval2=self.lag_crval2,
            lag_cdelt1=self.lag_cdelt1,
            lag_cdelt2=self.lag_cdelt2,
            lag_crota=self.lag_crota,
            unit_lag=self.unit_lag,
            image_to_align_path=self.small_fov_to_correct,
            image_to_align_window=self.small_fov_window,
            reference_image_path=self.large_fov_known_pointing,
            reference_image_window=self.large_fov_window,
        )

    # ------------------------------------------------------------------
    # alignment entry points
    # ------------------------------------------------------------------
    def align_using_helioprojective(
        self,
        method: str = "correlation",
        return_type: str = "AlignmentResults",
        fov_limits=None,
        remove_fov_limits=None,
    ):
        """Lag search in the helioprojective frame (flagship path;
        reference call stack SURVEY.md 3.1)."""
        self._begin_helioprojective(method, fov_limits=fov_limits,
                                    remove_fov_limits=remove_fov_limits)

        corr = self._with_engine_retries(
            lambda: self._run_projected_search(wrap=True))
        if return_type == "corr":
            return corr
        return self._make_results(corr)

    def _begin_helioprojective(self, method: str, fov_limits=None,
                               remove_fov_limits=None):
        """Load + threshold + fov prep for a helioprojective search.

        Shared by :meth:`align_using_helioprojective` and the fleet movie
        path (``jitter_correction._align_movie_batched``), so the two stay
        behaviorally identical up to the engine call."""
        self.method = method
        self.coordinate_frame = "final_helioprojective"
        if self.data_small is None:
            self._load_pair()
        self._apply_thresholds()
        if remove_fov_limits is not None:
            self._apply_remove_fov(remove_fov_limits)
        if fov_limits is not None:
            self._apply_fov_limits(fov_limits)
        if np.all(np.isnan(self.data_small)):
            raise ValueError("minimum or maximum value have set all small FOV to nan")

    def align_using_initial_carrington(
        self, method: str = "correlation", return_type: str = "AlignmentResults"
    ):
        """Lag search for inputs already in Carrington (CAR) coordinates
        (alignment.py:344-399)."""
        self.method = method
        self.coordinate_frame = "initial_carrington"
        if self.data_small is None:
            self._load_pair(dtype=np.float64)
        self._apply_thresholds()
        if np.all(np.isnan(self.data_small)):
            raise ValueError("minimum or maximum value have set all small FOV to nan")
        corr = self._with_engine_retries(
            lambda: self._run_projected_search(wrap=False))
        if return_type == "corr":
            return corr
        return self._make_results(corr)

    def _with_engine_retries(self, fn):
        """Whole-search failure recovery (SURVEY.md section 5): a transient
        device runtime error (runtime crash/restart) re-runs the search
        body after clearing the device-array cache — buffers that died with
        the runtime must be re-uploaded, and every search body
        re-fetches its operands through ``_small_dev``/``_large_dev``.
        Chunk-level retries inside ``lag_search.run_chunked`` recover the
        cheap cases first; this is the outer net.  Persistent errors
        (version mismatch, OOM) propagate immediately
        (``utils.jaxcfg.is_transient_runtime_error``)."""
        from ..utils import devcache
        from ..utils.jaxcfg import with_retries

        return with_retries(fn, on_retry=devcache.clear)()

    def _prepare_projected_operands(self, wrap: bool):
        """Comparison-grid world coordinates + reference submap + base WCS
        for a projected (helioprojective / initial-carrington) search.

        Shared by :meth:`_run_projected_search` and the batched movie path
        (``jitter_correction.align_movie_to_reference(mesh=...)``), which
        hoists this per-frame prep out of the engine fan-out.

        Returns ``(lon, lat, ref_img, base, kind)`` with the arrays on the
        default device.
        """
        from ..utils.obs import timed

        small_params = wcs_params_from_header(self.hdr_small)
        large_params = wcs_params_from_header(self.hdr_large)
        kind = small_params.kind

        # world coordinates of the comparison grid (= the small image's own
        # grid) and the reference-image submap (alignment.py:987-1016), both
        # computed on device — coordinate fields never cross host<->device.
        import jax.numpy as jnp

        do_wrap = wrap and kind == "tan"
        h, w = self.data_small.shape

        # the ]-180, 180] wrap is a mathematical no-op unless the field
        # approaches the branch cut; applying it on device in float32 costs
        # ~0.04 px of world precision (mod-360 at magnitude ~360), so skip it
        # when the host float64 probes show it cannot fire
        if do_wrap:
            px_pr = np.array([w // 2, 0, w - 1, 0, w - 1], dtype=np.float64)
            py_pr = np.array([h // 2, 0, 0, h - 1, h - 1], dtype=np.float64)
            pl_pr, pb_pr = wcs_mod.pixel_to_world(
                small_params.as_dict(), px_pr, py_pr, kind=kind, xp=np)
            if max(np.max(np.abs(pl_pr)), np.max(np.abs(pb_pr))) < 170.0:
                do_wrap = False
        sp = {k: jnp.asarray(v, dtype=self.compute_dtype)
              for k, v in small_params.as_dict().items()}
        lp = {k: jnp.asarray(v, dtype=self.compute_dtype)
              for k, v in large_params.as_dict().items()}

        with timed("submap (reference image -> comparison grid)"):
            select_cfg = None
            if self.data_large.shape == (h, w) and self.order in (0, 1, 2):
                # same-instrument pair (e.g. jitter movies): the submap warp
                # is a bounded-residual translation -> gather-free sampler
                px0, py0 = lag_search.probe_pixel_points(h, w)
                pl, pb = wcs_mod.pixel_to_world(
                    small_params.as_dict(), px0, py0, kind=kind, xp=np)
                if do_wrap:
                    pl = units.ang2pipi_deg(pl)
                    pb = units.ang2pipi_deg(pb)
                xg, yg = wcs_mod.world_to_pixel(
                    large_params.as_dict(), pl, pb, kind=kind, xp=np)
                cx, cy = xg - px0, yg - py0
                if np.isfinite(cx).all() and np.isfinite(cy).all():
                    sx = int(np.floor(cx[0] + 0.5))
                    sy = int(np.floor(cy[0] + 0.5))
                    spread = max(np.max(np.abs(cx - cx[0])),
                                 np.max(np.abs(cy - cy[0])))
                    m = int(np.ceil(spread)) + 1
                    pad = max(abs(sx), abs(sy)) + m + 2
                    if m <= 16 and pad <= min(h, w) - 1:
                        select_cfg = (sx, sy, m, pad)
            if select_cfg is not None:
                sx, sy, m, pad = select_cfg
                padded = jnp.pad(self._large_dev(), pad, mode="reflect")
                lon, lat, ref_img = lag_search._submap_select_jit(
                    padded, sp, lp, h, w, kind, do_wrap, self.order,
                    sx, sy, m, pad, h, w)
            else:
                lon, lat, ref_img = lag_search.prepare_grid_and_submap(
                    self._large_dev(), sp, lp, h, w, kind, do_wrap, self.order)

        # pre-seed the engine's probe cache from host float64 WCS math —
        # the 5 probe world values of a fresh device grid otherwise cost a
        # device sync per search (lag_search.seed_probe_values).  Only when
        # the ±180° wrap is inactive: there world magnitudes are arcsec-
        # scale and the f64 seeds match the f32 device grid to ~1e-9 deg,
        # while NEAR the branch cut the grid's own f32 rounding is ~1e-5
        # deg (≈0.04 px of world precision) and seeding would
        # make the displacement model disagree with the ref_img actually
        # sampled through that grid — pay the extraction sync instead.
        if not do_wrap:
            pts_x, pts_y = lag_search.probe_pixel_points(h, w)
            plh, pbh = wcs_mod.pixel_to_world(small_params.as_dict(), pts_x,
                                              pts_y, kind=kind, xp=np)
            lag_search.seed_probe_values(lon, lat, plh, pbh)

        base = {**small_params.as_dict(), "crota": get_crota(self.hdr_small)}
        return lon, lat, ref_img, base, kind

    # ------------------------------------------------------------------
    # in-alignment diagnostic figures (reference alignment.py:988-1012,
    # 903-927, 955-972 — saved when ``path_save_figure`` is set)
    # ------------------------------------------------------------------
    def _figpath(self, name: str) -> str:
        os.makedirs(self.path_save_figure, exist_ok=True)
        return os.path.join(self.path_save_figure, name)

    def _save_projected_figures(self, ref_img):
        """Reprojected large/small FOV + compare figures for a projected
        search (the reference saves these inside
        ``_create_submap_of_large_data``, alignment.py:988-1016)."""
        if self.path_save_figure is None:
            return
        from matplotlib import pyplot as plt

        from ..plot import plot

        plot.simple_plot(self.hdr_large, self.data_large, show=False,
                         path_save=self._figpath("large_fov_before_cut.pdf"))
        date_small = str(self.hdr_small.get(
            "DATE-AVG", self.hdr_small.get("DATE-OBS", "unknown")))
        date_small = date_small.replace(":", "_")
        submap = np.asarray(ref_img, dtype=np.float64)
        # after the cut the reference grid IS the small header's grid
        plot.simple_plot(self.hdr_small, submap, show=False,
                         path_save=self._figpath(f"large_fov_{date_small}.pdf"))
        plot.simple_plot(self.hdr_small, self.data_small, show=False,
                         path_save=self._figpath(f"small_fov_{date_small}.pdf"))
        levels = [0.15 * np.nanmax(self.data_small)]
        plot.contour_plot(self.hdr_small, submap, self.hdr_small,
                          self.data_small, levels=levels, show=False,
                          path_save=self._figpath(f"compare_plot_{date_small}.pdf"))
        plt.close("all")

    def _save_carrington_figures(self, ref_img, d_solar_r, rate_wave):
        """Reprojected large + small Carrington FOV figures (the reference
        saves these inside ``_carrington_transform_fa``,
        alignment.py:903-927; its dlat extent bug — latlims mixed with
        lonlims — is not reproduced)."""
        if self.path_save_figure is None:
            return
        from matplotlib import pyplot as plt

        from ..plot import plot

        dlon = (self.lonlims[1] - self.lonlims[0]) / self.shape[0]
        dlat = (self.latlims[1] - self.latlims[0]) / self.shape[1]
        extent = (self.lonlims[0] - 0.5 * dlon, self.lonlims[1] + 0.5 * dlon,
                  self.latlims[0] - 0.5 * dlat, self.latlims[1] + 0.5 * dlat)
        date_obs = str(self.hdr_large.get(
            "DATE-OBS", self.hdr_large.get("DATE-AVG", "unknown")))[:19]
        plot.plot_fov(np.asarray(ref_img, dtype=np.float64), show=False,
                      path_save=self._figpath(f"image_large_{date_obs}.pdf"),
                      extent=extent,
                      xlabel="carrington longitude [°]",
                      ylabel="carrington latitude [°]")
        image_small = np.asarray(carr_engine.reproject_to_carrington(
            self._small_dev(), self.hdr_small, self.lonlims, self.latlims,
            self.shape, d_solar_r=float(d_solar_r),
            reference_date=self.reference_date, rate_wave=rate_wave,
            order=self.order, compute_dtype=self.compute_dtype),
            dtype=np.float64)
        date_obs = str(self.hdr_small.get(
            "DATE-OBS", self.hdr_small.get("DATE-AVG", "unknown")))[:19]
        plot.plot_fov(image_small, show=False,
                      path_save=self._figpath(f"image_small_{date_obs}.pdf"),
                      extent=extent,
                      xlabel="carrington longitude [°]",
                      ylabel="carrington latitude [°]")
        plt.close("all")

    def _save_solar_surface_figures(self, ref_img):
        """Small / large / reprojected-large figures for the native
        sunpy-equivalent branch (reference alignment.py:955-972)."""
        if self.path_save_figure is None:
            return
        from matplotlib import pyplot as plt

        from ..plot import plot

        date_obs = str(self.hdr_large.get(
            "DATE-OBS", self.hdr_large.get("DATE-AVG", "unknown")))[:19]
        plot.simple_plot_sunpy((self.data_small, self.hdr_small), show=False,
                               path_save=self._figpath(f"image_small_{date_obs}.pdf"))
        date_obs = str(self.hdr_small.get(
            "DATE-OBS", self.hdr_small.get("DATE-AVG", "unknown")))[:19]
        plot.simple_plot_sunpy((self.data_large, self.hdr_large), show=False,
                               path_save=self._figpath(f"image_large_{date_obs}.pdf"))
        plot.simple_plot_sunpy(
            (np.asarray(ref_img, dtype=np.float64), self.hdr_small),
            show=False,
            path_save=self._figpath(f"image_large_rep_{date_obs}.pdf"))
        plt.close("all")

    def _run_projected_search(self, wrap: bool):
        """Shared helioprojective / initial-carrington search body."""
        from ..utils.obs import logger, timed

        if self.display_progress_bar:
            from ..utils.obs import enable_console_logging

            enable_console_logging()

        lon, lat, ref_img, base, kind = self._prepare_projected_operands(wrap)
        self._save_projected_figures(ref_img)

        l1, l2, l3, l4, l5 = self._lags_deg(wrap=wrap)
        n_lags = len(l1) * len(l2) * len(l3) * len(l4) * len(l5)
        allow_fast = self._allow_fast_mode(n_lags)
        logger.info("lag search: %d candidates, mode=%s, order=%d",
                    n_lags * len(self.lag_solar_r), self.lag_search_mode, self.order)
        with timed(f"lag-grid search ({n_lags} candidates)"), \
                self._progress_scope():
            corr5 = self._evaluate(lon, lat, base, l1, l2, l3, l4, l5, kind,
                                   allow_fast, ref_img)
        # helioprojective ignores lag_solar_r: replicate across the 6th axis
        return np.repeat(corr5[..., np.newaxis], len(self.lag_solar_r), axis=-1)

    def _progress_scope(self):
        """Console progress bar for long public-API calls when
        ``display_progress_bar=True`` (the reference's tqdm bar,
        alignment.py:478)."""
        from ..utils import obs

        return obs.console_progress_bar(self.display_progress_bar)

    def _allow_fast_mode(self, n_lags):
        """Map ``lag_search_mode`` to the engine's ``allow_fast`` knob."""
        if self.lag_search_mode == "exact":
            return False
        if self.lag_search_mode in ("fast", "tile_fft"):
            # tile_fft is a Carrington select mode; projected searches use
            # the (already factorized) FFT/block fast paths
            return "block"
        return "block" if n_lags > 2000 else True  # auto

    def _run_solar_surface_search(self):
        """Native equivalent of the reference's sunpy reprojection branch
        (``alignment.py:939-985``): the reference image is reprojected ONCE
        onto the small image's own WCS assuming solar-surface corotation
        (``engine.carrington.reproject_solar_surface``); the per-lag
        reprojection — shifted small WCS onto the original small WCS at
        equal obstime — is then plain WCS resampling, i.e. the standard
        projected-frame engine, so every helioprojective fast path applies.
        """
        import jax.numpy as jnp

        from ..utils.obs import logger, timed

        small_params = wcs_params_from_header(self.hdr_small)
        kind = small_params.kind
        h, w = self.data_small.shape
        sp = {k: jnp.asarray(v, dtype=self.compute_dtype)
              for k, v in small_params.as_dict().items()}
        lon, lat = lag_search.world_grid_jit(sp, h, w, kind, False)
        base = {**small_params.as_dict(), "crota": get_crota(self.hdr_small)}

        l1, l2, l3, l4, l5 = self._lags_deg(wrap=True)
        n_lags = len(l1) * len(l2) * len(l3) * len(l4) * len(l5)
        allow_fast = self._allow_fast_mode(n_lags)
        logger.info("solar-surface (sunpy-equivalent) search: %d candidates, "
                    "mode=%s", n_lags * len(self.lag_solar_r),
                    self.lag_search_mode)

        corr_parts = []
        for d_solar_r in self.lag_solar_r:
            with timed("solar-surface reprojection (reference -> small WCS)"):
                ref_img = carr_engine.reproject_solar_surface(
                    self._large_dev(), self.hdr_large, self.hdr_small,
                    d_solar_r=float(d_solar_r), order=self.order,
                    compute_dtype=self.compute_dtype)
            self._save_solar_surface_figures(ref_img)
            with timed(f"lag-grid search ({n_lags} candidates)"), \
                    self._progress_scope():
                corr5 = self._evaluate(lon, lat, base, l1, l2, l3, l4, l5,
                                       kind, allow_fast, ref_img)
            corr_parts.append(corr5)
        return np.stack(corr_parts, axis=-1)

    def _evaluate(self, lon, lat, base, l1, l2, l3, l4, l5, kind, allow_fast,
                  ref_img):
        return lag_search.evaluate_lag_grid(
            self._small_dev(),
            ref_img,
            lon,
            lat,
            base,
            l1, l2, l3, l4, l5,
            order=self.order,
            method=self.method,
            kind=kind,
            compute_dtype=self.compute_dtype,
            batch_size=self.batch_size_lags,
            mesh=self.mesh,
            allow_fast=allow_fast,
        )

    def align_using_carrington(
        self,
        lonlims=None,
        latlims=None,
        size_deg_carrington=None,
        shape=None,
        reference_date=None,
        method: str = "correlation",
        method_carrington_reprojection: str = "fa",
        return_type: str = "AlignmentResults",
    ):
        """Lag search on a user Carrington lon/lat grid (alignment.py:144-261).

        ``method_carrington_reprojection="fa"`` searches on an explicit
        Carrington lon/lat grid.  ``"sunpy"`` reproduces the reference's
        sunpy branch natively (no sunpy dependency): the reference image is
        reprojected once onto the small image's own WCS assuming solar-
        surface corotation (``alignment.py:939-985``), and the per-lag
        search then runs in the small image's projected frame (lonlims/
        latlims/shape/reference_date are not required, matching the
        reference docstring).
        """
        if method_carrington_reprojection not in ("fa", "sunpy"):
            raise ValueError(
                "method_carrington_reprojection must be either 'fa' or 'sunpy'"
            )
        self.method = method
        self.coordinate_frame = "final_carrington"
        if self.data_small is None:
            self._load_pair()
        self._apply_thresholds()
        if np.all(np.isnan(self.data_small)):
            raise ValueError("minimum or maximum value have set all small FOV to nan")

        if method_carrington_reprojection == "sunpy":
            corr = self._with_engine_retries(self._run_solar_surface_search)
            if return_type == "corr":
                return corr
            return self._make_results(corr)

        if reference_date is None:
            if "DATE-AVG" not in self.hdr_large:
                raise ValueError(
                    "Either provide a reference date manually or the reference "
                    "file header must have a DATE-AVG keyword."
                )
            self.reference_date = self.hdr_large["DATE-AVG"]
        else:
            self.reference_date = reference_date

        if (lonlims is None) and (latlims is None) and (size_deg_carrington is not None):
            crln = self.hdr_small["CRLN_OBS"]
            crlt = self.hdr_small["CRLT_OBS"]
            self.lonlims = [crln - 0.5 * size_deg_carrington[0], crln + 0.5 * size_deg_carrington[0]]
            self.latlims = [crlt - 0.5 * size_deg_carrington[1], crlt + 0.5 * size_deg_carrington[1]]
            self.shape = [int(self.hdr_small["NAXIS1"]), int(self.hdr_small["NAXIS2"])]
        elif (lonlims is not None) and (latlims is not None) and (shape is not None):
            self.lonlims = list(lonlims)
            self.latlims = list(latlims)
            self.shape = list(shape)
        else:
            raise ValueError("either set lonlims as None, or not. no in between.")
        if self.shape[0] * self.shape[1] > 25_000_000:
            warnings.warn(
                f"shape parameter is {self.shape}, which is very large. "
                "Computational time might significantly increase"
            )

        wave = self.hdr_large.get("WAVELNTH")
        rate_wave = self.rat_wave.get(str(int(wave))) if wave is not None else None

        corr = self._with_engine_retries(
            lambda: self._run_carrington_fa_search(rate_wave))
        if return_type == "corr":
            return corr
        return self._make_results(corr)

    def _run_carrington_fa_search(self, rate_wave):
        """Carrington explicit-grid search body (one reprojection + lag
        search per ``lag_solar_r``; alignment.py:144-261)."""
        from ..utils.obs import stage

        l1, l2, l3, l4, l5 = self._lags_deg(wrap=True)
        corr_parts = []
        for d_solar_r in self.lag_solar_r:
            with stage("carr_api_reproject_s"):
                # as_numpy=False: the search consumes the grid on device;
                # a 2048^2 f64 host round-trip would be pure overhead
                ref_img = carr_engine.reproject_to_carrington(
                    self._large_dev(),
                    self.hdr_large,
                    self.lonlims,
                    self.latlims,
                    self.shape,
                    d_solar_r=float(d_solar_r),
                    reference_date=self.reference_date,
                    rate_wave=rate_wave,
                    order=self.order,
                    compute_dtype=self.compute_dtype,
                    as_numpy=False,
                )
            self._save_carrington_figures(ref_img, d_solar_r, rate_wave)
            with self._progress_scope():
                corr5 = carr_engine.evaluate_lag_grid_carrington(
                    self._small_dev(),
                    ref_img,
                    self.hdr_small,
                    self.lonlims,
                    self.latlims,
                    self.shape,
                    l1, l2, l3, l4, l5,
                    d_solar_r=float(d_solar_r),
                    reference_date=self.reference_date,
                    rate_wave=rate_wave,
                    order=self.order,
                    method=self.method,
                    compute_dtype=self.compute_dtype,
                    batch_size=self.batch_size_lags,
                    mesh=self.mesh,
                    lag_mode=self.lag_search_mode,
                )
            corr_parts.append(corr5)
        return np.stack(corr_parts, axis=-1)
