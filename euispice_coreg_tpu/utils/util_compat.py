"""Reference-shaped utility surface (``euispice_coreg.utils.Util`` parity).

Users migrating from the reference import ``AlignCommonUtil`` /
``AlignEUIUtil`` / ``AlignSpiceUtil`` / ``PlotFits`` from ``utils.Util``
(``/root/reference/euispice_coreg/utils/Util.py``).  This module provides the
same names, delegating to the device-engine implementations.
"""
from __future__ import annotations

import numpy as np

from ..core import header as header_mod
from ..core.ndwcs import NDWCS
from . import coords, timeutils, units


class AlignCommonUtil:
    @staticmethod
    def ang2pipi(ang_deg):
        """Wrap degrees into ]-180, 180] (Util.py:76-80).  Degrees in/out
        (the reference wraps astropy Quantities)."""
        return units.ang2pipi_deg(ang_deg)

    @staticmethod
    def interpol2d(image, x, y, fill, order, dst=None):
        """scipy-convention spline sampling on device (Util.py:82-104)."""
        from ..core import resample

        out = np.asarray(resample.interpol2d(image, x=x, y=y, fill=fill, order=order))
        if dst is not None:
            dst[...] = out
            return None
        return out

    correct_pointing_header = staticmethod(header_mod.correct_pointing_header)

    @staticmethod
    def write_corrected_fits(path_to_l2_input, window_list_to_apply_shift,
                             path_to_l3_output, corr,
                             lag_crval1=None, lag_crval2=None, lag_crota=None,
                             lag_cdelt1=None, lag_cdelt2=None,
                             shift_arcsec=None):
        """Write pointing-corrected FITS (Util.py:106-159)."""
        from ..hdrshift.results import AlignmentResults

        if shift_arcsec is None:
            corr = np.asarray(corr)
            mi = np.unravel_index(np.nanargmax(corr), corr.shape)
            shift_arcsec = [
                np.atleast_1d(lag_crval1)[mi[0]],
                np.atleast_1d(lag_crval2)[mi[1]],
                np.atleast_1d(lag_cdelt1 if lag_cdelt1 is not None else [0])[mi[2]],
                np.atleast_1d(lag_cdelt2 if lag_cdelt2 is not None else [0])[mi[3]],
                np.atleast_1d(lag_crota if lag_crota is not None else [0])[mi[4]],
            ]
        res = AlignmentResults.__new__(AlignmentResults)
        res.shift_arcsec = tuple(float(v) for v in shift_arcsec)
        res.image_to_align_path = path_to_l2_input
        res.write_corrected_fits(
            window_list_to_apply_shift=window_list_to_apply_shift,
            path_to_l3_output=path_to_l3_output,
            path_to_l2_input=path_to_l2_input,
        )

    @staticmethod
    def find_closest_dict_index(utc_to_find, dict_file_reference, threshold_time,
                                time_delay=False, dsun_obs_to_find=None):
        """Closest DATE-AVG in a {'date-avg': [...], 'dsun-obs': [...]} record
        (Util.py:22-41); times as epoch seconds or ISO strings,
        threshold/delay in seconds/meters."""
        C_M_S = 299792458.0

        def _sec(v):
            return timeutils.parse_fits_time(v) if isinstance(v, str) else float(v)

        t_find = _sec(utc_to_find)
        times = [_sec(t) for t in dict_file_reference["date-avg"]]
        if time_delay:
            if dsun_obs_to_find is None:
                raise ValueError(
                    "please enter dsun_obs_ref if time delay is not negligeable.")
            dsun = dict_file_reference["dsun-obs"]
            times = [t - (d - dsun_obs_to_find) / C_M_S for t, d in zip(times, dsun)]
        delta = np.abs(np.asarray(times) - t_find)
        idx = int(np.argmin(delta))
        if delta[idx] > float(threshold_time):
            raise ValueError(
                "Delta time between EUI and SPICE file equal to "
                f"{delta[idx]:.2f} s > {float(threshold_time):.2f}")
        return idx, float(delta[idx])

    @staticmethod
    def find_closest_time(list_to_find, list_ref, window_to_find=-1,
                          window_ref=-1, time_delay=True,
                          maximal_threshold=15.0):
        """Index of the closest-in-time reference file for each input file,
        by DATE-AVG with optional light-travel correction between the two
        observer distances.

        Working replacement for the reference's dead code (Util.py:44-74:
        ``np.arr`` NameError, and the threshold compared against indices):
        ``maximal_threshold`` is in seconds and is checked against the
        minimal time difference.  Returns an int array of indices into
        ``list_ref``.
        """
        from ..io import fits

        C_M_S = 299792458.0

        def _meta(path, window):
            hdul = fits.open(path)
            hdr = hdul[window].header
            t = timeutils.parse_fits_time(str(hdr["DATE-AVG"]))
            d = float(hdr.get("DSUN_OBS", 0.0))
            return t, d

        refs = [_meta(p, window_ref) for p in list_ref]
        out = []
        for path in list_to_find:
            t_find, d_find = _meta(path, window_to_find)
            diffs = []
            for t_ref, d_ref in refs:
                if time_delay:
                    t_ref = t_ref + (d_find - d_ref) / C_M_S
                diffs.append(abs(t_find - t_ref))
            best = int(np.argmin(diffs))
            if diffs[best] > float(maximal_threshold):
                raise ValueError(
                    "Threshold delta time of %i s attained"
                    % int(float(maximal_threshold)))
            out.append(best)
        return np.asarray(out, dtype=int)

    @staticmethod
    def align_pixels_shift(delta_pix1, delta_pix2, windows, large_fov_fits_path,
                           large_fov_window, small_fov_path):
        """Re-anchor a small-FOV header onto the large FOV center plus a pixel
        offset (Util.py:247-278); returns the corrected header."""
        from ..io import fits

        hdul_small = fits.open(small_fov_path)
        hdul_large = fits.open(large_fov_fits_path)
        hdr_large = hdul_large[large_fov_window].header
        naxis1_l, naxis2_l = header_mod.get_naxis(hdr_large)
        p = header_mod.wcs_params_from_header(hdr_large)
        from ..core import wcs as wcs2d

        lon_mid, lat_mid = wcs2d.pixel_to_world(
            p.as_dict(), np.array([(naxis1_l - 1) / 2]),
            np.array([(naxis2_l - 1) / 2]), kind=p.kind, xp=np)
        out_header = None
        for win in windows:
            hdr_s = hdul_small[win].header
            cunit1 = hdr_s.get("CUNIT1", "deg")
            cunit2 = hdr_s.get("CUNIT2", "deg")
            naxis1, naxis2 = header_mod.get_naxis(hdr_s)
            hdr_s["CRVAL1"] = units.from_deg(float(lon_mid[0]), cunit1) \
                + delta_pix1 * hdr_s["CDELT1"]
            hdr_s["CRVAL2"] = units.from_deg(float(lat_mid[0]), cunit2) \
                + delta_pix2 * hdr_s["CDELT2"]
            hdr_s["CRPIX1"] = (naxis1 + 1) / 2
            hdr_s["CRPIX2"] = (naxis2 + 1) / 2
            out_header = hdr_s
        return out_header


class AlignEUIUtil:
    @staticmethod
    def extract_EUI_coordinates(hdr, dsun=True, lon_ctype="HPLN-TAN",
                                lat_ctype="HPLT-TAN"):
        """World grid of a 2-D header, wrapped, in degrees (Util.py:282-312)."""
        lon, lat = coords.header_world_grid(hdr)
        if dsun:
            return lon, lat, hdr["DSUN_OBS"]
        return lon, lat

    @staticmethod
    def diff_rot(lat, wvl="default"):
        """Angular-velocity difference vs Carrington rotation, rad/s
        (Util.py:314-345; Hortin 2003)."""
        p = {
            "EIT 171": (14.56, -2.65, 0.96),
            "EIT 195": (14.50, -2.14, 0.66),
            "EIT 284": (14.60, -0.71, -1.18),
            "EIT 304": (14.51, -3.12, 0.34),
        }
        p["default"] = p["EIT 195"]
        A, B, C = p[wvl]
        a_car = 360 / 25.38
        corr = A - a_car + B * np.sin(lat) ** 2 + C * np.sin(lat) ** 4
        return np.deg2rad(corr / 86400)

    @staticmethod
    def recenter_crpix_in_header(hdr):
        """No-op, as in the reference (Util.py:347-365)."""


class AlignSpiceUtil:
    @staticmethod
    def slit_pxl(header):
        from ..hdrshift.alignment_spice import SpiceUtil

        return SpiceUtil.slit_pxl(header)

    @staticmethod
    def vertical_edges_limits(header):
        from ..hdrshift.alignment_spice import SpiceUtil

        return SpiceUtil.vertical_edges_limits(header)

    @staticmethod
    def recenter_crpix_in_header_L2(hdr):
        """No-op, as in the reference (Util.py:564-592)."""

    @staticmethod
    def extract_spice_coordinates_l2(hdr, return_type="xy"):
        """Spatial (and time) world coordinates of a SPICE L2 header
        (Util.py:514-562): lon/lat in degrees, time in epoch seconds."""
        w = NDWCS.from_header(hdr)
        w_xyt = w.dropaxis(2)
        nx = int(hdr["NAXIS1"])
        ny = int(hdr["NAXIS2"])
        if return_type == "xy":
            w_xy = w_xyt.copy()
            w_xy.set_pc(2, 0, 0.0)
            w_xy = w_xy.dropaxis(2)
            from ..core import wcs as wcs2d

            p = header_mod.wcs_params_from_header(w_xy.to_header())
            x, y = coords.pixel_grid(nx, ny)
            lon, lat = wcs2d.pixel_to_world(p.as_dict(), x, y, kind=p.kind, xp=np)
            return units.ang2pipi_deg(lon), units.ang2pipi_deg(lat)
        elif return_type == "xyt":
            lon, lat = AlignSpiceUtil.extract_spice_coordinates_l2(hdr, "xy")
            it = 2
            qx = np.arange(nx) + 1.0 - w_xyt.crpix[0]
            qt = 1.0 - w_xyt.crpix[it]
            tsec = (w_xyt.crval[it] + w_xyt.cdelt[it]
                    * (w_xyt.pc[it, 0] * qx + w_xyt.pc[it, it] * qt))
            utc = w_xyt.time_origin_seconds() + tsec
            return lon, lat, np.broadcast_to(utc, lon.shape)
        raise ValueError(return_type)

    @staticmethod
    def extract_spice_coordinates_l3(hdr, return_type="xy"):
        """Spatial (and time) world coordinates of a SPICE L3 header
        (Util.py:485-512): the 4-D fitted-coefficient WCS reduced to the
        celestial pair after decoupling the time axis, lon/lat in degrees,
        time in epoch seconds."""
        w = NDWCS.from_header(hdr)
        pair = w.celestial_pair()
        nx = int(hdr[f"NAXIS{pair[0] + 1}"])
        ny = int(hdr[f"NAXIS{pair[1] + 1}"])

        w_xy = w.copy()
        drop = [i for i in range(w_xy.n) if i not in pair]
        for d in sorted(drop, reverse=True):
            for j in range(w_xy.n):
                if j != d:
                    w_xy.set_pc(d, j, 0.0)
                    w_xy.set_pc(j, d, 0.0)
            w_xy = w_xy.dropaxis(d)
        from ..core import wcs as wcs2d

        p = header_mod.wcs_params_from_header(w_xy.to_header())
        x, y = coords.pixel_grid(nx, ny)
        lon, lat = wcs2d.pixel_to_world(p.as_dict(), x, y, kind=p.kind, xp=np)
        lon = units.ang2pipi_deg(lon)
        lat = units.ang2pipi_deg(lat)
        if return_type == "xy":
            return lon, lat
        if return_type == "xyt":
            it = w.axis_index("UTC")
            qx = np.arange(nx) + 1.0 - w.crpix[pair[0]]
            qt = 1.0 - w.crpix[it]
            tsec = (w.crval[it] + w.cdelt[it]
                    * (w.pc[it, pair[0]] * qx + w.pc[it, it] * qt))
            utc = w.time_origin_seconds() + tsec
            return lon, lat, np.broadcast_to(utc, lon.shape)
        raise ValueError(return_type)

    @staticmethod
    def extract_l3_data(path_spice, line: dict, index_line: int, window=0):
        """Named L3 coefficient planes with missing-value masking
        (Util.py:594-614)."""
        from ..io import fits

        hdul = fits.open(path_spice)
        hdu = hdul[window]
        data = np.asarray(hdu.data, dtype=np.float64)
        miss = hdu.header["ANA_MISS"]
        out = {k: data[:, :, line[k][index_line]]
               for k in ("amplitude", "width", "chi2", "background", "lambda")}
        out["chi2"] = np.where(out["amplitude"] == miss, np.nan, out["chi2"])
        for key in ("amplitude", "width", "background", "lambda"):
            out[key] = np.where(out["chi2"] == 0, np.nan, out[key])
            out[key] = np.where(out[key] == miss, np.nan, out[key])
        out["radiance"] = (out["amplitude"] * out["width"]
                           * np.sqrt(2 * np.pi) * 0.424660900)
        return out


class PlotFits:
    """Plot-oriented helpers (Util.py:678-945)."""

    @staticmethod
    def get_range(data, stre="log", imax=99.5, imin=2):
        """Percentile-clipped matplotlib norm (Util.py:679-707)."""
        import matplotlib.colors as mcolors

        finite = np.asarray(data)[np.isfinite(data)]
        if finite.size == 0:
            return None
        if imax > 100:
            vmin, vmax = np.percentile(finite, [imin, 100])
            vmax = vmax * imax / 100
        else:
            vmin, vmax = np.percentile(finite, [imin, imax])
        if stre is None:
            return mcolors.Normalize(vmin=vmin, vmax=vmax)
        if stre == "sqrt":
            return mcolors.PowerNorm(gamma=0.5, vmin=vmin, vmax=vmax)
        if stre == "log":
            return mcolors.LogNorm(vmin=max(vmin, 1e-12), vmax=vmax)
        raise ValueError("Bad stre value: either None, sqrt or log")

    @staticmethod
    def build_regular_grid(longitude, latitude, lonlims=None, latlims=None):
        return coords.build_regular_grid(longitude, latitude, lonlims, latlims)

    @staticmethod
    def extend_regular_grid(longitude_grid, latitude_grid,
                            delta_longitude, delta_latitude):
        """Grow a regular grid by half-margins (Util.py:906-945); degrees."""
        lon = np.asarray(longitude_grid, dtype=np.float64)
        lat = np.asarray(latitude_grid, dtype=np.float64)
        dlon = float(np.hypot(lon[0, 1] - lon[0, 0], lat[0, 1] - lat[0, 0]))
        dlat = float(np.hypot(lon[1, 0] - lon[0, 0], lat[1, 0] - lat[0, 0]))
        lon1d = np.arange(np.min(lon) - 0.5 * delta_longitude,
                          np.max(lon) + 0.5 * delta_longitude, dlon)
        lat1d = np.arange(np.min(lat) - 0.5 * delta_latitude,
                          np.max(lat) + 0.5 * delta_latitude, dlat)
        return np.meshgrid(lon1d, lat1d)

    # figure helpers live in plot.plot; re-exported for parity
    @staticmethod
    def plot_fov(*args, **kwargs):
        from ..plot import plot

        return plot.plot_fov(*args, **kwargs)

    @staticmethod
    def plot_fov_rectangle(*args, **kwargs):
        from ..plot import plot

        return plot.plot_fov_rectangle(*args, **kwargs)

    @staticmethod
    def simple_plot(*args, **kwargs):
        from ..plot import plot

        return plot.simple_plot(*args, **kwargs)

    @staticmethod
    def contour_plot(*args, **kwargs):
        from ..plot import plot

        return plot.contour_plot(*args, **kwargs)

    @staticmethod
    def compare_plot(*args, **kwargs):
        from ..plot import plot

        return plot.compare_plot(*args, **kwargs)


class MpUtils:
    """Shared-memory helpers (Util.py:948-967).

    The device engine itself never uses shared memory (the lag fan-out lives on
    device, PARITY.md #13); ``gen_shmm`` is provided for users who relied on
    it as a general utility.  The caller owns the segment lifetime
    (``shmm.close()`` / ``shmm.unlink()``).
    """

    @staticmethod
    def gen_shmm(create=False, name=None, ndarray=None, size=0, shape=None,
                 dtype=None):
        """Create (from ``ndarray``/``size``) or attach (by ``name``) a POSIX
        shared-memory block; returns (shmm, ndarray view)."""
        from multiprocessing.shared_memory import SharedMemory

        if ndarray is None and size == 0 and name is None:
            raise ValueError("provide ndarray, size or name")
        if ndarray is None and shape is None:
            raise ValueError("provide ndarray or shape")
        if dtype is None:
            if not create or ndarray is None:
                raise ValueError("dtype must be set")
            dtype = ndarray.dtype
        size = size if ndarray is None else ndarray.nbytes
        shmm = SharedMemory(create=create, size=size, name=name)
        shmm_data = np.ndarray(
            shape=shape if ndarray is None else ndarray.shape,
            buffer=shmm.buf, dtype=dtype)
        if create and ndarray is not None:
            shmm_data[...] = ndarray[...]
        return shmm, shmm_data
