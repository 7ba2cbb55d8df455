"""Pixel-space (non-WCS) shift search.

Behavioural port of ``AlignmentPixels``
(``/root/reference/euispice_coreg/pxlshift/alignment_pixels.py:14-156``):
degrade the large image to the small image's plate scale, optionally correct
the large image for solar rotation, then slide the small image (optionally
rotated) over it in integer-pixel steps and Pearson-score every offset.

Device restructuring: the reference's triple loop (drot -> dx -> dy, one
numba correlation per offset) becomes, per rotation angle, ONE FFT
correlation-surface evaluation over the whole (dx, dy) grid
(engine/fast_corr.pearson_integer_shifts).
"""
from __future__ import annotations

import numpy as np

from ..core.header import ensure_pcij
from ..engine import fast_corr, lag_search
from ..utils import timeutils, units


class AlignmentPixels:
    """Pixel-space shift search (no WCS): degrade the large image to the
    small plate scale, optionally pre-shift for solar rotation, then Pearson
    -score every (dx, dy, drot) candidate — one FFT correlation surface per
    rotation instead of the reference's per-offset loop
    (``alignment_pixels.py:14-156``)."""

    def __init__(self, large_fov_known_pointing: str, window_large,
                 small_fov_to_correct: str, window_small):
        from ..io import fits

        hdul_large = fits.open(large_fov_known_pointing)
        hdu_large = hdul_large[window_large]
        self.hdr_large = hdu_large.header.copy()
        self.data_large = np.asarray(hdu_large.data, dtype=np.float64)
        hdul_small = fits.open(small_fov_to_correct)
        hdu_small = hdul_small[window_small]
        self.hdr_small = hdu_small.header.copy()
        self.data_small = np.asarray(hdu_small.data, dtype=np.float64)
        self.slc_small_ref = None

    # ------------------------------------------------------------------
    def find_best_parameters(self, lag_dx, lag_dy, lag_drot,
                             unit_rot: str = "degree",
                             shift_solar_rotation_dx_large: bool = False,
                             mesh=None):
        """corr hypercube of shape (len(lag_dx), len(lag_dy), len(lag_drot)).

        ``mesh``: optional 1-axis ``jax.sharding.Mesh`` — the rotation axis
        is then sharded over the devices as one fleet evaluation (each chip
        builds the FFT correlation surfaces of its own rotated canvases;
        see ``engine/fast_corr.evaluate_movie_from_displacements``)."""
        if shift_solar_rotation_dx_large:
            self._shift_large_fov()
        self._sub_resolution_large_fov()
        self._initialise_slice_corresponding_to_small()

        lag_dx = np.asarray(lag_dx, dtype=np.int64)
        lag_dy = np.asarray(lag_dy, dtype=np.int64)
        lag_drot = np.atleast_1d(np.asarray(lag_drot, dtype=np.float64))

        # every candidate window must stay inside the large frame
        for dx in (lag_dx.min(), lag_dx.max()):
            for dy in (lag_dy.min(), lag_dy.max()):
                slc = (
                    slice(self.slc_small_ref[0].start + int(dy),
                          self.slc_small_ref[0].stop + int(dy)),
                    slice(self.slc_small_ref[1].start + int(dx),
                          self.slc_small_ref[1].stop + int(dx)),
                )
                self._check_boundaries(slc, self.data_large.shape)

        # embed the small image in large-frame coordinates; NaN elsewhere
        from ..utils.jaxcfg import with_retries

        if (mesh is not None
                and getattr(mesh, "devices", np.empty(0)).size > 1
                and len(lag_drot) > 1):
            fleet = self._find_best_parameters_fleet(
                lag_dx, lag_dy, lag_drot, unit_rot, mesh)
            if fleet is not None:
                return fleet

        corr = np.zeros((len(lag_dx), len(lag_dy), len(lag_drot)))
        for kk, drot in enumerate(lag_drot):
            small_rot = self._rotate_small(float(drot), unit_rot)
            canvas = np.full(self.data_large.shape, np.nan)
            canvas[self.slc_small_ref] = small_rot
            # operands are host-side, so a transient-error retry re-uploads
            # everything it needs (same recovery as hdrshift/alignment.py)
            corr[:, :, kk] = np.asarray(with_retries(
                fast_corr.pearson_integer_shifts)(
                    canvas, self.data_large, lag_dx, lag_dy))
        return corr

    def _find_best_parameters_fleet(self, lag_dx, lag_dy, lag_drot,
                                    unit_rot: str, mesh):
        """Rotation-axis fleet evaluation: rotations are the frames of one
        :func:`engine.fast_corr.evaluate_movie_from_displacements` call
        (order-0, shared integer offset grid, moving image = the large
        frame, comparison canvas = the embedded rotated small image —
        exactly :func:`engine.fast_corr.pearson_integer_shifts` per frame).
        Returns the (len(dx), len(dy), len(drot)) hypercube or None (caller
        falls back to the per-rotation loop)."""
        import jax.numpy as jnp

        from ..utils.jaxcfg import with_retries

        F = len(lag_drot)
        shape = self.data_large.shape
        # f32 canvases: halves the host allocation + device upload (the
        # engine computes in float32 anyway)
        canvases = np.full((F,) + shape, np.nan, dtype=np.float32)
        for kk, drot in enumerate(lag_drot):
            canvases[kk][self.slc_small_ref] = self._rotate_small(
                float(drot), unit_rot)

        gx, gy = np.meshgrid(lag_dx, lag_dy, indexing="ij")
        cs0 = np.stack([gx.ravel(), gy.ravel()],
                       axis=-1).astype(np.float64)  # (L, 2) x/y order

        def run():
            # upload the large image ONCE and broadcast on device — F
            # identical copies need not be uploaded
            large_d = jnp.broadcast_to(
                jnp.asarray(self.data_large, dtype=jnp.float32),
                (F,) + shape)
            return fast_corr.evaluate_movie_from_displacements(
                large_d, canvases, np.broadcast_to(cs0, (F,) + cs0.shape),
                order=0, mesh=mesh)

        corr = with_retries(run)()
        if corr is None:
            return None
        return corr.reshape(F, len(lag_dx), len(lag_dy)).transpose(1, 2, 0)

    def _rotate_small(self, drot: float, unit_rot: str):
        """Rotate the small image about its center (matrix_transform.py:77-106
        polar transform + order-1 resample)."""
        if drot == 0.0:
            return self.data_small.copy()
        theta = np.radians(drot) if unit_rot in ("degree", "deg") else drot
        h, w = self.data_small.shape
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
        xc = xx[round(h / 2), round(w / 2)]
        yc = yy[round(h / 2), round(w / 2)]
        r = np.hypot(xx - xc, yy - yc)
        ang = np.arctan2(yy - yc, xx - xc) + theta
        nx = r * np.cos(ang) + xc
        ny = r * np.sin(ang) + yc
        return lag_search.resample_to_grid(self.data_small, nx, ny, order=1)

    # ------------------------------------------------------------------
    def _shift_large_fov(self):
        """Displace the large image by the solar-rotation drift accumulated
        between the two observations (alignment_pixels.py:86-107)."""
        dcrval_arcsec = self._return_shift_large_fov_solar_rotation()
        cunit1 = self.hdr_large.get("CUNIT1", "arcsec")
        if "CROTA" in self.hdr_large:
            theta = np.deg2rad(self.hdr_large["CROTA"])
            dx = (units.convert(dcrval_arcsec, "arcsec", cunit1)
                  / self.hdr_large["CDELT1"]) * np.cos(-theta)
            dy = (units.convert(dcrval_arcsec, "arcsec", cunit1)
                  / self.hdr_large["CDELT2"]) * np.sin(-theta)
        else:
            dx = units.convert(dcrval_arcsec, "arcsec", cunit1) / self.hdr_large["CDELT1"]
            dy = 0.0
        h, w = self.data_large.shape
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
        self.data_large = lag_search.resample_to_grid(
            self.data_large, xx + dx, yy + dy, order=1)

    def _return_shift_large_fov_solar_rotation(self) -> float:
        """Solar-rotation drift in arcsec (alignment_pixels.py:109-124)."""
        from ..engine import carrington as carr

        band = self.hdr_large["WAVELNTH"]
        if band == 174:
            band = 171
        b0 = np.deg2rad(self.hdr_large["SOLAR_B0"])
        omega_car = np.deg2rad(360 / 25.38 / 86400)
        coeffs = carr.DIFF_ROT_COEFFS.get(str(band), carr.DIFF_ROT_COEFFS["195"])
        a_car = 360 / 25.38
        corr_deg_day = (coeffs[0] - a_car + coeffs[1] * np.sin(b0) ** 2
                        + coeffs[2] * np.sin(b0) ** 4)
        omega = omega_car + np.deg2rad(corr_deg_day / 86400)
        rsun = self.hdr_large["RSUN_REF"]
        dsun = self.hdr_large["DSUN_OBS"]
        phi = np.rad2deg(omega * rsun / (dsun - rsun)) * 3600  # arcsec/s
        dt = timeutils.time_diff_seconds(
            str(self.hdr_small["DATE-AVG"]), str(self.hdr_large["DATE-AVG"]))
        return dt * phi

    def _sub_resolution_large_fov(self):
        """Degrade the large image to the small image's plate scale
        (alignment_pixels.py:126-143)."""
        cunit_l1 = self.hdr_large.get("CUNIT1", "arcsec")
        cunit_l2 = self.hdr_large.get("CUNIT2", "arcsec")
        c1 = units.convert(self.hdr_small["CDELT1"],
                           self.hdr_small.get("CUNIT1", "arcsec"), cunit_l1)
        c2 = units.convert(self.hdr_small["CDELT2"],
                           self.hdr_small.get("CUNIT2", "arcsec"), cunit_l2)
        self.ratio_res_1 = c1 / self.hdr_large["CDELT1"]
        self.ratio_res_2 = c2 / self.hdr_large["CDELT2"]
        x, y = np.meshgrid(
            np.arange(0, self.data_large.shape[1], self.ratio_res_1),
            np.arange(0, self.data_large.shape[0], self.ratio_res_2),
        )
        self.data_large = lag_search.resample_to_grid(self.data_large, x, y, order=1)

    def _initialise_slice_corresponding_to_small(self):
        l = [int((self.data_large.shape[n] - self.data_small.shape[n] - 1) / 2)
             for n in range(2)]
        self.slc_small_ref = (
            slice(l[0], l[0] + self.data_small.shape[0]),
            slice(l[1], l[1] + self.data_small.shape[1]),
        )

    @staticmethod
    def _check_boundaries(slc, shape):
        for n in range(2):
            if slc[n].start < 0 or slc[n].stop > shape[n]:
                raise ValueError("too large shift : outside FSI")
