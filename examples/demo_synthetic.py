"""Self-contained, self-verifying demo: no archive data needed.

Synthesizes a reference/mispointed image pair with an exactly known
pointing error, writes them as FITS, runs the helioprojective and
Carrington alignments through the public API, and checks the recovered
shift (the reference's README examples require live SIDC archive files;
this one runs anywhere, on the CPU or a GPU).

    python examples/demo_synthetic.py [output_dir]
"""
import os
import sys
import tempfile

import numpy as np

from euispice_coreg_tpu.core.header import Header, pc_from_crota
from euispice_coreg_tpu.hdrshift import Alignment
from euispice_coreg_tpu.io import fits
from euispice_coreg_tpu.utils import coords
from euispice_coreg_tpu.utils import jaxcfg

jaxcfg.enable_persistent_compile_cache()

TRUE_SHIFT = (8.0, -4.0)  # arcsec: the pointing error injected into hdr


def make_header(naxis, cdelt_arcsec, crval_arcsec, crota_deg):
    n1, n2 = naxis
    pc11, pc12, pc21, pc22 = pc_from_crota(
        crota_deg, cdelt_arcsec[0], cdelt_arcsec[1])
    return Header({
        "NAXIS1": n1, "NAXIS2": n2,
        "CRVAL1": crval_arcsec[0], "CRVAL2": crval_arcsec[1],
        "CRPIX1": (n1 + 1) / 2, "CRPIX2": (n2 + 1) / 2,
        "CDELT1": cdelt_arcsec[0], "CDELT2": cdelt_arcsec[1],
        "CUNIT1": "arcsec", "CUNIT2": "arcsec",
        "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN",
        "CROTA": crota_deg,
        "PC1_1": pc11, "PC1_2": pc12, "PC2_1": pc21, "PC2_2": pc22,
        "DATE-OBS": "2022-03-17T09:50:45.281",
        "DATE-AVG": "2022-03-17T09:50:50.281",
        "WAVELNTH": 174, "DETECTOR": "FSI", "BUNIT": "DN/s",
        # observer geometry (used by the Carrington engine)
        "DSUN_OBS": 0.5 * 1.496e11, "CRLN_OBS": 120.0, "CRLT_OBS": 3.0,
    })


def scene(lon_deg, lat_deg, seed=0):
    """Smooth analytic 'sun': a fixed field of Gaussian blobs, so the same
    world-coordinate scene renders consistently through ANY header."""
    rng = np.random.default_rng(seed)
    out = np.full(lon_deg.shape, 100.0)
    for _ in range(30):
        cx, cy = rng.uniform(-0.08, 0.12), rng.uniform(-0.06, 0.10)
        w = rng.uniform(0.004, 0.02)
        a = rng.uniform(0.5, 3.0)
        out += a * np.exp(-(((lon_deg - cx) ** 2) + ((lat_deg - cy) ** 2))
                          / (2 * w * w))
    return out


def render(hdr):
    lon, lat = coords.header_world_grid(hdr)
    return scene(lon, lat)


def main(out_dir):
    # the large reference image, correctly pointed at the origin
    hdr_large = make_header((196, 196), (12.0, 12.0), (0.0, 0.0), 0.0)
    # the small image: rendered through its TRUE pointing, but handed to the
    # engine with a header mispointed by -TRUE_SHIFT — the search must
    # recover +TRUE_SHIFT
    hdr_true = make_header((96, 96), (5.0, 5.0), (120.0, 80.0), 0.75)
    hdr_small = make_header(
        (96, 96), (5.0, 5.0),
        (120.0 - TRUE_SHIFT[0], 80.0 - TRUE_SHIFT[1]), 0.75)

    p_large = os.path.join(out_dir, "large.fits")
    p_small = os.path.join(out_dir, "small.fits")
    fits.writeto(p_large, render(hdr_large), hdr_large)
    fits.writeto(p_small, render(hdr_true), hdr_small)

    A = Alignment(
        large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
        lag_crval1=np.arange(2.0, 15.0, 1.0),
        lag_crval2=np.arange(-10.0, 3.0, 1.0),
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        small_fov_window=0, large_fov_window=0,
        display_progress_bar=False,
    )
    res = A.align_using_helioprojective(method="correlation")
    print(f"helioprojective: recovered shift = "
          f"({res.shift_arcsec[0]:+.2f}, {res.shift_arcsec[1]:+.2f}) arcsec "
          f"(injected {TRUE_SHIFT[0]:+.1f}, {TRUE_SHIFT[1]:+.1f})")
    res.plot_correlation(os.path.join(out_dir, "correlation.pdf"))
    res.write_corrected_fits(window_list_to_apply_shift=[0],
                             path_to_l3_output=os.path.join(out_dir,
                                                            "aligned.fits"))

    B = Alignment(
        large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
        lag_crval1=np.arange(2.0, 15.0, 1.0),
        lag_crval2=np.arange(-10.0, 3.0, 1.0),
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        small_fov_window=0, large_fov_window=0,
    )
    res_c = B.align_using_carrington(
        lonlims=(117.0, 123.0), latlims=(-1.0, 7.0), shape=(128, 128))
    print(f"carrington:      recovered shift = "
          f"({res_c.shift_arcsec[0]:+.2f}, {res_c.shift_arcsec[1]:+.2f}) "
          f"arcsec")

    ok = (abs(res.shift_arcsec[0] - TRUE_SHIFT[0]) < 1.0
          and abs(res.shift_arcsec[1] - TRUE_SHIFT[1]) < 1.0)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 1:
        os.makedirs(sys.argv[1], exist_ok=True)
        sys.exit(main(sys.argv[1]))
    with tempfile.TemporaryDirectory() as td:
        sys.exit(main(td))
