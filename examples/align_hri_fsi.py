"""Align an HRIEUV image against an FSI 174 reference (helioprojective).

Mirrors the reference package's README example; runs fully offline against a
synthetic pair when no paths are given.  With real data:

    python examples/align_hri_fsi.py <fsi.fits> <hri.fits>
"""
import sys

import numpy as np

from euispice_coreg_tpu.hdrshift import Alignment
from euispice_coreg_tpu.utils import jaxcfg

jaxcfg.enable_persistent_compile_cache()


def synthetic_pair(tmp="/tmp"):
    sys.path.insert(0, "tests")
    import fixtures as fx

    dl, hl, ds, hs = fx.make_helioprojective_pair(true_shift_arcsec=(24.0, 6.0))
    import pathlib

    return fx.write_pair_fits(pathlib.Path(tmp), dl, hl, ds, hs)


def main():
    if len(sys.argv) == 3:
        path_fsi, path_hri = sys.argv[1], sys.argv[2]
        window = -1
    else:
        path_fsi, path_hri = synthetic_pair()
        window = 0

    A = Alignment(
        large_fov_known_pointing=path_fsi,
        small_fov_to_correct=path_hri,
        lag_crval1=np.arange(15, 35, 1.0),
        lag_crval2=np.arange(-4, 17, 1.0),
        lag_cdelt1=None,
        lag_cdelt2=None,
        lag_crota=None,
        large_fov_window=window,
        small_fov_window=window,
    )
    results = A.align_using_helioprojective(method="correlation")
    print(results)
    results.plot_correlation(path_save_figure="/tmp/correlation.png")
    results.write_corrected_fits(
        window_list_to_apply_shift=[window],
        path_to_l3_output="/tmp/aligned.fits",
    )
    print("wrote /tmp/aligned.fits and /tmp/correlation.png")


if __name__ == "__main__":
    main()
