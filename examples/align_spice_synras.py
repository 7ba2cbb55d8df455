"""Align a SPICE L2 raster against a synthetic raster built from an imager
sequence (the reference package's SPICE workflow), fully offline.

    python examples/align_spice_synras.py
"""
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, "tests")
import fixtures as fx  # noqa: E402

from euispice_coreg_tpu.hdrshift import AlignmentSpice  # noqa: E402
from euispice_coreg_tpu.io import fits  # noqa: E402
from euispice_coreg_tpu.synras import SPICEComposedMapBuilder  # noqa: E402
from euispice_coreg_tpu.utils import timeutils  # noqa: E402
from euispice_coreg_tpu.utils import jaxcfg

jaxcfg.enable_persistent_compile_cache()


def main():
    tmp = pathlib.Path(tempfile.mkdtemp())

    # imager sequence spanning the raster duration
    t0 = timeutils.parse_fits_time("2022-03-17T09:45:00")
    imager_paths = []
    for k in range(3):
        hdr = fx.make_header((196, 196), (12.0, 12.0), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0 + 120.0 * k)
        data = fx.render_helioprojective(hdr)
        p = str(tmp / f"imager_{k}.fits")
        fits.write(p, [fits.PrimaryHDU(data=data.astype(np.float32), header=hdr)])
        imager_paths.append(p)

    # SPICE L2 cube, mispointed by (8, -4) arcsec
    cube = fx.render_spice_l2_cube(fx.make_spice_l2_header(crval_arcsec=(120.0, 80.0)))
    hdr_given = fx.make_spice_l2_header(crval_arcsec=(112.0, 84.0))
    p_spice = str(tmp / "solo_L2_spice.fits")
    fits.write(p_spice, [fits.PrimaryHDU(data=cube.astype(np.float32),
                                         header=hdr_given)])

    # 1. build the synthetic raster matched to the slit exposure times
    builder = SPICEComposedMapBuilder(
        path_to_spectro=p_spice, list_imager_paths=imager_paths,
        threshold_time=600.0, window_imager=0, window_spectro=0)
    synras = builder.process(folder_path_output=str(tmp), level=2,
                             print_filename=False, return_synras_name=True)
    print("synthetic raster:", synras)

    # 2. align the SPICE cube against it
    A = AlignmentSpice(
        large_fov_known_pointing=synras,
        small_fov_to_correct=p_spice,
        lag_crval1=np.arange(0.0, 17.0, 1.0),
        lag_crval2=np.arange(-12.0, 5.0, 1.0),
        large_fov_window=0, small_fov_window=0,
    )
    results = A.align_using_helioprojective()
    print(results)


if __name__ == "__main__":
    main()
