"""Correct the jitter of an imager movie (offline synthetic demo).

    python examples/jitter_movie.py
"""
import os
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, "tests")
import fixtures as fx  # noqa: E402

from euispice_coreg_tpu.io import fits  # noqa: E402
from euispice_coreg_tpu.jitter_correction import jitter_correction_imagers  # noqa: E402
from euispice_coreg_tpu.utils import timeutils  # noqa: E402
from euispice_coreg_tpu.utils import jaxcfg

jaxcfg.enable_persistent_compile_cache()


def main():
    tmp = pathlib.Path(tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    t0 = timeutils.parse_fits_time("2022-03-17T09:00:00")
    paths = []
    for k in range(6):
        jitter = rng.uniform(-4, 4, size=2) if k else (0.0, 0.0)
        hdr_true = fx.make_header((128, 128), (8.0, 8.0), (0.0, 0.0), 0.0)
        hdr_true["DATE-AVG"] = timeutils.format_fits_time(t0 + 60.0 * k)
        data = fx.render_helioprojective(hdr_true)
        hdr = hdr_true.copy()
        hdr["CRVAL1"] -= jitter[0]
        hdr["CRVAL2"] -= jitter[1]
        p = str(tmp / f"movie_{k:02d}.fits")
        fits.write(p, [fits.PrimaryHDU(data=data.astype(np.float32), header=hdr)])
        paths.append(p)

    outdir = tmp / "corrected"
    os.makedirs(outdir, exist_ok=True)
    jitter_correction_imagers(
        list_files_input=paths,
        path_files_output=str(outdir),
        lag_crval1=np.arange(-6.0, 6.5, 0.5),
        lag_crval2=np.arange(-6.0, 6.5, 0.5),
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        window_files_input=0,
        alignement_method="helioprojective",
    )
    print("corrected movie written to", outdir)


if __name__ == "__main__":
    main()
