"""Jitter correction of imager time series.

Behavioural port of ``jitter_correction_imagers``
(``/root/reference/euispice_coreg/jitter_correction/jitter_correction.py:14-256``,
after Chitta et al. 2022): split the series into overlapping sublists and
align each frame to the first frame of its sublist, writing pointing-corrected
copies.  The reference's backward pass is broken (it indexes a string,
jitter_correction.py:154-156, SURVEY.md 2.3); here both passes share one
correct implementation.

Each per-frame alignment runs on the device lag-search engine; for crval-only
lag grids every frame costs a single FFT correlation-surface evaluation.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ..hdrshift.alignment import Alignment


def jitter_correction_imagers(
    list_files_input,
    path_files_output: str,
    lonlims=None,
    latlims=None,
    shape=None,
    lag_crval1=np.arange(-5, 5, 0.1),
    lag_crval2=np.arange(-5, 5, 0.1),
    lag_cdelt1=np.arange(0, 1, 1),
    lag_cdelt2=np.arange(0, 1, 1),
    lag_crota=np.arange(0, 1, 1),
    sublist_length: int = 10,
    overlap: int = 1,
    window_files_input=-1,
    method_carrington_reprojection: str = "fa",
    unit_lag: str = "arcsec",
    path_figures: str | None = None,
    plot_all_figures: bool = False,
    parallelism: bool = True,
    cpu_count: int | None = None,
    small_fov_value_max=None,
    small_fov_value_min=None,
    alignement_method: str = "carrington",
    mesh=None,
    resume: bool = False,
):
    """Correct the jitter of a list of FITS files against overlapping-sublist
    references; corrected files are written into ``path_files_output``.

    ``mesh``: optional 1-axis ``jax.sharding.Mesh`` — in helioprojective mode
    with a CRVAL-only lag grid, each sublist is evaluated as ONE fleet search
    with the frame axis sharded over the mesh (see
    :func:`align_movie_to_reference`).  Sublists stay sequential: each
    sublist's reference is the corrected overlap frame written by the
    previous one.

    ``resume=True`` skips frames whose corrected output already exists in
    ``path_files_output`` (they are absent from the returned dict) — an
    interrupted long movie continues where it stopped instead of restarting
    from scratch (the reference always restarts, SURVEY.md section 5; its
    written L3 products are the natural checkpoint artifact).
    """
    if overlap == 0:
        raise ValueError(
            "number of overlapping images between sublists can not be equal to 0."
        )
    from ..io import fits
    from ..utils import timeutils

    dates = []
    for path in list_files_input:
        hdul = fits.open(path)
        dates.append(str(hdul[window_files_input].header["DATE-AVG"]))

    parameter_alignment = {
        "lag_crval1": lag_crval1,
        "lag_crval2": lag_crval2,
        "lag_cdelt1": lag_cdelt1,
        "lag_cdelt2": lag_cdelt2,
        "lag_crota": lag_crota,
    }

    idx = np.arange(len(list_files_input))
    sublists = [idx[n : n + sublist_length + overlap]
                for n in range(0, len(idx), sublist_length)]

    from ..utils.obs import Progress, logger

    progress = Progress(total=max(len(list_files_input) - 1, 1),
                        label="jitter correction")
    logger.info("jitter correction: %d frames in %d sublists",
                len(list_files_input), len(sublists))
    crval_only = all(
        g is None or (len(np.atleast_1d(g)) == 1
                      and float(np.atleast_1d(g)[0]) == 0.0)
        for g in (lag_cdelt1, lag_cdelt2, lag_crota))
    # how many sublists align each frame (resume rule below)
    align_count = {}
    for s in sublists:
        for i in s[1:]:
            align_count[int(i)] = align_count.get(int(i), 0) + 1

    results_all = {}
    for ii, sub in enumerate(sublists):
        index_ref = int(sub[0])
        basename_ref = os.path.basename(str(list_files_input[index_ref]))
        path_reference = os.path.join(path_files_output, basename_ref)
        if ii == 0 and not os.path.isfile(path_reference):
            # the anchor frame is copied unmodified (jitter_correction.py:108-109);
            # copy atomically so a resumed run never sees a truncated anchor
            tmp = path_reference + ".tmp"
            shutil.copyfile(list_files_input[index_ref], tmp)
            os.replace(tmp, path_reference)

        pending = [int(i) for i in sub[1:]]
        if resume:
            # a frame is done only if its output exists AND exactly one
            # sublist aligns it: with overlap > 1 an overlap frame is
            # aligned twice (the later pass overwrites), and an existing
            # output cannot reveal WHICH pass wrote it — always re-align
            # those (overlap=1, the default, never pays this)
            done = [i for i in pending
                    if align_count[i] == 1
                    and os.path.isfile(os.path.join(
                        path_files_output,
                        os.path.basename(str(list_files_input[i]))))]
            if done:
                logger.info("resume: skipping %d already-corrected frames "
                            "in sublist %d", len(done), ii)
                for _ in done:
                    progress.step()
            pending = [i for i in pending if i not in done]
            if not pending:
                continue

        if (mesh is not None and alignement_method == "helioprojective"
                and crval_only and len(pending) > 0):
            sub_paths = [list_files_input[i] for i in pending]
            fleet = align_movie_to_reference(
                sub_paths, path_reference,
                path_files_output=path_files_output,
                lag_crval1=lag_crval1, lag_crval2=lag_crval2,
                window_files_input=window_files_input,
                reference_window=window_files_input,
                mesh=mesh, unit_lag=unit_lag,
                small_fov_value_max=small_fov_value_max,
                small_fov_value_min=small_fov_value_min,
            )
            date_ref = str(dates[index_ref])[11:19].replace(":", "_")
            for j, index_to_align in enumerate(pending):
                results = fleet[j]
                results_all[index_to_align] = results
                if path_figures is not None:
                    date_to_align = dates[index_to_align][11:19].replace(":", "_")
                    results.plot_correlation(path_save_figure=os.path.join(
                        path_figures,
                        f"correlation_{date_to_align}_{date_ref}.pdf"))
                    if plot_all_figures:
                        results.plot_co_alignment(
                            type_plot="successive_plot",
                            path_save_figure=os.path.join(
                                path_figures,
                                f"plot_co_alignment_{date_to_align}_{date_ref}.pdf"))
                    from matplotlib import pyplot as plt

                    plt.close("all")
                progress.step()
            continue

        for index_to_align in pending:
            date_to_align = dates[index_to_align][11:19].replace(":", "_")
            results = _align_hrieuv_with_hrieuv(
                path_output_figures=path_figures,
                large_fov_fits_path=path_reference,
                large_fov_window=window_files_input,
                small_fov_path=list_files_input[index_to_align],
                window_to_align=window_files_input,
                date_to_align=date_to_align,
                parameter_alignment=parameter_alignment,
                cpu_count=cpu_count,
                do_plot_figure=plot_all_figures,
                method_carrington_reprojection=method_carrington_reprojection,
                reference_date=dates[index_ref],
                parallelism=parallelism,
                alignement_method=alignement_method,
                small_fov_value_max=small_fov_value_max,
                small_fov_value_min=small_fov_value_min,
                unit_lag=unit_lag,
                lonlims=lonlims,
                latlims=latlims,
                shape=shape,
            )
            basename_new = os.path.basename(str(list_files_input[index_to_align]))
            results.write_corrected_fits(
                window_list_to_apply_shift=[window_files_input],
                path_to_l3_output=os.path.join(path_files_output, basename_new),
            )
            results_all[index_to_align] = results
            progress.step()
    return results_all


def align_movie_to_reference(
    list_files_input,
    reference_path: str,
    path_files_output: str | None = None,
    lag_crval1=np.arange(-5, 5.5, 0.5),
    lag_crval2=np.arange(-5, 5.5, 0.5),
    window_files_input=-1,
    reference_window=-1,
    alignement_method: str = "helioprojective",
    lonlims=None,
    latlims=None,
    shape=None,
    reference_date=None,
    mesh=None,
    resume: bool = False,
    **alignment_kwargs,
):
    """Align every frame of a movie against ONE fixed reference image
    (BASELINE.md batched-movie configuration).

    ``resume=True`` (with ``path_files_output``) skips frames whose
    corrected output already exists — skipped frames are absent from the
    returned dict (outputs are written atomically, so an existing file is
    always complete).

    Frames share image shape and lag grid, so after the first frame every
    alignment reuses the compiled device program; with a CRVAL-only lag grid
    each frame costs a single FFT correlation-surface evaluation.

    ``mesh``: optional 1-axis ``jax.sharding.Mesh`` — helioprojective
    CRVAL-only movies are then evaluated as ONE fleet search with the frame
    axis sharded over the mesh (data parallelism over image pairs, the
    multi-chip extension of the reference's per-frame process fan-out,
    ``alignment.py:667-721``; see
    ``engine/fast_corr.evaluate_movie_from_displacements``).  Falls back to
    the per-frame loop whenever a frame fails the fast-path preconditions.
    Worth it when the movie has at least ~one frame per device; for a
    handful of frames on a large mesh, omit ``mesh`` — the per-frame path
    already shards each frame's surface stack over the lag axis
    (``fast_corr.surfaces_at_sharded``), which wins when frames are few.

    Returns {index: AlignmentResults}; writes corrected files when
    ``path_files_output`` is given.
    """
    from ..utils.obs import Progress, logger

    frames = list(enumerate(list_files_input))  # (original index, path)
    if resume and path_files_output is not None:
        todo = [(k, p) for k, p in frames
                if not os.path.isfile(os.path.join(
                    path_files_output, os.path.basename(str(p))))]
        if len(todo) < len(frames):
            logger.info("resume: skipping %d already-corrected frames",
                        len(frames) - len(todo))
        frames = todo

    if (mesh is not None and alignement_method == "helioprojective"
            and len(frames) > 0):
        batched = _align_movie_batched(
            [p for _, p in frames], reference_path, path_files_output,
            lag_crval1, lag_crval2, window_files_input, reference_window,
            mesh, dict(alignment_kwargs))
        if batched is not None:
            return {frames[j][0]: r for j, r in batched.items()}

    # per-frame loop (and the fleet fallback): one bar for the whole movie
    progress = Progress(total=len(frames), label="movie alignment")
    results_all = {}
    for k, path in frames:
        A = Alignment(
            large_fov_known_pointing=reference_path,
            large_fov_window=reference_window,
            small_fov_to_correct=path,
            small_fov_window=window_files_input,
            lag_crval1=lag_crval1,
            lag_crval2=lag_crval2,
            lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
            **alignment_kwargs,
        )
        if alignement_method == "helioprojective":
            results = A.align_using_helioprojective()
        elif alignement_method == "carrington":
            results = A.align_using_carrington(
                lonlims=lonlims, latlims=latlims, shape=shape,
                reference_date=reference_date)
        elif alignement_method == "initial_carrington":
            results = A.align_using_initial_carrington()
        else:
            raise ValueError(f"unknown alignement_method: {alignement_method}")
        results_all[k] = results
        if path_files_output is not None:
            basename = os.path.basename(str(path))
            results.write_corrected_fits(
                window_list_to_apply_shift=[window_files_input],
                path_to_l3_output=os.path.join(path_files_output, basename),
            )
        progress.step()
    return results_all


def _align_movie_batched(paths, reference_path, path_files_output,
                         lag_crval1, lag_crval2, window, ref_window,
                         mesh, akw):
    """Fleet evaluation of a helioprojective CRVAL-only movie alignment.

    Per frame: load + thresholds + submap (the one-shot prep of
    ``Alignment._prepare_projected_operands``), then ONE engine call scores
    every (frame, lag) pair with the frame axis sharded over ``mesh``.
    Returns ``{index: AlignmentResults}`` or None when any precondition
    fails (caller falls back to the per-frame loop).
    """
    from ..engine import fast_corr
    from ..utils.obs import Progress, logger

    if akw.get("lag_search_mode", "auto") not in ("auto", "fast"):
        return None
    if akw.get("reprojection_order", 2) not in (0, 2):
        return None
    if getattr(mesh, "devices", np.empty(0)).size <= 1:
        return None
    method = "correlation"

    progress = Progress(total=len(paths) + 1, label="movie alignment (fleet)")
    alignments = []
    smalls, refs, cs_list = [], [], []
    n1 = n2 = None
    for path in paths:
        A = Alignment(
            large_fov_known_pointing=reference_path,
            large_fov_window=ref_window,
            small_fov_to_correct=path,
            small_fov_window=window,
            lag_crval1=lag_crval1,
            lag_crval2=lag_crval2,
            lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
            **akw,
        )
        A._begin_helioprojective(method)
        lon, lat, ref_img, base, kind = A._prepare_projected_operands(
            wrap=True)
        l1, l2, l3, l4, l5 = A._lags_deg(wrap=True)
        if not fast_corr.fast_path_applicable(l3, l4, l5, A.order):
            return None
        g1, g2 = np.meshgrid(np.asarray(l1, dtype=np.float64),
                             np.asarray(l2, dtype=np.float64), indexing="ij")
        lags = np.stack([g1.ravel(), g2.ravel()], axis=-1)
        c, spread = fast_corr.displacement_per_lag(base, lags, lon, lat, kind)
        if spread > fast_corr.MAX_DISPLACEMENT_SPREAD_PX:
            return None
        if smalls and (A.data_small.shape != smalls[0].shape
                       or c.shape != cs_list[0].shape):
            return None  # mixed frame shapes: per-frame loop handles them
        n1, n2 = len(l1), len(l2)
        alignments.append(A)
        smalls.append(np.asarray(A.data_small))
        refs.append(ref_img)  # stays device-resident
        cs_list.append(c)
        progress.step()

    import jax.numpy as jnp

    A0 = alignments[0]
    attempts = {"n": 0}

    def run_fleet():
        if attempts["n"]:
            # retry after a worker crash: the cached submap buffers died
            # with the device — rebuild them (devcache was cleared)
            refs[:] = [a._prepare_projected_operands(wrap=True)[2]
                       for a in alignments]
        attempts["n"] += 1
        return fast_corr.evaluate_movie_from_displacements(
            np.stack(smalls), jnp.stack(refs), np.stack(cs_list),
            order=A0.order, compute_dtype=A0.compute_dtype, mesh=mesh,
            method=method)

    corr = A0._with_engine_retries(run_fleet)
    if corr is None:
        return None
    logger.info("fleet movie search: %d frames x %d lags on %d devices",
                len(alignments), corr.shape[1], mesh.devices.size)
    progress.step()

    results_all = {}
    for k, A in enumerate(alignments):
        corr5 = corr[k].reshape(n1, n2, 1, 1, 1)
        corr6 = np.repeat(corr5[..., np.newaxis], len(A.lag_solar_r), axis=-1)
        results = A._make_results(corr6)
        results_all[k] = results
        if path_files_output is not None:
            basename = os.path.basename(str(paths[k]))
            results.write_corrected_fits(
                window_list_to_apply_shift=[window],
                path_to_l3_output=os.path.join(path_files_output, basename),
            )
    return results_all


def _align_hrieuv_with_hrieuv(
    large_fov_fits_path: str,
    large_fov_window,
    small_fov_path: str,
    parameter_alignment: dict,
    date_to_align,
    cpu_count=30,
    window_to_align=3,
    do_plot_figure: bool = False,
    parallelism: bool = True,
    lonlims=None,
    latlims=None,
    shape=None,
    unit_lag: str = "arcsec",
    reference_date=None,
    small_fov_value_max=None,
    small_fov_value_min=None,
    method_carrington_reprojection: str = "fa",
    alignement_method: str = "carrington",
    path_output_figures: str | None = None,
    fov_limits=None,
):
    """One imager-vs-imager alignment (jitter_correction.py:177-256)."""
    A = Alignment(
        large_fov_known_pointing=large_fov_fits_path,
        large_fov_window=large_fov_window,
        small_fov_to_correct=small_fov_path,
        small_fov_window=window_to_align,
        small_fov_value_max=small_fov_value_max,
        small_fov_value_min=small_fov_value_min,
        parallelism=parallelism,
        counts_cpu_max=cpu_count,
        unit_lag=unit_lag,
        **parameter_alignment,
    )

    if alignement_method == "carrington":
        results = A.align_using_carrington(
            method="correlation",
            lonlims=lonlims, latlims=latlims, shape=shape,
            reference_date=reference_date,
            method_carrington_reprojection=method_carrington_reprojection,
        )
    elif alignement_method == "initial_carrington":
        results = A.align_using_initial_carrington(method="correlation")
    elif alignement_method == "helioprojective":
        results = A.align_using_helioprojective(
            method="correlation", fov_limits=fov_limits)
    else:
        raise ValueError(f"unknown alignement_method: {alignement_method}")

    if path_output_figures is not None:
        date_ref = str(reference_date)[11:19].replace(":", "_")
        results.plot_correlation(
            path_save_figure=os.path.join(
                path_output_figures, f"correlation_{date_to_align}_{date_ref}.pdf")
        )
        if do_plot_figure:
            results.plot_co_alignment(
                type_plot="successive_plot",
                path_save_figure=os.path.join(
                    path_output_figures,
                    f"plot_co_alignment_{date_to_align}_{date_ref}.pdf"),
            )
        from matplotlib import pyplot as plt

        plt.close("all")
    return results
