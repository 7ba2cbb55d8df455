"""Generate docs/API.md from the public surface's docstrings.

Usage:  python tools/gen_api_doc.py > docs/API.md
(Forces the CPU backend so it runs without an accelerator.)
"""
import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

SECTIONS = [
    ("Header-shift alignment — `euispice_coreg_tpu.hdrshift`",
     "euispice_coreg_tpu.hdrshift",
     ["Alignment", "AlignmentSpice", "AlignementSpiceIterativeContextRaster",
      "AlignmentResults"]),
    ("Selector-driven SPICE alignment",
     "euispice_coreg_tpu.hdrshift.alignment_spice_selector", None),
    ("Synthetic rasters — `euispice_coreg_tpu.synras`",
     "euispice_coreg_tpu.synras",
     ["MapBuilder", "ComposedMapBuilder", "SPICEComposedMapBuilder"]),
    ("Pixel-space alignment — `euispice_coreg_tpu.pxlshift`",
     "euispice_coreg_tpu.pxlshift",
     ["AlignmentPixels", "AlignmentSpicePixel"]),
    ("Jitter correction — `euispice_coreg_tpu.jitter_correction`",
     "euispice_coreg_tpu.jitter_correction",
     ["jitter_correction_imagers", "align_movie_to_reference"]),
    ("Data selector — `euispice_coreg_tpu.selector`",
     "euispice_coreg_tpu.selector",
     ["Selector", "SelectorEui", "SelectorSpice"]),
    ("Plotting — `euispice_coreg_tpu.plot.plot`",
     "euispice_coreg_tpu.plot.plot", None),
    ("FITS I/O — `euispice_coreg_tpu.io.fits`",
     "euispice_coreg_tpu.io.fits", None),
    ("Engine (advanced) — `euispice_coreg_tpu.engine.lag_search`",
     "euispice_coreg_tpu.engine.lag_search",
     ["evaluate_lag_grid", "default_mesh", "mesh_put"]),
]


def sig_of(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def own_doc(obj):
    """First paragraph of the object's OWN docstring (no MRO inheritance
    for classes; function objects never inherit docstrings)."""
    raw = vars(obj).get("__doc__") if inspect.isclass(obj) else obj.__doc__
    if not raw:
        return ""
    out = []
    for line in inspect.cleandoc(raw).splitlines():
        line = line.strip()
        if not line:
            if out:
                break
            continue
        out.append(line)
    return " ".join(out)


def main():
    print("# Public API reference\n")
    print("Generated from docstrings (`python tools/gen_api_doc.py > "
          "docs/API.md`).")
    print("Import paths mirror the reference package; see PARITY.md for the")
    print("component mapping and README.md for walkthroughs.\n")
    for title, modname, names in SECTIONS:
        mod = importlib.import_module(modname)
        if names is None:
            names = [n for n, o in vars(mod).items()
                     if not n.startswith("_") and callable(o)
                     and getattr(o, "__module__", "").startswith(modname)]
        print(f"## {title}\n")
        for n in names:
            obj = getattr(mod, n, None)
            if obj is None:
                continue
            if inspect.isclass(obj):
                print(f"### `{n}`\n")
                if own_doc(obj):
                    print(own_doc(obj) + "\n")
                print(f"```python\n{n}{sig_of(obj)}\n```\n")
                for mn, mo in inspect.getmembers(
                        obj, predicate=inspect.isfunction):
                    if mn.startswith("_"):
                        continue
                    doc = own_doc(mo)
                    inherited = mn not in vars(obj)
                    tag = " *(inherited)*" if inherited else ""
                    print(f"- **`{mn}{sig_of(mo)}`**{tag} — {doc}")
                print()
            else:
                print(f"### `{n}{sig_of(obj)}`\n")
                print(own_doc(obj) + "\n")


if __name__ == "__main__":
    main()
