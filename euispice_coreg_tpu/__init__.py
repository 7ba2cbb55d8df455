"""euispice_coreg_tpu — accelerator-native coalignment framework for Solar
Orbiter imagery, a ground-up JAX/XLA rebuild of the capabilities of
``adolliou/euispice_coreg`` (see SURVEY.md).

Public import surface mirrors the reference
(``/root/reference/euispice_coreg/hdrshift/__init__.py``,
``synras/__init__.py``)::

    from euispice_coreg_tpu.hdrshift import Alignment, AlignmentSpice, AlignmentResults
    from euispice_coreg_tpu.synras import SPICEComposedMapBuilder
"""

__version__ = "0.1.0"

from .hdrshift.alignment import Alignment  # noqa: F401
from .hdrshift.results import AlignmentResults  # noqa: F401
