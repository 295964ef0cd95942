"""The framework-free parts of ``smcsmc_tpu`` that the port shares.

These modules of the JAX package import numpy only (no jax), so the port
uses them as they are instead of copying them: the demography model, the
.seg reader/writer and splitter, the simulator, the .out writer and the
command-line helpers that build a ``Demography``.  This is the one module
of the port that imports ``smcsmc_tpu``; everything else, and
``chip_smoke.py``, takes these names from here.
"""

from smcsmc_tpu import outfmt
from smcsmc_tpu.cli import build_demography, load_option_file
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.segio import (
    SEGMENT_INVARIANT,
    SegData,
    define_chunks,
    read_seg,
    slice_seg,
    split_long_segments,
    write_seg,
)
from smcsmc_tpu.simulate import simulate_seg

__all__ = [
    "SEGMENT_INVARIANT",
    "Demography",
    "SegData",
    "build_demography",
    "define_chunks",
    "load_option_file",
    "outfmt",
    "read_seg",
    "simulate_seg",
    "slice_seg",
    "split_long_segments",
    "write_seg",
]
