# Copied from smcsmc_tpu/pattern.py at commit dfc2fad; keep the code letter for letter (the docstrings name the reference's files by their path inside the reference tree).
"""PSMC-style epoch pattern parser.

Reproduces the behaviour of the reference pattern parser
(src/pattern.cpp:139-163, src/pattern.hpp):
a pattern string like ``"3*1+2*3+4"`` describes how ``num_seg`` log-spaced
time points on ``[0, top_t]`` are grouped into epochs.  ``a*b`` means
"a epochs, each spanning b elementary segments"; a bare number ``b`` means
"1 epoch spanning b segments".

The elementary segment boundaries are (pattern.cpp:144):

    t_i = 0.1 * exp( i/(n-1) * ln(1 + 10*top_t) ) - 0.1 ,  i = 0..n-1

so t_0 = 0 and t_{n-1} = top_t.  Epoch start times are the t_i at the start
of each group.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass


class PatternError(ValueError):
    """Invalid epoch pattern string (reference: src/exception.hpp)."""


@dataclass
class Pattern:
    """Parsed epoch pattern: groups of (num_epochs, segments_per_epoch)."""

    groups: list[tuple[int, int]]
    top_t: float

    @property
    def num_segments(self) -> int:
        return sum(a * b for a, b in self.groups)

    @property
    def num_epochs(self) -> int:
        return sum(a for a, _ in self.groups)

    def segment_times(self) -> list[float]:
        """Log-spaced elementary segment start times on [0, top_t]."""
        n = self.num_segments
        if n < 1:
            raise PatternError("pattern yields no segments")
        if n == 1:
            return [0.0]
        return [
            0.1 * math.exp(i / (n - 1) * math.log(1 + 10 * self.top_t)) - 0.1
            for i in range(n)
        ]

    def epoch_start_times(self) -> list[float]:
        """Start time of each epoch (units of top_t, typically 4N0 gens)."""
        seg = self.segment_times()
        out = []
        idx = 0
        for count, span in self.groups:
            for _ in range(count):
                out.append(seg[idx])
                idx += span
        return out


def parse_pattern(expr: str, top_t: float) -> Pattern:
    """Parse ``"3*1+2*3+4"``-style strings (reference: pattern.cpp:63-133)."""
    if not expr:
        raise PatternError("empty pattern")
    groups: list[tuple[int, int]] = []
    for factor in expr.split("+"):
        factor = factor.strip()
        m = re.fullmatch(r"(\d+)\s*\*\s*(\d+)", factor)
        if m:
            a, b = int(m.group(1)), int(m.group(2))
        elif re.fullmatch(r"\d+", factor):
            # bare number: one epoch spanning that many segments
            a, b = 1, int(factor)
        else:
            raise PatternError(f"cannot parse pattern factor {factor!r}")
        if a < 1 or b < 1:
            raise PatternError(f"pattern factor {factor!r} must be positive")
        groups.append((a, b))
    return Pattern(groups=groups, top_t=top_t)


def epoch_times_from_pattern(expr: str, top_t: float) -> list[float]:
    """Epoch start times for a pattern, in the units of ``top_t``."""
    return parse_pattern(expr, top_t).epoch_start_times()


def smc2_pattern_times(
    start: float, end: float, pattern: str, n0: float = 10000.0
) -> list[float]:
    """Reproduce the smc2 ``-P start end pattern`` epoch generation
    (reference: smcsmc/model.py:470-536, ``set_pattern``).

    ``start`` and ``end`` are generations; ``pattern`` must consist of
    strictly ``a*b`` factors joined by ``+`` (the reference raises on bare
    numbers here).  Builds the mask ``[1] + ([1]+[0]*(b-1))*a per factor +
    [1]`` and log-spaced times between ``start`` and ``end``; returns the
    epoch start times **in units of 4*N0 generations** (as fed to the
    scrm-style ``-eN`` flags), beginning at 0.
    """
    if start <= 0:
        raise PatternError("-P: start generation should be > 0")
    mask = [1]
    for factor in pattern.split("+"):
        m = re.fullmatch(r"(\d+)\s*\*\s*(\d+)", factor.strip())
        if not m:
            raise PatternError(f"Problem parsing pattern {pattern!r}")
        a, b = int(m.group(1)), int(m.group(2))
        mask += ([1] + [0] * (b - 1)) * a
    mask += [1]  # final epoch [end, infinity)
    times = [0.0] + [
        start * math.exp(math.log(end / start) * (i - 1) / (len(mask) - 2.0)) / (4 * n0)
        for i in range(1, len(mask))
    ]
    return [t for t, m in zip(times, mask) if m == 1]
