# Copied from smcsmc_tpu/recombio.py at commit f882ad0; keep it letter for letter.
"""Local-recombination record (.recomb.gz) and guide-file IO.

Reference surfaces:
- ``CountModel::dump_local_recomb_logs`` (src/count.cpp:616-654)
  writes per-window rows ``iter locus size opp_per_nt 1..n time log_time``;
  the opportunity column is stored differentially in memory and converted to
  absolute density on the fly.
- ``RecombinationBias::parse_recomb_bias_file`` (pfparam.hpp:169-202) reads
  the smoothed guide (``locus size recomb_rate <leaf rel rates>``; rows are
  contiguous and 0-based).
"""

from __future__ import annotations

import gzip

import numpy as np


def _open(path, mode="rt"):
    if str(path).upper().endswith(".GZ"):
        return gzip.open(path, mode)
    return open(path, mode)


def write_recomb(
    path: str,
    iteration: int,
    window_size: float,
    opp_diff: np.ndarray,
    leaf_cnt: np.ndarray,
    time_cnt: np.ndarray,
    logtime_cnt: np.ndarray,
    start_position: float = 0.0,
    append: bool = False,
) -> None:
    """Dump one iteration's local-recombination evidence
    (count.cpp:616-654).  ``opp_diff`` [W+1] is the differential opportunity
    density (cumsum recovers the absolute density); counts are divided by the
    window size, matching the reference's per-nt normalization."""
    W, n = leaf_cnt.shape
    opp = np.cumsum(np.asarray(opp_diff, dtype=np.float64))[:W]
    mode = "at" if append else "wt"
    with _open(path, mode) as fh:
        # the reference writes the header only for iteration 0 of its single
        # append-mode file (count.cpp:622-628); standalone per-iteration
        # files here always get one
        if not append:
            fh.write(
                "iter\tlocus\tsize\topp_per_nt"
                + "".join(f"\t{s + 1}" for s in range(n))
                + "\ttime\tlog_time\n"
            )
        ws = window_size
        for idx in range(W):
            row = [
                str(iteration),
                f"{idx * ws + start_position:.0f}",
                f"{ws:.0f}",
                f"{opp[idx] / ws:.5e}",
            ]
            row += [f"{leaf_cnt[idx, s] / ws:.5e}" for s in range(n)]
            row.append(f"{time_cnt[idx] / ws:.5e}")
            row.append(f"{logtime_cnt[idx] / ws:.5e}")
            fh.write("\t".join(row) + "\n")


def read_guide(path: str):
    """Parse a guide file into (locus [R], size [R], rate [R],
    leaf_rel [R, n]) row arrays (pfparam.hpp:169-202: contiguous from 0)."""
    locus, size, rate, leaf = [], [], [], []
    with _open(path) as fh:
        header = fh.readline()
        if not header.startswith("locus"):
            raise ValueError(
                "Expected header line (columns 'locus', 'size', "
                "'recomb_rate', '1', ...) in recombination guide file"
            )
        for line in fh:
            elts = line.strip().split("\t")
            if len(elts) < 4:
                continue
            locus.append(int(elts[0]))
            size.append(int(elts[1]))
            rate.append(float(elts[2]))
            leaf.append([float(x) for x in elts[3:]])
    locus = np.asarray(locus, dtype=np.int64)
    size = np.asarray(size, dtype=np.int64)
    if locus.shape[0] == 0:
        raise ValueError("empty recombination guide file")
    # contiguity check (the reference parser additionally requires a 0 start,
    # pfparam.hpp:198-202; chunk guides here carry their absolute offset)
    if np.any(locus[1:] != locus[:-1] + size[:-1]):
        raise ValueError(
            "Did not get expected locus position (records should leave no "
            "gaps)"
        )
    return locus, size, np.asarray(rate), np.asarray(leaf)


def guide_to_windows(
    path: str, chunk_start: float, chunk_len: float, window_size: float
):
    """Uniform per-window guide arrays for the sweep's traced inputs:
    (rate [W], leaf_rel [W, n]) over ``W = ceil(chunk_len/window_size)``
    chunk-relative windows.  Positions in the guide file are absolute
    (0-based across the locus); out-of-range windows extend the edge rows."""
    locus, size, rate, leaf = read_guide(path)
    W = int(np.ceil(chunk_len / window_size))
    centers = chunk_start + (np.arange(W) + 0.5) * window_size
    ends = np.cumsum(size) + locus[0]
    row = np.clip(np.searchsorted(ends, centers, side="right"), 0, len(rate) - 1)
    return rate[row].astype(np.float32), leaf[row].astype(np.float32)
