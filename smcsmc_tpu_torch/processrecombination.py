# Copied from smcsmc_tpu/processrecombination.py at commit f882ad0; keep it letter for letter.
"""Recombination-guide smoothing: CUSUM + Wild Binary Segmentation.

Reference surface: smcsmc/processrecombination.py:17-234 — reads per-window
local recombination records (``.recomb.gz``: iter, locus, size,
opportunity/nt, per-leaf counts, ...; header written at count.cpp:622-627),
detects rate change points with WBS (Fryzlewicz 2014), and writes a
``.recomb_guide.gz`` (``locus  size  recomb_rate  <leaf rel rates>``)
consumed by the guided proposal (pfparam.hpp:169-202).

This implementation vectorizes the CUSUM statistics with numpy instead of
the reference's generator pipeline.
"""

from __future__ import annotations

import bisect
import gzip
import heapq
import math

import numpy as np


def _open(path, mode="rt"):
    if str(path).upper().endswith(".GZ"):
        return gzip.open(path, mode)
    return open(path, mode)


class LocalRecombination:
    """Per-window local recombination evidence + WBS smoothing."""

    def __init__(self, infile: str, iteration: int = 0):
        self._read_data(infile, iteration)

    def _read_data(self, infile: str, iteration: int):
        rows = []
        header_leaves = None
        with _open(infile) as fh:
            for line in fh:
                if line.startswith("iter"):
                    cols = line.strip().split("\t")
                    # header: iter locus size opp_per_nt 1..n [time log_time]
                    header_leaves = sum(1 for c in cols if c.isdigit())
                    continue
                elts = line.strip().split()
                it = int(elts[0])
                if it < iteration:
                    continue
                if it > iteration:
                    break
                rows.append(
                    [int(elts[1]), int(elts[2])] + [float(x) for x in elts[3:]]
                )
        if not rows:
            raise ValueError(f"no rows for iteration {iteration} in {infile}")
        locus = np.array([r[0] for r in rows], dtype=np.int64)
        size = np.array([r[1] for r in rows], dtype=np.int64)
        if np.any(locus[1:] != locus[:-1] + size[:-1]):
            raise ValueError("Found gaps or overlaps in input file")
        self.step = int(np.gcd.reduce(size))
        self.start = int(locus[0])
        self.opp = np.array([r[2] for r in rows])  # per-nt opportunity
        counts = np.array([r[3:] for r in rows])  # per-nt per-leaf counts
        if header_leaves is not None and counts.shape[1] > header_leaves:
            # drop the time/log_time columns (count.cpp:649-650); the
            # reference reader predates them ("NOTE: will not work properly
            # with the newfangled output files", processrecombination.py:14)
            counts = counts[:, :header_leaves]
        self.counts = counts
        self.leaves = self.counts.shape[1]
        # unmerge to uniform windows of self.step
        reps = (size // self.step).astype(int)
        self.u_opp = np.repeat(self.opp, reps)
        self.u_counts = np.repeat(self.counts, reps, axis=0)
        self.size = int(locus[-1] + size[-1])
        opportunity = float(np.sum(self.step * self.u_opp))
        recomb = float(np.sum(self.step * self.u_counts))
        self.rate = recomb / opportunity

    def _cusum(self, leaf: int | None = None) -> np.ndarray:
        if leaf is None:
            datum = self.u_counts.sum(axis=1) / self.u_opp - self.rate
        else:
            datum = self.u_counts[:, leaf] / self.u_opp - self.rate / self.leaves
        return np.cumsum(datum)

    @staticmethod
    def _argmax_xbse(s: int, e: int, cusum: np.ndarray):
        """Best single change point of the CUSUM statistic on [s, e)
        (vectorized version of processrecombination.py:137-157)."""
        n = float(e - s)
        prev = 0.0 if s == 0 else cusum[s - 1]
        total = cusum[e - 1] - prev
        b = np.arange(s + 1, e)
        sumleft = cusum[s:e - 1] - prev
        sumright = total - sumleft
        f1 = np.sqrt((e - b) / (n * (b - s)))
        f2 = np.sqrt((b - s) / (n * (e - b)))
        xbse = np.abs(f1 * sumleft - f2 * sumright)
        i = int(np.argmax(xbse))
        return float(xbse[i]), int(b[i])

    def _wbs(self, cusum: np.ndarray, beta: float, B=None) -> list[int]:
        """Wild Binary Segmentation over a deterministic multiscale grid of
        test segments (processrecombination.py:159-208)."""
        if B is None:
            B = []
        n = len(cusum)
        testsegs = []
        for l in (2, 3, 4, 6, 9, 13, 20, 30, 40, 60, 90, 130, 200, 300, 400,
                  600, 900, 1300, 2000):
            for s in range(0, n, max(l // 2, 1)):
                if s + l < n:
                    testsegs.append((s, s + l))
        for s, e in zip([0] + B, B + [n]):
            if e - s >= 2:
                testsegs.append((s, e))
        F = []
        for s, e in testsegs:
            value, b = self._argmax_xbse(s, e, cusum)
            F.append((-value, b, s, e))
        heapq.heapify(F)
        B = sorted(B)
        while F:
            value, bk, s, e = heapq.heappop(F)
            if -value < beta * self.rate:
                break
            # skip segments already containing an accepted change point
            if bisect.bisect_right(B, s) != bisect.bisect_left(B, e):
                continue
            bisect.insort(B, bk)
        return B

    def _smooth_column(self, B: list[int], leaf: int | None = None) -> np.ndarray:
        """Piecewise-constant mean rate between change points."""
        if leaf is None:
            col = self.u_counts.sum(axis=1) / self.u_opp
        else:
            col = self.u_counts[:, leaf] / self.u_opp
        out = np.empty_like(col)
        bounds = [0] + list(B) + [len(col)]
        for s, e in zip(bounds[:-1], bounds[1:]):
            if e > s:
                out[s:e] = col[s:e].mean()
        return out

    def smooth(self, alpha: float, beta: float) -> None:
        """alpha-mix the WBS-smoothed posterior rates with the flat prior
        (processrecombination.py:210-234)."""
        assert 0 <= alpha <= 1 and beta > 0
        B = self._wbs(self._cusum(), beta)
        overall = self._smooth_column(B)
        Bp = list(B)
        for leaf in range(self.leaves):
            Bp = self._wbs(self._cusum(leaf), beta, Bp)
        per_leaf = np.stack(
            [self._smooth_column(Bp, leaf) for leaf in range(self.leaves)], axis=1
        )
        rel = per_leaf / (per_leaf.sum(axis=1, keepdims=True) + 1e-30)
        smoothed = alpha * (rel * overall[:, None]) + (1 - alpha) * (
            self.rate / self.leaves
        )
        self.smoothed_data = smoothed  # [windows, leaves]

    def write_data(self, outfile) -> None:
        """Write the guide file: runs of identical smoothed values are merged
        into one row (processrecombination.py:107-131)."""
        close = False
        if isinstance(outfile, str):
            outfile = _open(outfile, "wt")
            close = True
        try:
            outfile.write(
                "locus\tsize\trecomb_rate"
                + "".join(f"\t{leaf + 1}" for leaf in range(self.leaves))
                + "\n"
            )
            sd = self.smoothed_data
            change = np.any(sd[1:] != sd[:-1], axis=1)
            starts = np.concatenate([[0], np.where(change)[0] + 1])
            ends = np.concatenate([starts[1:], [len(sd)]])
            for s, e in zip(starts, ends):
                vals = sd[s]
                rate = float(vals.sum())
                rel = vals / (rate + 1e-30)
                line = (
                    f"{self.start + s * self.step}\t{(e - s) * self.step}"
                    f"\t{rate:9.3e}"
                )
                line += "".join(f"\t{v:5.3f}" for v in rel)
                outfile.write(line + "\n")
        finally:
            if close:
                outfile.close()
