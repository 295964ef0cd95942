# Copied from smcsmc_tpu/segio.py at commit dfc2fad; keep it letter for letter.
""".seg input/output: the reference's primary data format.

Format (reference: src/segdata.cpp:79-106): tab-separated, 3 or 6 columns:

    ``start  length  [T/F  T/F  chrom]  alleles``

``alleles`` is one character per haplotype from the alphabet ``0 1 . /``
(segdata.cpp:413-451): 0/1 = phased alleles, ``.`` = missing, ``/`` =
unphased genotype (appears in pairs; the pair carries an unordered {0,1}
genotype).  Each row covers ``[start, start+length)``; the allele column
gives the variant state at the **last** position of the segment.

Internal encoding matches the reference: 0, 1, -1 (missing), 2 (unphased).

Over-long segments are split into ``SEGMENT_INVARIANT_PARTIAL`` pieces of at
most ``max_segment_length = max_segment_length_factor / (4*N0*rho)``
(segdata.cpp:121-145, pfparam.cpp:364-370) so that the particle filter's
per-step event buffers stay bounded.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

# segment states (reference: segdata.hpp)
SEGMENT_INVARIANT = 0
SEGMENT_INVARIANT_PARTIAL = 1  # split piece: no site likelihood at its end
SEGMENT_MISSING = 2


class SegError(ValueError):
    """Invalid .seg input (reference: src/exception.hpp InvalidSeg*)."""


@dataclass
class SegData:
    """Columnar .seg data.

    positions : (S,) int64 — segment start positions (bp)
    lengths   : (S,) int64 — segment lengths (bp)
    states    : (S,) int8  — SEGMENT_* code
    alleles   : (S, n) int8 — allele at segment-final site: 0/1/-1/2
    phased    : (n,) bool  — per-haplotype phasing status
    """

    positions: np.ndarray
    lengths: np.ndarray
    states: np.ndarray
    alleles: np.ndarray
    phased: np.ndarray

    @property
    def num_segments(self) -> int:
        return len(self.positions)

    @property
    def num_samples(self) -> int:
        return self.alleles.shape[1]

    @property
    def end(self) -> int:
        return int(self.positions[-1] + self.lengths[-1])


_ALLELE_CODE = {"0": 0, "1": 1, ".": -1, "/": 2}


def _decode_alleles(field: str) -> list[int]:
    try:
        return [_ALLELE_CODE[c] for c in field.strip()]
    except KeyError as e:
        raise SegError(f"undefined allele code {e.args[0]!r}") from None


def _open(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


_NATIVE = None


def _native_scanner():
    """ctypes handle to the C seg scanner (native/segscan.c), if built."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    import ctypes
    import os

    so = os.path.join(os.path.dirname(__file__), "_segscan.so")
    if not os.path.exists(so):
        _NATIVE = False
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.segscan_parse  # symbol check before committing to the binary
    except (OSError, AttributeError):
        # stale/foreign-ABI binary: use the Python parser; `make native`
        # rebuilds the scanner for this host
        _NATIVE = False
        return None
    lib.segscan_parse.restype = ctypes.c_long
    lib.segscan_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.segscan_count.restype = ctypes.c_long
    lib.segscan_count.argtypes = [ctypes.c_char_p]
    _NATIVE = lib
    return lib


def _read_seg_native(path: str) -> SegData | None:
    """Parse with the native scanner; None on any mismatch (caller falls
    back to the reference-faithful Python parser for error reporting)."""
    import ctypes

    lib = _native_scanner()
    if lib is None:
        return None
    mode = "rb" if not str(path).endswith(".gz") else "rb"
    with _open(path, mode) as fh:
        text = fh.read()
    if not isinstance(text, bytes):
        text = text.encode()
    text += b"\0"
    cap = lib.segscan_count(text)
    if cap <= 0:
        return None
    # probe allele-column width from the first data line (exact allocation)
    nsam_max = 0
    for line in text.split(b"\n", 50):
        if line and not line.startswith(b"#"):
            nsam_max = len(line.split(b"\t")[-1].strip())
            break
    if nsam_max <= 0:
        return None
    pos = np.empty(cap, dtype=np.int64)
    length = np.empty(cap, dtype=np.int64)
    alleles = np.empty((cap, nsam_max), dtype=np.int8)
    nsam = ctypes.c_int(0)
    rows = lib.segscan_parse(
        text, cap, nsam_max,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        length.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        alleles.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.byref(nsam), 1,
    )
    if rows <= 0:
        return None
    al = alleles[:rows, : nsam.value]
    if nsam.value != nsam_max or rows != cap:
        al = al.copy()
    return SegData(
        positions=pos[:rows].copy(),
        lengths=length[:rows].copy(),
        states=np.zeros(rows, dtype=np.int8),
        alleles=al,
        phased=~np.any(al == 2, axis=0),
    )


def read_seg(
    path: str,
    data_start: int = 1,
    seqlen: float | None = None,
    max_segment_length: float | None = None,
) -> SegData:
    """Read a .seg file, mirroring segdata.cpp:55-166.

    Uses the native C scanner (native/segscan.c, ``make native``) when built
    and the read is un-windowed; otherwise the Python parser.

    ``data_start``/``seqlen`` window the data (the reference's ``-startpos``
    chunking); ``max_segment_length`` splits over-long segments into
    INVARIANT_PARTIAL pieces.
    """
    if data_start == 1 and seqlen is None:
        fast = _read_seg_native(path)
        if fast is not None:
            if max_segment_length is not None:
                return split_long_segments(fast, max_segment_length)
            return fast
    positions, lengths, states, alleles = [], [], [], []
    next_start = None
    nsam = None
    data_end = None if seqlen is None else data_start + seqlen

    with _open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            cols = line.split("\t")
            if len(cols) < 3:
                raise SegError("Require 3 or 6 columns")
            try:
                start = int(cols[0])
            except ValueError:
                raise SegError(f"Invalid segment start position {cols[0]!r}")
            length = int(float(cols[1]))
            if len(cols) >= 6 and cols[2] in "TF":
                if cols[3] not in "TF":
                    raise SegError("Expected T or F in .seg file column 3 and 4")
                allele = _decode_alleles(cols[5])
            elif len(cols) == 3:
                allele = _decode_alleles(cols[2])
            else:
                raise SegError("Require 3 (or 6) columns")
            if nsam is None:
                nsam = len(allele)
            elif len(allele) != nsam:
                raise SegError("Wrong number of allele entries")
            if next_start is not None and next_start != start:
                raise SegError("Segments are not consecutive")
            next_start = start + length
            if data_end is not None and start >= data_end:
                break
            # split over-long segments (segdata.cpp:121-145)
            seg_start, seg_len = start, length
            while seg_len > 0:
                if max_segment_length is not None and seg_len > max_segment_length:
                    piece = int(max_segment_length)
                    state = SEGMENT_INVARIANT_PARTIAL
                else:
                    piece = seg_len
                    state = SEGMENT_INVARIANT
                if seg_start + piece > data_start:
                    positions.append(seg_start)
                    lengths.append(piece)
                    states.append(state)
                    alleles.append(allele)
                seg_start += piece
                seg_len -= piece

    if not positions:
        raise SegError(f"No data found in {path} at [{data_start}, {data_end})")

    alleles = np.array(alleles, dtype=np.int8)
    phased = ~np.any(alleles == 2, axis=0)
    return SegData(
        positions=np.array(positions, dtype=np.int64),
        lengths=np.array(lengths, dtype=np.int64),
        states=np.array(states, dtype=np.int8),
        alleles=alleles,
        phased=phased,
    )


def write_seg(path: str, seg: SegData, chrom: int = 1) -> None:
    """Write .seg rows in the 6-column format used by the reference's
    simulator conversion (populationmodels.py:533)."""
    inv_code = {0: "0", 1: "1", -1: ".", 2: "/"}
    with _open(path, "wt") as fh:
        for s, l, al in zip(seg.positions, seg.lengths, seg.alleles):
            geno = "".join(inv_code[int(a)] for a in al)
            fh.write(f"{int(s)}\t{int(l)}\tT\tF\t{chrom}\t{geno}\n")


def merge_segs(
    paths: list[str], gap: int = 1000000
) -> tuple[SegData, list[tuple[int, int, int]]]:
    """Merge per-chromosome .seg files into one coordinate system with
    inter-chromosome gaps (reference: model.py:810-840, process_segfiles).

    Returns the merged data plus a map ``(merged_start, chrom_index,
    original_start)`` recording the offset of each input file.
    """
    merged = []
    mapping = []
    offset = 0
    for idx, p in enumerate(paths):
        seg = read_seg(p)
        first = int(seg.positions[0])
        mapping.append((offset, idx, first))
        shift = offset - first
        merged.append(
            SegData(
                positions=seg.positions + shift,
                lengths=seg.lengths,
                states=seg.states,
                alleles=seg.alleles,
                phased=seg.phased,
            )
        )
        offset = int(merged[-1].positions[-1] + merged[-1].lengths[-1]) + gap
    nsam = merged[0].num_samples
    for m in merged:
        if m.num_samples != nsam:
            raise SegError("All .seg files must have the same sample count")
    out = SegData(
        positions=np.concatenate([m.positions for m in merged]),
        lengths=np.concatenate([m.lengths for m in merged]),
        states=np.concatenate([m.states for m in merged]),
        alleles=np.concatenate([m.alleles for m in merged]),
        phased=np.logical_and.reduce([m.phased for m in merged]),
    )
    return out, mapping


@dataclass
class Chunk:
    start: int
    end: int

    @property
    def length(self) -> int:
        return self.end - self.start


def define_chunks(
    seg: SegData,
    num_chunks: int,
    maxgap: int = 200000,
    minseg: int = 500000,
    startpos: float | None = None,
    length: float | None = None,
) -> list[Chunk]:
    """Split the genome into chunks for parallel inference (reference:
    model.py:563-662, ``define_chunks``): restrict to the window
    ``[startpos, startpos + length)`` (pfparam.cpp -startpos), split at gaps
    (all-missing stretches) longer than ``maxgap``, drop pieces shorter
    than ``minseg``, then split the largest pieces until there are
    ``num_chunks``.
    """
    if startpos is not None or length is not None:
        w0 = int(startpos) if startpos is not None else int(seg.positions[0])
        w1 = (
            int(w0 + length)
            if length is not None
            else int(seg.positions[-1] + seg.lengths[-1])
        )
        seg = slice_seg(seg, w0, w1)
        if seg.num_segments == 0:
            raise SegError(
                f"window [{w0}, {w1}) contains no data "
                "(reference: 'No segments left - nothing to do...')"
            )
        # clip the boundary segments to the window
        seg = SegData(
            positions=np.maximum(seg.positions, w0),
            lengths=np.minimum(seg.positions + seg.lengths, w1)
            - np.maximum(seg.positions, w0),
            states=seg.states,
            alleles=seg.alleles,
            phased=seg.phased,
        )
    # find gaps: runs of segments where all alleles are missing
    missing = np.all(seg.alleles == -1, axis=1)
    pieces: list[Chunk] = []
    start = int(seg.positions[0])
    pos = seg.positions
    ln = seg.lengths
    i = 0
    S = seg.num_segments
    while i < S:
        if missing[i]:
            j = i
            while j < S and missing[j]:
                j += 1
            gap_len = int(pos[j - 1] + ln[j - 1] - pos[i])
            if gap_len > maxgap:
                if int(pos[i]) - start > 0:
                    pieces.append(Chunk(start, int(pos[i])))
                start = int(pos[j - 1] + ln[j - 1])
            i = j
        else:
            i += 1
    end = int(pos[-1] + ln[-1])
    if end - start > 0:
        pieces.append(Chunk(start, end))
    pieces = [p for p in pieces if p.length >= minseg] or pieces
    # split largest until we have num_chunks
    while len(pieces) < num_chunks:
        pieces.sort(key=lambda c: -c.length)
        big = pieces.pop(0)
        mid = (big.start + big.end) // 2
        pieces += [Chunk(big.start, mid), Chunk(mid, big.end)]
    pieces.sort(key=lambda c: c.start)
    return pieces[:num_chunks] if len(pieces) > num_chunks else pieces


def watterson_estimate(
    seg: SegData,
    startpos: float | None = None,
    length: float | None = None,
) -> float:
    """Missingness-aware Watterson θ̂ per nt over the inference window
    (reference: model.py:567-621 inside define_chunks):

        θ̂ = segregating_sites / Σ_segments size · H(k−1)

    with k the number of non-missing alleles in the segment and H the
    harmonic number.  Used for the default N0 = θ̂ / (4 μ) when -N0 is not
    given (model.py:705-711)."""
    pos = seg.positions.astype(np.float64)
    ln = seg.lengths.astype(np.float64)
    if startpos is not None:
        keep = pos + ln >= startpos
        pos, ln = pos[keep], ln[keep]
        al = seg.alleles[keep]
    else:
        al = seg.alleles
    if length is not None and startpos is not None:
        keep = pos <= startpos + length
        pos, ln, al = pos[keep], ln[keep], al[keep]
    n = al.shape[1]
    non_missing = np.sum(al >= 0, axis=1)
    informative = non_missing > 0
    harmonic = np.concatenate(
        [[0.0], np.cumsum(1.0 / np.arange(1, max(n, 1) + 1))]
    )  # harmonic[k] = H(k)
    weighted_length = 1e-10 + float(
        np.sum(ln[informative]
               * harmonic[np.maximum(non_missing[informative] - 1, 0)])
    )
    segregating = int(
        np.sum(np.any(al == 0, axis=1) & np.any(al == 1, axis=1))
    )
    return segregating / weighted_length


def split_long_segments(seg: SegData, max_segment_length: float) -> SegData:
    """Split over-long segments into INVARIANT_PARTIAL pieces
    (segdata.cpp:121-145; max length = factor/(4*N0*rho), pfparam.cpp:364)
    so the per-step recombination loop stays bounded."""
    max_len = int(max_segment_length)
    if max_len <= 0 or np.all(seg.lengths <= max_len):
        return seg
    positions, lengths, states, alleles = [], [], [], []
    for s, l, st, al in zip(seg.positions, seg.lengths, seg.states, seg.alleles):
        start, remaining = int(s), int(l)
        while remaining > max_len:
            positions.append(start)
            lengths.append(max_len)
            states.append(SEGMENT_INVARIANT_PARTIAL)
            alleles.append(al)
            start += max_len
            remaining -= max_len
        positions.append(start)
        lengths.append(remaining)
        states.append(st)
        alleles.append(al)
    return SegData(
        positions=np.array(positions, dtype=np.int64),
        lengths=np.array(lengths, dtype=np.int64),
        states=np.array(states, dtype=np.int8),
        alleles=np.array(alleles, dtype=np.int8),
        phased=seg.phased,
    )


def slice_seg(seg: SegData, start: int, end: int) -> SegData:
    """Extract the data overlapping [start, end) — per-chunk input."""
    seg_end = seg.positions + seg.lengths
    mask = (seg_end > start) & (seg.positions < end)
    return SegData(
        positions=seg.positions[mask],
        lengths=seg.lengths[mask],
        states=seg.states[mask],
        alleles=seg.alleles[mask],
        phased=seg.phased,
    )
