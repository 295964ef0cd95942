# Copied from smcsmc_tpu/lookahead.py at commit 8392f87; keep it letter for letter.
"""Host-side lookahead statistics for the Auxiliary Particle Filter (-apf).

Faithful reimplementation of ``Segment::set_lookahead``
(src/segdata.cpp:225-410): for each segment (= each position
the sweep will stop at) scan *forward* through upcoming variants and record

- per lineage: the distance to its first singleton (signed: negative means
  "no singleton seen within |distance|" — either a long missing streak or the
  end of the data), and the relative mutation rate correcting for missing
  data (total_length_times_branches_missing / total_length_times_branches);
- doubletons ("cherries"): pairs of lineages carrying a shared mutation, with
  the distance of the first and of the last *compatible* evidence
  (phasing-aware incompatibility freezes last_evidence, segdata.cpp:338-357);
- the first "split": a variant with >2 carriers and >2 non-carriers, with its
  allele vector and minor count (segdata.cpp:375-380).

Deviations from the reference (deliberate):
- rows produced by long-segment splitting (SEGMENT_INVARIANT_PARTIAL) are
  treated as mutation-free extensions; the reference's scan re-reads the
  allele vector on every partial piece (segdata.cpp:125-145 keeps the allele
  copy) and so double-counts split mutations.
- the reference marks a lineage hit by a >2Mb missing streak with
  first_singleton_distance = -epsilon via a comparison that is always true
  (segdata.cpp:295-297: a negative LHS against a positive RHS); we reproduce
  the resulting behavior (-epsilon) directly.

The arrays returned are fixed-shape so they can ride the device scan as
additional per-segment inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .segio import SEGMENT_INVARIANT, SegData

MAX_MISSING_DATA = 2_000_000.0  # segdata.cpp:244
_EPS = 1e-6


@dataclass
class LookaheadData:
    """Per-segment APF statistics ([S] leading axis; D = doubleton slots)."""

    fsd: np.ndarray  # [S, n] f32 signed first-singleton distance
    rel_mu: np.ndarray  # [S, n] f32 relative mutation rate
    unphased: np.ndarray  # [S, n] bool: singleton was an unphased het (even
    #                       index of the pair; the odd partner mirrors fsd)
    dbl_s1: np.ndarray  # [S, D] i32, -1 = empty slot
    dbl_s2: np.ndarray  # [S, D] i32
    dbl_first: np.ndarray  # [S, D] f32 first_evidence_distance
    dbl_last: np.ndarray  # [S, D] f32 last_evidence_distance
    dbl_unph1: np.ndarray  # [S, D] bool
    dbl_unph2: np.ndarray  # [S, D] bool
    split_dist: np.ndarray  # [S] f32, -1 = no split seen
    split_alleles: np.ndarray  # [S, n] i8
    split_k: np.ndarray  # [S] i32 minor allele count at the split


def _pad_block(la: LookaheadData, pad: int) -> LookaheadData:
    n = la.fsd.shape[1]
    D = la.dbl_s1.shape[1]
    return LookaheadData(
        fsd=np.concatenate([la.fsd, -_EPS * np.ones((pad, n), np.float32)]),
        rel_mu=np.concatenate([la.rel_mu, np.ones((pad, n), np.float32)]),
        unphased=np.concatenate([la.unphased, np.zeros((pad, n), bool)]),
        dbl_s1=np.concatenate([la.dbl_s1, -np.ones((pad, D), np.int32)]),
        dbl_s2=np.concatenate([la.dbl_s2, -np.ones((pad, D), np.int32)]),
        dbl_first=np.concatenate([la.dbl_first, np.zeros((pad, D), np.float32)]),
        dbl_last=np.concatenate([la.dbl_last, np.zeros((pad, D), np.float32)]),
        dbl_unph1=np.concatenate([la.dbl_unph1, np.zeros((pad, D), bool)]),
        dbl_unph2=np.concatenate([la.dbl_unph2, np.zeros((pad, D), bool)]),
        split_dist=np.concatenate([la.split_dist, -np.ones(pad, np.float32)]),
        split_alleles=np.concatenate(
            [la.split_alleles, -np.ones((pad, n), np.int8)]
        ),
        split_k=np.concatenate([la.split_k, np.zeros(pad, np.int32)]),
    )


def _native_lookahead():
    """ctypes handle to the C scan (native/lookahead.c), if built."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    import ctypes
    import os

    so = os.path.join(os.path.dirname(__file__), "_lookahead.so")
    if not os.path.exists(so):
        _NATIVE = False
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.lookahead_scan  # symbol check before committing to the binary
    except (OSError, AttributeError):
        # stale/foreign-ABI binary (e.g. built elsewhere): fall back to the
        # Python oracle instead of crashing; `make native` rebuilds it
        _NATIVE = False
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.lookahead_scan.restype = None
    lib.lookahead_scan.argtypes = [
        ctypes.c_long, ctypes.c_int, ctypes.c_int,
        f64p, f64p, i8p, u8p,
        f32p, f32p, u8p, i32p, i32p, f32p, f32p, u8p, u8p,
        f32p, i8p, i32p,
    ]
    _NATIVE = lib
    return lib


_NATIVE = None


def compute_lookahead(seg: SegData, max_doubletons: int | None = None) -> LookaheadData:
    """Scan-forward APF statistics for every segment (segdata.cpp:225-410).

    Dispatches to the C scanner (native/lookahead.c) when built — the
    Python scan below is the oracle (~3 ms/segment at n=8; the C path is
    >100x faster) and the fallback."""
    lib = _native_lookahead()
    if lib is not None:
        return _compute_lookahead_native(lib, seg, max_doubletons)
    return compute_lookahead_py(seg, max_doubletons)


def _compute_lookahead_native(lib, seg: SegData, max_doubletons):
    S, n = seg.alleles.shape
    if n > 64:
        return compute_lookahead_py(seg, max_doubletons)
    D = min(max_doubletons or max(n, 2), 256)
    pos = np.ascontiguousarray(seg.positions, np.float64)
    ln = np.ascontiguousarray(seg.lengths, np.float64)
    al = np.ascontiguousarray(seg.alleles, np.int8)
    is_mut_row = np.ascontiguousarray(
        ((seg.states == SEGMENT_INVARIANT) & np.any(al > 0, axis=1)).astype(
            np.uint8
        )
    )
    out = LookaheadData(
        fsd=np.zeros((S, n), np.float32),
        rel_mu=np.ones((S, n), np.float32),
        unphased=np.zeros((S, n), np.uint8),
        dbl_s1=-np.ones((S, D), np.int32),
        dbl_s2=-np.ones((S, D), np.int32),
        dbl_first=np.zeros((S, D), np.float32),
        dbl_last=np.zeros((S, D), np.float32),
        dbl_unph1=np.zeros((S, D), np.uint8),
        dbl_unph2=np.zeros((S, D), np.uint8),
        split_dist=-np.ones(S, np.float32),
        split_alleles=-np.ones((S, n), np.int8),
        split_k=np.zeros(S, np.int32),
    )
    lib.lookahead_scan(
        S, n, D, pos, ln, al, is_mut_row,
        out.fsd, out.rel_mu, out.unphased,
        out.dbl_s1, out.dbl_s2, out.dbl_first, out.dbl_last,
        out.dbl_unph1, out.dbl_unph2,
        out.split_dist, out.split_alleles, out.split_k,
    )
    return LookaheadData(
        fsd=out.fsd, rel_mu=out.rel_mu, unphased=out.unphased.astype(bool),
        dbl_s1=out.dbl_s1, dbl_s2=out.dbl_s2, dbl_first=out.dbl_first,
        dbl_last=out.dbl_last, dbl_unph1=out.dbl_unph1.astype(bool),
        dbl_unph2=out.dbl_unph2.astype(bool), split_dist=out.split_dist,
        split_alleles=out.split_alleles, split_k=out.split_k,
    )


def compute_lookahead_py(seg: SegData, max_doubletons: int | None = None) -> LookaheadData:
    """Pure-Python oracle for the lookahead scan (see compute_lookahead)."""
    S, n = seg.alleles.shape
    D = max_doubletons or max(n, 2)
    pos = seg.positions.astype(np.float64)
    ln = seg.lengths.astype(np.float64)
    al = seg.alleles  # [S, n] int8
    is_mut_row = (seg.states == SEGMENT_INVARIANT) & np.any(al > 0, axis=1)
    any_data = ~np.all(al == -1, axis=1)
    n_missing_row = np.sum(al == -1, axis=1)

    out = LookaheadData(
        fsd=np.zeros((S, n), np.float32),
        rel_mu=np.ones((S, n), np.float32),
        unphased=np.zeros((S, n), bool),
        dbl_s1=-np.ones((S, D), np.int32),
        dbl_s2=-np.ones((S, D), np.int32),
        dbl_first=np.zeros((S, D), np.float32),
        dbl_last=np.zeros((S, D), np.float32),
        dbl_unph1=np.zeros((S, D), bool),
        dbl_unph2=np.zeros((S, D), bool),
        split_dist=-np.ones(S, np.float32),
        split_alleles=-np.ones((S, n), np.int8),
        split_k=np.zeros(S, np.int32),
    )

    for i in range(S):
        fsd = np.zeros(n)
        rel_mu = np.zeros(n)
        unph = np.zeros(n, bool)
        found_dbl = np.zeros(n, bool)
        doubletons: list[list] = []  # [s1, s2, first, last, u1, u2, incompat]
        num_singletons = 0
        num_unph_singletons = 0
        num_dbl_seq = 0
        tlb = 0.1  # total_length_times_branches (segdata.cpp:250)
        tlbm = 0.1
        cur_missing = 0.0
        last_sing_dist = 0.0
        distance = 0.0
        base = pos[i]

        for j in range(i, S):
            a = al[j]
            mut_row = is_mut_row[j]
            # per-lineage variant/missing bookkeeping (segdata.cpp:263-306)
            num_var = 0
            s1 = s2 = -1
            sing_unph = np.zeros(n, bool)
            num_missing = int(n_missing_row[j])
            if num_missing:
                cur_missing += ln[j]
            k = 0
            while k < n:
                if mut_row and a[k] > 0:
                    num_var += 1
                    if num_var == 1:
                        s1 = k
                    elif num_var == 2:
                        s2 = k
                    if a[k] == 2:
                        sing_unph[k] = True
                        if k + 1 < n:
                            sing_unph[k + 1] = True
                        k += 1  # skip the pair partner
                k += 1
            if cur_missing > MAX_MISSING_DATA:
                miss = a == -1
                for jj in np.nonzero(miss)[0]:
                    if fsd[jj] == 0:
                        # long missing streak: give up on this lineage
                        # (segdata.cpp:288-300; effective value is -epsilon)
                        last_sing_dist = pos[j] - base
                        fsd[jj] = -_EPS
                        rel_mu[jj] = tlbm / tlb
                        num_singletons += 1
                    if not found_dbl[jj]:
                        found_dbl[jj] = True
                        num_dbl_seq += 1
            if num_missing == 0:
                cur_missing = 0.0
            tlb += ln[j] * n
            tlbm += ln[j] * (n - num_missing)
            if cur_missing > MAX_MISSING_DATA:
                continue

            have_dbl = False
            distance = pos[j] + ln[j] - base + 0.5
            if num_var == 1:  # singleton (segdata.cpp:319-334)
                if fsd[s1] == 0:
                    fsd[s1] = distance
                    rel_mu[s1] = tlbm / tlb
                    num_singletons += 1
                    last_sing_dist = distance
                    if sing_unph[s1]:
                        unph[s1] = True
                        if s1 + 1 < n:
                            fsd[s1 + 1] = distance
                            rel_mu[s1 + 1] = rel_mu[s1]
                        num_singletons += 1
                        num_unph_singletons += 1
            elif mut_row:  # non-singleton variant (segdata.cpp:335-357)
                for d in doubletons:
                    ds1, ds2 = d[0], d[1]
                    if ((ds1 | 1) == ds2 and a[ds1] == 2) or (
                        a[ds1] >= 0
                        and a[ds2] >= 0
                        and a[ds1] + a[ds2] == 1
                        and (a[ds1] | a[ds2]) == 1
                    ):
                        d[6] = True  # incompatible
                    if num_var == 2 and ds1 == s1 and ds2 == s2:
                        have_dbl = True
                        if not d[6]:
                            d[3] = distance  # last compatible evidence
            # enter new doubleton (segdata.cpp:359-373)
            if (
                num_var == 2
                and not have_dbl
                and a[s1] > -1
                and a[s2] > -1
                and len(doubletons) < D
            ):
                entered = False
                for d1 in range(1 + (a[s1] == 2)):
                    for d2 in range(1 + (a[s2] == 2)):
                        if entered:
                            break
                        i1, i2 = s1 + d1, s2 + d2
                        if i1 < n and i2 < n and not found_dbl[i1] and not found_dbl[i2]:
                            doubletons.append(
                                [s1, s2, distance, distance,
                                 a[s1] == 2, a[s2] == 2, False]
                            )
                            found_dbl[i1] = True
                            found_dbl[i2] = True
                            num_dbl_seq += 2
                            entered = True
                    if entered:
                        break
            # first split (segdata.cpp:375-380)
            if (
                out.split_dist[i] < 0
                and mut_row
                and num_var > 2
                and n - num_var > 2
            ):
                out.split_dist[i] = distance
                out.split_alleles[i] = a
                out.split_k[i] = min(num_var, n - num_var)
            # bail-outs (segdata.cpp:382-387)
            if num_singletons >= n and num_dbl_seq >= n - 1:
                break
            if (
                num_singletons >= n
                and distance > (2 + num_unph_singletons) * last_sing_dist
            ):
                break

        # fill in lineages with no singleton found (segdata.cpp:389-396)
        for jj in range(n):
            if fsd[jj] == 0:
                fsd[jj] = -distance
                rel_mu[jj] = tlbm / tlb
        out.fsd[i] = fsd
        out.rel_mu[i] = rel_mu
        out.unphased[i] = unph
        for di, d in enumerate(doubletons[:D]):
            out.dbl_s1[i, di] = d[0]
            out.dbl_s2[i, di] = d[1]
            out.dbl_first[i, di] = d[2]
            out.dbl_last[i, di] = d[3]
            out.dbl_unph1[i, di] = d[4]
            out.dbl_unph2[i, di] = d[5]
    return out
