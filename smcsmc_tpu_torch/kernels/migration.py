"""Structured populations with migration: the plain torch pieces of the
migration variant of the segment pass.

Counterparts in ``smcsmc_tpu/kernels/transition.py``: ``_filter_events``
(:1107), ``_merge_events_hold`` (:1125), the lock-step loop walk
``_walk_mig_batched`` (:339), the buffer routing of ``_apply_spr``
(:1170-1283) and the migration branch of ``recombination_transition``
(:1348-1437).  The JAX package's default walk (the jump walk) is not
ported: its asymmetric-migration fault is open, and the loop walk is the
one the port is held against.

Randomness.  A walk draws four uniforms per event and may take up to
``max_walk_events`` events, so its numbers are not pre-drawn: they come
from Philox-4x32-10 keyed by a per-segment key (two 32-bit words drawn
from the run's ``torch.Generator``) and counted by (particle, trip, event,
0).  :func:`philox4x32` computes it with int64 tensors (each 32-bit
product split into 16-bit halves so that nothing overflows), and the CUDA
kernel computes the same function, so both draw the same numbers.  The
point and the gap of a trip still take columns 0 and 3 of the pre-drawn
uniforms, as in the plain pass.

Every per-particle list here is ascending and INF-padded; a padded
destination is 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .arg import pick_desc, push_trip_rows, store_ring
from .bias import (
    MIGR_DELAY,
    BiasedPass,
    delay_code,
    epoch_index,
    guide_branch_rates,
    push_delayed,
    section_of,
)
from .guide import GuideTables, draw_gap, leaf_rates_at, span_log_iw
from .local import LocalPass, push_local_event
from .tree import (
    INF,
    Epochs,
    Trees,
    branch_lengths,
    descendant_bitmask,
    parent_time,
    tree_summaries,
)

# compile-time caps of the migration kernel (csrc/trip.cu MAX_POPS,
# MAX_MIG); the walk's event bound is the JAX package's max_walk_events
MAX_POPS = 4
MAX_MIG = 96
MAX_WALK_EVENTS = 256

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


class MigrationPass(NamedTuple):
    """What a migration segment pass reads and updates beyond the plain
    one.  ``pop``, the buffers and ``diag`` are updated IN PLACE."""

    pop: torch.Tensor  # [P, N] i32 population at each node's time
    mig_time: torch.Tensor  # [P, N, Mw] f32 branch migration events
    mig_dest: torch.Tensor  # [P, N, Mw] i32 their destinations
    diag: torch.Tensor  # [2] f64: walks capped, events dropped
    key: torch.Tensor  # [2] i32 the segment's Philox key
    ne: torch.Tensor  # [E, Pp] f32 diploid sizes
    mig: torch.Tensor  # [E, Pp, Pp] f32 backwards migration rates
    tot_mig: torch.Tensor  # [E, Pp] f32 total out-rate of each population
    pop_map: torch.Tensor  # [E, Pp] i32 -ej relabelling per epoch
    max_walk_events: int = MAX_WALK_EVENTS


def migration_tables(epochs):
    """(ne, mig, tot_mig, pop_map) of a structured ``Epochs``, contiguous;
    the total out-rates are summed once here, for kernel and plain version
    alike."""
    mig = epochs.mig.contiguous()
    return (epochs.ne.contiguous(), mig, mig.sum(dim=2).contiguous(),
            epochs.pop_map.to(torch.int32).contiguous())


STATS_FIELDS = ("coal_opp", "coal_cnt", "mig_opp", "mig_cnt", "recomb_opp",
                "recomb_cnt")


def stats_field_shapes(E: int, Pp: int):
    """Shapes of the fields of a flat statistics row, in the order of
    :data:`STATS_FIELDS`, each epoch-major (smc.py:53-131 of the JAX
    package)."""
    return [(E, Pp), (E, Pp), (E, Pp), (E, Pp, Pp), (E,), (E,)]


def stats_offsets(E: int, Pp: int) -> dict:
    """Column offset of each field of a flat statistics row
    [coal_opp E*Pp | coal_cnt E*Pp | mig_opp E*Pp | mig_cnt E*Pp*Pp |
    recomb_opp E | recomb_cnt E], and the row's ``width``."""
    out, k = {}, 0
    for name, shape in zip(STATS_FIELDS, stats_field_shapes(E, Pp)):
        out[name] = k
        k += math.prod(shape)
    out["width"] = k
    return out


# ---------------------------------------------------------------------------
# the counter-based generator
# ---------------------------------------------------------------------------


def philox4x32_int(ctr, key) -> tuple:
    """Philox-4x32-10 of four 32-bit counter words and two key words, in
    Python integers (the reference the tensor version is held to)."""
    c0, c1, c2, c3 = (int(x) & _MASK32 for x in ctr)
    k0, k1 = (int(x) & _MASK32 for x in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK32)
    return c0, c1, c2, c3


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for x in [0, 2^32) as int64, from
    16-bit halves of x so that no product reaches 2^63."""
    p1 = m * (x & 0xFFFF)
    p2 = m * (x >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return ((s >> 32) + (p2 >> 16)) & _MASK32, s & _MASK32


def philox4x32(ctr, key: torch.Tensor):
    """Philox-4x32-10 of counter words ``ctr`` (four int64 tensors or ints,
    broadcast together) under ``key`` ([2] integer tensor); returns four
    int64 tensors of 32-bit words."""
    c = [torch.as_tensor(x, dtype=torch.int64, device=key.device) & _MASK32
         for x in ctr]
    c = list(torch.broadcast_tensors(*c))
    k0 = key[0].to(torch.int64) & _MASK32
    k1 = key[1].to(torch.int64) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def uniforms_of(words) -> torch.Tensor:
    """[..., 4] float32 uniforms in [0, 1) from four 32-bit words: the top
    24 bits times 2^-24, exact in float32."""
    return torch.stack([(w >> 8).to(torch.float32) * (2.0 ** -24)
                        for w in words], dim=-1)


def walk_uniforms(key: torch.Tensor, trip: int, event: int, P: int,
                  count: int = 1):
    """[P, count, 4] uniforms of events ``event .. event + count - 1`` of
    trip ``trip`` for particles 0..P-1 (counter (particle, trip, event,
    0))."""
    ids = torch.arange(P, dtype=torch.int64, device=key.device)[:, None]
    events = torch.arange(event, event + count, dtype=torch.int64,
                          device=key.device)[None, :]
    return uniforms_of(philox4x32((ids, trip, events, 0), key))


# ---------------------------------------------------------------------------
# event lists
# ---------------------------------------------------------------------------


def _compact(keep, t, d, M: int):
    """The first ``M`` entries of ``t``/``d`` [..., K] where ``keep``, in
    their order, INF/0-padded."""
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    order = order[..., :M]
    k = keep.gather(-1, order)
    return (torch.where(k, t.gather(-1, order), INF),
            torch.where(k, d.gather(-1, order), 0))


def filter_events(ev_t, ev_d, lo, hi):
    """Keep the events with lo <= t < hi (``lo``/``hi`` [...] or floats),
    compacted to the left, INF-padded (transition.py:1107)."""
    lo = torch.as_tensor(lo, dtype=ev_t.dtype, device=ev_t.device)
    hi = torch.as_tensor(hi, dtype=ev_t.dtype, device=ev_t.device)
    keep = (ev_t >= lo[..., None]) & (ev_t < hi[..., None]) & (ev_t < INF)
    return _compact(keep, ev_t, ev_d, ev_t.shape[-1])


def merge_events_hold(t1, d1, t2, d2, M: int):
    """Merge two ascending INF-padded lists into capacity ``M``
    (transition.py:1125): ordered by time, ties in list order; on overflow
    the events with the smallest hold (time until the branch's next event;
    the last one's is unbounded) are dropped, of equal holds the later
    one.  Returns (times [..., M], dests [..., M], dropped [...])."""
    t = torch.cat([t1, t2], dim=-1)
    d = torch.cat([d1, d2], dim=-1)
    order = torch.argsort(t, dim=-1, stable=True)
    ts, ds = t.gather(-1, order), d.gather(-1, order)
    valid = ts < INF
    nxt = torch.cat([ts[..., 1:], torch.full_like(ts[..., :1], INF)], dim=-1)
    hold = torch.where(valid, nxt - ts, -1.0)
    by_hold = torch.argsort(-hold, dim=-1, stable=True)
    rank = torch.empty_like(by_hold).scatter_(
        -1, by_hold, torch.arange(ts.shape[-1], device=ts.device).expand_as(
            by_hold).contiguous())
    keep = (rank < M) & valid
    tk, dk = _compact(keep, ts, ds, M)
    dropped = (valid.sum(dim=-1) - M).clamp(min=0)
    return tk, dk, dropped


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[p, idx[p]] of [P, N, M] buffers -> [P, M] (idx < 0 reads row 0)."""
    i = idx.clamp(min=0).long()[:, None, None].expand(-1, 1, x.shape[2])
    return x.gather(1, i)[:, 0]


def _set_rows(x, idx, v):
    """x with row idx[p] of particle p set to v[p] ([P, M])."""
    hit = torch.arange(x.shape[1], device=x.device)[None, :] == idx[:, None]
    return torch.where(hit[:, :, None], v[:, None, :], x)


def _categorical_seq(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[P] index drawn in proportion to ``w`` [P, K]: the first index whose
    running sum (added left to right, as the kernel adds) exceeds u times
    the total; the last index of positive weight if rounding leaves none."""
    K = w.shape[1]
    total = torch.zeros_like(u)
    for q in range(K):
        total = total + w[:, q]
    x = u * total
    cum = torch.zeros_like(u)
    pick = torch.full_like(u, -1, dtype=torch.int32)
    last = torch.zeros_like(pick)
    for q in range(K):
        cum = cum + w[:, q]
        last = torch.where(w[:, q] > 0, q, last)
        pick = torch.where((pick < 0) & (cum > x), q, pick)
    return torch.where(pick < 0, last, pick)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def start_pop(mig_time, mig_dest, pop, c, h_r):
    """[P] the population the floating lineage starts in: c's at h_r,
    after c's own events below h_r (transition.py:402-405)."""
    mt_c, md_c = _rows(mig_time, c), _rows(mig_dest, c)
    k0 = (mt_c <= h_r[:, None]).sum(dim=1)
    return torch.where(k0 > 0, md_c.gather(1, (k0 - 1).clamp(min=0)[:, None]
                                           )[:, 0],
                       pop.gather(1, c.long()[:, None])[:, 0])


def walk_mig(mp: MigrationPass, trip: int, time, parent, c, h_r, active,
             epoch_start, pending, E: int, Pp: int):
    """The lock-step loop walk (transition.py:339-592) of every active
    particle from (c, h_r), drawing event j's uniforms from
    :func:`walk_uniforms` (trip, j).

    Below the root the floating lineage walks against its tree's branches,
    whose populations follow their stored migrations; above the root the
    root's lineage migrates too and the two coalesce when they share a
    population.  Per event: the epoch, the populations, k_same, the rates
    (coalescence k_same / 2Ne, the floating lineage's out-migration, above
    the root the root lineage's), the next breakpoint (node times, epoch
    starts, every stored event), the waiting time, then coalescence, a
    floating or a root migration.  The statistics go straight into
    ``pending`` [P, K] as they arise.  A walk that has not coalesced after
    ``mp.max_walk_events`` events coalesces onto the root lineage (capped).

    Returns (t_c, d, fpop_c, ev_t, ev_d, rev_t, rev_d, capped, events):
    the coalescence, its target and population, the floating and the root
    lineage's events ([P, 2 Mw], the last slot overwritten on overflow),
    [P] bool walks capped and [P] events each walk took."""
    P, N = time.shape
    Mw = mp.mig_time.shape[2]
    dev = time.device
    off = stats_offsets(E, Pp)
    f32, i32 = torch.float32, torch.int32
    mig_time, mig_dest, pop = mp.mig_time, mp.mig_dest, mp.pop
    pt = parent_time(time, parent)
    root = (parent < 0).to(i32).argmax(dim=1)
    root_h = time.gather(1, root[:, None].long())[:, 0]
    bks = torch.cat([time, epoch_start[None, :].expand(P, E),
                     mig_time.reshape(P, N * Mw)], dim=1)
    cols_N = torch.arange(N, device=dev)

    p_raw = start_pop(mig_time, mig_dest, pop, c, h_r)
    r_raw = pop.gather(1, root.long()[:, None])[:, 0]
    t = h_r.clone()
    done = ~active
    events = torch.zeros(P, dtype=torch.int64, device=dev)
    t_c = torch.zeros(P, device=dev)
    d = torch.full((P,), -1, dtype=i32, device=dev)
    fpop = torch.zeros(P, dtype=i32, device=dev)
    lists = {k: (torch.full((P, 2 * Mw), INF, device=dev),
                 torch.zeros((P, 2 * Mw), dtype=i32, device=dev),
                 torch.zeros(P, dtype=torch.int64, device=dev))
             for k in ("ev", "rev")}

    flat = pending.view(-1)
    row0 = torch.arange(P, device=dev) * pending.shape[1]

    def add(col, val, mask):
        # one addend per particle into its own row (0 where masked, which
        # leaves the row's value as it is), as the kernel adds them
        flat.index_add_(0, row0 + col.long(),
                        torch.where(mask, val, torch.zeros_like(val)))

    for j in range(mp.max_walk_events):
        go = ~done
        if not bool(go.any()):
            break
        if j % 16 == 0:  # the next 16 events' uniforms in one go
            block = walk_uniforms(mp.key, trip, j, P,
                                  min(16, mp.max_walk_events - j))
        u = block[:, j % 16]
        events += go.to(torch.int64)
        e = epoch_index(epoch_start, t)
        pm = mp.pop_map[e]  # [P, Pp]
        p_cur = pm.gather(1, p_raw.long()[:, None])[:, 0]
        r_cur = pm.gather(1, r_raw.long()[:, None])[:, 0]
        above = t >= root_h
        k_ev = (mig_time <= t[:, None, None]).sum(dim=2)  # [P, N]
        last = mig_dest.gather(2, (k_ev - 1).clamp(min=0)[:, :, None])[..., 0]
        last = torch.where(k_ev > 0, last, pop)
        bp = pm.gather(1, last.long())
        bp = torch.where(cols_N[None, :] == root[:, None], r_cur[:, None], bp)
        cand = ((time <= t[:, None]) & (t[:, None] < pt)
                & (bp == p_cur[:, None]))
        kc = cand.sum(dim=1)
        k_same = kc.to(f32)
        coal_rate = k_same / (2.0 * mp.ne[e, p_cur])
        mig_rate = mp.tot_mig[e, p_cur]
        root_rate = torch.where(above, mp.tot_mig[e, r_cur],
                                torch.zeros_like(mig_rate))
        total = coal_rate + mig_rate + root_rate
        t_bk = torch.where(bks > t[:, None], bks,
                           torch.full_like(bks, INF)).min(dim=1).values
        u_dt = u[:, 0].clamp(1e-7, 1.0 - 1e-7)
        dt = torch.where(total > 0, -torch.log1p(-u_dt)
                         / total.clamp(min=1e-30), torch.full_like(t, INF))
        hit_bk = t + dt >= t_bk
        t_next = torch.minimum(t + dt, t_bk)
        span = (t_next - t).clamp(min=0.0)
        span = torch.where(torch.isfinite(span) & go, span,
                           torch.zeros_like(span))
        ep = e * Pp
        add(off["coal_opp"] + ep + p_cur, k_same * span, go)
        add(off["mig_opp"] + ep + p_cur, span, go)
        add(off["mig_opp"] + ep + r_cur, span, go & above)

        x = u[:, 1] * total
        move = go & ~hit_bk
        is_coal = move & (x < coal_rate)
        is_fm = move & ~is_coal & (x < coal_rate + mig_rate)
        is_rm = move & ~is_coal & ~is_fm
        r = torch.floor(u[:, 2] * kc.clamp(min=1).to(f32)).to(i32)
        csum = cand.to(i32).cumsum(dim=1) - 1
        d_new = ((csum == r[:, None]) & cand).to(i32).argmax(dim=1).to(i32)
        add(off["coal_cnt"] + ep + p_cur, torch.ones_like(t), is_coal)
        mover = torch.where(is_rm, r_cur, p_cur)
        dest = _categorical_seq(mp.mig[e, mover], u[:, 3])
        add(off["mig_cnt"] + (ep + mover) * Pp + dest, torch.ones_like(t),
            is_fm | is_rm)
        for name, mask in (("ev", is_fm), ("rev", is_rm)):
            lt, ld, cnt = lists[name]
            slot = cnt.clamp(max=2 * Mw - 1)
            at = (torch.arange(2 * Mw, device=dev)[None, :] == slot[:, None]) \
                & mask[:, None]
            lists[name] = (torch.where(at, t_next[:, None], lt),
                           torch.where(at, dest[:, None], ld),
                           cnt + mask.to(torch.int64))

        t = torch.where(go, t_next, t)
        p_raw = torch.where(is_fm, dest, p_raw)
        r_raw = torch.where(is_rm, dest, r_raw)
        done = done | is_coal
        t_c = torch.where(is_coal, t_next, t_c)
        d = torch.where(is_coal, d_new, d)
        fpop = torch.where(is_coal, p_cur, fpop)
    ok = done | ~active
    d = torch.where(ok, d, root)
    t_c = torch.where(ok, t_c, torch.maximum(t, time.max(dim=1).values))
    fpop = torch.where(ok, fpop, r_raw)
    return (t_c, d, fpop, lists["ev"][0], lists["ev"][1], lists["rev"][0],
            lists["rev"][1], ~ok, events)


# ---------------------------------------------------------------------------
# the SPR with buffer routing
# ---------------------------------------------------------------------------


def apply_spr_mig(parent, time, child0, child1, pop, mig_time, mig_dest, c,
                  d, t_c, fpop_c, h_r, ev_t, ev_d, rev_t, rev_d):
    """The SPR of ``_apply_spr`` (transition.py:1170-1283) with its buffer
    routing, for every particle (the caller masks the inactive ones):

    * normal SPR: c's branch keeps its events below h_r and takes the
      walk's; o's merged branch takes o's and p's; the target's branch
      (o's merged one when d_eff == o), with the root lineage's walk events
      added when the target is the old root, splits at t_c into d_eff's
      (below) and the new node's (above);
    * self-coalescence (d == c): c's events in [h_r, t_c) are replaced by
      the walk's;
    * the row of the new root is emptied (the path above the root is drawn
      afresh by every walk).

    Returns (parent, time, child0, child1, pop, mig_time, mig_dest,
    dropped [P]): events dropped on overflow by the min-hold rule."""
    P, N = parent.shape
    M = mig_time.shape[2]
    dev = parent.device

    def pick(x, i):
        got = x.gather(1, i.clamp(min=0).long()[:, None])[:, 0]
        return torch.where(i >= 0, got, torch.zeros_like(got))

    p = pick(parent, c)
    sib0, sib1 = pick(child0, p), pick(child1, p)
    o = torch.where(sib0 == c, sib1, sib0)
    g = pick(parent, p)
    noop = d == c
    d_eff = torch.where(d == p, o, d)
    gp = torch.where(d_eff == o, g, pick(parent, d_eff))
    cols = torch.arange(N, device=dev)[None, :]

    def at(i):
        return cols == i[:, None]

    new_par = torch.where(at(o), g[:, None], parent)
    new_par = torch.where(at(d_eff), p[:, None], new_par)
    new_par = torch.where(at(p), gp[:, None], new_par)
    new_c0 = torch.where(at(g) & (child0 == p[:, None]), o[:, None], child0)
    new_c1 = torch.where(at(g) & (child1 == p[:, None]), o[:, None], child1)
    new_c0 = torch.where(at(p), c[:, None], new_c0)
    new_c1 = torch.where(at(p), d_eff[:, None], new_c1)
    new_c0 = torch.where(at(gp) & (new_c0 == d_eff[:, None]), p[:, None],
                         new_c0)
    new_c1 = torch.where(at(gp) & (new_c1 == d_eff[:, None]), p[:, None],
                         new_c1)
    new_time = torch.where(at(p), t_c[:, None], time)
    new_pop = torch.where(at(p), fpop_c[:, None], pop)

    mt_c, md_c = _rows(mig_time, c), _rows(mig_dest, c)
    lo_t, lo_d = filter_events(mt_c, md_c, -INF, h_r)
    c_t, c_d, dr1 = merge_events_hold(lo_t, lo_d, ev_t, ev_d, M)
    # ---- normal SPR ----
    o_t, o_d, dr2 = merge_events_hold(_rows(mig_time, o), _rows(mig_dest, o),
                                      _rows(mig_time, p), _rows(mig_dest, p), M)
    same = (d_eff == o)[:, None]
    do_t = torch.where(same, o_t, _rows(mig_time, d_eff))
    do_d = torch.where(same, o_d, _rows(mig_dest, d_eff))
    root_old = (parent < 0).to(torch.int32).argmax(dim=1)
    to_root = ((d == root_old) | (d_eff == root_old))[:, None]
    do_t, do_d, dr3 = merge_events_hold(
        do_t, do_d, torch.where(to_root, rev_t, INF),
        torch.where(to_root, rev_d, 0), M)
    dlow_t, dlow_d = filter_events(do_t, do_d, -INF, t_c)
    dhigh_t, dhigh_d = filter_events(do_t, do_d, t_c, INF)
    nm = _set_rows(_set_rows(_set_rows(_set_rows(
        mig_time, o, o_t), d_eff, dlow_t), c, c_t), p, dhigh_t)
    nd = _set_rows(_set_rows(_set_rows(_set_rows(
        mig_dest, o, o_d), d_eff, dlow_d), c, c_d), p, dhigh_d)
    # ---- self-coalescence ----
    hi_t, hi_d = filter_events(mt_c, md_c, t_c, INF)
    cs_t, cs_d, dr5 = merge_events_hold(c_t, c_d, hi_t, hi_d, M)
    keep = noop[:, None, None]
    nm = torch.where(keep, _set_rows(mig_time, c, cs_t), nm)
    nd = torch.where(keep, _set_rows(mig_dest, c, cs_d), nd)
    dropped = torch.where(noop, dr1 + dr5, dr1 + dr2 + dr3)

    k1 = noop[:, None]
    par_f = torch.where(k1, parent, new_par)
    root_f = (par_f < 0).to(torch.int32).argmax(dim=1)
    empty = at(root_f)[:, :, None]
    nm = torch.where(empty, INF, nm)
    nd = torch.where(empty, 0, nd)
    return (par_f, torch.where(k1, time, new_time),
            torch.where(k1, child0, new_c0), torch.where(k1, child1, new_c1),
            torch.where(k1, pop, new_pop), nm, nd, dropped)


def uniform_point(u_pt, time, parent):
    """(c, h_r): the first node whose running sum of branch lengths (added
    in node order) reaches u * the tree length; the last node if rounding
    leaves none (transition.py:108)."""
    P, N = time.shape
    bl = branch_lengths(time, parent)
    total = torch.zeros_like(u_pt)
    for j in range(N):
        total = total + bl[:, j]
    x = u_pt * total
    cum = torch.zeros_like(u_pt)
    c = torch.full((P,), -1, dtype=torch.int32, device=time.device)
    prev = torch.zeros_like(u_pt)
    for j in range(N):
        before = cum
        cum = cum + bl[:, j]
        hit = (c < 0) & (cum >= x)
        c = torch.where(hit, j, c)
        prev = torch.where(hit, before, prev)
    last = c < 0
    c = torch.where(last, N - 1, c)
    prev = torch.where(last, cum - bl[:, N - 1], prev)
    h_r = time.gather(1, c.long()[:, None])[:, 0] + (x - prev)
    return c, h_r


def biased_point_seq(u, time, parent, heights, strengths,
                     branch_rates=None):
    """``bias.biased_point`` with every sum taken one addend after the
    other in node-major order (node j's sections s, pair q = j S + s), as
    the migration kernel takes them: the weighted lengths' running sums,
    their total, the plain length and, with ``branch_rates`` [P, N], the
    length weighted by the strengths alone.  Returns (c, h_r, log_iw,
    strength, log_iw_bias) as ``biased_point`` does
    (transition.py:160 of the JAX package)."""
    P, N = time.shape
    S = strengths.shape[0]
    Q = N * S
    pt = parent_time(time, parent)
    lo = torch.maximum(time[:, :, None], heights[None, None, :-1])  # [P,N,S]
    hi = torch.minimum(pt[:, :, None], heights[None, None, 1:])
    seg = (hi - lo).clamp(min=0.0)
    seg = torch.where(parent[:, :, None] < 0, torch.zeros_like(seg), seg)
    wseg_bias = seg * strengths[None, None, :]
    wseg = (wseg_bias if branch_rates is None
            else wseg_bias * branch_rates[:, :, None])
    seg, wseg, wseg_bias = (x.reshape(P, Q) for x in (seg, wseg, wseg_bias))
    wtot = torch.zeros_like(u)
    ptot = torch.zeros_like(u)
    btot = torch.zeros_like(u)
    cum = torch.empty((P, Q), dtype=u.dtype, device=u.device)
    for q in range(Q):
        wtot = wtot + wseg[:, q]
        ptot = ptot + seg[:, q]
        if branch_rates is not None:
            btot = btot + wseg_bias[:, q]
        cum[:, q] = wtot
    x = u * wtot
    hit = cum >= x[:, None]
    idx = torch.where(hit.any(dim=1), hit.to(torch.int32).argmax(dim=1),
                      torch.full_like(hit[:, 0], Q - 1, dtype=torch.int64))
    prev = torch.where(
        idx > 0, cum.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0],
        torch.zeros_like(x))
    c = idx // S
    strength = strengths[idx % S]
    local_w = (strength if branch_rates is None
               else strength * branch_rates.gather(1, c[:, None])[:, 0])
    h_r = (lo.reshape(P, Q).gather(1, idx[:, None])[:, 0]
           + (x - prev) / local_w.clamp(min=1e-30))
    log_plain = torch.log(ptot.clamp(min=1e-30))
    log_iw = (torch.log(wtot) - log_plain
              - torch.log(local_w.clamp(min=1e-30)))
    if branch_rates is None:
        log_iw_bias = log_iw
    else:
        log_iw_bias = (torch.log(btot) - log_plain
                       - torch.log(strength.clamp(min=1e-30)))
    return c.to(torch.int32), h_r, log_iw, strength, log_iw_bias


def delay_height(code: int, h_r, t_c, ev_t):
    """[P] the height that keys a trip's delayed factor: the recombination
    point (code 0), the coalescence (1), or under ``-delay_migr``
    (:data:`bias.MIGR_DELAY`) the lower of the coalescence and the walk's
    first migration on the new branch (``ev_t[:, 0]``, INF if none;
    smc.py:980-989 of the JAX package)."""
    if code == 0:
        return h_r
    if code == MIGR_DELAY:
        return torch.minimum(t_c, ev_t[:, 0])
    return t_c


def migration_trips(uniforms, leaf_status, time, parent, child0, child1,
                    next_rec, upd, log_w, tl, B, tl_e, pending, L, mu, rho,
                    epoch_start, has_data, mp: MigrationPass, vb=None,
                    arg=None, biased: BiasedPass | None = None,
                    guide: GuideTables | None = None,
                    local: LocalPass | None = None):
    """The trips of a migration segment pass, IN PLACE (the migration
    branch of ``recombination_transition`` and the sweep's trip loop,
    smc.py:876-1080 of the JAX package): per trip and active particle the
    extension, the uniform point (uniform column 0), the loop walk, the
    recombination count, the SPR with buffer routing, the refreshed
    summaries and the next gap (column 3); walks capped and events dropped
    go into ``mp.diag``.  With ``vb`` = (vb_coal [E, Pp], vb_mig [E, Pp,
    Pp]) each trip adds to ``log_w`` the table entries of the coalescence
    and the migrations its walk records (smc.py:951-967): the trip's count
    rows (the change of ``pending``'s counts over the walk) times the
    tables, the coalescence's sum and then the migrations'.  With ``arg``
    (a ``kernels.arg.ArgPass``) each trip pushes its R, C and M rows
    (smc.py:1021-1052): the leaves below c and below the target in the
    tree before the SPR, the coalescence's population, and each of the
    walk's first hops from the population it left (the start population,
    then the hops' destinations, transition.py:1366) to its
    destination.

    With ``biased`` (a ``bias.BiasedPass``) the point is height-biased
    (:func:`biased_point_seq`, the same uniform), the posterior weight
    takes its importance weight after the VB term, the pilot weight the
    extension, the VB term and the immediate part, and the delayed part
    goes into the particle's ring at ``front + next_rec`` (smc.py:968-1020),
    its delay keyed by :func:`delay_height` (under ``-delay_migr`` the
    walk's first migration where it lies below the coalescence).  With
    ``guide`` (and ``biased``) each extension takes the guide's survival
    weight in both weights, the point's segments are weighed by the
    branches' guide rates at the event's window and the gap is drawn in
    guide mass.  With ``local`` each trip's event goes into the particle's
    ring of pending local events (smc.py:1054-1069): at ``front +
    next_rec``, due a lag of h_r's epoch later, with the leaves below c in
    the tree before the SPR."""
    E, Pp = epoch_start.shape[0], mp.ne.shape[1]
    off = stats_offsets(E, Pp)
    counts = slice(off["coal_cnt"], off["coal_cnt"] + E * Pp)
    mig_counts = slice(off["mig_cnt"], off["mig_cnt"] + E * Pp * Pp)
    epochs = Epochs(start=epoch_start, ne=mp.ne)
    f32 = torch.float32
    cur = dict(time=time, parent=parent, child0=child0, child1=child1,
               pop=mp.pop, mig_time=mp.mig_time, mig_dest=mp.mig_dest,
               next_rec=next_rec, upd=upd, log_w=log_w, tl=tl, B=B,
               tl_e=tl_e)
    b = biased
    if b is not None:
        cur.update(log_pilot=b.log_pilot, df_pos=b.df_pos, df_logf=b.df_logf,
                   df_delta=b.df_delta, df_k=b.df_k)
        code = delay_code(b.delay_type, True)
    if local is not None:
        cur.update(lr_pos=local.lr_pos, lr_due=local.lr_due,
                   lr_time=local.lr_time, lr_desc=local.lr_desc,
                   lr_dropped=local.lr_dropped)
    start = dict(cur)
    diag = mp.diag.clone()
    aring = None if arg is None else arg.ring
    for j in range(uniforms.shape[0]):
        active = cur["next_rec"] < L
        if not bool(active.any()):
            break
        u = uniforms[j].clamp(1e-7, 1.0 - 1e-7)
        nr, up = cur["next_rec"], cur["upd"]
        zero = torch.zeros_like(nr)
        delta = torch.where(active, nr - up, zero)
        cur["log_w"] = cur["log_w"] - mu * cur["B"] * delta
        if b is not None:
            cur["log_pilot"] = cur["log_pilot"] - mu * cur["B"] * delta
        if guide is not None:
            liw = torch.where(active, span_log_iw(
                guide, rho, cur["tl"], up + b.front, nr + b.front), zero)
            cur["log_w"] = cur["log_w"] + liw
            cur["log_pilot"] = cur["log_pilot"] + liw
        pending[:, off["recomb_opp"]:off["recomb_opp"] + E] += \
            delta[:, None] * cur["tl_e"]
        if b is None:
            c, h_r = uniform_point(u[:, 0], cur["time"], cur["parent"])
        else:
            rates = (None if guide is None else guide_branch_rates(
                cur["time"], cur["parent"], cur["child0"], cur["child1"],
                leaf_rates_at(guide, nr + b.front)))
            c, h_r, log_iw, strength, log_iw_bias = biased_point_seq(
                u[:, 0], cur["time"], cur["parent"], b.heights, b.strengths,
                rates)
        walk_mp = mp._replace(pop=cur["pop"], mig_time=cur["mig_time"],
                              mig_dest=cur["mig_dest"])
        if vb is not None:
            before = (pending[:, counts].clone(), pending[:, mig_counts].clone())
        (t_c, d, fpop, ev_t, ev_d, rev_t, rev_d, capped, _) = walk_mig(
            walk_mp, j, cur["time"], cur["parent"], c, h_r, active,
            epoch_start, pending, E, Pp)
        if vb is not None:
            term_c = ((pending[:, counts] - before[0])
                      * vb[0].reshape(-1)).sum(dim=1)
            term_m = ((pending[:, mig_counts] - before[1])
                      * vb[1].reshape(-1)).sum(dim=1)
            term = term_c + term_m
            cur["log_w"] = cur["log_w"] + term
            if b is not None:
                cur["log_pilot"] = cur["log_pilot"] + term
        if b is not None:
            # the posterior takes the whole importance weight, the pilot
            # its height-bias part where the delay height's section is
            # unbiased, the ring the rest (smc.py:968-1020)
            cur["log_w"] = cur["log_w"] + torch.where(active, log_iw, zero)
            d_h = delay_height(code, h_r, t_c, ev_t)
            strength_h = (strength if code == 0
                          else b.strengths[section_of(b.heights, d_h)])
            imm = torch.where((strength_h - 1.0).abs() < 1e-6, log_iw_bias,
                              zero)
            late = log_iw - imm
            cur["log_pilot"] = cur["log_pilot"] + torch.where(active, imm,
                                                              zero)
            delay = b.delays[epoch_index(epoch_start, d_h)]
            (cur["df_pos"], cur["df_logf"], cur["df_delta"], cur["df_k"],
             overflow) = push_delayed(
                cur["df_pos"], cur["df_logf"], cur["df_delta"], cur["df_k"],
                active & (late.abs() > 1e-9), nr + b.front, delay, late,
                b.delay_k)
            cur["log_pilot"] = cur["log_pilot"] + overflow
        if arg is not None or local is not None:
            desc = descendant_bitmask(cur["parent"])
        if arg is not None:
            p0 = start_pop(cur["mig_time"], cur["mig_dest"], cur["pop"], c,
                           h_r)
            aring = push_trip_rows(
                aring, active, nr + arg.front, h_r, t_c, fpop,
                pick_desc(desc, c), pick_desc(desc, d),
                (ev_t, torch.cat([p0[:, None], ev_d[:, :-1]], dim=1), ev_d))
        e_r = epoch_index(epoch_start, h_r)
        if local is not None:
            pos = nr + local.front
            (cur["lr_pos"], cur["lr_due"], cur["lr_time"], cur["lr_desc"],
             cur["lr_dropped"]) = push_local_event(
                cur["lr_pos"], cur["lr_due"], cur["lr_time"], cur["lr_desc"],
                cur["lr_dropped"], active, pos, pos + local.lags[e_r], h_r,
                pick_desc(desc, c))
        pending[:, off["recomb_cnt"]:off["recomb_cnt"] + E] += (
            (torch.arange(E, device=time.device)[None, :] == e_r[:, None])
            & active[:, None]).to(f32)
        out = apply_spr_mig(cur["parent"], cur["time"], cur["child0"],
                            cur["child1"], cur["pop"], cur["mig_time"],
                            cur["mig_dest"], c, d, t_c, fpop, h_r, ev_t,
                            ev_d, rev_t, rev_d)
        a1 = active[:, None]
        for k, v in zip(("parent", "time", "child0", "child1", "pop",
                         "mig_time", "mig_dest"), out[:7]):
            cur[k] = torch.where(active.view(-1, *([1] * (v.dim() - 1))),
                                 v, cur[k])
        diag[0] += (capped & active).sum().double()
        diag[1] += torch.where(active, out[7], 0).sum().double()
        tl2, tle2, B2 = tree_summaries(
            Trees(cur["parent"], cur["time"], cur["child0"], cur["child1"]),
            epochs, leaf_status, has_data)
        cur["tl"] = torch.where(active, tl2, cur["tl"])
        cur["B"] = torch.where(active, B2, cur["B"])
        cur["tl_e"] = torch.where(a1, tle2, cur["tl_e"])
        x_gap = -torch.log1p(-u[:, 3])
        if guide is None:
            gap = x_gap / (rho * cur["tl"]).clamp(min=1e-30)
        else:
            gap = draw_gap(guide, x_gap, rho, cur["tl"], nr + b.front)
        cur["upd"] = torch.where(active, nr, up)
        cur["next_rec"] = torch.where(active, nr + gap, nr)
    for k, dst in start.items():
        if cur[k] is not dst:
            dst.copy_(cur[k])
    mp.diag.copy_(diag)
    store_ring(arg, aring)
