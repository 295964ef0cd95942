"""The recombination trip and a segment's tree pass: plain torch versions
and the wrappers of the CUDA kernels (``csrc/trip.cu``).

Counterpart of the Pallas kernel ``smcsmc_tpu/kernels/pallas_trip.py``
(``_trip_kernel`` :91, entered through ``fused_trip`` :356).  One trip, per
particle whose next recombination ``next_rec`` lies inside the segment
(``next_rec < L``):

1. the no-mutation weight update ``log_w -= mu*B*delta`` and the
   recombination opportunity ``delta*tl_e``;
2. a uniform recombination point (c, h_r) on the local tree;
3. the SMC' re-coalescence time t_c, inverting the piecewise-linear hazard
   sum k(t)/2Ne(t) over the candidates {node times} U {epoch starts};
4. a uniform coalescence target among the branches crossing t_c;
5. coal opp/cnt, mig opp and recomb cnt added into ``pending``;
6. the SPR on the parent/child arrays and ``time``;
7. refreshed ``tl``, ``tl_e`` and data branch length ``B`` (``leaf_status``
   -1 gives 0, 1 gives tl, 0 the informative branches only);
8. the next gap, Exp(1)/(rho*tl).

Randomness comes in as four pre-drawn uniforms per particle and trip
(``uniforms[j]`` is trip j's row), so the plain version, the CUDA kernel and
the JAX reference can be fed identical numbers.  Both versions update their
tensor arguments IN PLACE; particles that are inactive keep every value.

``segment_pass`` is what the sweep launches once per segment: the tree
summaries at segment entry, all trips of the segment, the final extension
to the segment end and the push of the segment's statistics into FIFO slot
0, so that ``upd`` and ``pending`` stay inside the kernel.  Given a
``bias.BiasedPass`` it is the biased pass (a compile-time variant of the
kernel): each trip's point is height-biased, the posterior weight takes the
importance weight, the pilot weight tracks the immediate part and a ring of
delayed factors the rest, drained at the segment end.  ``trip`` is the same
device code behind the interface of the Pallas kernel, which is how it is
held against ``fused_trip``; the lag calibration launches it one trip at a
time.  Given a ``migration.MigrationPass`` it is the migration pass (a
further variant, a warp per particle): each trip's
re-coalescence is the loop walk of a structured population with migration
and the SPR routes the branches' migration buffers; the statistics row is
the structured layout of ``migration.stats_offsets``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ._build import load_trip_library
from .bias import (
    DELAY_TYPES,
    MAX_DELAY_SLOTS,
    MAX_SECTIONS,
    BiasedPass,
    apply_due_delayed,
    biased_point,
    delay_code,
    epoch_index,
    guide_branch_rates,
    push_delayed,
    section_of,
)
from .arg import ArgPass, pick_desc, push_trip_rows, store_ring
from .guide import (
    SEARCH_NODES,
    GuideTables,
    draw_gap,
    leaf_rates_at,
    span_log_iw,
)
from .local import MAX_LOCAL_SLOTS, LocalPass, push_local_event
from .migration import (
    MAX_MIG,
    MAX_POPS,
    MAX_WALK_EVENTS,
    MigrationPass,
    migration_trips,
    stats_field_shapes,
    stats_offsets,
)
from .tree import (
    INF,
    Epochs,
    Trees,
    _pick,
    branch_lengths,
    data_branch_length,
    descendant_bitmask,
    parent_time,
    tree_summaries,
)

# compile-time caps of the CUDA kernel (csrc/trip.cu MAX_LEAVES/MAX_EPOCHS):
# the narrow kernels take up to MAX_LEAVES leaves; the wide ones (the plain
# and biased passes, the guided and local passes, each with and without VB,
# the plain pass's ARG variant and trip) up to WIDE_MAX_LEAVES
MAX_LEAVES = 8
WIDE_MAX_LEAVES = 64
MAX_EPOCHS = 64

# the tensors a trip updates, in argument order
FIELDS = ("time", "parent", "child0", "child1", "next_rec", "upd", "log_w",
          "tl", "B", "tl_e", "pending")
TREE_FIELDS = ("parent", "child0", "child1")
# what the biased segment pass updates beyond the plain one
BIAS_FIELDS = ("log_pilot", "df_pos", "df_logf", "df_delta", "df_k")
FLOAT_FIELDS = tuple(k for k in FIELDS if k not in TREE_FIELDS) + BIAS_FIELDS


def _onehot(idx: torch.Tensor, N: int) -> torch.Tensor:
    """[P] index -> [P, N] one-hot (all False for idx < 0)."""
    return torch.arange(N, device=idx.device)[None, :] == idx[:, None]


class TripRecord(NamedTuple):
    """What one trip hands back beyond the updated tensors, per particle
    (values of inactive particles are not meaningful)."""

    h_r: torch.Tensor  # recombination height
    t_c: torch.Tensor  # coalescence height
    log_iw: torch.Tensor  # importance weight of the point (0 unbiased)
    strength: torch.Tensor  # bias strength of the point's section
    log_iw_bias: torch.Tensor  # its height-bias part (log_iw unguided)
    c: torch.Tensor  # [P] i32 the node whose branch was cut
    d: torch.Tensor  # [P] i32 the coalescence target, before the SPR


def _trip(u, leaf_status, time, parent, child0, child1, next_rec, upd,
          log_w, tl, B, tl_e, pending, L, mu, rho, est, eend, i2n,
          has_data, bias=None, guide: GuideTables | None = None,
          front: float = 0.0):
    """One trip over the population; returns the updated tensors and the
    trip's :class:`TripRecord`.

    Follows ``pallas_trip._trip_kernel`` step for step, except for the
    mixed-data branch length, which is computed as ``data_branch_length``
    (the kernel's ancestor-chain walk restarts at node 0 after passing the
    root; see ROADMAP, faults).  ``bias`` = (heights [S+1], strengths [S])
    draws the point with :func:`bias.biased_point` instead (log_iw 0 and
    strength 1 without it); a third entry, the leaves' guide rates [P, n]
    at the event's window, weighs each branch by its guide rate
    (:func:`bias.guide_branch_rates` of the tree before the trip).
    ``guide`` draws the next gap from the guide at ``front + next_rec``
    (:func:`guide.draw_gap`)."""
    P, N = time.shape
    E = est.shape[0]
    f32 = torch.float32
    u = u.clamp(1e-7, 1.0 - 1e-7)
    u_pt, u_exp, u_tgt, u_gap = u[:, 0], u[:, 1], u[:, 2], u[:, 3]
    zero = torch.zeros_like(next_rec)
    inf = torch.full_like(next_rec, INF)

    active = next_rec < L
    delta = torch.where(active, next_rec - upd, zero)

    # ---- extension: no-mutation likelihood + recombination opportunity ----
    log_w = log_w - mu * B * delta
    recomb_opp_add = delta[:, None] * tl_e  # [P, E]

    # ---- recombination point: uniform (or height-biased) on the tree ------
    pt = parent_time(time, parent)
    if bias is None:
        bl = branch_lengths(time, parent)
        cum = bl.cumsum(dim=1)
        total = cum[:, N - 1]
        x_pt = u_pt * total
        hit = cum >= x_pt[:, None]
        c = torch.where(hit.any(dim=1), hit.to(torch.int32).argmax(dim=1),
                        torch.full_like(parent[:, 0], -1)).to(torch.int32)
        cc = c[:, None]
        prev = _pick(cum, cc)[:, 0] - _pick(bl, cc)[:, 0]
        h_r = _pick(time, cc)[:, 0] + (x_pt - prev)
        log_iw, strength = zero, torch.ones_like(zero)
        log_iw_bias = zero
    else:
        rates = (None if len(bias) < 3 else
                 guide_branch_rates(time, parent, child0, child1, bias[2]))
        c, h_r, log_iw, strength, log_iw_bias = biased_point(
            u_pt, time, parent, bias[0], bias[1], rates)
        cc = c[:, None]

    # ---- hazard inversion over the (epoch x node) grid --------------------
    # lam(v) = sum_{e,j} inv2ne_e * |branch_j ∩ epoch_e ∩ [h_r, v]|
    lo = torch.maximum(time[:, None, :],
                       torch.maximum(est[None, :, None], h_r[:, None, None]))
    hi = torch.minimum(pt[:, None, :], eend[None, :, None])  # [P, E, N]
    w = i2n[None, :, None]
    x_exp = -torch.log1p(-u_exp)
    vcand = torch.cat([time, est[None, :].expand(P, E)], dim=1)  # [P, V]
    ov = (torch.minimum(hi[:, None], vcand[:, :, None, None])
          - lo[:, None]).clamp(min=0.0)  # [P, V, E, N]
    lam_v = (ov * w[:, None]).sum(dim=(2, 3))
    t_lo = torch.where(lam_v <= x_exp[:, None], vcand,
                       torch.full_like(vcand, -INF)).max(dim=1).values
    t_lo = torch.maximum(t_lo, h_r)
    lam_lo = ((torch.minimum(hi, t_lo[:, None, None]) - lo).clamp(min=0.0)
              * w).sum(dim=(1, 2))
    in_e_lo = (t_lo[:, None] >= est[None]) & (t_lo[:, None] < eend[None])
    inv2ne_lo = torch.where(in_e_lo, i2n[None], 0.0).sum(dim=1)
    k_lo = ((time <= t_lo[:, None]) & (t_lo[:, None] < pt)).to(f32).sum(dim=1)
    rate_lo = k_lo * inv2ne_lo
    t_c = t_lo + torch.where(rate_lo > 0,
                             (x_exp - lam_lo) / rate_lo.clamp(min=1e-30), inf)
    t_c = t_c.clamp(max=0.99 * INF)

    # ---- coalescence target -----------------------------------------------
    cross = (time <= t_c[:, None]) & (t_c[:, None] < pt)
    kc = cross.to(f32).sum(dim=1)
    r = torch.floor(u_tgt * kc.clamp(min=1.0)).to(torch.int32)
    csum = cross.to(torch.int32).cumsum(dim=1) - 1
    d_hit = (csum == r[:, None]) & cross
    d = torch.where(d_hit.any(dim=1), d_hit.to(torch.int32).argmax(dim=1),
                    torch.full_like(r, -1)).to(torch.int32)

    # ---- opportunity / count records --------------------------------------
    # pending layout (Pp=1): [coal_opp | coal_cnt | mig_opp | mig_cnt |
    #                         recomb_opp | recomb_cnt], E columns each
    actf = active.to(f32)[:, None]
    ov_c = (torch.minimum(hi, t_c[:, None, None]) - lo).clamp(min=0.0)
    coal_opp_add = actf * ov_c.sum(dim=2)
    span_e = (torch.minimum(eend[None], t_c[:, None])
              - torch.maximum(est[None], h_r[:, None])).clamp(min=0.0)
    mig_opp_add = actf * span_e
    in_e_c = (t_c[:, None] >= est[None]) & (t_c[:, None] < eend[None])
    in_e_r = (h_r[:, None] >= est[None]) & (h_r[:, None] < eend[None])
    coal_cnt_add = actf * in_e_c.to(f32)
    recomb_cnt_add = actf * in_e_r.to(f32)
    pending = pending + torch.cat(
        [coal_opp_add, coal_cnt_add, mig_opp_add, torch.zeros_like(span_e),
         recomb_opp_add, recomb_cnt_add], dim=1)

    # ---- SPR: cut the branch above c, regraft onto d at t_c ---------------
    p = _pick(parent, cc)[:, 0]  # parent of c (c is never the root)
    pp = p[:, None]
    sib0 = _pick(child0, pp)[:, 0]
    sib1 = _pick(child1, pp)[:, 0]
    o = torch.where(sib0 == c, sib1, sib0)
    g = _pick(parent, pp)[:, 0]
    noop = d == c
    d_eff = torch.where(d == p, o, d)
    gp = torch.where(d_eff == o, g, _pick(parent, d_eff[:, None])[:, 0])
    o_oh, p_oh = _onehot(o, N), _onehot(p, N)
    g_oh, deff_oh, gp_oh = _onehot(g, N), _onehot(d_eff, N), _onehot(gp, N)

    new_par = torch.where(o_oh, g[:, None], parent)
    new_par = torch.where(deff_oh, p[:, None], new_par)
    new_par = torch.where(p_oh, gp[:, None], new_par)
    new_c0 = torch.where(g_oh & (child0 == pp), o[:, None], child0)
    new_c1 = torch.where(g_oh & (child1 == pp), o[:, None], child1)
    new_c0 = torch.where(p_oh, c[:, None], new_c0)
    new_c1 = torch.where(p_oh, d_eff[:, None], new_c1)
    new_c0 = torch.where(gp_oh & (new_c0 == d_eff[:, None]), pp, new_c0)
    new_c1 = torch.where(gp_oh & (new_c1 == d_eff[:, None]), pp, new_c1)
    new_time = torch.where(p_oh, t_c[:, None], time)

    chg = (active & ~noop)[:, None]
    par2 = torch.where(chg, new_par, parent)
    c0_2 = torch.where(chg, new_c0, child0)
    c1_2 = torch.where(chg, new_c1, child1)
    t2 = torch.where(chg, new_time, time)

    # ---- refreshed tree summaries ------------------------------------------
    pt2 = parent_time(t2, par2)
    ov2 = (torch.minimum(pt2[:, None, :], eend[None, :, None])
           - torch.maximum(t2[:, None, :], est[None, :, None])).clamp(min=0.0)
    ov2 = ov2 * (par2 >= 0).to(f32)[:, None, :]  # [P, E, N]
    tle2 = ov2.sum(dim=2)
    tl2 = ov2.reshape(P, E * N).sum(dim=1)
    if leaf_status == 1:
        B2 = tl2
    elif leaf_status == -1:
        B2 = torch.zeros_like(tl2)
    else:
        B2 = data_branch_length(t2, par2, has_data)

    act1 = active[:, None]
    tl_out = torch.where(active, tl2, tl)
    B_out = torch.where(active, B2, B)

    # ---- next recombination gap (from the refreshed tree length) ----------
    x_gap = -torch.log1p(-u_gap)
    if guide is None:
        gap = x_gap / (rho * tl_out).clamp(min=1e-30)
    else:
        gap = draw_gap(guide, x_gap, rho, tl_out, next_rec + front)
    upd_out = torch.where(active, next_rec, upd)
    nr_out = torch.where(active, next_rec + gap, next_rec)
    return ((t2, par2, c0_2, c1_2, nr_out, upd_out, log_w, tl_out, B_out,
             torch.where(act1, tle2, tl_e), pending),
            TripRecord(h_r, t_c, log_iw, strength, log_iw_bias, c, d))


def vb_coal_term(vb_coal: torch.Tensor, epoch_start: torch.Tensor,
                 t_c: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """[P] one trip's VB term with one population: the table entry
    ``vb_coal`` [E] of the epoch of the trip's coalescence ``t_c`` for an
    active particle (its trip records one coalescence), 0 otherwise."""
    return torch.where(active, vb_coal[epoch_index(epoch_start, t_c)], 0.0)


def _local_ring(local: LocalPass | None) -> tuple:
    """The ring of a LocalPass as the tuple ``push_local_event`` takes."""
    return (() if local is None else
            (local.lr_pos, local.lr_due, local.lr_time, local.lr_desc,
             local.lr_dropped))


def _push_trip_event(local: LocalPass, ring: tuple, active, next_rec,
                     rec: TripRecord, desc_pre, epoch_start) -> tuple:
    """Push each active particle's trip as a pending local event: at
    ``front + next_rec``, due a lag of the recombination height's epoch
    later, with the leaves below the cut node in the tree before the trip
    (``desc_pre`` [P, N]); smc.py:1054-1069 of the JAX package."""
    pos = next_rec + local.front
    due = pos + local.lags[epoch_index(epoch_start, rec.h_r)]
    desc = desc_pre.gather(1, rec.c.clamp(min=0).long()[:, None])[:, 0]
    return push_local_event(*ring, active, pos, due, rec.h_r, desc)


def _store_ring(local: LocalPass | None, ring: tuple) -> None:
    if local is not None:
        for dst, src in zip(_local_ring(local), ring):
            dst.copy_(src)


def _push_arg_rows(arg: ArgPass, ring: tuple, active, next_rec,
                   rec: TripRecord, desc_pre) -> tuple:
    """Push each active particle's trip as ARG rows at ``front +
    next_rec``: R and C, with the leaves below the cut node and below the
    target in the tree before the trip (``desc_pre`` [P, N]); one
    population, so the coalescence's is 0 (smc.py:1021-1037 of the JAX
    package)."""
    return push_trip_rows(ring, active, next_rec + arg.front, rec.h_r,
                          rec.t_c, 0, pick_desc(desc_pre, rec.c),
                          pick_desc(desc_pre, rec.d))


def trip_plain(uniforms, leaf_status, time, parent, child0, child1, next_rec,
               upd, log_w, tl, B, tl_e, pending, L, mu, rho, epoch_start,
               inv2ne, has_data, vb_coal=None, local: LocalPass | None = None,
               arg: ArgPass | None = None):
    """Plain torch version of :func:`trip` on any device (same arguments,
    same in-place contract).  Stops early once no particle is active.
    ``vb_coal`` [E] (the plain segment pass's VB; ``trip`` takes none)
    adds each trip's :func:`vb_coal_term` to ``log_w`` after it; ``local``
    (the plain segment pass's local recording) pushes each trip's event
    into its ring, ``arg`` (its ARG recording) the trip's rows into its
    ring."""
    f32 = torch.float32
    dev = time.device
    L = torch.tensor(L, dtype=f32, device=dev)
    mu = torch.tensor(mu, dtype=f32, device=dev)
    rho = torch.tensor(rho, dtype=f32, device=dev)
    est = epoch_start
    eend = torch.cat([est[1:], est.new_full((1,), INF)])
    outs = (time, parent, child0, child1, next_rec, upd, log_w, tl, B, tl_e,
            pending)
    cur = outs
    ring = _local_ring(local)
    aring = None if arg is None else arg.ring
    for j in range(uniforms.shape[0]):
        if not bool((cur[4] < L).any()):
            break
        (t, p, c0, c1, nr, up, lw, tl_, B_, tle, pend) = cur
        desc_pre = (None if local is None and arg is None
                    else descendant_bitmask(p))
        cur, rec = _trip(uniforms[j], int(leaf_status), t, p, c0, c1, nr,
                         up, lw, tl_, B_, tle, pend, L, mu, rho, est, eend,
                         inv2ne, has_data)
        if vb_coal is not None:
            cur = cur[:6] + (cur[6] + vb_coal_term(vb_coal, est, rec.t_c,
                                                   nr < L),) + cur[7:]
        if local is not None:
            ring = _push_trip_event(local, ring, nr < L, nr, rec, desc_pre,
                                    est)
        if arg is not None:
            aring = _push_arg_rows(arg, aring, nr < L, nr, rec, desc_pre)
    if cur is not outs:
        for dst, src in zip(outs, cur):
            dst.copy_(src)
        _store_ring(local, ring)
        store_ring(arg, aring)


def float_tolerances(ref: dict, L: float, mu: float, scale: float = 1e-5,
                     Pp: int = 1) -> dict:
    """Absolute tolerance of each float output of a trip, in its own units.

    The unit is one node height: ``scale`` times the tallest node h_max
    (generations).  Tree length, data branch length, per-epoch tree length
    and coalescence opportunity sum N branches (N x unit); migration
    opportunity is one lineage's span (unit), and so is a migration
    event's time; the recombination
    opportunity is bp x generations (L x N x unit); the weight update
    ``mu*B*delta`` is in nats (mu x L x N x unit), and so are the biased
    pass's pilot weight and delayed log factors; positions ``next_rec``,
    ``upd`` and the delayed factors' ``df_pos`` and ``df_delta`` are bp
    (scale x L).  Counts (and ``df_k``, applications left) are whole
    events, so half an event tells an equal count from one that differs.
    ``Pp`` populations give the statistics row the structured layout."""
    N = ref["time"].shape[1]
    E = ref["pending"].shape[1] // stats_offsets(1, Pp)["width"]
    unit = scale * float(ref["time"].max())
    tree = N * unit
    sizes = torch.tensor([math.prod(s) for s in stats_field_shapes(E, Pp)],
                         device=ref["time"].device)
    per_block = torch.tensor([tree, 0.5, unit, 0.5, L * tree, 0.5],
                             dtype=torch.float64, device=ref["time"].device)
    return {"time": unit, "next_rec": scale * L, "upd": scale * L,
            "log_w": mu * L * tree, "tl": tree, "B": tree, "tl_e": tree,
            "pending": per_block.repeat_interleave(sizes),
            "mig_time": unit,
            "log_pilot": mu * L * tree, "df_pos": scale * L,
            "df_logf": mu * L * tree, "df_delta": scale * L, "df_k": 0.5}


def disagreement(got: dict, ref: dict, L: float, mu: float,
                 rtol: float = 1e-4, Pp: int = 1):
    """Where two trip results (dicts of :data:`FIELDS`) differ.  Results
    of a segment pass are compared the same way: they hold ``tl`` and, under
    ``pending``, FIFO slot 0, and lack ``upd``, ``B`` and ``tl_e``; those
    of the biased pass hold :data:`BIAS_FIELDS` too, those of the migration
    pass (``Pp`` populations) ``pop``, ``mig_time`` and ``mig_dest``.

    Returns ``(tree_differs, floats_differ, errs)``: [P] bool masks of the
    particles whose tree arrays differ (for the migration pass also their
    populations, the buffers' destinations or which buffer slots are in
    use), and of those whose tree arrays agree but a float lies beyond
    ``rtol * |ref| + atol`` (atol from :func:`float_tolerances`);
    ``errs[field] = (max abs error, max error / tolerance)`` over the
    particles whose tree arrays agree."""
    tree_differs = torch.zeros(ref["parent"].shape[0], dtype=torch.bool,
                               device=ref["parent"].device)
    for k in TREE_FIELDS + ("pop", "mig_dest"):
        if k in ref:
            tree_differs |= (got[k] != ref[k]).flatten(1).any(dim=1)
    if "mig_time" in ref:
        tree_differs |= ((got["mig_time"] < INF) != (ref["mig_time"] < INF)
                         ).flatten(1).any(dim=1)
    atol = float_tolerances(ref, L, mu, Pp=Pp)
    floats_differ = torch.zeros_like(tree_differs)
    errs = {}
    for k in (k for k in FLOAT_FIELDS + ("mig_time",) if k in ref):
        a, b = got[k].double(), ref[k].double()
        if k == "mig_time":  # padding compares as equal
            pad = b >= INF
            a, b = torch.where(pad, 0.0, a), torch.where(pad, 0.0, b)
            a, b = a.flatten(1), b.flatten(1)
        err = (a - b).abs()
        ratio = torch.where(err > 0, err / (rtol * b.abs() + atol[k]), 0.0)
        if err.dim() > 1:
            err, ratio = err.amax(dim=1), ratio.amax(dim=1)
        err = torch.where(tree_differs, 0.0, err)
        ratio = torch.where(tree_differs, 0.0, ratio)
        floats_differ |= ratio > 1.0
        errs[k] = (float(err.max()), float(ratio.max()))
    return tree_differs, floats_differ, errs


def _check_caps(N: int, E: int, Pp: int = 1, Mw: int = 0,
                variant: str | None = None) -> int:
    """Leaves for N nodes; raise outside the kernels' compile-time caps
    (for the migration pass also populations and buffer capacity).  The
    plain and biased passes and trip take up to :data:`WIDE_MAX_LEAVES`
    leaves (the wide kernels above :data:`MAX_LEAVES`); ``variant`` names
    a pass that has no wide form (the migration pass and its variants, the
    biased ARG pass), which takes up to :data:`MAX_LEAVES`."""
    n = (N + 1) // 2
    cap = MAX_LEAVES if variant else WIDE_MAX_LEAVES
    if N != 2 * n - 1 or n < 2 or n > cap:
        raise ValueError(f"the {variant or 'trip'} kernel supports 2..{cap} "
                         f"leaves, got N={N}")
    if E < 1 or E > MAX_EPOCHS:
        raise ValueError(f"trip kernel supports 1..{MAX_EPOCHS} epochs, got {E}")
    if Pp < 1 or Pp > MAX_POPS:
        raise ValueError(f"migration pass supports 1..{MAX_POPS} populations,"
                         f" got {Pp}")
    if Mw < 0 or Mw > MAX_MIG:
        raise ValueError(f"migration pass supports buffers of 1..{MAX_MIG} "
                         f"events, got {Mw}")
    return n


def narrow_variant(biased=False, migration=False, guide=False, local=False,
                   arg=False) -> str | None:
    """The name :func:`_check_caps` gives a pass that has no wide form
    (the migration pass and its biased, guided and local variants, the
    biased pass's ARG variant), or None: the guided and local passes have
    wide forms."""
    if not (migration or (biased and arg)):
        return None
    return " ".join(w for w, on in (
        ("migration", migration), ("guided", guide),
        ("biased", biased and not guide and (migration or local or arg)),
        ("local", local), ("ARG", arg and not migration)) if on)


def _check_tensor(name, x, dtype, shape, dev):
    """Raise unless ``x`` is what the kernel takes for this argument."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(uniforms, time, parent, child0, child1, next_rec, upd, log_w, tl,
           B, tl_e, pending, epoch_start, inv2ne, has_data):
    """Validate what the CUDA trip kernel takes; raise on anything else."""
    dev = time.device
    P, N = time.shape
    E = epoch_start.shape[0]
    n = _check_caps(N, E)
    f32, i32 = torch.float32, torch.int32
    spec = [
        ("uniforms", uniforms, f32, (uniforms.shape[0], P, 4)),
        ("time", time, f32, (P, N)),
        ("parent", parent, i32, (P, N)),
        ("child0", child0, i32, (P, N)),
        ("child1", child1, i32, (P, N)),
        ("next_rec", next_rec, f32, (P,)),
        ("upd", upd, f32, (P,)),
        ("log_w", log_w, f32, (P,)),
        ("tl", tl, f32, (P,)),
        ("B", B, f32, (P,)),
        ("tl_e", tl_e, f32, (P, E)),
        ("pending", pending, f32, (P, 6 * E)),
        ("epoch_start", epoch_start, f32, (E,)),
        ("inv2ne", inv2ne, f32, (E,)),
        ("has_data", has_data, torch.bool, (n,)),
    ]
    for name, x, dtype, shape in spec:
        _check_tensor(name, x, dtype, shape, dev)
    if uniforms.shape[0] < 1:
        raise ValueError("uniforms must hold at least one trip")


def _launch(fn, dev, *args):
    """Call a launch function of the library on ``dev``'s current stream;
    raise on the CUDA error it returns."""
    lib = load_trip_library()
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return _launch(fn, dev, *args)
    err = getattr(lib, fn)(*args,
                           torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err} "
                           f"({lib.smc_cuda_error_string(err).decode()})")


def trip(uniforms, leaf_status, time, parent, child0, child1, next_rec, upd,
         log_w, tl, B, tl_e, pending, L, mu, rho, epoch_start, inv2ne,
         has_data):
    """Up to ``uniforms.shape[0]`` recombination trips, IN PLACE.

    uniforms [T, P, 4] f32 (row j feeds trip j); time [P, N] f32; parent,
    child0, child1 [P, N] i32; next_rec, upd, log_w, tl, B [P] f32; tl_e
    [P, E] f32; pending [P, 6E] f32; L, mu, rho python floats; leaf_status
    -1/0/1; epoch_start, inv2ne [E] f32; has_data [n] bool.  A particle
    stops after the trip that takes ``next_rec`` to or past ``L``.

    CPU tensors run :func:`trip_plain`.  CUDA tensors launch the kernel of
    ``csrc/trip.cu`` on the current stream (one launch for all T trips) or
    raise; nothing falls back.  Above :data:`MAX_LEAVES` leaves that is the
    wide kernel, counted in ``trip.wide_launches``.  The sweep launches :func:`segment_pass`;
    this entry point is the one held against the Pallas kernel."""
    dev = time.device
    if dev.type == "cpu":
        trip_plain(uniforms, leaf_status, time, parent, child0, child1,
                   next_rec, upd, log_w, tl, B, tl_e, pending, L, mu, rho,
                   epoch_start, inv2ne, has_data)
        return
    if dev.type != "cuda":
        raise ValueError(f"trip: unsupported device {dev}")
    _check(uniforms, time, parent, child0, child1, next_rec, upd, log_w, tl,
           B, tl_e, pending, epoch_start, inv2ne, has_data)
    P, N = time.shape
    _launch("smc_trip_launch", dev,
            uniforms.data_ptr(), uniforms.shape[0], P, (N + 1) // 2,
            epoch_start.shape[0], int(leaf_status),
            time.data_ptr(), parent.data_ptr(), child0.data_ptr(),
            child1.data_ptr(), next_rec.data_ptr(), upd.data_ptr(),
            log_w.data_ptr(), tl.data_ptr(), B.data_ptr(), tl_e.data_ptr(),
            pending.data_ptr(), float(L), float(mu), float(rho),
            epoch_start.data_ptr(), inv2ne.data_ptr(), has_data.data_ptr())
    if (N + 1) // 2 > MAX_LEAVES:
        trip.wide_launches += 1
    else:
        trip.launches += 1


trip.launches = 0
trip.wide_launches = 0  # the wide kernel's (more than MAX_LEAVES leaves)


# ---------------------------------------------------------------------------
# a segment's whole tree pass
# ---------------------------------------------------------------------------


def _biased_trips(uniforms, leaf_status, time, parent, child0, child1,
                  next_rec, upd, log_w, tl, B, tl_e, pending, L, mu, rho,
                  epoch_start, inv2ne, has_data, b: BiasedPass,
                  vb_coal=None, guide: GuideTables | None = None,
                  local: LocalPass | None = None, arg: ArgPass | None = None):
    """The biased form of :func:`trip_plain`, IN PLACE: after each trip the
    posterior weight takes the whole importance weight, the pilot weight
    the no-mutation factor and the immediate part (its height-bias part,
    where the delay height's section is unbiased), and the delayed part
    goes into the particle's ring at ``front + next_rec`` (smc.py:968-1020
    of the JAX package).  With ``vb_coal`` [E] both weights take the
    trip's VB term first (smc.py:951-967).  With ``guide`` each extension
    takes the guide's survival weight in both weights (smc.py:903-914),
    the point is weighed by the branches' guide rates at the event's
    window, and the next gap comes from the guide; with ``local`` each
    trip's event goes into the particle's ring of pending local events,
    with ``arg`` its rows into the particle's ARG ring."""
    f32 = torch.float32
    dev = time.device
    L_t = torch.tensor(L, dtype=f32, device=dev)
    mu_t = torch.tensor(mu, dtype=f32, device=dev)
    rho_t = torch.tensor(rho, dtype=f32, device=dev)
    eend = torch.cat([epoch_start[1:], epoch_start.new_full((1,), INF)])
    by_point = DELAY_TYPES[b.delay_type] == 0
    outs = (time, parent, child0, child1, next_rec, upd, log_w, tl, B, tl_e,
            pending)
    cur = outs
    lp = b.log_pilot
    ring = (b.df_pos, b.df_logf, b.df_delta, b.df_k)
    lring = _local_ring(local)
    aring = None if arg is None else arg.ring
    for j in range(uniforms.shape[0]):
        nr, up, tl_pre, B_pre = cur[4], cur[5], cur[7], cur[8]
        active = nr < L_t
        if not bool(active.any()):
            break
        zero = torch.zeros_like(nr)
        delta = torch.where(active, nr - up, zero)
        point = (b.heights, b.strengths)
        if guide is not None:
            liw = torch.where(active, span_log_iw(
                guide, rho_t, tl_pre, up + b.front, nr + b.front), zero)
            point += (leaf_rates_at(guide, nr + b.front),)
        desc_pre = (None if local is None and arg is None
                    else descendant_bitmask(cur[1]))
        cur, rec = _trip(
            uniforms[j], int(leaf_status), *cur, L_t, mu_t, rho_t,
            epoch_start, eend, inv2ne, has_data, point, guide, b.front)
        lp = lp - mu_t * B_pre * delta
        lw = cur[6]
        if guide is not None:
            lw, lp = lw + liw, lp + liw
        if vb_coal is not None:
            term = vb_coal_term(vb_coal, epoch_start, rec.t_c, active)
            lw, lp = lw + term, lp + term
        cur = cur[:6] + (lw + torch.where(active, rec.log_iw, zero),) \
            + cur[7:]
        d_h = rec.h_r if by_point else rec.t_c
        strength_h = (rec.strength if by_point
                      else b.strengths[section_of(b.heights, d_h)])
        immediate = (strength_h - 1.0).abs() < 1e-6
        imm = torch.where(immediate, rec.log_iw_bias, zero)
        late = rec.log_iw - imm
        lp = lp + torch.where(active, imm, zero)
        delay = b.delays[epoch_index(epoch_start, d_h)]
        *ring, overflow = push_delayed(
            *ring, active & (late.abs() > 1e-9), nr + b.front, delay, late,
            b.delay_k)
        lp = lp + overflow
        if local is not None:
            lring = _push_trip_event(local, lring, active, nr, rec, desc_pre,
                                     epoch_start)
        if arg is not None:
            aring = _push_arg_rows(arg, aring, active, nr, rec, desc_pre)
    if cur is not outs:
        for dst, src in zip(outs + (b.log_pilot, b.df_pos, b.df_logf,
                                    b.df_delta, b.df_k),
                            cur + (lp, *ring)):
            dst.copy_(src)
        _store_ring(local, lring)
        store_ring(arg, aring)


def segment_pass_plain(uniforms, leaf_status, time, parent, child0, child1,
                       next_rec, log_w, fifo, fifo_mask, tl_out, L, mu, rho,
                       epoch_start, inv2ne, has_data,
                       biased: BiasedPass | None = None,
                       migration: MigrationPass | None = None,
                       vb: tuple | None = None,
                       guide: GuideTables | None = None,
                       local: LocalPass | None = None,
                       arg: ArgPass | None = None):
    """Plain torch version of :func:`segment_pass` on any device (same
    arguments, same in-place contract): ``tree_summaries``, the trips
    (``trip_plain``, :func:`_biased_trips` or
    ``migration.migration_trips``, each with the VB term after every trip
    when ``vb`` is given and the rows of ``arg``, with the local events of
    ``local``; the biased and the migration one under ``biased`` with the
    ``guide``), the
    final extension (with the
    guide's survival weight), under bias the drain of the delayed factors
    due at ``front + L``, and the push into FIFO slot 0; with ``local``
    the segment's ungated recombination opportunity into ``local.ropp``."""
    P = time.shape[0]
    E = epoch_start.shape[0]
    dev = time.device
    Pp = 1 if migration is None else migration.ne.shape[1]
    off = stats_offsets(E, Pp)
    trees = Trees(parent=parent, time=time, child0=child0, child1=child1)
    epochs = Epochs(start=epoch_start, ne=(0.5 / inv2ne)[:, None])
    tl, tl_e, B = tree_summaries(trees, epochs, leaf_status, has_data)
    tl, tl_e, B = tl.contiguous(), tl_e.contiguous(), B.contiguous()
    upd = torch.zeros(P, device=dev)
    pending = torch.zeros((P, off["width"]), device=dev)
    if guide is not None and biased is None:
        raise ValueError("the guide runs in the biased pass")

    # ---- recombination trips inside [front, front + L) ---------------------
    if uniforms.shape[0] > 0:
        args = (uniforms, leaf_status, time, parent, child0, child1, next_rec,
                upd, log_w, tl, B, tl_e, pending, L, mu, rho, epoch_start,
                inv2ne, has_data)
        vb_coal = None if vb is None else vb[0][:, 0]
        if migration is not None:
            migration_trips(*args[:-2], has_data, migration, vb, arg,
                            biased, guide, local)
        elif biased is None:
            trip_plain(*args, vb_coal, local, arg)
        else:
            _biased_trips(*args, biased, vb_coal, guide, local, arg)

    # ---- final extension to the segment end --------------------------------
    delta = L - upd
    log_w.copy_(log_w - mu * B * delta)
    liw = None
    if guide is not None:
        front = biased.front
        end = torch.full_like(upd, float(np.float32(front) + np.float32(L)))
        liw = torch.where(delta > 0,
                          span_log_iw(guide, float(np.float32(rho)), tl,
                                      upd + front, end),
                          torch.zeros_like(delta))
        log_w.add_(liw)
    ro = off["recomb_opp"]
    pending[:, ro:ro + E] += delta[:, None] * tl_e
    next_rec.copy_(next_rec - L)

    if biased is not None:
        # ---- the pilot's extension; the factors due at the end -------------
        b = biased
        lp = b.log_pilot - mu * B * delta
        if liw is not None:
            lp = lp + liw
        add, *ring = apply_due_delayed(
            b.df_pos, b.df_logf, b.df_delta, b.df_k,
            float(np.float32(b.front) + np.float32(L)))
        b.log_pilot.copy_(lp + add)
        for dst, src in zip((b.df_pos, b.df_logf, b.df_delta, b.df_k), ring):
            dst.copy_(src)

    # ---- push pending increments into FIFO slot 0 --------------------------
    fifo[:, 0] += pending * fifo_mask[None, :]
    tl_out.copy_(tl)
    if local is not None:
        local.ropp.copy_(pending[:, ro:ro + E].sum(dim=1))


def segment_pass(uniforms, leaf_status, time, parent, child0, child1,
                 next_rec, log_w, fifo, fifo_mask, tl_out, L, mu, rho,
                 epoch_start, inv2ne, has_data,
                 biased: BiasedPass | None = None,
                 migration: MigrationPass | None = None,
                 vb: tuple | None = None,
                 guide: GuideTables | None = None,
                 local: LocalPass | None = None,
                 arg: ArgPass | None = None):
    """One segment's tree pass for every particle, IN PLACE.

    From the trees alone: tree length, per-epoch tree length and data branch
    length at segment entry; then up to ``uniforms.shape[0]`` trips per
    particle (none when it is 0); then the final extension ``log_w -=
    mu*B*(L - upd)`` and ``recomb_opp += (L - upd)*tl_e``, ``next_rec -= L``
    and the push ``fifo[:, 0] += pending * fifo_mask``.  ``tl_out`` receives
    the post-trip tree length.

    uniforms [T, P, 4] f32; time [P, N] f32; parent, child0, child1 [P, N]
    i32; next_rec, log_w, tl_out [P] f32; fifo [P, F, 6E] f32; fifo_mask
    [6E] f32; L, mu, rho python floats; leaf_status -1/0/1; epoch_start,
    inv2ne [E] f32; has_data [n] bool.

    ``biased`` (a :class:`BiasedPass`) makes it the biased pass: each trip
    draws its point height-biased (``biased_point``, column 0 of the same
    uniforms), adds the importance weight to ``log_w``, tracks the pilot
    weight and pushes the delayed part into the ring; after the final
    extension the factors due at ``front + L`` go into the pilot.  Its
    ring holds at most 32 slots per particle and its sections at most 8.

    ``migration`` (a :class:`MigrationPass`) makes it the migration pass
    of Pp populations: the point from column 0 and the gap from column 3
    of the uniforms, the re-coalescence by the loop walk on the pass's
    Philox stream, the SPR with buffer routing; ``fifo`` and ``fifo_mask``
    are ``stats_offsets(E, Pp)["width"]`` wide, ``inv2ne`` is not read.
    At most 4 populations and 96 events per buffer.  With ``biased``,
    ``guide`` or ``local`` it is one of the migration pass's proposal
    variants (``migration.migration_trips``): the biased point in
    node-major order, the delay under ``-delay_migr`` keyed by the walk's
    first migration where it lies below the coalescence, the guide and
    the local ring as in the passes below.

    ``vb`` = (vb_coal [E, Pp], vb_mig [E, Pp, Pp]) f32, the VB tables with
    the ``-xc`` epochs' entries 0, makes it the VB variant of the pass (a
    compile-time variant of each kernel): after each trip's extension, and
    before its importance weight, the posterior weight (and the biased
    pass's pilot) takes the table entry of every coalescence and migration
    the trip records, whatever the recording gate says.

    ``guide`` (a ``guide.GuideTables``, with ``biased`` only: the guide
    without height bias is the biased pass with one section of strength
    1) makes it the guided pass: each extension over [x0, x1) takes the
    guide's survival weight in both weights, the point's segments are
    weighed by the branches' guide rates at the event's window (the
    delayed part is then the whole weight less its height-bias part), and
    each gap is drawn in guide mass.  ``local`` (a ``local.LocalPass``,
    with any pass but the ARG variants) makes each trip push its pending
    local event into the particle's ring (the first free slot; on a full
    ring it is dropped and counted) and writes the segment's ungated
    recombination opportunity into ``local.ropp``.  Its ring holds at most
    32 slots.

    ``arg`` (a ``kernels.arg.ArgPass``, with the plain, the biased or the
    migration pass; not with ``guide`` or ``local``, nor with both
    ``biased`` and ``migration``) makes it the ARG
    variant: each trip pushes its R and C rows (and with migration an M
    row for each of the walk's first 4 hops) into the particle's ARG ring
    at slot ``arg_n % A``; the pass draws nothing and changes no weight.

    Up to :data:`MAX_LEAVES` leaves every variant runs; above, up to
    :data:`WIDE_MAX_LEAVES`, the plain and biased passes, the guided and
    local passes (each with and without VB) and the plain pass's ARG
    variant run as the wide kernels (counted as ``wide_launches``,
    ``biased_wide_vb_launches``, ``wide_local_launches``,
    ``biased_wide_guide_local_vb_launches``, ``wide_arg_launches``, ...)
    and the migration and biased ARG variants raise.

    CPU tensors run :func:`segment_pass_plain`.  CUDA tensors launch the
    kernel of ``csrc/trip.cu`` on the current stream (one launch) or raise;
    nothing falls back.  Every call checks every tensor, as :func:`trip`
    does.  ``segment_pass.launches`` counts the launches of the plain
    kernel, ``segment_pass.biased_launches`` those of the biased one and
    ``segment_pass.migration_launches`` those of the migration one; the
    ``vb_`` counts (``vb_launches``, ``biased_vb_launches``,
    ``migration_vb_launches``) those of their VB variants; the guided,
    local, ARG and migration proposal variants count under
    :func:`launch_count`'s names (``local_launches``,
    ``biased_guide_local_vb_launches``, ``arg_launches``,
    ``migration_arg_vb_launches``, ``migration_biased_guide_launches``,
    ...)."""
    dev = time.device
    if guide is not None and biased is None:
        raise ValueError("the guide runs in the biased pass")
    if dev.type == "cpu":
        segment_pass_plain(uniforms, leaf_status, time, parent, child0,
                           child1, next_rec, log_w, fifo, fifo_mask, tl_out,
                           L, mu, rho, epoch_start, inv2ne, has_data, biased,
                           migration, vb, guide, local, arg)
        return
    if dev.type != "cuda":
        raise ValueError(f"segment_pass: unsupported device {dev}")
    name, args = segment_pass_launch_args(
        uniforms, leaf_status, time, parent, child0, child1, next_rec, log_w,
        fifo, fifo_mask, tl_out, L, mu, rho, epoch_start, inv2ne, has_data,
        biased, migration, vb, guide, local, arg)
    _launch("smc_segment_pass_launch", dev, *args)
    setattr(segment_pass, name, getattr(segment_pass, name) + 1)


def segment_pass_launch_args(uniforms, leaf_status, time, parent, child0,
                             child1, next_rec, log_w, fifo, fifo_mask, tl_out,
                             L, mu, rho, epoch_start, inv2ne, has_data,
                             biased=None, migration=None, vb=None, guide=None,
                             local=None, arg=None) -> tuple:
    """What :func:`segment_pass` hands ``smc_segment_pass_launch`` (all
    but the stream) for its arguments, every tensor checked; returns
    (the name of the variant's launch count, the arguments).  Raises on
    anything the kernels do not take."""
    dev = time.device
    if guide is not None and biased is None:
        raise ValueError("the guide runs in the biased pass")
    if arg is not None and (guide is not None or local is not None):
        raise ValueError("segment_pass has no guided or local ARG variant")
    if arg is not None and migration is not None and biased is not None:
        raise ValueError("segment_pass has no ARG variant of the biased "
                         "migration pass")
    P, N = time.shape
    E = epoch_start.shape[0]
    Pp = 1 if migration is None else migration.ne.shape[1]
    Mw = 0 if migration is None else migration.mig_time.shape[2]
    n = _check_caps(N, E, Pp, Mw, narrow_variant(
        biased is not None, migration is not None, guide is not None,
        local is not None, arg is not None))
    K = stats_offsets(E, Pp)["width"]
    if fifo.dim() != 3:
        raise ValueError(f"fifo has shape {tuple(fifo.shape)}, expected "
                         f"(P, F, {K})")
    T, F = uniforms.shape[0], fifo.shape[1]
    f32, i32 = torch.float32, torch.int32
    spec = [
        ("uniforms", uniforms, f32, (T, P, 4)),
        ("time", time, f32, (P, N)),
        ("parent", parent, i32, (P, N)),
        ("child0", child0, i32, (P, N)),
        ("child1", child1, i32, (P, N)),
        ("next_rec", next_rec, f32, (P,)),
        ("log_w", log_w, f32, (P,)),
        ("fifo", fifo, f32, (P, F, K)),
        ("fifo_mask", fifo_mask, f32, (K,)),
        ("tl_out", tl_out, f32, (P,)),
        ("epoch_start", epoch_start, f32, (E,)),
        ("inv2ne", inv2ne, f32, (E,)),
        ("has_data", has_data, torch.bool, (n,)),
    ]
    bias_args = (None,) * 8 + (0, 0, 0.0, 0, 0)  # the plain pass
    mig_args = (None,) * 9 + (0, 0, 0)
    if biased is not None:
        b = biased
        D, S = b.df_pos.shape[-1], b.strengths.shape[0]
        if not 1 <= D <= MAX_DELAY_SLOTS or not 1 <= S <= MAX_SECTIONS:
            raise ValueError(f"biased segment_pass takes 1..{MAX_DELAY_SLOTS}"
                             f" delay slots and 1..{MAX_SECTIONS} sections, "
                             f"got {D} and {S}")
        if b.delay_type not in DELAY_TYPES or b.delay_k < 1:
            raise ValueError(f"delay type {b.delay_type!r}, k {b.delay_k}")
        code = delay_code(b.delay_type, migration is not None)
        spec += [
            ("log_pilot", b.log_pilot, f32, (P,)),
            ("df_pos", b.df_pos, f32, (P, D)),
            ("df_logf", b.df_logf, f32, (P, D)),
            ("df_delta", b.df_delta, f32, (P, D)),
            ("df_k", b.df_k, i32, (P, D)),
            ("heights", b.heights, f32, (S + 1,)),
            ("strengths", b.strengths, f32, (S,)),
            ("delays", b.delays, f32, (E,)),
        ]
        bias_args = (*(x.data_ptr() for x in (
            b.log_pilot, b.df_pos, b.df_logf, b.df_delta, b.df_k, b.heights,
            b.strengths, b.delays)), D, S, float(b.front),
            code, int(b.delay_k))
    if migration is not None:
        m = migration
        if Mw < 1 or not 1 <= m.max_walk_events <= MAX_WALK_EVENTS:
            raise ValueError(f"migration segment_pass takes buffers of 1.."
                             f"{MAX_MIG} events and walks of 1.."
                             f"{MAX_WALK_EVENTS} events, got {Mw} and "
                             f"{m.max_walk_events}")
        spec += [
            ("pop", m.pop, i32, (P, N)),
            ("mig_time", m.mig_time, f32, (P, N, Mw)),
            ("mig_dest", m.mig_dest, i32, (P, N, Mw)),
            ("diag", m.diag, torch.float64, (2,)),
            ("key", m.key, i32, (2,)),
            ("ne", m.ne, f32, (E, Pp)),
            ("mig", m.mig, f32, (E, Pp, Pp)),
            ("tot_mig", m.tot_mig, f32, (E, Pp)),
            ("pop_map", m.pop_map, i32, (E, Pp)),
        ]
        mig_args = (*(x.data_ptr() for x in (
            m.pop, m.mig_time, m.mig_dest, m.diag, m.key, m.ne, m.mig,
            m.tot_mig, m.pop_map)), Pp, Mw, int(m.max_walk_events))
    vb_args = (None, None)
    if vb is not None:
        spec += [("vb_coal", vb[0], f32, (E, Pp)),
                 ("vb_mig", vb[1], f32, (E, Pp, Pp))]
        vb_args = (vb[0].data_ptr(), vb[1].data_ptr())
    guide_args = (None, None, None, None, 0, 0.0)
    if guide is not None:
        Wg = guide.g_rel.shape[0]
        if Wg < 1 or not guide.ws > 0:
            raise ValueError(f"a guide of {Wg} windows of {guide.ws} bp")
        spec += [("g_rel", guide.g_rel, f32, (Wg,)),
                 ("cum_mass", guide.cum_mass, f32, (Wg + 1,)),
                 ("g_leaf", guide.g_leaf, f32, (Wg, n)),
                 ("pivots", guide.pivots, f32, (SEARCH_NODES,))]
        guide_args = (guide.g_rel.data_ptr(), guide.cum_mass.data_ptr(),
                      guide.g_leaf.data_ptr(), guide.pivots.data_ptr(), Wg,
                      float(guide.ws))
    local_args = (None,) * 7 + (0,)
    front = 0.0 if biased is None else float(biased.front)
    if local is not None:
        R = local.lr_pos.shape[-1]
        if not 1 <= R <= MAX_LOCAL_SLOTS:
            raise ValueError(f"segment_pass takes local rings of 1.."
                             f"{MAX_LOCAL_SLOTS} slots, got {R}")
        if biased is not None and float(local.front) != front:
            raise ValueError(f"the local front {local.front} is not the "
                             f"biased front {front}")
        front = float(local.front)
        spec += [("lr_pos", local.lr_pos, f32, (P, R)),
                 ("lr_due", local.lr_due, f32, (P, R)),
                 ("lr_time", local.lr_time, f32, (P, R)),
                 ("lr_desc", local.lr_desc, torch.int64, (P, R)),
                 ("lr_dropped", local.lr_dropped, i32, ()),
                 ("lags", local.lags, f32, (E,)),
                 ("ropp", local.ropp, f32, (P,))]
        local_args = (*(x.data_ptr() for x in local[:7]), R)
    arg_args = (None,) * 7 + (0,)
    if arg is not None:
        A = arg.arg_pos.shape[-1]
        if A < 1:
            raise ValueError("segment_pass takes ARG rings of 1 slot or more")
        if (biased is not None or local is not None) \
                and float(arg.front) != front:
            raise ValueError(f"the ARG front {arg.front} is not the pass's "
                             f"front {front}")
        front = float(arg.front)
        i8 = torch.int8
        spec += [("arg_pos", arg.arg_pos, f32, (P, A)),
                 ("arg_code", arg.arg_code, i8, (P, A)),
                 ("arg_time", arg.arg_time, f32, (P, A)),
                 ("arg_from", arg.arg_from, i8, (P, A)),
                 ("arg_to", arg.arg_to, i8, (P, A)),
                 ("arg_desc", arg.arg_desc, torch.int64, (P, A)),
                 ("arg_n", arg.arg_n, i32, (P,))]
        arg_args = (*(x.data_ptr() for x in arg.ring), A)
    for name, x, dtype, shape in spec:
        _check_tensor(name, x, dtype, shape, dev)
    # the segment's start: the biased pass's, the local or the ARG ring's
    bias_args = bias_args[:10] + (front,) + bias_args[11:]
    args = (uniforms.data_ptr(), T, P, n, E, F, int(leaf_status),
            time.data_ptr(), parent.data_ptr(), child0.data_ptr(),
            child1.data_ptr(), next_rec.data_ptr(), log_w.data_ptr(),
            fifo.data_ptr(), fifo_mask.data_ptr(), tl_out.data_ptr(),
            float(L), float(mu), float(rho), epoch_start.data_ptr(),
            inv2ne.data_ptr(), has_data.data_ptr(), *bias_args, *mig_args,
            *vb_args, *guide_args, *local_args, *arg_args)
    return launch_count(biased is not None, migration is not None,
                        vb is not None, guide is not None, local is not None,
                        n > MAX_LEAVES, arg is not None), args


def launch_count(biased=False, migration=False, vb=False, guide=False,
                 local=False, wide=False, arg=False) -> str:
    """The name of the ``segment_pass`` count of a kernel variant:
    ``[migration_][biased_][wide_][guide_][local_][arg_][vb_]launches``
    (``wide``: the wide kernels, more than :data:`MAX_LEAVES` leaves)."""
    return ("migration_" if migration else "") \
        + ("biased_" if biased else "") + ("wide_" if wide else "") \
        + ("guide_" if guide else "") + ("local_" if local else "") \
        + ("arg_" if arg else "") + ("vb_" if vb else "") + "launches"


# launches of every variant of the kernel: the plain, the biased and the
# migration pass, each with and without VB; the plain pass with local
# recording; the biased pass guided, with local recording or both; the
# wide plain and biased passes, the wide plain pass with local recording
# and the wide biased pass guided, with local recording or both; the ARG
# variants of the plain, biased, migration and wide plain passes; the
# migration pass biased, guided (and biased), with local recording,
# biased with local recording, and guided with local recording
LAUNCH_COUNTS = tuple(
    launch_count(b, m, v, g, lo, wd, a)
    for b, m, g, lo, wd, a in ((False, False, False, False, False, False),
                               (True, False, False, False, False, False),
                               (False, True, False, False, False, False),
                               (False, False, False, True, False, False),
                               (True, False, True, False, False, False),
                               (True, False, False, True, False, False),
                               (True, False, True, True, False, False),
                               (False, False, False, False, True, False),
                               (True, False, False, False, True, False),
                               (False, False, False, True, True, False),
                               (True, False, True, False, True, False),
                               (True, False, False, True, True, False),
                               (True, False, True, True, True, False),
                               (False, False, False, False, False, True),
                               (True, False, False, False, False, True),
                               (False, True, False, False, False, True),
                               (False, False, False, False, True, True),
                               (True, True, False, False, False, False),
                               (True, True, True, False, False, False),
                               (False, True, False, True, False, False),
                               (True, True, False, True, False, False),
                               (True, True, True, True, False, False))
    for v in (False, True))
for _count in LAUNCH_COUNTS:
    setattr(segment_pass, _count, 0)


RESOURCES = ("registers", "local_bytes", "static_shared_bytes",
             "dynamic_shared_bytes", "particles_per_block", "blocks_per_sm",
             "sms")
# the kernels of csrc/trip.cu by the kind smc_kernel_resources takes
RESOURCE_VARIANTS = {"trip": 0, "segment_pass": 1, "biased": 2,
                     "migration": 3}
WAVES_AT = 10000  # the particle count of the paths chip_smoke drives


def kernel_resources(variant: str, n: int, E: int, Pp: int = 1,
                     Mw: int = 0, S: int = 2, vb: bool = False,
                     guide: bool = False, local: bool = False,
                     arg: bool = False, biased: bool = False) -> dict:
    """What a kernel of ``csrc/trip.cu`` takes on the current CUDA device
    at (n leaves, E epochs; for the biased pass also S bias sections, for
    the migration pass Pp populations and Mw events per buffer): registers
    and local (stack) bytes per thread and static shared bytes as
    ``cudaFuncGetAttributes`` reports them, the dynamic shared bytes and
    particles per block it is launched with, the blocks an SM holds at once
    and the card's SMs (:data:`RESOURCES`), and from those the particles an
    SM holds and the waves a launch of :data:`WAVES_AT` particles takes.  ``variant`` is a key of :data:`RESOURCE_VARIANTS`
    (n picks the instantiation: 7 padded nodes up to 4 leaves, 15 up to 8;
    above 8 the wide kernels, the guided and local ones among them, 8
    lanes per particle up to 16 leaves and 16 up to 64;
    ``vb`` a pass's VB variant, ``guide`` the biased pass's guided one,
    ``local`` the plain or biased pass's local recording, ``arg`` the
    plain, biased or migration pass's ARG recording; for the migration
    pass ``biased`` its biased variant of S sections, ``guide`` its guided
    one (biased too) and ``local`` its local recording).  Raises on an
    unknown variant or a shape beyond the caps before any CUDA call."""
    if variant not in RESOURCE_VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}; one of "
                         f"{tuple(RESOURCE_VARIANTS)}")
    migration = variant == "migration"
    if migration and (Pp < 1 or Mw < 1):
        raise ValueError(f"the migration pass needs populations and buffers,"
                         f" got Pp={Pp}, Mw={Mw}")
    if biased and not migration:
        raise ValueError("biased= names the migration pass's biased "
                         "variant; the biased pass is variant 'biased'")
    biased = biased or guide or variant == "biased"
    _check_caps(2 * n - 1, E, Pp if migration else 1, Mw if migration else 0,
                narrow_variant(biased, migration, guide, local,
                               arg and variant == "biased"))
    if vb and variant == "trip":
        raise ValueError("trip has no VB variant")
    if biased and not 1 <= S <= MAX_SECTIONS:
        raise ValueError(f"the biased pass takes 1..{MAX_SECTIONS} sections,"
                         f" got {S}")
    if guide and variant not in ("biased", "migration"):
        raise ValueError("only the biased and migration passes have a "
                         "guided variant")
    if local and variant not in ("segment_pass", "biased", "migration"):
        raise ValueError("only the plain, biased and migration passes "
                         "record locally")
    if arg and (variant == "trip" or guide or local
                or (migration and biased)):
        raise ValueError("only the plain, biased and migration passes "
                         "without the guide or local recording, and the "
                         "migration pass without bias, record the ARG")
    out = (ctypes.c_int * len(RESOURCES))()
    lib = load_trip_library()
    kind = 4 if migration and biased else RESOURCE_VARIANTS[variant]
    err = lib.smc_kernel_resources(kind, n, E, S, Pp, Mw, int(vb),
                                   int(guide), int(local), int(arg), out)
    if err != 0:
        raise RuntimeError(f"smc_kernel_resources failed: CUDA error {err} "
                           f"({lib.smc_cuda_error_string(err).decode()})")
    res = dict(zip(RESOURCES, out))
    per_sm = res["blocks_per_sm"] * res["particles_per_block"]
    res["particles_per_sm"] = per_sm
    res["waves_at_10000"] = math.ceil(WAVES_AT / max(per_sm * res["sms"], 1))
    return res
