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
time.
"""

from __future__ import annotations

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
    epoch_index,
    push_delayed,
    section_of,
)
from .tree import (
    INF,
    Epochs,
    Trees,
    _pick,
    branch_lengths,
    data_branch_length,
    parent_time,
    tree_summaries,
)

# compile-time caps of the CUDA kernel (csrc/trip.cu MAX_LEAVES/MAX_EPOCHS)
MAX_LEAVES = 8
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


def _trip_once(u, leaf_status, time, parent, child0, child1, next_rec, upd,
               log_w, tl, B, tl_e, pending, L, mu, rho, est, eend, i2n,
               has_data, bias=None):
    """One trip over the population; returns the updated tensors and the
    trip's event ``(h_r, t_c, log_iw, strength)`` of every particle.

    Follows ``pallas_trip._trip_kernel`` step for step, except for the
    mixed-data branch length, which is computed as ``data_branch_length``
    (the kernel's ancestor-chain walk restarts at node 0 after passing the
    root; see ROADMAP, faults).  ``bias`` = (heights [S+1], strengths [S])
    draws the point with :func:`bias.biased_point` instead (log_iw 0 and
    strength 1 without it)."""
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
    else:
        c, h_r, log_iw, strength = biased_point(u_pt, time, parent, *bias)
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
    gap = -torch.log1p(-u_gap) / (rho * tl_out).clamp(min=1e-30)
    upd_out = torch.where(active, next_rec, upd)
    nr_out = torch.where(active, next_rec + gap, next_rec)
    return ((t2, par2, c0_2, c1_2, nr_out, upd_out, log_w, tl_out, B_out,
             torch.where(act1, tle2, tl_e), pending),
            (h_r, t_c, log_iw, strength))


def trip_plain(uniforms, leaf_status, time, parent, child0, child1, next_rec,
               upd, log_w, tl, B, tl_e, pending, L, mu, rho, epoch_start,
               inv2ne, has_data):
    """Plain torch version of :func:`trip` on any device (same arguments,
    same in-place contract).  Stops early once no particle is active."""
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
    for j in range(uniforms.shape[0]):
        if not bool((cur[4] < L).any()):
            break
        (t, p, c0, c1, nr, up, lw, tl_, B_, tle, pend) = cur
        cur, _ = _trip_once(uniforms[j], int(leaf_status), t, p, c0, c1, nr,
                            up, lw, tl_, B_, tle, pend, L, mu, rho, est, eend,
                            inv2ne, has_data)
    if cur is not outs:
        for dst, src in zip(outs, cur):
            dst.copy_(src)


def float_tolerances(ref: dict, L: float, mu: float, scale: float = 1e-5
                     ) -> dict:
    """Absolute tolerance of each float output of a trip, in its own units.

    The unit is one node height: ``scale`` times the tallest node h_max
    (generations).  Tree length, data branch length, per-epoch tree length
    and coalescence opportunity sum N branches (N x unit); migration
    opportunity is one lineage's span (unit); the recombination
    opportunity is bp x generations (L x N x unit); the weight update
    ``mu*B*delta`` is in nats (mu x L x N x unit), and so are the biased
    pass's pilot weight and delayed log factors; positions ``next_rec``,
    ``upd`` and the delayed factors' ``df_pos`` and ``df_delta`` are bp
    (scale x L).  Counts (and ``df_k``, applications left) are whole
    events, so half an event tells an equal count from one that differs."""
    N = ref["time"].shape[1]
    E = ref["pending"].shape[1] // 6
    unit = scale * float(ref["time"].max())
    tree = N * unit
    per_block = torch.tensor([tree, 0.5, unit, 0.5, L * tree, 0.5],
                             dtype=torch.float64, device=ref["time"].device)
    return {"time": unit, "next_rec": scale * L, "upd": scale * L,
            "log_w": mu * L * tree, "tl": tree, "B": tree, "tl_e": tree,
            "pending": per_block.repeat_interleave(E),
            "log_pilot": mu * L * tree, "df_pos": scale * L,
            "df_logf": mu * L * tree, "df_delta": scale * L, "df_k": 0.5}


def disagreement(got: dict, ref: dict, L: float, mu: float,
                 rtol: float = 1e-4):
    """Where two trip results (dicts of :data:`FIELDS`) differ.  Results
    of a segment pass are compared the same way: they hold ``tl`` and, under
    ``pending``, FIFO slot 0, and lack ``upd``, ``B`` and ``tl_e``; those
    of the biased pass hold :data:`BIAS_FIELDS` too.

    Returns ``(tree_differs, floats_differ, errs)``: [P] bool masks of the
    particles whose tree arrays differ, and of those whose tree arrays
    agree but a float lies beyond ``rtol * |ref| + atol`` (atol from
    :func:`float_tolerances`); ``errs[field] = (max abs error, max
    error / tolerance)`` over the particles whose tree arrays agree."""
    tree_differs = torch.zeros(ref["parent"].shape[0], dtype=torch.bool,
                               device=ref["parent"].device)
    for k in TREE_FIELDS:
        tree_differs |= (got[k] != ref[k]).any(dim=1)
    atol = float_tolerances(ref, L, mu)
    floats_differ = torch.zeros_like(tree_differs)
    errs = {}
    for k in (k for k in FLOAT_FIELDS if k in ref):
        a, b = got[k].double(), ref[k].double()
        err = (a - b).abs()
        ratio = torch.where(err > 0, err / (rtol * b.abs() + atol[k]), 0.0)
        if err.dim() > 1:
            err, ratio = err.amax(dim=1), ratio.amax(dim=1)
        err = torch.where(tree_differs, 0.0, err)
        ratio = torch.where(tree_differs, 0.0, ratio)
        floats_differ |= ratio > 1.0
        errs[k] = (float(err.max()), float(ratio.max()))
    return tree_differs, floats_differ, errs


def _check_caps(N: int, E: int) -> int:
    """Leaves for N nodes; raise outside the kernels' compile-time caps."""
    n = (N + 1) // 2
    if N != 2 * n - 1 or n < 2 or n > MAX_LEAVES:
        raise ValueError(f"trip kernel supports 2..{MAX_LEAVES} leaves, got N={N}")
    if E < 1 or E > MAX_EPOCHS:
        raise ValueError(f"trip kernel supports 1..{MAX_EPOCHS} epochs, got {E}")
    return n


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
    raise; nothing falls back.  The sweep launches :func:`segment_pass`;
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
    trip.launches += 1


trip.launches = 0


# ---------------------------------------------------------------------------
# a segment's whole tree pass
# ---------------------------------------------------------------------------


def _biased_trips(uniforms, leaf_status, time, parent, child0, child1,
                  next_rec, upd, log_w, tl, B, tl_e, pending, L, mu, rho,
                  epoch_start, inv2ne, has_data, b: BiasedPass):
    """The biased form of :func:`trip_plain`, IN PLACE: after each trip the
    posterior weight takes the whole importance weight, the pilot weight
    the no-mutation factor and the immediate part, and the delayed part
    goes into the particle's ring at ``front + next_rec`` (smc.py:968-1020
    of the JAX package)."""
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
    for j in range(uniforms.shape[0]):
        nr, up, B_pre = cur[4], cur[5], cur[8]
        active = nr < L_t
        if not bool(active.any()):
            break
        delta = torch.where(active, nr - up, torch.zeros_like(nr))
        cur, (h_r, t_c, log_iw, strength) = _trip_once(
            uniforms[j], int(leaf_status), *cur, L_t, mu_t, rho_t,
            epoch_start, eend, inv2ne, has_data, (b.heights, b.strengths))
        zero = torch.zeros_like(log_iw)
        lp = lp - mu_t * B_pre * delta
        cur = cur[:6] + (cur[6] + torch.where(active, log_iw, zero),) \
            + cur[7:]
        d_h = h_r if by_point else t_c
        strength_h = (strength if by_point
                      else b.strengths[section_of(b.heights, d_h)])
        immediate = (strength_h - 1.0).abs() < 1e-6
        imm = torch.where(immediate, log_iw, zero)
        late = log_iw - imm
        lp = lp + torch.where(active, imm, zero)
        delay = b.delays[epoch_index(epoch_start, d_h)]
        *ring, overflow = push_delayed(
            *ring, active & (late.abs() > 1e-9), nr + b.front, delay, late,
            b.delay_k)
        lp = lp + overflow
    if cur is not outs:
        for dst, src in zip(outs + (b.log_pilot, b.df_pos, b.df_logf,
                                    b.df_delta, b.df_k),
                            cur + (lp, *ring)):
            dst.copy_(src)


def segment_pass_plain(uniforms, leaf_status, time, parent, child0, child1,
                       next_rec, log_w, fifo, fifo_mask, tl_out, L, mu, rho,
                       epoch_start, inv2ne, has_data,
                       biased: BiasedPass | None = None):
    """Plain torch version of :func:`segment_pass` on any device (same
    arguments, same in-place contract): ``tree_summaries``, the trips
    (``trip_plain``, or :func:`_biased_trips`), the final extension, under
    bias the drain of the delayed factors due at ``front + L``, and the
    push into FIFO slot 0."""
    P = time.shape[0]
    E = epoch_start.shape[0]
    dev = time.device
    off_recomb_opp = 4 * E  # [coal_opp | coal_cnt | mig_opp | mig_cnt | ...]
    trees = Trees(parent=parent, time=time, child0=child0, child1=child1)
    epochs = Epochs(start=epoch_start, ne=(0.5 / inv2ne)[:, None])
    tl, tl_e, B = tree_summaries(trees, epochs, leaf_status, has_data)
    tl, tl_e, B = tl.contiguous(), tl_e.contiguous(), B.contiguous()
    upd = torch.zeros(P, device=dev)
    pending = torch.zeros((P, 6 * E), device=dev)

    # ---- recombination trips inside [front, front + L) ---------------------
    if uniforms.shape[0] > 0:
        args = (uniforms, leaf_status, time, parent, child0, child1, next_rec,
                upd, log_w, tl, B, tl_e, pending, L, mu, rho, epoch_start,
                inv2ne, has_data)
        if biased is None:
            trip_plain(*args)
        else:
            _biased_trips(*args, biased)

    # ---- final extension to the segment end --------------------------------
    delta = L - upd
    log_w.copy_(log_w - mu * B * delta)
    pending[:, off_recomb_opp:off_recomb_opp + E] += delta[:, None] * tl_e
    next_rec.copy_(next_rec - L)

    if biased is not None:
        # ---- the pilot's extension and the factors due at the end ----------
        b = biased
        lp = b.log_pilot - mu * B * delta
        add, *ring = apply_due_delayed(
            b.df_pos, b.df_logf, b.df_delta, b.df_k,
            float(np.float32(b.front) + np.float32(L)))
        b.log_pilot.copy_(lp + add)
        for dst, src in zip((b.df_pos, b.df_logf, b.df_delta, b.df_k), ring):
            dst.copy_(src)

    # ---- push pending increments into FIFO slot 0 --------------------------
    fifo[:, 0] += pending * fifo_mask[None, :]
    tl_out.copy_(tl)


def segment_pass(uniforms, leaf_status, time, parent, child0, child1,
                 next_rec, log_w, fifo, fifo_mask, tl_out, L, mu, rho,
                 epoch_start, inv2ne, has_data,
                 biased: BiasedPass | None = None):
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

    CPU tensors run :func:`segment_pass_plain`.  CUDA tensors launch the
    kernel of ``csrc/trip.cu`` on the current stream (one launch) or raise;
    nothing falls back.  Every call checks every tensor, as :func:`trip`
    does.  ``segment_pass.launches`` counts the launches of the plain
    kernel, ``segment_pass.biased_launches`` those of the biased one."""
    dev = time.device
    if dev.type == "cpu":
        segment_pass_plain(uniforms, leaf_status, time, parent, child0,
                           child1, next_rec, log_w, fifo, fifo_mask, tl_out,
                           L, mu, rho, epoch_start, inv2ne, has_data, biased)
        return
    if dev.type != "cuda":
        raise ValueError(f"segment_pass: unsupported device {dev}")
    P, N = time.shape
    E = epoch_start.shape[0]
    n = _check_caps(N, E)
    if fifo.dim() != 3:
        raise ValueError(f"fifo has shape {tuple(fifo.shape)}, expected "
                         f"(P, F, {6 * E})")
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
        ("fifo", fifo, f32, (P, F, 6 * E)),
        ("fifo_mask", fifo_mask, f32, (6 * E,)),
        ("tl_out", tl_out, f32, (P,)),
        ("epoch_start", epoch_start, f32, (E,)),
        ("inv2ne", inv2ne, f32, (E,)),
        ("has_data", has_data, torch.bool, (n,)),
    ]
    bias_args = (None,) * 8 + (0, 0, 0.0, 0, 0)  # the plain pass
    if biased is not None:
        b = biased
        K, S = b.df_pos.shape[-1], b.strengths.shape[0]
        if not 1 <= K <= MAX_DELAY_SLOTS or not 1 <= S <= MAX_SECTIONS:
            raise ValueError(f"biased segment_pass takes 1..{MAX_DELAY_SLOTS}"
                             f" delay slots and 1..{MAX_SECTIONS} sections, "
                             f"got {K} and {S}")
        if b.delay_type not in DELAY_TYPES or b.delay_k < 1:
            raise ValueError(f"delay type {b.delay_type!r}, k {b.delay_k}")
        spec += [
            ("log_pilot", b.log_pilot, f32, (P,)),
            ("df_pos", b.df_pos, f32, (P, K)),
            ("df_logf", b.df_logf, f32, (P, K)),
            ("df_delta", b.df_delta, f32, (P, K)),
            ("df_k", b.df_k, i32, (P, K)),
            ("heights", b.heights, f32, (S + 1,)),
            ("strengths", b.strengths, f32, (S,)),
            ("delays", b.delays, f32, (E,)),
        ]
        bias_args = (*(x.data_ptr() for x in (
            b.log_pilot, b.df_pos, b.df_logf, b.df_delta, b.df_k, b.heights,
            b.strengths, b.delays)), K, S, float(b.front),
            DELAY_TYPES[b.delay_type], int(b.delay_k))
    for name, x, dtype, shape in spec:
        _check_tensor(name, x, dtype, shape, dev)
    _launch("smc_segment_pass_launch", dev,
            uniforms.data_ptr(), T, P, n, E, F, int(leaf_status),
            time.data_ptr(), parent.data_ptr(), child0.data_ptr(),
            child1.data_ptr(), next_rec.data_ptr(), log_w.data_ptr(),
            fifo.data_ptr(), fifo_mask.data_ptr(), tl_out.data_ptr(),
            float(L), float(mu), float(rho), epoch_start.data_ptr(),
            inv2ne.data_ptr(), has_data.data_ptr(), *bias_args)
    if biased is None:
        segment_pass.launches += 1
    else:
        segment_pass.biased_launches += 1


# launches of the plain and of the biased kernel
segment_pass.launches = 0
segment_pass.biased_launches = 0
