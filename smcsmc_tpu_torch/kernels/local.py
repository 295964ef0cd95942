"""Local recombination recording (the windows behind ``.recomb.gz``, which
the guide loop of ``-alpha`` smooths into the next iteration's guide):
the ring of pending events and the window accumulators.

Counterparts: ``smcsmc_tpu/smc.py::_push_local_event`` (:557),
``_add_window_opportunity`` (:576) and ``_commit_due_local`` (:603)
(count.cpp:559-654 of the reference).  Each recombination trip pushes one
pending event into its particle's ring: the position, the position at
which it is due (``pos + lag[epoch(h_r)]``), the height and the leaves below
the cut branch before the SPR.  Once per segment the segment's
recombination opportunity, weighted by the normalised weights, is spread
over the segment's windows, and every event that has come due is added to
its window with the particle's weight at that time (1 / leaves per leaf,
plus the height and log(height + 1) columns).

The window accumulators live in one tensor ``win_cnt`` [W, n + 2]:
columns 0..n-1 the leaf counts, n the time-weighted and n + 1 the
log-time-weighted count.  The commit gathers the events that are due
(``nonzero``: one read by the host per segment) and adds them with one
``index_put_(accumulate=True)``, whose CUDA form sorts the indices and
sums each window's addends in one fixed order, so that a seed gives the
same accumulators, and the same ``.recomb.gz``, in every run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .tree import INF

# slots of the ring of pending events (PFConfig.local_ring; the CUDA
# kernel's MAX_LOCAL_SLOTS)
MAX_LOCAL_SLOTS = 32


class LocalPass(NamedTuple):
    """What a segment pass with local recording reads and updates beyond
    its variant's own tensors.  The ring and ``dropped`` are updated IN
    PLACE and ``ropp`` is written."""

    lr_pos: torch.Tensor  # [P, R] f32 event position (INF: free slot)
    lr_due: torch.Tensor  # [P, R] f32 commit position
    lr_time: torch.Tensor  # [P, R] f32 recombination height
    lr_desc: torch.Tensor  # [P, R] i64 leaves below the cut branch
    lr_dropped: torch.Tensor  # [] i32 events dropped on a full ring
    lags: torch.Tensor  # [E] f32 lag (bp) by epoch
    ropp: torch.Tensor  # [P] f32 out: the segment's ungated recombination
    # opportunity, sum over epochs of the pending row
    front: float  # the segment's start, chunk relative (host float32)


def push_local_event(lr_pos, lr_due, lr_time, lr_desc, lr_dropped, mask,
                     pos, due, height, desc):
    """Insert one pending event per masked particle into the first free
    slot of its ring; a full ring drops the event and counts it.  Returns
    the new ring and count."""
    R = lr_pos.shape[1]
    free = lr_pos >= 0.5 * INF
    has_free = free.any(dim=1)
    slot = free.to(torch.int32).argmax(dim=1)
    do = mask & has_free
    hit = (torch.arange(R, device=lr_pos.device)[None, :] == slot[:, None]) \
        & do[:, None]
    lr_pos = torch.where(hit, pos[:, None], lr_pos)
    lr_due = torch.where(hit, due[:, None], lr_due)
    lr_time = torch.where(hit, height[:, None], lr_time)
    lr_desc = torch.where(hit, desc[:, None], lr_desc)
    lr_dropped = lr_dropped + (mask & ~has_free).sum().to(torch.int32)
    return lr_pos, lr_due, lr_time, lr_desc, lr_dropped


def window_opportunity_terms(x_start, x_end, ws: float, W: int):
    """Host half of the opportunity update over [x_start, x_end): the
    span, and the indices into the differential density [W + 1] with the
    factors that multiply the density, in the JAX package's order (the
    first and last windows fractional); None for an empty span."""
    f32 = np.float32
    x_start, x_end, ws32 = f32(x_start), f32(x_end), f32(ws)
    span = f32(x_end - x_start)
    if not span > 0:
        return None
    fi = int(np.floor(f32(x_start / ws32)))
    li = int(np.floor(f32(x_end / ws32))) + 1
    f_int = f32(np.minimum(f32(fi + 1) * ws32, x_end) - x_start)
    l_int = f32(x_end - np.maximum(f32(li - 1) * ws32, x_start))
    if fi == li - 1:
        coef = [f_int, -f_int, f32(0.0), f32(0.0)]
    else:
        coef = [f_int, f32(ws32 - f_int), f32(l_int - ws32), -l_int]
    idx = [min(max(k, 0), W) for k in (fi, fi + 1, li - 1, li)]
    return span, idx, coef


def add_window_opportunity(win_opp_diff: torch.Tensor, x_start, x_end,
                           total_opp: torch.Tensor, ws: float) -> None:
    """Spread ``total_opp`` (a [] tensor) over [x_start, x_end) as a
    density, IN PLACE into the differential per-window opportunity
    ``win_opp_diff`` [W + 1] (cumsum at dump time gives each window's
    opportunity): one term after another, in the JAX package's order."""
    W = win_opp_diff.shape[0] - 1
    terms = window_opportunity_terms(x_start, x_end, ws, W)
    if terms is None:
        return
    span, idx, coef = terms
    dens = total_opp / float(max(span, np.float32(1e-30)))
    for i, c in zip(idx, coef):
        if c != 0.0:
            win_opp_diff[i] += dens * float(c)


def commit_due_local(win_cnt: torch.Tensor, lr_pos, lr_due, lr_time,
                     lr_desc, w: torch.Tensor, front: float,
                     ws: float) -> None:
    """Add every pending event due at ``front`` (``lr_due <= front``) to
    its window with its particle's normalised weight ``w`` [P], and free
    its slot; IN PLACE on ``win_cnt`` [W, n + 2] and the ring.  The due
    events are taken in (particle, slot) order."""
    W, n = win_cnt.shape[0], win_cnt.shape[1] - 2
    R = lr_pos.shape[1]
    due = (lr_due <= front) & (lr_pos < 0.5 * INF)
    at = due.view(-1).nonzero().squeeze(1)
    if at.numel() == 0:
        return
    pos, time = lr_pos.view(-1)[at], lr_time.view(-1)[at]
    shift = torch.arange(n, dtype=torch.int64, device=lr_desc.device)
    bits = (lr_desc.view(-1)[at][:, None] >> shift) & 1  # [D, n]
    nd = bits.sum(dim=1).clamp(min=1).to(torch.float32)
    wt = w[at // R]
    vals = torch.cat([(wt / nd)[:, None] * bits.to(torch.float32),
                      (wt * time)[:, None],
                      (wt * torch.log(time + 1.0))[:, None]], dim=1)
    widx = (pos / ws).clamp(0, W - 1).to(torch.int64)
    win_cnt.index_put_((widx,), vals, accumulate=True)
    lr_pos.view(-1).index_fill_(0, at, INF)
    lr_due.view(-1).index_fill_(0, at, INF)


def split_windows(win_cnt) -> tuple:
    """(leaf_cnt [W, n], time_cnt [W], logtime_cnt [W]) of ``win_cnt``,
    the JAX package's three accumulators."""
    n = win_cnt.shape[1] - 2
    return win_cnt[:, :n], win_cnt[:, n], win_cnt[:, n + 1]
