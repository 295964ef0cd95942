"""The recombination guide (``-guide``, and the guide loop of ``-alpha``):
plain torch pieces of the guided segment pass.

Counterparts: the guide closures of ``smcsmc_tpu/smc.py::make_segment_step``
(:783-812: ``mass``, ``inv_mass``, ``draw_gap``, ``span_log_iw``) and the
guided gap of ``init_state`` (:294-303).  A guide file gives a
recombination rate per window of ``ws`` bp; in "guide mass"
``m(x) = (1/rho) * integral of the rate up to x`` the proposal's
recombination process is homogeneous, so a gap drawn as usual in mass
units maps back to a genome position through ``inv_mass``.  Each extension
over ``[x0, x1)`` takes the survival importance weight ``rho * tl *
(m(x1) - m(x0) - (x1 - x0))`` (particle.cpp:1138-1182), in both weights.

``cum_mass`` is built on the host once per chunk, in float32, in the order
of the JAX package's ``jnp.cumsum`` on the CPU (:func:`xla_cumsum`), so that
both packages search the same table; beside it the pivots of the search's
first steps (:func:`search_pivots`), which the guided kernels keep in
shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# nodes of the decision tree of the mass table's search whose pivots the
# guided kernels keep (csrc/trip.cu's GUIDE_TOP): its first 9 steps
SEARCH_NODES = 512


class GuideTables(NamedTuple):
    """A guide resampled to the sweep's windows, on the device."""

    g_rel: torch.Tensor  # [Wg] f32 rate relative to rho
    cum_mass: torch.Tensor  # [Wg + 1] f32 mass at the window boundaries (bp)
    g_leaf: torch.Tensor  # [Wg, n] f32 relative rate of each leaf
    ws: float  # window size (bp)
    pivots: torch.Tensor  # [SEARCH_NODES] f32 (search_pivots of cum_mass)


def search_pivots(cum: np.ndarray) -> np.ndarray:
    """[SEARCH_NODES] the boundaries the binary search of ``cum`` (the first
    index whose boundary is above m, over [0, len(cum))) reads first, by
    node of its decision tree in heap order: node 1 the first step's pivot,
    nodes 2h and 2h + 1 the next step's after h's pivot was above m or at
    or below it; 0 where the search ends before the node."""
    out = np.zeros(SEARCH_NODES, np.float32)
    for h in range(1, SEARCH_NODES):
        lo, hi = 0, len(cum)
        for d in range(h.bit_length() - 2, -1, -1):
            if lo >= hi:
                break
            mid = (lo + hi) >> 1
            if (h >> d) & 1:
                lo = mid + 1
            else:
                hi = mid
        if lo < hi:
            out[h] = cum[(lo + hi) >> 1]
    return out


def xla_cumsum(x: np.ndarray, base: int = 16) -> np.ndarray:
    """Inclusive float32 prefix sum in the order of XLA's CPU
    ``reduce-window`` rewrite (what ``jnp.cumsum`` runs on the CPU): rows of
    ``base`` summed in order, the rows' totals scanned the same way
    recursively, and each row's exclusive prefix added to it."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    rows = max(-(-n // base), 1)
    padded = np.zeros(rows * base, np.float32)
    padded[:n] = x
    within = np.cumsum(padded.reshape(rows, base), axis=1, dtype=np.float32)
    totals = within[:, -1]
    incl = (xla_cumsum(totals, base) if rows > base
            else np.cumsum(totals, dtype=np.float32))
    before = np.concatenate([np.zeros(1, np.float32), incl[:-1]])
    return (within + before[:, None]).reshape(-1)[:n].astype(np.float32)


def guide_tables(g_rate, g_leaf, rho: float, ws: float,
                 device) -> GuideTables:
    """GuideTables from a chunk's per-window guide rates [Wg] and leaf rates
    [Wg, n] (``recombio.guide_to_windows``), as the JAX step builds them:
    ``g_rel = g_rate / max(rho, 1e-38)``, ``cum_mass = [0, cumsum(g_rel *
    ws)]``, all in float32; and the search's first pivots of ``cum_mass``
    (:func:`search_pivots`)."""
    rho32 = np.float32(max(np.float32(rho), np.float32(1e-38)))
    g_rel = (np.asarray(g_rate, np.float32) / rho32).astype(np.float32)
    cum = np.concatenate([np.zeros(1, np.float32),
                          xla_cumsum(g_rel * np.float32(ws))])
    on = [torch.as_tensor(np.ascontiguousarray(x)).to(device)
          for x in (g_rel, cum, np.asarray(g_leaf, np.float32),
                    search_pivots(cum))]
    return GuideTables(*on[:3], float(ws), on[3])


def _window(g: GuideTables, x: torch.Tensor) -> torch.Tensor:
    """[P] int64 window of positions ``x`` (chunk relative), clipped."""
    Wg = g.g_rel.shape[0]
    return torch.floor(x / g.ws).clamp(0, Wg - 1).long()


def mass(g: GuideTables, x: torch.Tensor) -> torch.Tensor:
    """Guide mass (bp) at positions ``x``: ``cum_mass[i] + (x - i ws)
    g_rel[i]`` in the window i of x (the first or last beyond the ends)."""
    i = _window(g, x)
    return g.cum_mass[i] + (x - i.to(torch.float32) * g.ws) * g.g_rel[i]


def inv_mass(g: GuideTables, m: torch.Tensor) -> torch.Tensor:
    """Position of guide mass ``m``: the last window boundary at or below m
    (``searchsorted(side="right") - 1``, clipped), plus the rest of m at
    that window's rate."""
    Wg = g.g_rel.shape[0]
    j = (torch.searchsorted(g.cum_mass, m.contiguous(), right=True) - 1
         ).clamp(0, Wg - 1)
    return (j.to(torch.float32) * g.ws
            + (m - g.cum_mass[j]) / g.g_rel[j].clamp(min=1e-30))


def draw_gap(g: GuideTables, x_exp: torch.Tensor, rho: float,
             tl: torch.Tensor, abs_pos: torch.Tensor) -> torch.Tensor:
    """Next recombination distance from ``abs_pos`` under the guide, for
    the unit exponentials ``x_exp``: the gap in mass units is ``x_exp /
    max(rho tl, 1e-30)``; at least 1e-3 bp."""
    gap_m = x_exp / (rho * tl).clamp(min=1e-30)
    nxt = inv_mass(g, mass(g, abs_pos) + gap_m)
    return (nxt - abs_pos).clamp(min=1e-3)


def span_log_iw(g: GuideTables, rho: float, tl: torch.Tensor,
                x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Log survival importance weight over [x0, x1): the sampled minus the
    target hazard, ``rho tl (m(x1) - m(x0) - (x1 - x0))``."""
    dm = mass(g, x1) - mass(g, x0)
    return rho * tl * (dm - (x1 - x0))


def leaf_rates_at(g: GuideTables, x: torch.Tensor) -> torch.Tensor:
    """[P, n] leaf rates of the windows holding positions ``x``: the JAX
    step's ``g_leaf[clip(int(x / ws), 0, Wg - 1)]``."""
    Wg = g.g_rel.shape[0]
    return g.g_leaf[(x / g.ws).to(torch.int64).clamp(0, Wg - 1)]
