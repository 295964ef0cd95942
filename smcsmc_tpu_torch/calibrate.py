"""Pre-passes that tune the biased proposal from the model (counterpart of
``smcsmc_tpu/calibrate.py``, the port's own code).

- :func:`default_bias_strengths`: section strengths that equalise the
  expected proposal mass across the bias sections (getBiasRatio,
  model_summary.hpp:119-133), from the branch length that trees drawn from
  the model have in each section.
- :func:`calibrate_survival` and :func:`calibrated_lags_and_delays`: the
  median genomic distance a tree node survives, by epoch of its height
  (calculate_median_survival_distances, smcsmc.cpp:169-263); ``lag =
  lag_fraction * survival`` and the delayed factors' application ``delay =
  delay_fraction * survival``.  The genealogies advance through the SMC'
  process with the ``trip`` kernel, one trip per launch; births, the
  per-epoch histogram of survival distances and its medians stay on the
  device.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .kernels.tree import (
    INF,
    Epochs,
    branch_length_per_epoch,
    branch_lengths,
    make_initial_trees,
    tree_summaries,
)
from .kernels.trip import trip

logger = logging.getLogger("smcsmc_tpu_torch")


def default_bias_strengths(generator: torch.Generator, epochs: Epochs,
                           sample_pop, bias_heights, num_trees: int = 20_000,
                           batch: int = 10_000,
                           max_strength: float = 10.0) -> tuple:
    """Strength of each bias section ``[0, h_1), [h_1, h_2), ..., [h_S,
    inf)``: with ``B_j`` the mean branch length of trees from the model
    inside section j, ``s_j = B_last / B_j``, clipped to [1,
    ``max_strength``], so that recent sections with little branch length
    get proportionally more proposals and the last keeps strength 1."""
    dev = epochs.start.device
    heights = np.concatenate([[0.0], np.asarray(bias_heights, np.float64)])
    starts = torch.as_tensor(heights, dtype=torch.float32, device=dev)
    ends = torch.cat([starts[1:], starts.new_full((1,), INF)])
    acc = np.zeros(len(heights))
    reps = (num_trees + batch - 1) // batch
    for _ in range(reps):
        trees = make_initial_trees(generator, epochs, batch, sample_pop)
        b = branch_length_per_epoch(trees.time, trees.parent, starts, ends)
        acc += b.mean(dim=0).double().cpu().numpy()
    b = acc / reps
    b = np.maximum(b, 1e-6 * b.sum() + 1e-30)
    s = b[-1] / b
    return tuple(float(x) for x in np.clip(s, 1.0, max_strength))


def _hist_median(counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Median of histograms ``counts`` [..., B] as the center of the bin
    where the cumulative count reaches half the total (NaN if empty)."""
    total = counts.sum(dim=-1, keepdim=True)
    cum = counts.cumsum(dim=-1)
    i = torch.searchsorted(cum, total / 2.0).clamp(max=centers.shape[0] - 1)
    med = centers[i[..., 0]]
    return torch.where(total[..., 0] > 0, med, torch.full_like(med, np.nan))


def calibrate_survival(generator: torch.Generator, epochs: Epochs, sample_pop,
                       rho: float, num_particles: int = 256,
                       distance: float = 2e6, num_windows: int = 20,
                       num_bins: int = 64) -> np.ndarray:
    """[E] median survival distance (bp) of nodes whose height falls in
    each epoch; an epoch with fewer than 10 deaths takes the median of all.

    ``num_particles`` genealogies advance ``distance`` bp in windows.  Each
    launch of ``trip`` takes every genealogy whose next recombination lies
    inside the window through one SMC' transition; the SPR moves only node
    ``p``, the parent of the cut branch, to the coalescence time, so a node
    whose time changed by more than 1e-3 is ``p``: it died there, and the
    node in its slot is born there.  Survival distances go into a
    histogram per epoch of the dead node's height, over log-spaced bins
    from 100 bp to 10 ``distance``."""
    dev = epochs.start.device
    E, Q = epochs.num_epochs, num_particles
    window = float(np.float32(distance / num_windows))
    edges_f32 = np.logspace(2, np.log10(distance * 10), num_bins - 1).astype(
        np.float32)
    bin_edges = torch.as_tensor(edges_f32, device=dev)
    edges = np.concatenate([[0.0], edges_f32.astype(np.float64),
                            [distance * 10]])
    centers = torch.as_tensor(0.5 * (edges[:-1] + edges[1:]), device=dev)

    trees = make_initial_trees(generator, epochs, Q, sample_pop)
    n = trees.num_leaves
    time, parent = trees.time.contiguous(), trees.parent.contiguous()
    child0, child1 = trees.child0.contiguous(), trees.child1.contiguous()
    has_data = torch.ones(n, dtype=torch.bool, device=dev)
    tl, tl_e, B = tree_summaries(trees, epochs, 1, has_data)
    tl, tl_e, B = tl.contiguous(), tl_e.contiguous(), B.clone()
    expo = torch.empty(Q, device=dev).exponential_(1.0, generator=generator)
    next_rec = expo / (rho * branch_lengths(time, parent).sum(dim=1))
    upd = torch.zeros(Q, device=dev)
    log_w = torch.zeros(Q, device=dev)
    pending = torch.zeros((Q, 6 * E), device=dev)
    start, inv2ne = epochs.start.contiguous(), epochs.inv2ne.contiguous()
    birth = torch.zeros_like(time)
    hist = torch.zeros(E * num_bins, dtype=torch.float64, device=dev)

    x0, trips = 0.0, 0
    for _ in range(num_windows):
        while bool((next_rec < window).any()):
            trips += 1
            pre_time, pre_nr = time.clone(), next_rec.clone()
            u = torch.rand((1, Q, 4), generator=generator, device=dev)
            trip(u, 1, time, parent, child0, child1, next_rec, upd, log_w,
                 tl, B, tl_e, pending, window, 0.0, rho, start, inv2ne,
                 has_data)
            moved = (time - pre_time).abs() > 1e-3
            died = moved.any(dim=1)
            p = moved.to(torch.int32).argmax(dim=1, keepdim=True)
            pos = pre_nr[:, None] + x0
            surv = (pos - birth.gather(1, p))[:, 0]
            old_t = pre_time.gather(1, p)[:, 0]
            e_old = (torch.searchsorted(start, old_t, right=True) - 1).clamp(
                0, E - 1)
            b_idx = torch.searchsorted(bin_edges, surv)
            hist.index_add_(0, e_old * num_bins + b_idx, died.double())
            birth.scatter_(1, p, torch.where(died[:, None], pos,
                                             birth.gather(1, p)))
        next_rec -= window
        x0 += window

    h = hist.view(E, num_bins)
    overall = _hist_median(h.sum(dim=0), centers)
    medians = torch.where(h.sum(dim=1) >= 10, _hist_median(h, centers),
                          overall)
    logger.info("survival calibration: %d trip launches for %d genealogies "
                "over %g bp", trips, Q, distance)
    return medians.cpu().numpy()


def calibrated_lags_and_delays(generator: torch.Generator, epochs: Epochs,
                               sample_pop, rho: float,
                               lag_fraction: float = 2.0, delay: float = 0.5,
                               **kw):
    """(lags [E], delays [E]): ``lag_fraction`` and ``delay`` times the
    calibrated survival distance (20 kb where none was observed)."""
    surv = calibrate_survival(generator, epochs, sample_pop, rho, **kw)
    surv = np.nan_to_num(surv, nan=20000.0)
    return lag_fraction * surv, delay * surv
