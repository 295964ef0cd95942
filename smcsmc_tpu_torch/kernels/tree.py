"""Array-encoded genealogies and batched coalescent primitives
(counterpart of ``smcsmc_tpu/kernels/tree.py``).

Node layout for ``n`` sampled haplotypes: nodes ``0..n-1`` are leaves,
``n..2n-2`` internal; the root has ``parent == -1``.  The branch above node
``i`` spans ``[time[i], time[parent[i]])``; the root's branch above is its
unbounded ancestral lineage.  Every function works on the whole particle
batch (leading axis P) with plain gathers and cumulative sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NO_NODE = -1
INF = 3e38  # float32-representable "infinity" shared with the CUDA kernel
_MAX_EVENTS = 256  # event bound of the initial-tree walk (JAX max_iters)


class Trees(NamedTuple):
    """Batched genealogy state (single population, no migration buffers).

    parent, child0, child1 : [P, N] int32 (-1 at the root / for leaves)
    time                   : [P, N] float32 node heights (generations)
    """

    parent: torch.Tensor
    time: torch.Tensor
    child0: torch.Tensor
    child1: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.parent.shape[-1]

    @property
    def num_leaves(self) -> int:
        return (self.num_nodes + 1) // 2


class Epochs(NamedTuple):
    """Device-side piecewise-constant demography of one population.

    start : [E] float32 epoch start times, start[0] == 0
    ne    : [E, 1] float32 diploid population sizes
    """

    start: torch.Tensor
    ne: torch.Tensor

    @property
    def num_epochs(self) -> int:
        return self.start.shape[0]

    @property
    def num_pops(self) -> int:
        return self.ne.shape[1]

    @property
    def end(self) -> torch.Tensor:
        """[E] epoch ends; the last epoch ends at INF."""
        return torch.cat([self.start[1:], self.start.new_full((1,), INF)])

    @property
    def inv2ne(self) -> torch.Tensor:
        """[E] coalescence rate per lineage pair, 1 / (2 Ne)."""
        return 1.0 / (2.0 * self.ne[:, 0])


def epochs_from_demography(demo, device) -> Epochs:
    """Build device Epochs from a host ``demography.Demography``.

    Raises NotImplementedError for structured models: the port covers one
    population without migration."""
    if demo.num_populations != 1 or np.any(demo.mig_rates > 0):
        raise NotImplementedError(
            "the torch port supports one population without migration "
            "(ROADMAP queue 1, migration)"
        )
    return Epochs(
        start=torch.as_tensor(demo.change_times, dtype=torch.float32,
                              device=device),
        ne=torch.as_tensor(demo.pop_sizes, dtype=torch.float32, device=device),
    )


def _pick(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[p, idx[p, ...]] along the node axis, 0 where idx < 0."""
    got = torch.gather(arr, 1, idx.clamp(min=0).long())
    return torch.where(idx >= 0, got, torch.zeros_like(got))


def parent_time(time: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """[P, N] time of each node's parent; INF at the root."""
    pt = torch.gather(time, 1, parent.clamp(min=0).long())
    return torch.where(parent < 0, torch.full_like(pt, INF), pt)


def branch_lengths(time: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """[P, N] finite branch lengths (0 for the root's lineage)."""
    pt = parent_time(time, parent)
    return torch.where(parent < 0, torch.zeros_like(pt), pt - time)


def branch_length_per_epoch(time, parent, epoch_start, epoch_end):
    """[P, E] total finite branch length inside each epoch."""
    pt = parent_time(time, parent)
    lo = torch.maximum(time[:, None, :], epoch_start[None, :, None])  # [P,E,N]
    hi = torch.minimum(pt[:, None, :], epoch_end[None, :, None])
    overlap = (hi - lo).clamp(min=0.0)
    overlap = torch.where(parent[:, None, :] < 0, torch.zeros_like(overlap),
                          overlap)
    return overlap.sum(dim=2)


def leaf_ancestor_ids(parent: torch.Tensor) -> torch.Tensor:
    """[P, n, n] node ids: column 0 is each leaf itself, column k its k-th
    ancestor (-1 past the root).  A leaf has at most n-1 ancestors."""
    P, N = parent.shape
    n = (N + 1) // 2
    cur = torch.arange(n, device=parent.device, dtype=parent.dtype)
    cur = cur.expand(P, n)
    cols = [cur]
    for _ in range(n - 1):
        cur = torch.where(cur >= 0, _pick(parent, cur), torch.full_like(cur, -1))
        cols.append(cur)
    return torch.stack(cols, dim=2)


def count_data_leaves_below(parent: torch.Tensor,
                            has_data: torch.Tensor) -> torch.Tensor:
    """[P, N] number of data-carrying leaves below (and including) each
    node: each leaf adds its data flag along its ancestor chain."""
    P, N = parent.shape
    n = (N + 1) // 2
    ids = leaf_ancestor_ids(parent).reshape(P, n * n)
    vals = has_data.to(torch.int32)[:, None].expand(n, n).reshape(1, n * n)
    vals = torch.where(ids >= 0, vals.expand(P, -1), torch.zeros_like(ids))
    cnt = torch.zeros((P, N + 1), dtype=torch.int32, device=parent.device)
    # ids == -1 land in the spare column N, which is dropped
    cnt.scatter_add_(1, torch.where(ids >= 0, ids, N).long(), vals)
    return cnt[:, :N]


def data_branch_length(time, parent, has_data) -> torch.Tensor:
    """[P] length of branches informative about mutations: at least one
    data-carrying leaf below and not all of them."""
    cnt = count_data_leaves_below(parent, has_data)
    total = has_data.to(torch.int32).sum()
    bl = branch_lengths(time, parent)
    informative = (cnt >= 1) & (cnt < total)
    return torch.where(informative, bl, torch.zeros_like(bl)).sum(dim=1)


def tree_summaries(trees: Trees, epochs: Epochs, leaf_status: int,
                   has_data: torch.Tensor):
    """tree length [P], per-epoch tree length [P, E], data branch length
    [P] for a segment's leaf status (-1 all missing / 0 mixed / 1 complete)."""
    tl_e = branch_length_per_epoch(trees.time, trees.parent, epochs.start,
                                   epochs.end)
    tl = tl_e.sum(dim=1)
    if leaf_status <= -1:
        B = torch.zeros_like(tl)
    elif leaf_status >= 1:
        B = tl
    else:
        B = data_branch_length(trees.time, trees.parent, has_data)
    return tl, tl_e, B


# ---------------------------------------------------------------------------
# initial tree sampling (counterpart of tree.make_initial_trees with
# max_mig=0; reference: scrm buildInitialTree)
# ---------------------------------------------------------------------------


def make_initial_trees(
    generator: torch.Generator,
    epochs: Epochs,
    num_particles: int,
    sample_pop,
    sample_time=None,
) -> Trees:
    """Draw the initial genealogies at sequence position 0 by an
    event-driven coalescent walk over {epoch boundary, sample activation,
    coalescence}, all particles advancing together; the loop ends when no
    particle has more than one lineage left (one host read per event)."""
    if epochs.num_pops != 1:
        raise NotImplementedError(
            "make_initial_trees supports one population (ROADMAP queue 1, "
            "migration)"
        )
    dev = epochs.start.device
    sample_pop = np.asarray(sample_pop)
    n = int(sample_pop.shape[0])
    if np.any(sample_pop != 0):
        raise NotImplementedError("samples must all come from population 0")
    if sample_time is None:
        sample_time = np.zeros(n)
    st = torch.as_tensor(np.asarray(sample_time), dtype=torch.float32,
                         device=dev)
    P, N, E = num_particles, 2 * n - 1, epochs.num_epochs
    f32, i32 = torch.float32, torch.int32

    parent = torch.full((P, N), NO_NODE, dtype=i32, device=dev)
    child0 = torch.full((P, N), NO_NODE, dtype=i32, device=dev)
    child1 = torch.full((P, N), NO_NODE, dtype=i32, device=dev)
    time = torch.cat([st, torch.zeros(n - 1, device=dev)]).expand(P, N).clone()
    node_id = torch.arange(n, dtype=i32, device=dev).expand(P, n).clone()
    alive = (st <= 0.0).expand(P, n).clone()
    t = torch.zeros(P, dtype=f32, device=dev)
    next_id = torch.full((P,), n, dtype=i32, device=dev)
    cols_N = torch.arange(N, device=dev)
    cols_n = torch.arange(n, device=dev)
    inf = torch.tensor(INF, dtype=f32, device=dev)

    def live():
        pending = (st[None, :] > t[:, None]).sum(dim=1)
        return (alive.sum(dim=1) + pending) > 1

    def uniform(lo=0.0, hi=1.0):
        return torch.rand(P, generator=generator, device=dev) * (hi - lo) + lo

    for _ in range(_MAX_EVENTS):
        go = live()
        if not bool(go.any()):
            break
        e = (torch.searchsorted(epochs.start, t, right=True) - 1).clamp(0, E - 1)
        m = alive.sum(dim=1)
        k = m.to(f32)
        total = k * (k - 1.0) / 2.0 / (2.0 * epochs.ne[e, 0])
        e_end = torch.where(e + 1 < E, epochs.start[(e + 1).clamp(max=E - 1)],
                            inf)
        future = torch.where(st[None, :] > t[:, None], st[None, :], inf)
        t_bk = torch.minimum(e_end, future.min(dim=1).values)
        u = uniform(1e-7, 1.0 - 1e-7)
        dt = torch.where(total > 0,
                         -torch.log1p(-u) / total.clamp(min=1e-30), inf)
        hit_bk = t + dt >= t_bk
        t_new = torch.where(hit_bk, t_bk, t + dt)

        # two distinct alive lineages, uniformly
        r1 = torch.floor(uniform() * m.clamp(min=1)).to(i32)
        r2 = torch.floor(uniform() * (m - 1).clamp(min=1)).to(i32)
        r2 = torch.where(r2 >= r1, r2 + 1, r2)
        csum = alive.to(i32).cumsum(dim=1) - 1
        slot1 = ((csum == r1[:, None]) & alive).to(i32).argmax(dim=1)
        slot2 = ((csum == r2[:, None]) & alive).to(i32).argmax(dim=1)
        a = node_id.gather(1, slot1[:, None])[:, 0]
        b = node_id.gather(1, slot2[:, None])[:, 0]
        do = go & ~hit_bk & (m >= 2)

        hit_a = (cols_N[None, :] == a[:, None]) & do[:, None]
        hit_b = (cols_N[None, :] == b[:, None]) & do[:, None]
        hit_m = (cols_N[None, :] == next_id[:, None]) & do[:, None]
        parent = torch.where(hit_a | hit_b, next_id[:, None], parent)
        child0 = torch.where(hit_m, a[:, None], child0)
        child1 = torch.where(hit_m, b[:, None], child1)
        time = torch.where(hit_m, t_new[:, None], time)
        node_id = torch.where(
            (cols_n[None, :] == slot1[:, None]) & do[:, None],
            next_id[:, None], node_id)
        alive = alive & ~((cols_n[None, :] == slot2[:, None]) & do[:, None])
        next_id = torch.where(do, next_id + 1, next_id)

        # sample activation at breakpoints
        act = go[:, None] & hit_bk[:, None] & torch.isclose(
            st[None, :].expand(P, n), t_bk[:, None].expand(P, n))
        alive = alive | act
        t = torch.where(go, t_new, t)
    return Trees(parent=parent, time=time, child0=child0, child1=child1)
