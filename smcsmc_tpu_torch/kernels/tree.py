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
    """Batched genealogy state.

    parent, child0, child1 : [P, N] int32 (-1 at the root / for leaves)
    time                   : [P, N] float32 node heights (generations)
    pop                    : [P, N] int32 population of the lineage at the
                             node's own time (None: one population)
    mig_time               : [P, N, Mw] float32 migration events on the
                             branch above each node, ascending, INF-padded
    mig_dest               : [P, N, Mw] int32 destination population of
                             each event (backwards in time), 0 as padding
    The last three are None for a model of one population, as the JAX
    package's ``max_mig=0`` omits them.
    """

    parent: torch.Tensor
    time: torch.Tensor
    child0: torch.Tensor
    child1: torch.Tensor
    pop: torch.Tensor | None = None
    mig_time: torch.Tensor | None = None
    mig_dest: torch.Tensor | None = None

    @property
    def num_nodes(self) -> int:
        return self.parent.shape[-1]

    @property
    def num_leaves(self) -> int:
        return (self.num_nodes + 1) // 2


class Epochs(NamedTuple):
    """Device-side piecewise-constant demography.

    start   : [E] float32 epoch start times, start[0] == 0
    ne      : [E, Pp] float32 diploid population sizes
    mig     : [E, Pp, Pp] float32 backwards migration rates per generation
    pop_map : [E, Pp] int32 population relabelling per epoch (-ej splits)
    """

    start: torch.Tensor
    ne: torch.Tensor
    mig: torch.Tensor | None = None
    pop_map: torch.Tensor | None = None

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
        """[E] coalescence rate per lineage pair of population 0,
        1 / (2 Ne)."""
        return 1.0 / (2.0 * self.ne[:, 0])

    @property
    def structured(self) -> bool:
        """More than one population: the sweep runs the migration walk."""
        return self.num_pops > 1


def epochs_from_demography(demo, device) -> Epochs:
    """Build device Epochs from a host ``demography.Demography``
    (tree.py:117 of the JAX package)."""
    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    return Epochs(
        start=f32(demo.change_times),
        ne=f32(demo.pop_sizes),
        mig=f32(demo.mig_rates),
        pop_map=torch.as_tensor(np.asarray(demo.pop_map_at_epoch()),
                                dtype=torch.int32, device=device),
    )


def branch_pop_at(pop: torch.Tensor, mig_time: torch.Tensor,
                  mig_dest: torch.Tensor, pop_map_e: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """[P, N] population of each branch at times ``t`` [P]: the branch's
    own population after its migration events at or below t, relabelled by
    the epoch's ``pop_map_e`` [P, Pp] (tree.py:67)."""
    if mig_time is None:
        return pop_map_e.gather(1, pop.long())
    k = (mig_time <= t[:, None, None]).sum(dim=2)  # [P, N] events applied
    last = mig_dest.gather(2, (k - 1).clamp(min=0)[:, :, None].long())[..., 0]
    last = torch.where(k > 0, last, pop)
    return pop_map_e.gather(1, last.long())


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


def descendant_bitmask(parent: torch.Tensor) -> torch.Tensor:
    """[P, N] int64 bitmask of the sample leaves below (and including) each
    node, bit l for leaf l: the JAX package's ``descendant_bitmask`` and
    ``descendant_bitmask64`` (tree.py:271/:292) in one word of up to 64
    leaves (the reference's u64 Descendants_t, descendants.hpp:16)."""
    P, N = parent.shape
    n = (N + 1) // 2
    if n > 64:
        raise ValueError(f"descendant bitmasks hold at most 64 leaves, got {n}")
    ids = leaf_ancestor_ids(parent).reshape(P, n * n)
    bits = torch.ones(n, dtype=torch.int64, device=parent.device) << \
        torch.arange(n, dtype=torch.int64, device=parent.device)
    vals = bits[:, None].expand(n, n).reshape(1, n * n).expand(P, -1)
    out = torch.zeros((P, N + 1), dtype=torch.int64, device=parent.device)
    # the bits of distinct leaves are disjoint, so adding them is OR-ing;
    # ids == -1 land in the spare column N, which is dropped
    out.scatter_add_(1, torch.where(ids >= 0, ids, N).long(), vals)
    return out[:, :N]


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
    max_mig: int = 0,
) -> Trees:
    """Draw the initial genealogies at sequence position 0 by an
    event-driven coalescent walk over {epoch boundary, sample activation,
    coalescence}, all particles advancing together; the loop ends when no
    particle has more than one lineage left (one host read per event).

    A structured model (several populations) takes
    :func:`_make_structured_trees` instead, which also walks migrations and
    records them in per-branch buffers of ``max_mig`` events."""
    if epochs.num_pops != 1 or max_mig:
        return _make_structured_trees(generator, epochs, num_particles,
                                      sample_pop, sample_time, max_mig)
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


def _categorical(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[P] index drawn with probability proportional to ``weights`` [P, K]
    by inverting their running sum at ``u * total`` (the first index whose
    running sum exceeds it; the last one of positive weight if rounding
    leaves none)."""
    cum = weights.cumsum(dim=1)
    x = u * cum[:, -1]
    hit = cum > x[:, None]
    K = weights.shape[1]
    cols = torch.arange(K, device=weights.device)
    last_pos = torch.where(weights > 0, cols, -1).max(dim=1).values
    first = torch.where(hit, cols, K).min(dim=1).values
    return torch.where(first < K, first, last_pos.clamp(min=0))


def _make_structured_trees(generator, epochs: Epochs, P: int, sample_pop,
                           sample_time, max_mig: int) -> Trees:
    """``make_initial_trees`` of a structured model (tree.py:355-548 of the
    JAX package): an event-driven walk over {epoch boundary, sample
    activation, migration, coalescence within a population}, population
    labels folded by the epoch's ``pop_map``; each lineage's migrations go
    into the buffer of the branch it is on (the last slot is overwritten
    once ``max_mig`` are full).  The event and the destination of a
    migration are drawn by inverting running sums of their rates."""
    dev = epochs.start.device
    sample_pop = torch.as_tensor(np.asarray(sample_pop), dtype=torch.int32,
                                 device=dev)
    n = int(sample_pop.shape[0])
    if sample_time is None:
        sample_time = np.zeros(n)
    st = torch.as_tensor(np.asarray(sample_time), dtype=torch.float32,
                         device=dev)
    N, E, Pp = 2 * n - 1, epochs.num_epochs, epochs.num_pops
    f32, i32 = torch.float32, torch.int32
    Mw = max(int(max_mig), 1)
    mig, pop_map = epochs.mig, epochs.pop_map
    tot_mig = mig.sum(dim=2)  # [E, Pp] total out-rate

    parent = torch.full((P, N), NO_NODE, dtype=i32, device=dev)
    child0 = torch.full((P, N), NO_NODE, dtype=i32, device=dev)
    child1 = torch.full((P, N), NO_NODE, dtype=i32, device=dev)
    time = torch.cat([st, torch.zeros(n - 1, device=dev)]).expand(P, N).clone()
    pop = torch.cat([sample_pop, torch.zeros(n - 1, dtype=i32, device=dev)]
                    ).expand(P, N).clone()
    node_id = torch.arange(n, dtype=i32, device=dev).expand(P, n).clone()
    alive = (st <= 0.0).expand(P, n).clone()
    cur_pop = sample_pop.expand(P, n).clone()
    mig_time = torch.full((P, N, Mw), INF, dtype=f32, device=dev)
    mig_dest = torch.zeros((P, N, Mw), dtype=i32, device=dev)
    t = torch.zeros(P, dtype=f32, device=dev)
    next_id = torch.full((P,), n, dtype=i32, device=dev)
    rows = torch.arange(P, device=dev)
    cols_N = torch.arange(N, device=dev)
    cols_n = torch.arange(n, device=dev)
    cols_M = torch.arange(Mw, device=dev)
    pops = torch.arange(Pp, device=dev)
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
        pm = pop_map[e]  # [P, Pp]
        mapped = torch.where(alive, pm.gather(1, cur_pop.long()),
                             torch.full_like(cur_pop, -1))  # [P, n]
        counts = (mapped[:, None, :] == pops[None, :, None]).sum(dim=2).to(f32)
        coal_rates = counts * (counts - 1.0) / 2.0 / (2.0 * epochs.ne[e])
        lin_mig = torch.where(
            alive, tot_mig[e].gather(1, mapped.clamp(min=0).long()),
            torch.zeros((), device=dev))  # [P, n]
        total = coal_rates.sum(dim=1) + lin_mig.sum(dim=1)
        e_end = torch.where(e + 1 < E, epochs.start[(e + 1).clamp(max=E - 1)],
                            inf)
        future = torch.where(st[None, :] > t[:, None], st[None, :], inf)
        t_bk = torch.minimum(e_end, future.min(dim=1).values)
        u = uniform(1e-7, 1.0 - 1e-7)
        dt = torch.where(total > 0,
                         -torch.log1p(-u) / total.clamp(min=1e-30), inf)
        hit_bk = t + dt >= t_bk
        t_new = torch.where(hit_bk, t_bk, t + dt)

        # ---- event: coalescence in a population or one lineage migrating
        idx = _categorical(torch.cat([coal_rates, lin_mig], dim=1), uniform())
        is_coal = idx < Pp

        # ---- coalescence of two lineages of population cpop ---------------
        cpop = idx.clamp(0, Pp - 1).to(i32)
        in_pop = (mapped == cpop[:, None]) & alive
        m = in_pop.sum(dim=1)
        r1 = torch.floor(uniform() * m.clamp(min=1)).to(i32)
        r2 = torch.floor(uniform() * (m - 1).clamp(min=1)).to(i32)
        r2 = torch.where(r2 >= r1, r2 + 1, r2)
        csum = in_pop.to(i32).cumsum(dim=1) - 1
        slot1 = ((csum == r1[:, None]) & in_pop).to(i32).argmax(dim=1)
        slot2 = ((csum == r2[:, None]) & in_pop).to(i32).argmax(dim=1)
        a = node_id.gather(1, slot1[:, None])[:, 0]
        b = node_id.gather(1, slot2[:, None])[:, 0]
        do = go & ~hit_bk & is_coal & (m >= 2)

        # ---- migration of one lineage (drawn before any update) -----------
        do_mig = go & ~hit_bk & ~is_coal
        slot = (idx - Pp).clamp(0, n - 1)
        src = pm.gather(1, cur_pop.gather(1, slot[:, None]).long())[:, 0]
        dest = _categorical(mig[e, src], uniform()).to(i32)
        moving = node_id.gather(1, slot[:, None])[:, 0].long()
        row = mig_time[rows, moving]  # [P, Mw]
        cnt = (row < INF).sum(dim=1).clamp(max=Mw - 1)
        at = ((cols_N[None, :, None] == moving[:, None, None])
              & (cols_M[None, None, :] == cnt[:, None, None])
              & do_mig[:, None, None])
        mig_time = torch.where(at, t_new[:, None, None], mig_time)
        mig_dest = torch.where(at, dest[:, None, None], mig_dest)
        cur_pop = torch.where((cols_n[None, :] == slot[:, None])
                              & do_mig[:, None], dest[:, None], cur_pop)

        hit_a = (cols_N[None, :] == a[:, None]) & do[:, None]
        hit_b = (cols_N[None, :] == b[:, None]) & do[:, None]
        hit_m = (cols_N[None, :] == next_id[:, None]) & do[:, None]
        parent = torch.where(hit_a | hit_b, next_id[:, None], parent)
        child0 = torch.where(hit_m, a[:, None], child0)
        child1 = torch.where(hit_m, b[:, None], child1)
        time = torch.where(hit_m, t_new[:, None], time)
        pop = torch.where(hit_m, cpop[:, None], pop)
        at1 = (cols_n[None, :] == slot1[:, None]) & do[:, None]
        node_id = torch.where(at1, next_id[:, None], node_id)
        cur_pop = torch.where(at1, cpop[:, None], cur_pop)
        alive = alive & ~((cols_n[None, :] == slot2[:, None]) & do[:, None])
        next_id = torch.where(do, next_id + 1, next_id)

        # sample activation at breakpoints
        act = go[:, None] & hit_bk[:, None] & torch.isclose(
            st[None, :].expand(P, n), t_bk[:, None].expand(P, n))
        alive = alive | act
        t = torch.where(go, t_new, t)
    if not max_mig:
        mig_time = mig_dest = None
    return Trees(parent=parent, time=time, child0=child0, child1=child1,
                 pop=pop, mig_time=mig_time, mig_dest=mig_dest)
