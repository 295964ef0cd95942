# Copied from smcsmc_tpu/simulate.py at commit dfc2fad; keep it letter for letter.
"""Sequence simulator: the framework's equivalent of the reference's bundled
``scrm`` binary (CMakeLists.txt:77; used for test data at
populationmodels.py:439-500).

A deliberately independent numpy implementation of the structured coalescent
+ SMC' process (piecewise-constant demography, continuous migration,
population splits, recombination along the sequence, infinite-sites
mutations), so that the JAX inference kernels are validated against
separately-written code.  Output is .seg data (convert_scrm_to_seg format,
populationmodels.py:502-577).
"""

from __future__ import annotations

import numpy as np

from .demography import Demography
from .segio import SegData


class _Sim:
    """One genealogy under SMC' along the sequence (numpy, single instance).

    Per-branch migration events are kept as python lists of (time, dest)
    on the branch above each node (ascending)."""

    def __init__(self, demo: Demography, rng: np.random.Generator):
        self.demo = demo
        self.rng = rng
        n = demo.num_samples
        self.n = n
        N = 2 * n - 1
        self.parent = np.full(N, -1, dtype=np.int64)
        self.time = np.zeros(N)
        self.pop = np.zeros(N, dtype=np.int64)
        self.children = np.full((N, 2), -1, dtype=np.int64)
        self.mig_events: list[list[tuple[float, int]]] = [[] for _ in range(N)]
        self.pop[:n] = demo.sample_pops
        self.time[:n] = demo.sample_times
        self._pop_map = demo.pop_map_at_epoch()
        self._build_initial()

    # -- demography helpers -------------------------------------------------

    def _epoch(self, t: float) -> int:
        return self.demo.epoch_of(t)

    def _map(self, raw_pop: int, t: float) -> int:
        return int(self._pop_map[self._epoch(t), raw_pop])

    def branch_pop(self, node: int, t: float) -> int:
        """Population of the branch above `node` at time t."""
        p = int(self.pop[node])
        for et, dest in self.mig_events[node]:
            if et <= t:
                p = dest
            else:
                break
        return self._map(p, t)

    # -- initial tree -------------------------------------------------------

    def _build_initial(self):
        demo = self.demo
        n = self.n
        # slots: (node_id, cur_raw_pop); inactive ancient samples join later
        slots = [[i, int(demo.sample_pops[i])] for i in range(n)]
        alive = [demo.sample_times[i] <= 0.0 for i in range(n)]
        t = 0.0
        next_id = n
        ct = demo.change_times
        while sum(alive) + sum(1 for i in range(n) if demo.sample_times[i] > t) > 1:
            e = self._epoch(t)
            pm = self._pop_map[e]
            live = [i for i in range(len(slots)) if alive[i]]
            mapped = [int(pm[slots[i][1]]) for i in live]
            rates = []
            for p in range(demo.num_populations):
                k = mapped.count(p)
                rates.append(k * (k - 1) / 2.0 / (2.0 * demo.pop_sizes[e, p]))
            mig_out = [float(np.sum(demo.mig_rates[e, mp])) for mp in mapped]
            total = sum(rates) + sum(mig_out)
            e_end = ct[e + 1] if e + 1 < len(ct) else np.inf
            future = [
                demo.sample_times[i]
                for i in range(n)
                if demo.sample_times[i] > t
            ]
            t_bk = min(e_end, min(future) if future else np.inf)
            dt = self.rng.exponential(1.0 / total) if total > 0 else np.inf
            if t + dt >= t_bk:
                t = t_bk
                for i in range(n):
                    if abs(demo.sample_times[i] - t_bk) < 1e-9:
                        alive[i] = True
                continue
            t = t + dt
            u = self.rng.uniform() * total
            acc = 0.0
            chosen = None
            for p in range(demo.num_populations):
                acc += rates[p]
                if u < acc:
                    chosen = ("coal", p)
                    break
            if chosen is None:
                for idx, i in enumerate(live):
                    acc += mig_out[idx]
                    if u < acc:
                        chosen = ("mig", i)
                        break
            if chosen is None:
                chosen = ("coal", int(np.argmax(rates)))
            if chosen[0] == "mig":
                i = chosen[1]
                src = int(pm[slots[i][1]])
                w = demo.mig_rates[e, src].copy()
                w[src] = 0
                dest = int(self.rng.choice(demo.num_populations, p=w / w.sum()))
                node = slots[i][0]
                self.mig_events[node].append((t, dest))
                slots[i][1] = dest
                continue
            p = chosen[1]
            members = [i for i, mp in zip(live, mapped) if mp == p]
            a_i, b_i = self.rng.choice(len(members), size=2, replace=False)
            sa, sb = members[a_i], members[b_i]
            na, nb = slots[sa][0], slots[sb][0]
            m = next_id
            next_id += 1
            self.parent[na] = m
            self.parent[nb] = m
            self.children[m] = [na, nb]
            self.time[m] = t
            self.pop[m] = p
            slots[sa] = [m, p]
            alive[sb] = False

    # -- tree queries -------------------------------------------------------

    def root(self) -> int:
        return int(np.where(self.parent == -1)[0][0])

    def parent_time(self) -> np.ndarray:
        return np.where(
            self.parent >= 0, self.time[np.clip(self.parent, 0, None)], np.inf
        )

    def branch_lengths(self) -> np.ndarray:
        pt = self.parent_time()
        return np.where(self.parent >= 0, pt - self.time, 0.0)

    def total_length(self) -> float:
        return float(self.branch_lengths().sum())

    def leaves_below(self, v: int) -> np.ndarray:
        out = []
        stack = [v]
        while stack:
            x = stack.pop()
            if x < self.n:
                out.append(x)
            else:
                stack += [int(c) for c in self.children[x]]
        return np.array(sorted(out))

    # -- SMC' transition ----------------------------------------------------

    def recombine(self):
        demo = self.demo
        bl = self.branch_lengths()
        cum = np.cumsum(bl)
        x = self.rng.uniform() * cum[-1]
        c = int(np.searchsorted(cum, x))
        h_r = self.time[c] + (x - (cum[c - 1] if c > 0 else 0.0))
        pt = self.parent_time()
        ct = demo.change_times

        # floating-lineage walk from h_r; above the root both the floating
        # and the ancestral lineage migrate (pairwise structured coalescent)
        t = h_r
        root = self.root()
        root_h = float(self.time[root])
        lineage_pop = self.branch_pop(c, h_r)
        root_pop = self._map(int(self.pop[root]), max(root_h, h_r))
        new_events: list[tuple[float, int]] = []
        root_events: list[tuple[float, int]] = []
        all_mig_times = sorted(
            et for evs in self.mig_events for et, _ in evs
        )
        while True:
            e = self._epoch(t)
            e_end = ct[e + 1] if e + 1 < len(ct) else np.inf
            pm = self._pop_map[e]
            lineage_pop = int(pm[lineage_pop])
            root_pop = int(pm[root_pop])
            above = t >= root_h
            crossing = (self.time <= t) & (t < pt)
            bp = np.array(
                [self.branch_pop(i, t) if crossing[i] else -1 for i in range(len(pt))]
            )
            if crossing[root]:
                bp[root] = root_pop
            k_same = int(np.sum(crossing & (bp == lineage_pop)))
            coal_rate = k_same / (2.0 * demo.pop_sizes[e, lineage_pop])
            mig_rate = float(np.sum(demo.mig_rates[e, lineage_pop]))
            rmig_rate = float(np.sum(demo.mig_rates[e, root_pop])) if above else 0.0
            total = coal_rate + mig_rate + rmig_rate
            nts = self.time[self.time > t]
            next_mig = next((mt for mt in all_mig_times if mt > t), np.inf)
            next_bk = min(
                float(nts.min()) if len(nts) else np.inf, e_end, next_mig,
                root_h if t < root_h else np.inf,
            )
            if total <= 0:
                t = next_bk
                continue
            dt = self.rng.exponential(1.0 / total)
            if t + dt >= next_bk:
                t = next_bk
                continue
            t = t + dt
            x = self.rng.uniform() * total
            if x < coal_rate:
                cands = np.where(crossing & (bp == lineage_pop))[0]
                d = int(self.rng.choice(cands))
                break
            if x < coal_rate + mig_rate:
                w = demo.mig_rates[e, lineage_pop].copy()
                w[lineage_pop] = 0
                lineage_pop = int(self.rng.choice(len(w), p=w / w.sum()))
                new_events.append((t, lineage_pop))
            else:
                w = demo.mig_rates[e, root_pop].copy()
                w[root_pop] = 0
                root_pop = int(self.rng.choice(len(w), p=w / w.sum()))
                root_events.append((t, root_pop))
        t_c = t

        if d == c:
            # self-coalescence: replace c's [h_r, t_c) event section
            old = self.mig_events[c]
            self.mig_events[c] = (
                [ev for ev in old if ev[0] < h_r]
                + new_events
                + [ev for ev in old if ev[0] >= t_c]
            )
            return
        p = int(self.parent[c])
        o = int(self.children[p][1]) if int(self.children[p][0]) == c else int(self.children[p][0])
        g = int(self.parent[p])
        d_eff = o if d == p else d
        # event routing
        c_events = [ev for ev in self.mig_events[c] if ev[0] < h_r] + new_events
        o_events = self.mig_events[o] + self.mig_events[p]
        if d_eff == o:
            d_events_all = list(o_events)
        else:
            d_events_all = list(self.mig_events[d_eff])
        if d == root or d_eff == root:
            # coalescence with the ancestral lineage: its realized migration
            # path becomes the old root's branch events (note d == p == root
            # remaps d_eff -> o)
            d_events_all = sorted(d_events_all + root_events)
        d_low = [ev for ev in d_events_all if ev[0] < t_c]
        d_high = [ev for ev in d_events_all if ev[0] >= t_c]
        gp = g if d_eff == o else int(self.parent[d_eff])
        # splice o up
        self.parent[o] = g
        if g >= 0:
            self.children[g][self.children[g] == p] = o
        # insert p on branch above d_eff
        self.parent[d_eff] = p
        self.parent[p] = gp
        self.children[p] = [c, d_eff]
        if gp >= 0:
            self.children[gp][self.children[gp] == d_eff] = p
        self.time[p] = t_c
        self.pop[p] = lineage_pop
        self.mig_events[c] = c_events
        self.mig_events[o] = o_events
        self.mig_events[d_eff] = d_low
        self.mig_events[p] = d_high
        # prune the (new) root's ancestral-lineage events — re-simulated
        # fresh by every walk
        self.mig_events[self.root()] = []


def simulate_seg(
    demo: Demography,
    seed: int = 1,
    missing_leaves: list[int] | None = None,
    phased: bool = True,
) -> SegData:
    """Simulate haplotypes and return .seg data (the reference's
    ``Population.simulate`` + ``convert_scrm_to_seg`` path)."""
    rng = np.random.default_rng(seed)
    sim = _Sim(demo, rng)
    L = int(demo.sequence_length)
    mu = demo.mutation_rate
    rho = demo.recombination_rate
    n = demo.num_samples

    var_positions = []
    var_alleles = []
    x = 0.0
    while x < L:
        tl = sim.total_length()
        d_rec = rng.exponential(1.0 / max(rho * tl, 1e-300)) if rho > 0 else np.inf
        seg_end = min(x + d_rec, L)
        n_mut = rng.poisson(mu * tl * (seg_end - x))
        if n_mut:
            positions = np.sort(rng.uniform(x, seg_end, size=n_mut))
            bl = sim.branch_lengths()
            cum = np.cumsum(bl)
            for pos in positions:
                b = int(np.searchsorted(cum, rng.uniform() * cum[-1]))
                carriers = sim.leaves_below(b)
                if 0 < len(carriers) < n:
                    al = np.zeros(n, dtype=np.int8)
                    al[carriers] = 1
                    var_positions.append(int(pos) + 1)
                    var_alleles.append(al)
        x = seg_end
        if x < L:
            sim.recombine()

    seen = {}
    for p, a in zip(var_positions, var_alleles):
        seen[p] = a
    var_positions = sorted(seen)
    var_alleles = [seen[p] for p in var_positions]

    positions = [1] + var_positions
    rows_pos, rows_len, rows_al = [], [], []
    for idx in range(len(positions) - 1):
        rows_pos.append(positions[idx])
        rows_len.append(positions[idx + 1] - positions[idx])
        rows_al.append(var_alleles[idx])
    rows_pos.append(positions[-1])
    rows_len.append(L - positions[-1] + 1)
    rows_al.append(np.full(n, -1, dtype=np.int8))

    alleles = np.array(rows_al, dtype=np.int8)
    if missing_leaves:
        alleles[:, missing_leaves] = -1
    if not phased:
        for i in range(0, n - 1, 2):
            het = alleles[:, i] != alleles[:, i + 1]
            known = (alleles[:, i] >= 0) & (alleles[:, i + 1] >= 0)
            unph = het & known
            alleles[unph, i] = 2
            alleles[unph, i + 1] = 2

    return SegData(
        positions=np.array(rows_pos, dtype=np.int64),
        lengths=np.array(rows_len, dtype=np.int64),
        states=np.zeros(len(rows_pos), dtype=np.int8),
        alleles=alleles,
        phased=np.array([phased] * n),
    )
