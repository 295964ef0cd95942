"""Structured populations with migration in the port against the JAX
package, on the CPU.

Exact where both packages take the same inputs: the device epochs (a
two-population model and a ``-ej`` split), a branch's population at a time,
the event lists' filter and their merge with the min-hold drop rule (ties
and overflow included), and the buffer routing of the SPR on the same
trees (JAX's ``make_initial_trees`` through ``convert``) with the same
(c, d, t_c, population, walk events, root-lineage events): a normal SPR, a
self-coalescence and a coalescence onto the root lineage.  Statistical
where the random streams differ: the port's loop walk against JAX's
(``SMCSMC_MIG_WALK=loop``) on the same trees and recombination points at
the bands of tests/test_migration_walk.py (and at a bound of 0 or 2 events,
where walks are capped: exact at 0), the island model's closed forms,
the initial trees' TMRCA and branch populations (tests/test_migration.py),
``run_chunk`` on a small two-population genome against JAX's over three
seeds, and no data giving posterior = prior.  The walk's counter-based
generator is held to a pure-Python Philox-4x32-10 and to its published
answers, and a checkpoint carries the buffers bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu import em as jem
from smcsmc_tpu.demography import Demography as JDemography
from smcsmc_tpu.demography import parse_scrm_args as j_parse
from smcsmc_tpu.kernels import transition as jtr
from smcsmc_tpu.kernels import tree as jtree
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.checkpoint import load_state, save_state
from smcsmc_tpu_torch.convert import trees_from_numpy
from smcsmc_tpu_torch.demography import Demography as TDemography
from smcsmc_tpu_torch.demography import parse_scrm_args as t_parse
from smcsmc_tpu_torch.kernels import migration as tmig
from smcsmc_tpu_torch.kernels import tree as ttree
from smcsmc_tpu_torch.segio import SegData

torch.set_num_threads(1)

NE = 10000.0
SPLIT_ARGS = "-I 2 2 2 -em 0 1 2 4 -em 0 2 1 2 -eN 0.1 1 -ej 0.5 2 1 -eN 2 2"


def _model(cls, E=8, m=5e-5, L=2e5, sample_pops=(0, 0, 1, 1)):
    """bench.py's twopop_demo (E epochs at 0 and logspace(2.5, 5), Ne
    10,000 each, symmetric m), or an island model with E = 1."""
    change = (np.array([0.0]) if E == 1 else
              np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]))
    mig = np.zeros((E, 2, 2))
    mig[:, 0, 1] = mig[:, 1, 0] = m
    return cls(change_times=change, pop_sizes=np.full((E, 2), NE),
               mig_rates=mig, sample_pops=np.array(sample_pops, np.int32),
               mutation_rate=1e-8, recombination_rate=1e-9,
               sequence_length=L)


def _jax_trees(demo, P, seed, max_mig):
    ep = jtree.epochs_from_demography(demo)
    trees = jtree.make_initial_trees(jax.random.PRNGKey(seed), ep, P,
                                     jnp.asarray(demo.sample_pops),
                                     max_mig=max_mig)
    return ep, jax.tree_util.tree_map(np.asarray, trees)


def _pass_of(trees, epochs, key=(12345, 678)):
    return tmig.MigrationPass(
        trees.pop, trees.mig_time, trees.mig_dest,
        torch.zeros(2, dtype=torch.float64),
        torch.tensor(key, dtype=torch.int32), *tmig.migration_tables(epochs))


# ---------------------------------------------------------------------------
# exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["twopop", "split"])
def test_epochs_from_demography_match_jax(which):
    if which == "twopop":
        jd, td = _model(JDemography), _model(TDemography)
    else:
        jd, td = j_parse(SPLIT_ARGS), t_parse(SPLIT_ARGS)
    got = ttree.epochs_from_demography(td, "cpu")
    ref = jtree.epochs_from_demography(jd)
    for k in ("start", "ne", "mig", "pop_map"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(ref, k))), k
    if which == "split":
        assert got.pop_map[-1].tolist() == [0, 0]  # pop 1 joined pop 0


def test_branch_pop_at_matches_jax():
    jd = j_parse(SPLIT_ARGS)
    ep, trees = _jax_trees(jd, 64, 3, 16)
    assert (trees.mig_time < 1e30).sum() > 20  # some events to look through
    rng = np.random.default_rng(0)
    t = (rng.random(64) * trees.time.max(axis=1)).astype(np.float32)
    e = np.clip(np.searchsorted(np.asarray(ep.start), t, side="right") - 1,
                0, None)
    pm = np.asarray(ep.pop_map)[e]
    ref = jax.vmap(jtree.branch_pop_at)(trees.pop, trees.mig_time,
                                        trees.mig_dest, pm, t)
    got = ttree.branch_pop_at(*(torch.as_tensor(np.array(x)) for x in (
        trees.pop, trees.mig_time, trees.mig_dest, pm, t)))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def _lists(rng, P, M, scale=50.0):
    """[P, M] ascending INF-padded times (integers, so ties occur) and
    destinations."""
    t = np.sort(np.floor(rng.random((P, M)) * scale), axis=1).astype(
        np.float32)
    n = rng.integers(0, M + 1, P)
    t[np.arange(M)[None, :] >= n[:, None]] = 3e38
    d = np.where(t < 1e30, rng.integers(0, 3, (P, M)), 0).astype(np.int32)
    return t, d


def test_filter_events_matches_jax():
    rng = np.random.default_rng(1)
    t, d = _lists(rng, 300, 12)
    lo = np.floor(rng.random(300) * 30).astype(np.float32)
    hi = (lo + np.floor(rng.random(300) * 30)).astype(np.float32)
    lo[:20] = -3e38
    hi[20:40] = 3e38
    rt, rd = jax.vmap(jtr._filter_events)(t, d, lo, hi)
    gt, gd = tmig.filter_events(torch.as_tensor(t), torch.as_tensor(d),
                                torch.as_tensor(lo), torch.as_tensor(hi))
    assert np.array_equal(gt.numpy(), np.asarray(rt))
    assert np.array_equal(gd.numpy(), np.asarray(rd))


@pytest.mark.parametrize("M", [8, 16])
def test_merge_events_hold_matches_jax(M):
    """Two lists of 8 and 16 into capacity M: with M = 8 most rows
    overflow, with M = 16 some; ties between and within the lists."""
    rng = np.random.default_rng(M)
    t1, d1 = _lists(rng, 400, 8)
    t2, d2 = _lists(rng, 400, 16)
    rt, rd, rn = jax.vmap(
        lambda a, b, c, e: jtr._merge_events_hold(a, b, c, e, M))(
            t1, d1, t2, d2)
    gt, gd, gn = tmig.merge_events_hold(*(torch.as_tensor(x)
                                          for x in (t1, d1, t2, d2)), M)
    assert np.array_equal(gt.numpy(), np.asarray(rt))
    assert np.array_equal(gd.numpy(), np.asarray(rd))
    assert np.array_equal(gn.numpy(), np.asarray(rn))
    assert int(np.asarray(rn).sum()) > 100  # overflow happened


def _spr_inputs(case, P=160, Mw=8, seed=5):
    """Trees with full buffers (m = 2e-4 and 8 slots), a cut point on a
    non-root branch, a target and time of the requested kind, the walk's
    events on [h_r, t_c) and the root lineage's on [root time, t_c)."""
    demo = _model(JDemography, E=1, m=2e-4)
    _, tr = _jax_trees(demo, P, seed, Mw)
    rng = np.random.default_rng(seed)
    N = tr.parent.shape[1]
    rows = np.arange(P)
    pt = np.where(tr.parent >= 0,
                  tr.time[rows[:, None], np.maximum(tr.parent, 0)], 3e38)
    root = np.argmax(tr.parent < 0, axis=1)
    c = np.array([rng.choice(np.nonzero(tr.parent[p] >= 0)[0])
                  for p in range(P)], np.int32)
    h_r = (tr.time[rows, c] + rng.random(P) * (pt[rows, c] - tr.time[rows, c])
           ).astype(np.float32)
    if case == "self":
        d = c.copy()
        t_c = (h_r + rng.random(P) * (pt[rows, c] - h_r)).astype(np.float32)
    elif case == "root":
        d = root.astype(np.int32)
        t_c = (np.maximum(h_r, tr.time[rows, root])
               + rng.random(P) * 2e4).astype(np.float32)
    else:
        t_c = (h_r + rng.random(P) * 3e4).astype(np.float32)
        d = np.empty(P, np.int32)
        for p in range(P):
            cross = np.nonzero((tr.time[p] <= t_c[p]) & (t_c[p] < pt[p])
                               & (np.arange(N) != c[p]))[0]
            d[p] = rng.choice(cross)

    def events(lo, hi, cap):
        t = np.sort(lo[:, None] + rng.random((P, cap)) * (hi - lo)[:, None],
                    axis=1).astype(np.float32)
        n = rng.integers(0, cap + 1, P)
        t[np.arange(cap)[None, :] >= n[:, None]] = 3e38
        dd = np.where(t < 1e30, rng.integers(0, 2, (P, cap)), 0)
        return t, dd.astype(np.int32)

    ev_t, ev_d = events(h_r, t_c, 2 * Mw)
    rev_t, rev_d = events(np.minimum(tr.time[rows, root], t_c), t_c, 2 * Mw)
    fpop = rng.integers(0, 2, P).astype(np.int32)
    return tr, c, d, t_c, fpop, h_r, ev_t, ev_d, rev_t, rev_d


@pytest.mark.parametrize("case", ["normal", "self", "root"])
def test_buffer_routing_matches_jax(case):
    tr, c, d, t_c, fpop, h_r, ev_t, ev_d, rev_t, rev_d = _spr_inputs(case)
    ref = jax.vmap(jtr._apply_spr)(
        tr.parent, tr.time, tr.pop, tr.child0, tr.child1, tr.mig_time,
        tr.mig_dest, c, d, t_c, fpop, ev_t, ev_d, h_r, rev_t, rev_d)
    tt = trees_from_numpy(tr, "cpu")
    T = torch.as_tensor
    got = tmig.apply_spr_mig(tt.parent, tt.time, tt.child0, tt.child1,
                             tt.pop, tt.mig_time, tt.mig_dest, T(c), T(d),
                             T(t_c), T(fpop), T(h_r), T(ev_t), T(ev_d),
                             T(rev_t), T(rev_d))
    names = ("parent", "time", "pop", "child0", "child1", "mig_time",
             "mig_dest", "dropped")
    ref = dict(zip(names, (np.asarray(x) for x in ref)))
    got = dict(zip(("parent", "time", "child0", "child1", "pop", "mig_time",
                    "mig_dest", "dropped"), (x.numpy() for x in got)))
    for k in names:
        assert np.array_equal(got[k], ref[k].astype(got[k].dtype)), k
    assert ref["dropped"].sum() > 0  # the min-hold rule was exercised
    if case == "root":
        assert (rev_t < 1e30).any()


# ---------------------------------------------------------------------------
# statistical: the walk, the island model, the initial trees
# ---------------------------------------------------------------------------


def _port_walk(ep_t, trees, c, h_r, max_walk_events=tmig.MAX_WALK_EVENTS):
    P = trees.parent.shape[0]
    E, Pp = ep_t.num_epochs, ep_t.num_pops
    K = tmig.stats_offsets(E, Pp)["width"]
    pending = torch.zeros((P, K))
    active = torch.ones(P, dtype=torch.bool)
    mp = _pass_of(trees, ep_t)._replace(max_walk_events=max_walk_events)
    t_c, d, fpop, ev_t, _, _, _, capped, _ = tmig.walk_mig(
        mp, 0, trees.time, trees.parent, c, h_r, active, ep_t.start, pending,
        E, Pp)
    off = tmig.stats_offsets(E, Pp)
    ep = E * Pp
    return dict(
        coal_opp=pending[:, :ep].sum(1).numpy().astype(np.float64),
        mig_opp=pending[:, off["mig_opp"]:off["mig_opp"] + ep].sum(1).numpy(),
        mig_cnt=pending[:, off["mig_cnt"]:off["mig_cnt"] + ep * Pp].sum(1)
        .numpy(), t_c=t_c.numpy(), d=d.numpy(), fpop=fpop.numpy(),
        capped=capped.numpy(), ev_t=ev_t.numpy())


def _points(trees, seed):
    """A uniform recombination point per particle, as (c, h_r)."""
    u = torch.as_tensor(np.random.default_rng(seed).random(
        trees.parent.shape[0]).astype(np.float32))
    return tmig.uniform_point(u, trees.time, trees.parent)


@pytest.mark.parametrize("m", [2.5e-5, 2e-4])
def test_walk_matches_jax_loop_walk(m, monkeypatch):
    """Record moments of one transition of the port's walk and of JAX's
    loop walk on the same 3000 trees and points (bands of
    tests/test_migration_walk.py)."""
    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    P = 3000
    jd = _model(JDemography, E=1, m=m, L=1e6)
    ep, tr = _jax_trees(jd, P, 6, 56)
    tt = trees_from_numpy(tr, "cpu")
    ep_t = ttree.epochs_from_demography(_model(TDemography, E=1, m=m), "cpu")
    c, h_r = _points(tt, 7)
    got = _port_walk(ep_t, tt, c, h_r)
    out = jtr._walk_mig_batched(
        jax.random.PRNGKey(8), tr.time, tr.parent, tr.pop, tr.mig_time,
        tr.mig_dest, jnp.asarray(c.numpy()), jnp.asarray(h_r.numpy()), ep,
        256, jnp.ones(P, bool))
    t_c, d = np.asarray(out[0]), np.asarray(out[1])
    coal_opp, mig_opp, mig_cnt = (np.asarray(x) for x in (out[4], out[6],
                                                           out[7]))
    ref = dict(mig_ratio=mig_cnt.sum() / mig_opp.sum(),
               coal_opp=coal_opp.sum(axis=(1, 2)).mean(), t_c=t_c.mean(),
               self_coal=np.mean(d == c.numpy()))
    port = dict(mig_ratio=got["mig_cnt"].sum() / got["mig_opp"].sum(),
                coal_opp=got["coal_opp"].mean(), t_c=got["t_c"].mean(),
                self_coal=np.mean(got["d"] == c.numpy()))
    assert port["mig_ratio"] == pytest.approx(ref["mig_ratio"], rel=0.15)
    assert port["coal_opp"] == pytest.approx(ref["coal_opp"], rel=0.05)
    assert port["t_c"] == pytest.approx(ref["t_c"], rel=0.05)
    assert port["self_coal"] == pytest.approx(ref["self_coal"], abs=0.03)
    assert got["capped"].mean() < 0.01
    # the new branch's events are ascending and below the coalescence
    fin = got["ev_t"] < 1e30
    assert np.all(np.diff(got["ev_t"], axis=1)[fin[:, 1:]] >= 0)
    assert np.all(np.where(fin, got["ev_t"], -1.0) <= got["t_c"][:, None])


@pytest.mark.parametrize("cap", [0, 2])
def test_capped_walk_matches_jax_loop_walk(cap, monkeypatch):
    """Walks bounded at ``cap`` events, so that most are capped and
    coalesce onto the root lineage at max(t, tree height) in the root
    lineage's population: with no event (cap 0) the port and JAX's loop
    walk give the same (t_c, d, population) exactly; with two events each
    the share capped, the share of self-coalescences and the mean t_c
    agree (abs 0.03, abs 0.03, rel 0.05 at P = 3000)."""
    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    P, m = 3000, 2e-4
    jd = _model(JDemography, E=1, m=m, L=1e6)
    ep, tr = _jax_trees(jd, P, 16, 56)
    tt = trees_from_numpy(tr, "cpu")
    ep_t = ttree.epochs_from_demography(_model(TDemography, E=1, m=m), "cpu")
    c, h_r = _points(tt, 17)
    got = _port_walk(ep_t, tt, c, h_r, max_walk_events=cap)
    out = jtr._walk_mig_batched(
        jax.random.PRNGKey(18), tr.time, tr.parent, tr.pop, tr.mig_time,
        tr.mig_dest, jnp.asarray(c.numpy()), jnp.asarray(h_r.numpy()), ep,
        cap, jnp.ones(P, bool))
    t_c, d, fpop = (np.asarray(x) for x in out[:3])
    capped = np.asarray(out[12]) > 0
    if cap == 0:
        assert capped.all() and got["capped"].all()
        np.testing.assert_array_equal(got["d"], d)
        np.testing.assert_array_equal(got["fpop"], fpop)
        np.testing.assert_array_equal(got["t_c"], t_c)
        return
    assert 0.1 < capped.mean() < 0.9
    assert got["capped"].mean() == pytest.approx(capped.mean(), abs=0.03)
    assert np.mean(got["d"] == c.numpy()) == pytest.approx(
        np.mean(d == c.numpy()), abs=0.03)
    assert got["t_c"].mean() == pytest.approx(t_c.mean(), rel=0.05)
    root = np.argmax(tr.parent < 0, axis=1)
    assert np.all(got["d"][got["capped"]] == root[got["capped"]])


def test_split_walk_matches_jax_walk_fast():
    """A -ej split without migration: the port runs its migration walk with
    zero rates; JAX runs ``_walk_fast`` with the trees' populations.  On
    the same trees and points the two sample one process.  Bands rel 0.1:
    at P = 3000 the standard error of each mean is about 2.3% (seeds 4,
    11, 12: coal_opp differed by 6.4%, 3.6% and 3.9%), so 0.1 is three
    standard errors of the difference."""
    args = "-I 2 2 2 -eN 0.05 1 -ej 0.25 2 1 -eN 1 2"
    jd, td = j_parse(args), t_parse(args)
    P = 3000
    ep, tr = _jax_trees(jd, P, 4, 0)  # no buffers, as JAX keeps it
    tt = trees_from_numpy(tr, "cpu", max_mig=16)
    ep_t = ttree.epochs_from_demography(td, "cpu")
    c, h_r = _points(tt, 5)
    got = _port_walk(ep_t, tt, c, h_r)
    keys = jax.random.split(jax.random.PRNGKey(9), P)
    out = jax.vmap(lambda k, t, p, po, cc, hh: jtr._walk_fast(
        k, t, p, po, cc, hh, ep))(keys, tr.time, tr.parent, tr.pop,
                                  jnp.asarray(c.numpy()),
                                  jnp.asarray(h_r.numpy()))
    t_c, d = np.asarray(out[0]), np.asarray(out[1])
    ref_opp = np.asarray(out[3]).sum(axis=(1, 2))
    assert got["mig_cnt"].sum() == 0 and got["capped"].sum() == 0
    assert got["t_c"].mean() == pytest.approx(t_c.mean(), rel=0.1)
    assert got["coal_opp"].mean() == pytest.approx(ref_opp.mean(), rel=0.1)
    assert np.mean(got["d"] == c.numpy()) == pytest.approx(
        np.mean(d == c.numpy()), abs=0.03)


def test_walk_island_closed_forms():
    """E[mig count] / E[mig opportunity] = m and E[coal opportunity] of one
    lineage pair = 2 Ne (tests/test_migration.py:156-176), rel 0.1."""
    m, P = 2e-4, 4000
    td = _model(TDemography, E=1, m=m, sample_pops=(0, 1))
    ep_t = ttree.epochs_from_demography(td, "cpu")
    gen = torch.Generator()
    gen.manual_seed(6)
    trees = ttree.make_initial_trees(gen, ep_t, P, td.sample_pops, max_mig=56)
    c, h_r = _points(trees, 7)
    got = _port_walk(ep_t, trees, c, h_r)
    assert got["mig_cnt"].sum() / got["mig_opp"].sum() == pytest.approx(
        m, rel=0.1)
    assert got["coal_opp"].mean() / (2 * NE) == pytest.approx(1.0, rel=0.1)


@pytest.mark.parametrize("pops,expected", [
    ((0, 0), 4 * NE), ((0, 1), 4 * NE + 1.0 / (2 * 1e-4))])
def test_initial_tree_tmrca(pops, expected):
    td = _model(TDemography, E=1, m=1e-4, sample_pops=pops)
    gen = torch.Generator()
    gen.manual_seed(1)
    trees = ttree.make_initial_trees(
        gen, ttree.epochs_from_demography(td, "cpu"), 8000, td.sample_pops,
        max_mig=56)
    assert float(trees.time[:, 2].mean()) == pytest.approx(expected, rel=0.08)


def test_initial_tree_branch_pops_agree_at_each_merge():
    """Both children's branches are in the parent's population just below
    it: two lineages coalesce only within a population."""
    td = _model(TDemography, E=1, m=1e-4)
    ep = ttree.epochs_from_demography(td, "cpu")
    gen = torch.Generator()
    gen.manual_seed(2)
    trees = ttree.make_initial_trees(gen, ep, 500, td.sample_pops, max_mig=56)
    assert int((trees.mig_time < 1e30).sum()) > 50
    pm = ep.pop_map[0].expand(500, 2)
    for v in range(4, 7):
        t_v = trees.time[:, v] - 1e-3
        bp = ttree.branch_pop_at(trees.pop, trees.mig_time, trees.mig_dest,
                                 pm, t_v)
        kids = torch.stack([trees.child0[:, v], trees.child1[:, v]], 1).long()
        got = bp.gather(1, kids)
        assert torch.equal(got[:, 0], got[:, 1])
        assert torch.equal(got[:, 0], trees.pop[:, v])


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def _summary(runs, E):
    """Mean LogL, Ne of each population over the interior epochs, pooled
    migration rate."""
    ne = [sum(r[0].coal_opp[1:E - 1, q].sum() for r in runs)
          / (2.0 * sum(r[0].coal_cnt[1:E - 1, q].sum() for r in runs))
          for q in range(2)]
    mig = (sum(r[0].mig_cnt.sum() for r in runs)
           / sum(r[0].mig_opp.sum() for r in runs))
    return np.mean([r[2] for r in runs]), ne, mig


def test_twopop_run_chunk_agrees_with_jax(monkeypatch):
    """LogL mean within 2%, Ne of each population (interior epochs pooled)
    within 30% and the pooled migration rate within 50% over seeds 1-3."""
    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    E = 8
    jd = _model(JDemography, E=E)
    seg = simulate_seg(jd, seed=13)
    td = _model(TDemography, E=E)
    res = {"jax": [], "torch": []}
    for s in (1, 2, 3):
        res["jax"].append(jem.run_chunk(
            jd, seg, jem.EMConfig(num_particles=64, block_size=512), seed=s))
        res["torch"].append(tem.run_chunk(
            td, seg, tem.EMConfig(num_particles=64, device="cpu"), seed=s))
    for runs in res.values():
        assert all(np.isfinite(r[2]) and r[2] < 0 for r in runs)
    (lj, nj, mj), (lt, nt, mt) = (_summary(res[k], E) for k in ("jax",
                                                                 "torch"))
    assert abs(lt - lj) <= 0.02 * abs(lj), (lj, lt)
    for q in range(2):
        assert nt[q] == pytest.approx(nj[q], rel=0.3), (nj, nt)
    assert mt == pytest.approx(mj, rel=0.5), (mj, mt)
    assert all(r[3]["walks_capped"] == 0 for r in res["torch"])


def test_twopop_no_data_posterior_equals_prior():
    """All sites missing: the weights stay flat, so the statistics are the
    proposal's: pooled Ne and migration rate within 10% of the model."""
    td = _model(TDemography, E=1, m=5e-5)
    n_seg = 16
    seg = SegData(
        positions=1 + np.arange(n_seg) * 12500,
        lengths=np.full(n_seg, 12500), states=np.zeros(n_seg, np.int8),
        alleles=np.full((n_seg, 4), -1, np.int8), phased=np.ones(4, bool))
    cfg = tem.EMConfig(num_particles=128, lag=20000.0, device="cpu")
    stats, _, logl, diag = tem.run_chunk(td, seg, cfg, seed=5)
    assert logl == pytest.approx(0.0, abs=1e-3)
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert ne_hat == pytest.approx(NE, rel=0.1)
    m_hat = float(stats.mig_cnt.sum() / stats.mig_opp.sum())
    assert m_hat == pytest.approx(5e-5, rel=0.1)
    assert diag["walks_capped"] == 0


# ---------------------------------------------------------------------------
# the generator, the checkpoint
# ---------------------------------------------------------------------------


# Random123's known answers for Philox-4x32-10 (kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff,) * 2,
        (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert tmig.philox4x32_int(ctr, key) == want
    k = torch.tensor([x - (1 << 32) if x >= 1 << 31 else x for x in key],
                     dtype=torch.int32)
    got = tmig.philox4x32(ctr, k)
    assert tuple(int(w) for w in got) == want


def test_philox_tensor_version_matches_python_ints():
    rng = np.random.default_rng(3)
    key = torch.tensor(rng.integers(-2**31, 2**31 - 1, 2), dtype=torch.int32)
    ctr = [torch.as_tensor(rng.integers(0, 2**32, 500)) for _ in range(4)]
    words = tmig.philox4x32(ctr, key)
    for i in range(500):
        assert tuple(int(w[i]) for w in words) == tmig.philox4x32_int(
            [int(x[i]) for x in ctr], key.tolist())
    u = tmig.walk_uniforms(key, 2, 5, 7, count=3)
    assert u.shape == (7, 3, 4) and float(u.min()) >= 0 and float(u.max()) < 1
    want = tmig.philox4x32_int((4, 2, 6, 0), key.tolist())
    assert u[4, 1].tolist() == [(w >> 8) * 2.0 ** -24 for w in want]


def test_checkpoint_round_trip_with_buffers(tmp_path):
    td = _model(TDemography, m=2e-4, L=6e4)
    seg = simulate_seg(_model(JDemography, m=2e-4, L=6e4), seed=3)
    cfg = tem.EMConfig(num_particles=24, device="cpu", mig_buffer=16)
    sweep = tem.start_sweep(td, seg, cfg, seed=9)
    state = sweep.state
    for s in range(len(sweep.segs) // 2):
        state, _ = sweep.step(state, sweep.segs[s])
    assert int((state.trees.mig_time < 1e30).sum()) > 0
    path = str(tmp_path / "ck.pt")
    save_state(path, state, sweep.generator, {"segments": 1})
    other = tem.start_sweep(td, seg, cfg, seed=10)
    back, done = load_state(path, other.generator, "cpu")
    assert done == {"segments": 1}
    for f in ("pop", "mig_time", "mig_dest", "parent", "time"):
        assert torch.equal(getattr(back.trees, f), getattr(state.trees, f)), f
    assert torch.equal(back.diag, state.diag) and back.diag.dtype == \
        torch.float64
    a, _ = sweep.step(state, sweep.segs[len(sweep.segs) // 2])
    b, _ = other.step(back, other.segs[len(other.segs) // 2])
    assert torch.equal(a.log_w, b.log_w)
    assert torch.equal(a.trees.mig_time, b.trees.mig_time)
