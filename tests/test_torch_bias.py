"""The port's height-biased proposal with delayed importance weights
against the JAX package, on the CPU.

Exact where both packages can be fed the same numbers: the biased point's
node (JAX's uniform drawn from the same key goes to the port), the ring of
delayed factors (push and drain; the log factors are multiples of 1/64, so
that every sum of them is exact in either order).  To f32 tolerance
(rtol 1e-5) where sums run in another order: the point's height and log
importance weight, and a whole biased segment step without trips from one
converted ``PFState`` with a pre-filled ring.  Statistical where the RNG
streams differ: with no data the posterior is the prior (the JAX package's
``test_bias_nodata_invariance`` bands), and a biased ``run_chunk`` against
JAX's on the same data (the bands of test_torch_em.py's unbiased
comparison; over seeds 7-18 the per-seed spread of LogL on this data was
12 (JAX) and 7 (port) on -1768, of the pooled Ne 1500 and 900 on 9400).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu import em as jem
from smcsmc_tpu import smc as jsmc
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.kernels import transition as jtr
from smcsmc_tpu.kernels.tree import epochs_from_demography as j_epochs
from smcsmc_tpu.segio import SegData
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch import smc as tsmc
from smcsmc_tpu_torch.convert import state_from_numpy, state_to_numpy
from smcsmc_tpu_torch.kernels.bias import (
    BiasedPass,
    apply_due_delayed,
    biased_point,
    push_delayed,
)
from smcsmc_tpu_torch.kernels.tree import INF
from smcsmc_tpu_torch.kernels.tree import epochs_from_demography as t_epochs
from smcsmc_tpu_torch.kernels.trip import disagreement, segment_pass_plain

torch.set_num_threads(1)

CPU = torch.device("cpu")
MU, RHO = 2e-6, 1e-9


def _demo(E=3, n=4, L=1e6, ne=None):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(3.0, 4.3, E - 1)]))
    sizes = np.full((E, 1), 10000.0) if ne is None else np.full((E, 1), ne)
    return Demography(
        change_times=change, pop_sizes=sizes, mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(n, np.int32), mutation_rate=MU,
        recombination_rate=RHO, sequence_length=L,
    )


def _tables(heights, strengths):
    bh = np.concatenate([[0.0], heights, [3e38]]).astype(np.float32)
    return bh, np.asarray(strengths, np.float32)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.mark.parametrize("heights,strengths", [
    ((2000.0,), (3.0, 1.0)),
    ((500.0, 5000.0), (8.0, 2.5, 1.0)),
    ((300.0, 3000.0, 9000.0), (1.0, 4.0, 1.0, 2.0)),
])
def test_biased_point_matches_jax(heights, strengths):
    P, n = 256, 6
    demo = _demo(n=n)
    st = jsmc.init_state(jax.random.PRNGKey(3), j_epochs(demo),
                         jsmc.PFConfig(num_particles=P, num_leaves=n),
                         demo.sample_pops, RHO)
    bh, bs = _tables(heights, strengths)
    keys = jax.random.split(jax.random.PRNGKey(len(heights)), P)
    c, h_r, log_iw, s, log_iw_bias = jax.vmap(
        lambda k, t, p: jtr._sample_recomb_point_biased(
            k, t, p, jnp.asarray(bh), jnp.asarray(bs)))(
        keys, st.trees.time, st.trees.parent)
    u = jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=1e-7, maxval=1.0 - 1e-7))(keys)
    got = biased_point(torch.from_numpy(np.array(u)),
                       torch.from_numpy(np.array(st.trees.time)),
                       torch.from_numpy(np.array(st.trees.parent)),
                       torch.from_numpy(bh), torch.from_numpy(bs))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(c))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(s))
    # h_r = lo + (x - prev) / strength: x and prev are running sums of the
    # N*S weighted segments, summed in another order by XLA, so h_r carries
    # a few ulp of the weighted tree length (<= N * h_max * max strength)
    N = st.trees.time.shape[1]
    ulps = 1e-7 * N * float(np.max(st.trees.time)) * max(strengths)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(h_r), rtol=1e-5,
                               atol=ulps)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(log_iw), rtol=1e-5,
                               atol=1e-5)
    # without a guide the bias part is the whole weight
    np.testing.assert_array_equal(np.asarray(log_iw_bias), np.asarray(log_iw))
    assert len(np.unique(np.asarray(s))) == len(set(strengths))


def _ring(P, K, front, rng, case="mixed"):
    """A ring with free slots, factors due before ``front`` with one and
    with several applications left, and factors not yet due; ``case``
    shapes it: ``full`` every slot in use, ``last_free`` one free slot
    (the last), ``due_at_end`` factors due exactly at ``front``, ``rearm``
    every factor due with 2 or 3 applications left."""
    used = rng.uniform(size=(P, K)) < 0.5
    used[:3] = True  # full rings
    if case == "full":
        used[:] = True
    elif case == "last_free":
        used[:] = True
        used[:, -1] = False
    pos = rng.uniform(front - 3000.0, front + 3000.0, (P, K))
    if case == "due_at_end":
        pos[:, ::3] = front
    elif case == "rearm":
        pos = rng.uniform(front - 3000.0, front, (P, K))
    pos = np.where(used, pos, INF).astype(np.float32)
    logf = np.where(used, rng.integers(-64, 64, (P, K)) / 64.0, 0.0)
    delta = np.where(used, rng.uniform(100.0, 900.0, (P, K)), 0.0)
    lo = 2 if case == "rearm" else 1
    k = np.where(used, rng.integers(lo, 4, (P, K)), 0)
    return (pos, logf.astype(np.float32), delta.astype(np.float32),
            k.astype(np.int32))


@pytest.mark.parametrize("case", ["mixed", "full", "last_free",
                                  "due_at_end", "rearm"])
def test_ring_push_and_drain_match_jax(case):
    """Push and drain against ``_push_delayed`` / ``_apply_due_delayed``:
    a ring with free slots, due and pending factors; every ring full (the
    factor goes to the pilot at once); one free slot, the last (the push
    takes it); factors due exactly at the drain's position; every factor
    due with applications left (re-armed at twice its spacing)."""
    P, K, front = 64, 32, 40000.0
    rng = np.random.default_rng(5)
    ring = _ring(P, K, front, rng, case)
    mask = rng.uniform(size=P) < 0.7
    pos = rng.uniform(front, front + 800.0, P).astype(np.float32)
    delay = rng.uniform(1000.0, 30000.0, P).astype(np.float32)
    log_iw = (rng.integers(-300, 300, P) / 64.0).astype(np.float32)
    ref = jsmc._push_delayed(*(jnp.asarray(x) for x in ring),
                             jnp.asarray(mask), jnp.asarray(pos),
                             jnp.asarray(delay), jnp.asarray(log_iw), 3)
    got = push_delayed(*(torch.from_numpy(x) for x in ring),
                       torch.from_numpy(mask), torch.from_numpy(pos),
                       torch.from_numpy(delay), torch.from_numpy(log_iw), 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case in ("mixed", "full"):  # full rings took the factor at once
        assert got[4][:3].abs().sum() > 0
    if case == "full":
        assert (got[4].numpy() == np.where(mask, log_iw, 0.0)).all()
    if case == "last_free":  # every push went into the last slot
        assert (got[0][:, -1].numpy() < INF).sum() == mask.sum()
        assert not got[4].any()

    ref = jsmc._apply_due_delayed(*(jnp.asarray(x) for x in ring),
                                  jnp.float32(front))
    got = apply_due_delayed(*(torch.from_numpy(x) for x in ring), front)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    due = ring[0] <= front
    assert (got[4].numpy() < ring[3]).any()  # applications taken
    if case != "full":
        assert (got[1].numpy() > ring[0]).any()  # and moved on
    if case == "due_at_end":
        assert (ring[0] == front).any() and due[ring[0] == front].all()
    if case == "rearm":  # every factor re-armed at twice its spacing
        used = ring[0] < INF
        np.testing.assert_array_equal(got[3].numpy()[used],
                                      2.0 * ring[2][used])
        assert (got[4].numpy()[used] == ring[3][used] - 1).all()


@pytest.mark.parametrize("S", [2, 8])
def test_coal_delay_section_and_epoch_match_jax(S):
    """The ``coal`` delay type keys the immediate-or-delayed choice and the
    delay off t_c: its section (``section_of``) and epoch (``epoch_index``)
    against the JAX package's step (``searchsorted`` on the boundaries,
    ``_epoch_index``) for t_c inside each section and exactly on each
    boundary, with 2 and 8 sections; then the push of those delays."""
    from smcsmc_tpu_torch.kernels.bias import epoch_index, section_of

    rng = np.random.default_rng(S)
    inner = np.sort(rng.uniform(100.0, 60000.0, S - 1)).astype(np.float32)
    bh, bs = _tables(inner, rng.uniform(1.0, 6.0, S))
    bs[S // 2] = 1.0  # one unbiased section
    mids = [rng.uniform(bh[s], min(bh[s + 1], 1e5), 4) for s in range(S)]
    t_c = np.concatenate(mids + [bh[:-1], bh[:-1] + 0.5]).astype(np.float32)
    starts = np.concatenate([[0.0], np.logspace(2.0, 4.9, 11)]).astype(
        np.float32)
    got_s = section_of(torch.from_numpy(bh), torch.from_numpy(t_c))
    ref_s = np.clip(np.asarray(jnp.searchsorted(jnp.asarray(bh),
                                                jnp.asarray(t_c),
                                                side="right")) - 1, 0, S - 1)
    np.testing.assert_array_equal(got_s.numpy(), ref_s)
    assert set(got_s.tolist()) == set(range(S))  # every section reached
    got_e = epoch_index(torch.from_numpy(starts), torch.from_numpy(t_c))
    ref_e = jtr._epoch_index(jnp.asarray(starts), jnp.asarray(t_c))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(ref_e))

    P = t_c.shape[0]
    delays = np.linspace(500.0, 20000.0, starts.shape[0]).astype(np.float32)
    delay = delays[got_e.numpy()]
    late = np.where(np.abs(bs[got_s.numpy()] - 1.0) < 1e-6, 0.0,
                    rng.integers(-300, 300, P) / 64.0).astype(np.float32)
    ring = _ring(P, 32, 40000.0, rng)
    mask = np.abs(late) > 1e-9
    pos = np.full(P, 40000.0, np.float32)
    ref = jsmc._push_delayed(*(jnp.asarray(x) for x in ring),
                             jnp.asarray(mask), jnp.asarray(pos),
                             jnp.asarray(delay), jnp.asarray(late), 3)
    got = push_delayed(*(torch.from_numpy(x) for x in ring),
                       torch.from_numpy(mask), torch.from_numpy(pos),
                       torch.from_numpy(delay), torch.from_numpy(late), 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _biased_jax_state(seed, L, P=64, n=4, E=3):
    """A biased JAX PFState with its own pilot weights and a pre-filled
    ring; ``next_rec`` beyond the segment (no trips)."""
    demo = _demo(E=E, n=n)
    epochs = j_epochs(demo)
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=n, ess_threshold=0.0,
                        use_bias=True)
    st = jsmc.init_state(jax.random.PRNGKey(seed), epochs, cfg,
                         demo.sample_pops, RHO)
    rng = np.random.default_rng(seed)

    def normed(x):
        return (x - np.log(np.exp(x - x.max()).sum()) - x.max()).astype(
            np.float32)

    front = 40000.0
    ring = _ring(P, cfg.delay_slots, front + 0.5 * L, rng)
    K = jsmc.stats_width(E, 1)
    st = st._replace(
        log_w=jnp.asarray(normed(rng.normal(0.0, 2.0, P))),
        log_pilot=jnp.asarray(normed(rng.normal(0.0, 2.0, P))),
        fifo=jnp.asarray(rng.uniform(0, 1, (P, cfg.fifo_slots, K)),
                         jnp.float32),
        stats=jnp.asarray(rng.uniform(0, 5, K), jnp.float32),
        stats_wt=jnp.asarray(rng.uniform(0, 1, K), jnp.float32),
        ln_norm=jnp.float32(-1234.567), ln_norm_c=jnp.float32(1.5e-5),
        front=jnp.float32(front),
        slot_open=jnp.asarray([39500.0, 30000.0, 39990.0], jnp.float32),
        next_rec=jnp.asarray(L + rng.uniform(1.0, 1e4, P), jnp.float32),
        df_pos=jnp.asarray(ring[0]), df_logf=jnp.asarray(ring[1]),
        df_delta=jnp.asarray(ring[2]), df_k=jnp.asarray(ring[3]),
    )
    return demo, epochs, cfg, st


@pytest.mark.parametrize("leaf_status,delay_type", [
    (1, "recomb"), (0, "coal"), (-1, "recomb")])
def test_biased_segment_step_matches_jax(leaf_status, delay_type):
    """One biased step without trips: the final extension of both
    weights, the site likelihood, the drain of the due factors into the
    pilot, both normalisations, the ESS read from the pilot."""
    L, dist_mut = 800, 3000.0
    demo, epochs, cfg, st = _biased_jax_state(20 + leaf_status, L)
    cfg = dataclasses.replace(cfg, delay_type=delay_type)
    lags = np.array([3000.0, 9000.0, 40000.0], np.float32)
    bh, bs = _tables((2000.0,), (3.0, 1.0))
    delays = lags * 0.25
    alleles = np.random.default_rng(7).integers(0, 2, 4).astype(np.int8)
    if leaf_status == 0:
        alleles[[0, 2]] = -1
    elif leaf_status == -1:
        alleles[:] = -1

    step = jsmc.make_segment_step(cfg, epochs, MU, RHO, jnp.asarray(lags),
                                  jnp.asarray(bh), jnp.asarray(bs),
                                  jnp.asarray(delays))
    seg = (jnp.int32(L), jnp.asarray(alleles)[None], jnp.int32(1),
           jnp.int8(0), jnp.int8(leaf_status), jnp.float32(dist_mut))
    ref_state, (ref_ess, ref_need, _) = jax.jit(step)(st, seg)
    ref = _np(ref_state)
    assert not bool(ref_need)

    tcfg = tsmc.PFConfig(num_particles=cfg.num_particles, num_leaves=4,
                         ess_threshold=0.0, use_bias=True,
                         delay_type=delay_type)
    t_step = tsmc.make_segment_step(
        tcfg, t_epochs(demo, CPU), MU, RHO, lags,
        torch.Generator().manual_seed(0), bias_heights=bh,
        bias_strengths=bs, delays=delays)
    al = torch.from_numpy(alleles)
    tseg = tsmc.Segment(
        L, 0, leaf_status, al[None], al >= 0,
        torch.from_numpy(tsmc.fifo_gate_masks(np.array([dist_mut]), lags)[0]))
    got_state, (ess, need, front) = t_step(state_from_numpy(_np(st), CPU),
                                           tseg)
    got = state_to_numpy(got_state)
    assert not need and front == float(ref.front)
    np.testing.assert_allclose(ess, float(ref_ess), rtol=1e-4)
    for k in ("log_w", "log_pilot"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("df_pos", "df_logf", "df_delta", "df_k"):
        np.testing.assert_array_equal(got[k], getattr(ref, k), err_msg=k)
    assert not np.array_equal(ref.df_pos, np.asarray(st.df_pos))
    np.testing.assert_allclose(got["ln_norm"], ref.ln_norm, rtol=1e-6)
    for k in ("fifo", "stats", "stats_wt"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                   err_msg=k)


def test_unit_strengths_give_the_plain_pass():
    """The biased pass with every strength 1 is the plain pass: the same
    tree topology after 16 trips, floats to f32 tolerance, log_w and the
    pilot equal and nothing delayed."""
    P, n, E, L, T = 128, 5, 4, 60000.0, 16
    demo = _demo(E=E, n=n)
    epochs = t_epochs(demo, CPU)
    gen = torch.Generator().manual_seed(4)
    from smcsmc_tpu_torch.kernels.tree import make_initial_trees

    trees = make_initial_trees(gen, epochs, P, [0] * n)
    base = dict(time=trees.time, parent=trees.parent, child0=trees.child0,
                child1=trees.child1,
                next_rec=torch.rand(P, generator=gen) * 0.3 * L,
                log_w=torch.zeros(P))
    u = torch.rand((T, P, 4), generator=gen)
    mask = torch.ones(6 * E)
    outs = {}
    for name in ("plain", "biased"):
        st = {k: v.clone() for k, v in base.items()}
        fifo, tl = torch.zeros((P, 4, 6 * E)), torch.zeros(P)
        b = None
        if name == "biased":
            bh, bs = _tables((1000.0, 8000.0), (1.0, 1.0, 1.0))
            b = BiasedPass(torch.zeros(P), torch.full((P, 32), INF),
                           torch.zeros((P, 32)), torch.zeros((P, 32)),
                           torch.zeros((P, 32), dtype=torch.int32),
                           torch.from_numpy(bh), torch.from_numpy(bs),
                           torch.full((E,), 5000.0), 20000.0)
        segment_pass_plain(u, 1, *(st[k] for k in (
            "time", "parent", "child0", "child1", "next_rec", "log_w")),
            fifo, mask, tl, L, MU, RHO, epochs.start, epochs.inv2ne,
            torch.ones(n, dtype=torch.bool), b)
        outs[name] = dict(st, tl=tl, pending=fifo[:, 0])
        if b is not None:
            assert not (b.df_pos < INF).any()  # nothing delayed
            torch.testing.assert_close(b.log_pilot, st["log_w"], rtol=1e-5,
                                       atol=1e-5)
    trees_d, floats_d, errs = disagreement(outs["biased"], outs["plain"], L,
                                           MU)
    assert not trees_d.any() and not floats_d.any(), errs
    assert int((base["next_rec"] < L).sum()) > P // 2


def test_no_data_posterior_equals_prior_under_bias():
    """Biased proposals with delayed weights, no data: the posterior is
    the prior (the JAX package's test_e2e.py::test_bias_nodata_invariance
    at its bands)."""
    ne = 10000.0
    demo = _demo(E=1, n=4, ne=ne)
    n_seg = 40
    seg = SegData(
        positions=1 + np.arange(n_seg) * 25000,
        lengths=np.full(n_seg, 25000), states=np.zeros(n_seg, np.int8),
        alleles=np.full((n_seg, 4), -1, np.int8), phased=np.ones(4, bool))
    cfg = tem.EMConfig(num_particles=300, lag=20000.0, device="cpu",
                       bias_heights=(5000.0,), bias_strengths=(3.0, 1.0))
    stats, _, logl, diag = tem.run_chunk(demo, seg, cfg, seed=5)
    assert logl == pytest.approx(0.0, abs=0.8)
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert ne_hat == pytest.approx(ne, rel=0.05)
    r_hat = float(stats.recomb_cnt.sum() / stats.recomb_opp.sum())
    assert r_hat == pytest.approx(1e-9, rel=0.25)
    assert diag["num_resamples"] > 0


@pytest.mark.parametrize("delay_type", ["coal", "migr"])
def test_biased_sweep_runs_with_delay_type(delay_type):
    """The delay keyed off the coalescence height stays finite (the JAX
    package's test_flag_surface.py::TestDelayType)."""
    demo = _demo(E=1, n=2, L=1e5)
    demo.mutation_rate = 1e-8
    seg = simulate_seg(demo, seed=17)
    cfg = tem.EMConfig(num_particles=32, device="cpu", bias_heights=(2000.0,),
                       bias_strengths=(2.0, 1.0), delay_type=delay_type)
    stats, _, logl, _ = tem.run_chunk(demo, seg, cfg, seed=5)
    assert np.isfinite(logl) and logl < 0
    assert np.all(np.isfinite(stats.coal_opp))


def test_biased_run_chunk_agrees_with_jax():
    E = 8
    demo = Demography(
        change_times=np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]),
        pop_sizes=np.full((E, 1), 10000.0), mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(4, np.int32), mutation_rate=1e-8,
        recombination_rate=1e-9, sequence_length=2e5)
    seg = simulate_seg(demo, seed=5)
    kw = dict(num_particles=64, bias_heights=(1000.0,),
              bias_strengths=(3.0, 1.0))
    res = {"jax": [], "torch": []}
    for s in (1, 2, 3):
        res["jax"].append(jem.run_chunk(
            demo, seg, jem.EMConfig(block_size=512, **kw), seed=s))
        res["torch"].append(tem.run_chunk(
            demo, seg, tem.EMConfig(device="cpu", **kw), seed=s))
    summary = {}
    for side, runs in res.items():
        assert all(np.isfinite(r[2]) and r[2] < 0 for r in runs)
        assert all(r[3]["num_resamples"] > 0 for r in runs)
        summary[side] = (
            np.mean([r[2] for r in runs]),
            sum(r[0].coal_opp.sum() for r in runs)
            / (2.0 * sum(r[0].coal_cnt.sum() for r in runs)),
            sum(r[0].recomb_cnt.sum() for r in runs)
            / sum(r[0].recomb_opp.sum() for r in runs))
    (lj, nj, rj), (lt, nt, rt) = summary["jax"], summary["torch"]
    assert abs(lt - lj) <= 0.02 * abs(lj), summary
    assert nt == pytest.approx(nj, rel=0.3), summary
    assert rt == pytest.approx(rj, rel=0.5), summary
