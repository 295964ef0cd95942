"""The port's VB (``-vb``, the in-proposal correction of particle.cpp:266-272
and the M-step's pseudocounts of model.py:997-1001) against the JAX
package.

- ``_digamma64``, ``vb_log_tables`` and the VB branch of ``m_step``: equal to
  JAX's exactly (they are copies; the tables are f32).
- The VB term of a trip, in each plain version of the segment pass: the
  plain pass's trips on shared uniforms against the Pallas trip kernel
  (interpret mode) with JAX's in-loop VB expression (smc.py:951-967)
  applied after each trip to the coalescence it recorded: ``log_w`` within
  rtol 1e-5 (the tolerance of tests/test_torch_trip.py).  The biased and
  the migration pass: the pass with VB against the same pass without VB on
  the same uniforms plus JAX's expression on the events the pass recorded
  (counts from FIFO slot 0 with the gate open): ``log_w`` and
  ``log_pilot`` within rtol 1e-5 and atol 1e-5 (a difference of weights of
  order 1 carries their last bits), trees and rings equal.
- One step with VB and a chain of trips, plain, biased and migration: the
  port's step against JAX's XLA step (``use_vb``, which runs JAX's VB
  branch in its order: the term, then the importance weight, then the
  pilot), its transitions replaced by the port's on the port's uniforms so
  that both take the same trips; weights within rtol 1e-5.
- The analogues of tests/test_vb_and_gaps.py::TestVB on the port's sweep.

The tables are built from small counts drawn in [0.05, 5] with one ``-xc``
epoch, so that the term is of order 0.1-1 per event and not the vanishing
1e-11 of iteration 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smcsmc_tpu.em as jem
from smcsmc_tpu.demography import Demography as JDemography
from smcsmc_tpu.kernels import pallas_trip
from smcsmc_tpu.kernels.tree import epochs_from_demography as j_epochs
from smcsmc_tpu import smc as jsmc
import smcsmc_tpu_torch.em as tem
from smcsmc_tpu_torch.demography import Demography as TDemography
from smcsmc_tpu_torch.kernels import migration as tmig
from smcsmc_tpu_torch.kernels.bias import BiasedPass
from smcsmc_tpu_torch.kernels.tree import (
    INF,
    epochs_from_demography as t_epochs,
    make_initial_trees,
)
from smcsmc_tpu_torch.kernels.trip import (
    disagreement,
    segment_pass_plain,
    trip_plain,
)
from smcsmc_tpu_torch.simulate import simulate_seg

torch.set_num_threads(1)

MU, RHO = 1e-8, 1e-9
P = 64
SEG_FIELDS = ("time", "parent", "child0", "child1", "next_rec", "log_w")


def _demo(cls, E=3, n=4, L=2e5, pops=1):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(3.2, 4.5, E - 1)]))
    mig = np.zeros((E, pops, pops))
    if pops > 1:
        mig[:, 0, 1] = mig[:, 1, 0] = 1e-4
    return cls(change_times=change, pop_sizes=np.full((E, pops), 10000.0),
               mig_rates=mig,
               sample_pops=np.arange(n, dtype=np.int32) * pops // n,
               mutation_rate=MU, recombination_rate=RHO, sequence_length=L)


def _small_counts(E, Pp, seed, xc_epoch=1):
    """Event counts drawn in [0.05, 5] and the ``-xc`` epoch ``xc_epoch``."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 5.0, (E, Pp)),
            rng.uniform(0.05, 5.0, (E, Pp, Pp))), (xc_epoch,)


def _jax_vb_term(coal_cnt, mig_cnt, vb_coal, vb_mig, xc_mask):
    """JAX's in-loop VB expression (smcsmc_tpu/smc.py:958-964) on one trip's
    recorded counts coal_cnt [P, E, Pp] and mig_cnt [P, E, Pp, Pp]."""
    return np.asarray(jnp.sum(
        jnp.asarray(coal_cnt) * (jnp.asarray(vb_coal)
                                 * jnp.asarray(xc_mask)[:, None])[None],
        axis=(1, 2),
    ) + jnp.sum(
        jnp.asarray(mig_cnt) * (jnp.asarray(vb_mig)
                                * jnp.asarray(xc_mask)[:, None, None])[None],
        axis=(1, 2, 3),
    ))


def _xc_mask(E, xc):
    m = np.ones(E, np.float32)
    m[list(xc)] = 0.0
    return m


# ---------------------------------------------------------------------------
# host: the tables and the M-step, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x", [
    np.array([1e-3, 0.05, 0.5, 1.0, 5.999, 6.0, 7.5, 1e3, 1e10]),
    np.random.default_rng(3).uniform(1e-3, 50.0, 200),
])
def test_digamma64_equals_jax(x):
    np.testing.assert_array_equal(tem._digamma64(x), jem._digamma64(x))


@pytest.mark.parametrize("counts,pseudo,pops", [
    (None, 1.0, 1),  # iteration 0: counts 1e10, the factor ~ 1
    (None, 1.0, 2),
    ("small", 1.0, 1),
    ("small", 0.5, 2),
    ("floor", 1e-2, 1),  # negative counts: the 1e-3 floor
])
def test_vb_log_tables_equal_jax(counts, pseudo, pops):
    E = 5
    jd, td = _demo(JDemography, E, pops=pops), _demo(TDemography, E,
                                                     pops=pops)
    if counts == "small":
        counts = _small_counts(E, pops, 4)[0]
    elif counts == "floor":
        counts = (np.full((E, pops), -0.5), np.full((E, pops, pops), -2.0))
    ref = jem.vb_log_tables(jd, counts, pseudo)
    got = tem.vb_log_tables(td, counts, pseudo)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    if counts is None:
        assert np.all(np.abs(got[0]) < 1e-6)


def test_vb_pass_tables_zero_the_xc_epochs():
    E = 5
    td = _demo(TDemography, E, pops=2)
    counts, xc = _small_counts(E, 2, 5, xc_epoch=3)
    cfg = tem.EMConfig(vb=True, xc_epochs=xc)
    coal, mig = tem.vb_pass_tables(td, counts, cfg)
    ref_c, ref_m = jem.vb_log_tables(_demo(JDemography, E, pops=2), counts)
    mask = _xc_mask(E, xc)
    np.testing.assert_array_equal(coal, ref_c * mask[:, None])
    np.testing.assert_array_equal(mig, ref_m * mask[:, None, None])
    assert not coal[3].any() and coal[2].all()


@pytest.mark.parametrize("pops,xc", [(1, ()), (1, (1,)), (2, (0,))])
def test_vb_m_step_equals_jax(pops, xc):
    E = 4
    rng = np.random.default_rng(11 + pops)
    stats = dict(
        coal_opp=rng.uniform(1e5, 1e7, (E, pops)),
        coal_cnt=rng.uniform(0.0, 40.0, (E, pops)),
        mig_opp=rng.uniform(1e5, 1e7, (E, pops)),
        mig_cnt=rng.uniform(0.0, 5.0, (E, pops, pops)),
        recomb_opp=rng.uniform(1e9, 1e10, E),
        recomb_cnt=rng.uniform(1.0, 20.0, E))
    for cap in (False, True):
        kw = dict(vb=True, vb_pseudocount=0.7, xc_epochs=xc, use_cap=cap,
                  ne_cap=15000.0)
        ref = jem.m_step(_demo(JDemography, E, pops=pops),
                         jsmc.SuffStats(**stats), jem.EMConfig(**kw))
        got = tem.m_step(_demo(TDemography, E, pops=pops),
                         tem.SuffStats(**stats), tem.EMConfig(**kw))
        for k in ("pop_sizes", "mig_rates", "recombination_rate"):
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                          err_msg=k)
    plain = tem.m_step(_demo(TDemography, E, pops=pops),
                       tem.SuffStats(**stats), tem.EMConfig())
    assert not np.array_equal(plain.pop_sizes, got.pop_sizes)


# ---------------------------------------------------------------------------
# the VB term of a trip in each plain version of the segment pass
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_trees(n, E, seed):
    epochs = j_epochs(_demo(JDemography, E, n))
    st = jsmc.init_state(jax.random.PRNGKey(seed), epochs,
                         jsmc.PFConfig(num_particles=P, num_leaves=n),
                         np.zeros(n, np.int32), RHO)
    return epochs, jax.tree_util.tree_map(np.asarray, st.trees)


_ORDER = ("time", "parent", "child0", "child1", "next_rec", "upd", "log_w",
          "tl", "B", "tl_e", "pending")


@pytest.mark.parametrize("leaf_status", [1, 0, -1])
@pytest.mark.parametrize("n", [4, 8])
def test_vb_plain_trips_match_pallas_trips_with_jax_term(n, leaf_status):
    """T trips of the plain version with VB on shared uniforms against T
    Pallas trips (interpret mode), each followed by JAX's VB expression on
    the coalescence the trip recorded: log_w within rtol 1e-5, trees
    exactly."""
    E, T, L = 3, 6, 80000.0
    epochs, trees = _jax_trees(n, E, 7 + n)
    hd = np.ones(n, bool)
    if leaf_status == 0:
        hd[[0, n // 2]] = False
    elif leaf_status == -1:
        hd[:] = False
    tl, tle, B = jsmc._tree_summaries(
        jax.tree_util.tree_map(jnp.asarray, trees), epochs,
        jnp.int8(leaf_status), jnp.asarray(hd))
    rng = np.random.default_rng(20 + n + leaf_status)
    d = dict(time=trees.time, parent=trees.parent, child0=trees.child0,
             child1=trees.child1,
             next_rec=rng.uniform(0.0, 0.3 * L, P).astype(np.float32),
             upd=np.zeros(P, np.float32),
             log_w=np.full(P, -np.log(P), np.float32), tl=np.asarray(tl),
             B=np.asarray(B), tl_e=np.asarray(tle),
             pending=np.zeros((P, 6 * E), np.float32))
    u = rng.uniform(size=(T, P, 4)).astype(np.float32)
    counts, xc = _small_counts(E, 1, 30 + n)
    jd = _demo(JDemography, E, n)
    vb_coal, vb_mig = jem.vb_log_tables(jd, counts)
    xc_mask = _xc_mask(E, xc)
    inv2ne = 1.0 / (2.0 * epochs.ne[:, 0])

    ref = {k: jnp.asarray(v) for k, v in d.items()}
    for j in range(T):
        out = dict(zip(_ORDER, pallas_trip.fused_trip(
            jnp.asarray(u[j]), leaf_status, *(ref[k] for k in _ORDER),
            jnp.float32(L), jnp.float32(MU), jnp.float32(RHO), epochs.start,
            inv2ne, jnp.asarray(hd.astype(np.float32)), N=2 * n - 1, E=E,
            BLK=P, interpret=True)))
        cnt = np.asarray(out["pending"][:, E:2 * E] - ref["pending"][:, E:2 * E])
        term = _jax_vb_term(cnt[:, :, None], np.zeros((P, E, 1, 1)),
                            vb_coal, vb_mig, xc_mask)
        out["log_w"] = out["log_w"] + term
        if leaf_status == 0:
            # the Pallas kernel's ancestor walk refreshes B wrongly for
            # mixed data (tests/test_torch_trip.py): take the XLA path's
            tr = jsmc.Trees(parent=out["parent"], time=out["time"],
                            pop=jnp.zeros_like(out["parent"]),
                            child0=out["child0"], child1=out["child1"])
            B_xla = jsmc._tree_summaries(tr, epochs, jnp.int8(0),
                                         jnp.asarray(hd))[2]
            out["B"] = jnp.where(out["upd"] != ref["upd"], B_xla, out["B"])
        ref = out
    ref = {k: np.asarray(v) for k, v in ref.items()}

    td = _demo(TDemography, E, n)
    cfg = tem.EMConfig(vb=True, xc_epochs=xc)
    t_coal = torch.from_numpy(tem.vb_pass_tables(td, counts, cfg)[0][:, 0])
    got = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    trip_plain(torch.from_numpy(u), leaf_status, *(got[k] for k in _ORDER),
               L, MU, RHO, torch.from_numpy(np.array(epochs.start)),
               torch.from_numpy(np.array(inv2ne)), torch.from_numpy(hd),
               t_coal)
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("parent", "child0", "child1"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["log_w"], ref["log_w"], rtol=1e-5)
    # the term is there: several coalescences per particle, the -xc epoch
    # among them carrying none
    n_coal = ref["pending"][:, E:2 * E].sum(axis=1)
    assert n_coal.max() >= 2 and ref["pending"][:, E + xc[0]].sum() > 0
    moved = ref["log_w"] - (-np.log(P))
    assert np.abs(moved).max() > 0.1


def _fifo_counts(fifo0, E, Pp):
    """(coal_cnt [P, E, Pp], mig_cnt [P, E, Pp, Pp]) from FIFO slot 0."""
    off = tmig.stats_offsets(E, Pp)
    c = fifo0[:, off["coal_cnt"]:off["coal_cnt"] + E * Pp]
    m = fifo0[:, off["mig_cnt"]:off["mig_cnt"] + E * Pp * Pp]
    return (c.reshape(-1, E, Pp).numpy().astype(np.float64),
            m.reshape(-1, E, Pp, Pp).numpy().astype(np.float64))


def _run_pass(trees, epochs, u, L, hd, E, Pp, vb=None, biased=None,
              migration=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    st = {k: getattr(trees, k).clone() for k in SEG_FIELDS[:4]}
    st["next_rec"] = torch.rand(P, generator=g) * 0.3 * L
    st["log_w"] = torch.full((P,), -float(np.log(P)))
    K = tmig.stats_offsets(E, Pp)["width"]
    fifo, tl = torch.zeros((P, 4, K)), torch.zeros(P)
    segment_pass_plain(u, 1, *(st[k] for k in SEG_FIELDS), fifo,
                       torch.ones(K), tl, L, MU, RHO, epochs.start,
                       epochs.inv2ne, hd, biased, migration, vb)
    return st, fifo[:, 0]


def _biased(P_, E, seed):
    g = torch.Generator().manual_seed(seed)
    used = torch.rand((P_, 32), generator=g) < 0.3
    return BiasedPass(
        torch.randn(P_, generator=g),
        torch.where(used, 1000.0 + 60000.0 * torch.rand((P_, 32),
                                                         generator=g), INF),
        torch.where(used, torch.randn((P_, 32), generator=g), 0.0),
        torch.where(used, 3000.0 * torch.rand((P_, 32), generator=g), 0.0),
        torch.where(used, torch.randint(1, 4, (P_, 32), generator=g,
                                        dtype=torch.int32), 0),
        torch.tensor([0.0, 2000.0, 3e38]), torch.tensor([4.0, 1.0]),
        torch.linspace(3000.0, 30000.0, E), 1000.0)


def _copy_pass(b):
    return b._replace(**{k: getattr(b, k).clone() for k in (
        "log_pilot", "df_pos", "df_logf", "df_delta", "df_k")})


@pytest.mark.parametrize("kind", ["plain", "biased", "migration"])
def test_vb_pass_adds_jax_term_of_its_events(kind):
    """Each plain pass with VB equals the same pass without VB on the same
    uniforms plus JAX's expression on the events the pass recorded (with
    the posterior and, under bias, the pilot): trees, rings and walks
    unchanged; log_w and log_pilot within rtol 1e-5, atol 1e-5."""
    E, n, L = 4, 4, 50000.0
    Pp = 2 if kind == "migration" else 1
    T = 1 if kind == "migration" else 16
    demo = _demo(TDemography, E, n, pops=Pp)
    epochs = t_epochs(demo, "cpu")
    g = torch.Generator().manual_seed(3)
    Mw = 16
    trees = make_initial_trees(g, epochs, P, demo.sample_pops,
                               max_mig=Mw if Pp > 1 else 0)
    u = torch.rand((T, P, 4), generator=g)
    hd = torch.ones(n, dtype=torch.bool)
    counts, xc = _small_counts(E, Pp, 40)
    cfg = tem.EMConfig(vb=True, xc_epochs=xc)
    tables = tuple(torch.from_numpy(x)
                   for x in tem.vb_pass_tables(demo, counts, cfg))
    ref_coal, ref_mig = jem.vb_log_tables(_demo(JDemography, E, n, pops=Pp),
                                          counts)

    def kwargs():
        if kind == "biased":
            return dict(biased=_copy_pass(base_b))
        if kind == "migration":
            mig = tmig.MigrationPass(
                trees.pop.clone(), trees.mig_time.clone(),
                trees.mig_dest.clone(), torch.zeros(2, dtype=torch.float64),
                torch.tensor([123, 45], dtype=torch.int32),
                *tmig.migration_tables(epochs))
            return dict(migration=mig)
        return {}

    base_b = _biased(P, E, 9)
    kw_off, kw_on = kwargs(), kwargs()
    off, f_off = _run_pass(trees, epochs, u, L, hd, E, Pp, None, **kw_off)
    on, f_on = _run_pass(trees, epochs, u, L, hd, E, Pp, tables, **kw_on)
    for k in SEG_FIELDS[:5]:
        assert torch.equal(on[k], off[k]), k
    assert torch.equal(f_on, f_off)
    coal_cnt, mig_cnt = _fifo_counts(f_on, E, Pp)
    term = _jax_vb_term(coal_cnt, mig_cnt, ref_coal, ref_mig,
                        _xc_mask(E, xc))
    np.testing.assert_allclose(on["log_w"].numpy(),
                               off["log_w"].numpy() + term, rtol=1e-5,
                               atol=1e-5)
    assert np.abs(term).max() > 0.1 and coal_cnt[:, xc[0]].sum() > 0
    if kind == "biased":
        b_on, b_off = kw_on["biased"], kw_off["biased"]
        for k in ("df_pos", "df_logf", "df_delta", "df_k"):
            assert torch.equal(getattr(b_on, k), getattr(b_off, k)), k
        assert not torch.equal(b_off.df_pos, base_b.df_pos)
        np.testing.assert_allclose(b_on.log_pilot.numpy(),
                                   b_off.log_pilot.numpy() + term,
                                   rtol=1e-5, atol=1e-5)
    if kind == "migration":
        m_on, m_off = kw_on["migration"], kw_off["migration"]
        for k in ("pop", "mig_time", "mig_dest", "diag"):
            assert torch.equal(getattr(m_on, k), getattr(m_off, k)), k
        assert mig_cnt.sum() > 0  # the walks migrated


def test_vb_biased_pass_with_unit_strengths_is_the_plain_pass():
    """Under unit strengths the biased pass is the plain one, VB included:
    the pilot takes the same VB terms as the posterior."""
    E, n, L, T = 4, 5, 60000.0, 16
    demo = _demo(TDemography, E, n)
    epochs = t_epochs(demo, "cpu")
    g = torch.Generator().manual_seed(8)
    trees = make_initial_trees(g, epochs, P, demo.sample_pops)
    u = torch.rand((T, P, 4), generator=g)
    hd = torch.ones(n, dtype=torch.bool)
    counts, xc = _small_counts(E, 1, 41)
    tables = tuple(torch.from_numpy(x) for x in tem.vb_pass_tables(
        demo, counts, tem.EMConfig(vb=True, xc_epochs=xc)))
    b = BiasedPass(torch.full((P,), -float(np.log(P))),
                   torch.full((P, 32), INF), torch.zeros((P, 32)),
                   torch.zeros((P, 32)), torch.zeros((P, 32), dtype=torch.int32),
                   torch.tensor([0.0, 1000.0, 3e38]), torch.tensor([1.0, 1.0]),
                   torch.full((E,), 5000.0), 20000.0)
    plain, f_plain = _run_pass(trees, epochs, u, L, hd, E, 1, tables)
    biased, f_biased = _run_pass(trees, epochs, u, L, hd, E, 1, tables,
                                 biased=b)
    # the topology equal, floats to f32 tolerance (as
    # tests/test_torch_bias.py::test_unit_strengths_give_the_plain_pass)
    trees_d, floats_d, errs = disagreement(
        dict(biased, pending=f_biased), dict(plain, pending=f_plain), L, MU)
    assert not trees_d.any() and not floats_d.any(), errs
    torch.testing.assert_close(b.log_pilot, plain["log_w"], rtol=1e-5,
                               atol=1e-5)
    assert not (b.df_pos < INF).any()  # nothing delayed


# ---------------------------------------------------------------------------
# one VB step with trips: the port's step against JAX's XLA step
# ---------------------------------------------------------------------------


def _normed(x):
    return (x - np.log(np.exp(x - x.max()).sum()) - x.max()).astype(np.float32)


def _step_ring(P_, front, L, rng):
    """A ring with free slots, factors due inside the segment (the drain at
    its end) and factors beyond it; the log factors multiples of 1/64."""
    used = rng.uniform(size=(P_, 32)) < 0.4
    pos = np.where(used, rng.uniform(front, front + 2.0 * L, (P_, 32)), INF)
    logf = np.where(used, rng.integers(-64, 64, (P_, 32)) / 64.0, 0.0)
    delta = np.where(used, rng.uniform(100.0, 900.0, (P_, 32)), 0.0)
    k = np.where(used, rng.integers(1, 4, (P_, 32)), 0)
    return (pos.astype(np.float32), logf.astype(np.float32),
            delta.astype(np.float32), k.astype(np.int32))


def _key_chain(key, T):
    """The keys JAX's trip loop draws from the state's key (smc.py: per
    trip one split for the transition, ``split(sub, P)`` per particle, and
    one for the next gap): the first particle's transition key of each
    trip, and the uniforms behind each trip's exponential gap."""
    firsts, gap_u = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        firsts.append(np.asarray(jax.random.split(sub, P)[0]).tobytes())
        key, sub = jax.random.split(key)
        gap_u.append(np.asarray(jax.random.uniform(sub, (P,))))
    return {k: j for j, k in enumerate(firsts)}, np.stack(gap_u)


@pytest.mark.parametrize("kind,leaf_status,delay_type", [
    ("plain", 1, "recomb"), ("biased", 1, "recomb"), ("biased", 0, "coal"),
    ("migration", 1, "recomb"), ("migration", 0, "recomb")])
def test_vb_step_with_trips_matches_jax_step(kind, leaf_status, delay_type,
                                             monkeypatch):
    """One segment step with VB and several trips per particle: the port's
    step (its plain pass) against JAX's XLA step
    (``make_segment_step`` with ``use_vb``), from one state, on one chain
    of trips.  JAX's per-particle transition keys draw other numbers than
    the port's uniforms, so JAX's ``recombination_transition`` is replaced
    by the port's own transition on the port's uniforms of that trip
    (through ``jax.pure_callback``); the gap uniforms are JAX's own.  What
    runs in JAX is then everything its step does around the transitions:
    the extensions, the VB term of each trip from the events it recorded
    (with the ``-xc`` mask), the importance weight after it, the pilot and
    the ring of delayed factors under bias, the gaps, the site likelihood,
    the normalisations and the FIFO.  log_w and log_pilot within rtol 1e-5
    and atol 1e-5, next_rec (as a position from the segment's start)
    within rtol 1e-5, trees equal, the ring's floats within rtol 1e-5 and
    its counts equal."""
    from smcsmc_tpu.kernels import transition as jtr
    from smcsmc_tpu_torch import smc as tsmc
    from smcsmc_tpu_torch.convert import (
        segment_from_numpy,
        state_from_numpy,
        state_to_numpy,
    )
    from smcsmc_tpu_torch.kernels import trip as ttrip

    E, n, L, dist_mut, seed = 4, 4, 50000, 3000.0, 60 + leaf_status
    Pp = 2 if kind == "migration" else 1
    biased, mig = kind == "biased", kind == "migration"
    jd, td = _demo(JDemography, E, n, pops=Pp), _demo(TDemography, E, n,
                                                      pops=Pp)
    epochs, t_ep = j_epochs(jd), t_epochs(td, "cpu")
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=n, ess_threshold=0.0,
                        use_bias=biased, delay_type=delay_type,
                        has_migration=mig, use_vb=True)
    st = jsmc.init_state(jax.random.PRNGKey(seed), epochs, cfg,
                         jd.sample_pops, RHO)
    rng = np.random.default_rng(seed)
    front = 40000.0
    lw = _normed(rng.normal(0.0, 2.0, P))
    K = jsmc.stats_width(E, Pp)
    st = st._replace(
        log_w=jnp.asarray(lw),
        log_pilot=jnp.asarray(_normed(rng.normal(0.0, 2.0, P)) if biased
                              else lw),
        fifo=jnp.asarray(rng.uniform(0, 1, (P, cfg.fifo_slots, K)),
                         jnp.float32),
        front=jnp.float32(front),
        next_rec=jnp.asarray(rng.uniform(0.0, 0.4 * L, P), jnp.float32))
    if biased:
        ring = _step_ring(P, front, L, rng)
        st = st._replace(df_pos=jnp.asarray(ring[0]),
                         df_logf=jnp.asarray(ring[1]),
                         df_delta=jnp.asarray(ring[2]),
                         df_k=jnp.asarray(ring[3]))
    lags = np.array([3000.0, 9000.0, 20000.0, 40000.0], np.float32)
    bh, bs = (np.array([0.0, 2000.0, 3e38], np.float32),
              np.array([3.0, 1.0], np.float32))
    delays = lags * 0.25
    alleles = np.random.default_rng(7).integers(0, 2, n).astype(np.int8)
    if leaf_status == 0:
        alleles[[0, 2]] = -1
    counts, xc = _small_counts(E, Pp, 50 + Pp)
    xc_mask = _xc_mask(E, xc)
    ref_coal, ref_mig = jem.vb_log_tables(jd, counts)

    # ---- the port's step, on uniforms of the test's choosing -------------
    T = tsmc.MAX_RECOMB_ITERS
    index, gap_u = _key_chain(st.key, T)
    U = torch.from_numpy(rng.uniform(size=(T, P, 4)).astype(np.float32))
    U[:, :, 3] = torch.from_numpy(gap_u)
    seen = {}
    real_pass = tsmc.segment_pass

    def with_uniforms(uniforms, *args):
        assert uniforms.shape == U.shape
        if args[-2] is not None:
            seen["walk_key"] = args[-2].key.clone()
        return real_pass(U, *args)

    monkeypatch.setattr(tsmc, "segment_pass", with_uniforms)
    tcfg = tsmc.PFConfig(num_particles=P, num_leaves=n, ess_threshold=0.0,
                         use_bias=biased, delay_type=delay_type,
                         has_migration=mig)
    t_step = tsmc.make_segment_step(
        tcfg, t_ep, MU, RHO, lags, torch.Generator().manual_seed(0),
        bias_heights=bh if biased else None,
        bias_strengths=bs if biased else None,
        delays=delays if biased else None,
        vb_tables=tem.vb_pass_tables(td, counts, tem.EMConfig(
            vb=True, xc_epochs=xc)))
    seg = (jnp.int32(L), jnp.asarray(alleles)[None], jnp.int32(1),
           jnp.int8(0), jnp.int8(leaf_status), jnp.float32(dist_mut))
    seg_np = jax.tree_util.tree_map(np.asarray, seg)
    st_np = jax.tree_util.tree_map(np.asarray, st)
    got_state, (ess, need, front_out) = t_step(
        state_from_numpy(st_np, "cpu"),
        segment_from_numpy(seg_np, lags, "cpu", xc, (), Pp))
    got = state_to_numpy(got_state)

    # ---- JAX's step, its transitions the port's ---------------------------
    est = t_ep.start
    eend = torch.cat([est[1:], est.new_full((1,), INF)])
    has_data = torch.from_numpy(alleles >= 0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    trips = []

    def port_trip(key0, time, parent, c0, c1, pop, mig_time, mig_dest,
                  active):
        j = index[np.asarray(key0).tobytes()]
        act = torch.from_numpy(np.array(active))
        tr = [torch.from_numpy(np.array(x)) for x in (time, parent, c0, c1)]
        nr = torch.where(act, 0.0, 2.0 * L)
        zeros = torch.zeros(P)
        pend = torch.zeros((P, K))
        ev = [zeros] * 4
        capped = dropped = 0.0
        if mig:
            mp = tmig.MigrationPass(
                *(torch.from_numpy(np.array(x)) for x in (pop, mig_time,
                                                          mig_dest)),
                torch.zeros(2, dtype=torch.float64), seen["walk_key"],
                *tmig.migration_tables(t_ep), tcfg.max_walk_events)
            real_walk = tmig.walk_mig
            # the pass's trip j: the walk's counter takes the trip index
            monkeypatch.setattr(tmig, "walk_mig",
                                lambda m, trip, *a: real_walk(m, j, *a))
            try:
                tmig.migration_trips(U[j:j + 1], leaf_status, *tr, nr,
                                     zeros.clone(), zeros.clone(),
                                     torch.ones(P), zeros.clone(),
                                     torch.zeros((P, E)), pend, float(L),
                                     MU, RHO, est, has_data, mp)
            finally:
                monkeypatch.setattr(tmig, "walk_mig", real_walk)
            pop, mig_time, mig_dest = (x.numpy() for x in (
                mp.pop, mp.mig_time, mp.mig_dest))
            capped, dropped = (float(x) for x in mp.diag)
        else:
            out, rec = ttrip._trip(
                U[j], leaf_status, *tr, nr, zeros, zeros, torch.ones(P),
                zeros, torch.zeros((P, E)), pend, f32(L), f32(MU), f32(RHO),
                est, eend, t_ep.inv2ne, has_data,
                (torch.from_numpy(bh), torch.from_numpy(bs)) if biased
                else None)
            tr, pend, ev = list(out[:4]), out[10], rec[:4]
        trips.append(pend.numpy())
        ev = [torch.where(act, x, 0.0).numpy() for x in ev]
        diag = np.zeros((2, P), np.float32)
        diag[:, 0] = capped, dropped
        return (*(x.numpy() for x in tr), np.asarray(pop),
                np.asarray(mig_time), np.asarray(mig_dest), pend.numpy(),
                *ev, diag)

    def transition(keys, trees, epochs_, active, **kw):
        mt = trees.mig_time
        shapes = [jax.ShapeDtypeStruct(x.shape, x.dtype) for x in (
            trees.time, trees.parent, trees.child0, trees.child1, trees.pop)]
        bufs = (mt, trees.mig_dest) if mt is not None else (
            jnp.zeros(()), jnp.zeros((), jnp.int32))
        shapes += [jax.ShapeDtypeStruct(x.shape, x.dtype) for x in bufs]
        shapes += [jax.ShapeDtypeStruct((P, K), jnp.float32)]
        shapes += [jax.ShapeDtypeStruct((P,), jnp.float32)] * 4
        shapes += [jax.ShapeDtypeStruct((2, P), jnp.float32)]
        (time, parent, c0, c1, pop, mt2, md2, pend, h_r, t_c, log_iw,
         strength, diag) = jax.pure_callback(
            port_trip, tuple(shapes), keys[0], trees.time, trees.parent,
            trees.child0, trees.child1, trees.pop, *bufs, active)
        s = jsmc.unpack_stats(pend, E, Pp)
        zi = jnp.zeros((P,), jnp.int32)
        rec = jtr.TransitionRecord(
            coal_opp=s.coal_opp, coal_cnt=s.coal_cnt, mig_opp=s.mig_opp,
            mig_cnt=s.mig_cnt, recomb_cnt=s.recomb_cnt, recomb_height=h_r,
            coal_height=t_c, log_iw=log_iw, log_iw_bias=log_iw,
            point_strength=strength, c_node=zi, d_node=zi, coal_pop=zi,
            walk_capped=diag[0], buf_dropped=diag[1])
        return trees._replace(
            time=time, parent=parent, child0=c0, child1=c1, pop=pop,
            mig_time=mt2 if mt is not None else None,
            mig_dest=md2 if mt is not None else None), rec

    monkeypatch.setattr(jsmc, "recombination_transition", transition)
    step = jsmc.make_segment_step(
        cfg, epochs, MU, RHO, jnp.asarray(lags),
        *((jnp.asarray(bh), jnp.asarray(bs), jnp.asarray(delays)) if biased
          else (None, None, None)),
        vb_tables=(jnp.asarray(ref_coal), jnp.asarray(ref_mig)),
        rec_masks=(jnp.asarray(xc_mask), jnp.ones(E, jnp.float32)))
    ref_state, (ref_ess, ref_need, _) = jax.jit(step)(st, seg)
    ref = jax.tree_util.tree_map(np.asarray, ref_state)

    # the chain: several trips per particle, the VB term among them
    # non-zero (and the -xc epoch's coalescences carrying none)
    recorded = np.stack(trips)
    assert len(trips) >= 4 and not bool(ref_need) and not need
    off = tmig.stats_offsets(E, Pp)
    cc = recorded[:, :, off["coal_cnt"]:off["coal_cnt"] + E * Pp]
    mc = recorded[:, :, off["mig_cnt"]:off["mig_cnt"] + E * Pp * Pp]
    assert cc.sum() >= 2 * P and cc.reshape(len(trips), P, E, Pp)[
        :, :, xc[0]].sum() > 0
    term = sum(_jax_vb_term(cc[j].reshape(P, E, Pp),
                            mc[j].reshape(P, E, Pp, Pp), ref_coal, ref_mig,
                            xc_mask) for j in range(len(trips)))
    assert np.abs(term).max() > 0.1
    if mig:
        assert mc.sum() > 0  # the walks migrated

    assert front_out == float(ref.front)
    np.testing.assert_allclose(ess, float(ref_ess), rtol=1e-4)
    for k in ("parent", "child0", "child1", "pop"):
        np.testing.assert_array_equal(got["trees"][k],
                                      getattr(ref.trees, k), err_msg=k)
    np.testing.assert_array_equal(got["trees"]["time"], ref.trees.time)
    if mig:
        for k in ("mig_time", "mig_dest"):
            np.testing.assert_array_equal(got["trees"][k],
                                          getattr(ref.trees, k), err_msg=k)
        np.testing.assert_array_equal(got["diag"], ref.diag)
    for k in ("log_w", "log_pilot"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # next_rec is the position after the segment's end, relative to it:
    # compare positions from the segment's start (the gaps were added at
    # positions up to L, where an ulp is L * 6e-8)
    np.testing.assert_allclose(got["next_rec"] + L, ref.next_rec + L,
                               rtol=1e-5)
    if biased:
        # the ring's floats come from trip positions (ulps of the gaps, as
        # next_rec) and importance weights split in another order (ulps):
        # within rtol 1e-5; its counts equal
        for k in ("df_pos", "df_logf", "df_delta"):
            np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got["df_k"], ref.df_k)
        assert not np.allclose(ref.log_pilot, ref.log_w, atol=1e-3)
    else:
        np.testing.assert_array_equal(ref.log_pilot, ref.log_w)
    np.testing.assert_allclose(got["ln_norm"], ref.ln_norm, rtol=1e-6)
    np.testing.assert_allclose(got["fifo"], ref.fifo, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the sweep: tests/test_vb_and_gaps.py::TestVB on the port
# ---------------------------------------------------------------------------


def _single_pop(num_epochs=1, L=2e5, n=4):
    return _demo(TDemography, num_epochs, n, L=L) if num_epochs > 1 else \
        TDemography(change_times=np.array([0.0]),
                    pop_sizes=np.full((1, 1), 10000.0),
                    mig_rates=np.zeros((1, 1, 1)),
                    sample_pops=np.zeros(n, np.int32), mutation_rate=1e-8,
                    recombination_rate=1e-9, sequence_length=L)


def test_vb_tables_order_as_jax_says():
    demo = _single_pop()
    c0, _ = tem.vb_log_tables(demo)
    assert np.all(np.abs(c0) < 1e-6)
    c1, _ = tem.vb_log_tables(demo, (np.full((1, 1), 1.0),
                                     np.zeros((1, 1, 1))))
    c4, _ = tem.vb_log_tables(demo, (np.full((1, 1), 4.0),
                                     np.zeros((1, 1, 1))))
    assert c1[0, 0] < c4[0, 0] < 0


def test_vb_neutral_at_large_counts():
    """Counts 1e10 (iteration 0): the VB run is the run without VB (the
    factor, about -5e-11 per event, vanishes in f32)."""
    demo = _single_pop()
    seg = simulate_seg(demo, seed=11)
    s0, _, l0, _ = tem.run_chunk(demo, seg, tem.EMConfig(
        num_particles=64, device="cpu"), seed=5)
    s1, _, l1, _ = tem.run_chunk(demo, seg, tem.EMConfig(
        num_particles=64, device="cpu", vb=True), seed=5)
    assert l1 == pytest.approx(l0, rel=1e-4)
    np.testing.assert_allclose(s1.coal_cnt, s0.coal_cnt, rtol=1e-3)


def test_vb_penalizes_low_count_epoch():
    """A tiny count for epoch 1 down-weights the genealogies that coalesce
    there, so that epoch's share of the posterior coalescences drops
    against the run with huge counts (same seed, paired proposals)."""
    demo = _single_pop(num_epochs=3)
    demo.change_times = np.array([0.0, 1585.0, 19952.0])
    seg = simulate_seg(demo, seed=12)
    cfg = tem.EMConfig(num_particles=128, vb=True, vb_pseudocount=1e-2,
                       device="cpu")
    E = demo.num_epochs
    big = (np.full((E, 1), 1e10), np.full((E, 1, 1), 1e10))
    small = (np.full((E, 1), 1e10), np.full((E, 1, 1), 1e10))
    small[0][1, 0] = 0.05
    sb, _, _, _ = tem.run_chunk(demo, seg, cfg, seed=9, vb_counts=big)
    ss, _, _, _ = tem.run_chunk(demo, seg, cfg, seed=9, vb_counts=small)
    pseudo = tem.prior_pseudostats(demo)
    eb = np.sum(sb.coal_cnt - pseudo.coal_cnt, axis=1)
    es = np.sum(ss.coal_cnt - pseudo.coal_cnt, axis=1)
    assert es[1] / max(es.sum(), 1e-12) < eb[1] / max(eb.sum(), 1e-12)


def test_run_em_carries_vb_counts_through_resume(tmp_path, monkeypatch):
    """run_em hands each iteration the previous one's event counts, and an
    iteration read back from its finished .out hands them on too."""
    demo = _single_pop(L=6e4)
    seg = simulate_seg(demo, seed=3)
    seen = []
    real = tem.run_chunk

    def spy(*args, vb_counts=None, **kw):
        seen.append(None if vb_counts is None
                    else np.array(vb_counts[0], np.float64))
        return real(*args, vb_counts=vb_counts, **kw)

    monkeypatch.setattr(tem, "run_chunk", spy)
    cfg = tem.EMConfig(num_particles=16, em_iters=2, vb=True, device="cpu",
                       outdir=str(tmp_path))
    res = tem.run_em(demo, seg, cfg)
    assert seen[0] is None and len(seen) == 3
    for it in (1, 2):
        np.testing.assert_array_equal(seen[it], res.stats[it - 1].coal_cnt)
    # resume: iteration 2 is swept again from the counts iteration 1's
    # .out gives back
    import shutil
    shutil.rmtree(tmp_path / "emiter2")
    seen.clear()
    res2 = tem.run_em(demo, seg, cfg)
    assert len(seen) == 1
    np.testing.assert_allclose(seen[0], res2.stats[1].coal_cnt)
    np.testing.assert_allclose(seen[0], res.stats[1].coal_cnt, rtol=1e-3)
