"""The production proposal and local recording in the port's migration pass
against the JAX package, on the CPU (the loop walk:
``SMCSMC_MIG_WALK=loop``).

- Unit strengths: one section of strength 1 along a chain of trips on
  structured trees with buffers (P=64, n=4 and 8, E=8, Pp=2, Mw=16) gives
  the migration pass without the proposal bit for bit: every importance
  weight 0, nothing pushed into the ring of delayed factors.
- The first trip's point: ``migration.biased_point_seq`` (the migration
  pass's node-major order) against JAX's ``_sample_recomb_point_biased``
  with JAX's uniform from the same key, on JAX's structured trees, with and
  without the guide's branch rates: ``c`` and the strength equal, ``h_r``,
  ``log_iw`` and ``log_iw_bias`` within rtol 1e-5.
- ``-delay_migr``: the delayed factor a trip pushes equals JAX's
  ``_epoch_index`` and ``_push_delayed`` on the trip's own coalescence
  height and walk events (the lower of the coalescence and the first
  migration of the new branch), with particles whose first hop lies below
  their coalescence among them: positions, factors and spacings within
  rtol 1e-6, applications left equal.
- The local ring: each event a trip pushes equals JAX's
  ``_push_local_event`` (position, due position, height within rtol 1e-6,
  leaves and drops equal).
- No data under bias: the statistics are the prior's (pooled Ne and
  migration rate within 15%, P=256 over 200 kb with every site missing).
- The wrapper: ``segment_pass_launch_args`` checks every tensor of each
  proposal variant (with and without VB), names its launch count and
  hands ``-delay_migr`` as the migration pass's own delay code; on the
  card (skipped here) each variant against its plain version.
- Whole chunks: the production proposal's flags (``-bias_heights 0 0.05
  -calibrate_lag 2 -delay_migr``) in ``run_chunk`` over seeds 1-3 against
  JAX's, at the tolerances of test_torch_migration.py's
  ``test_twopop_run_chunk_agrees_with_jax`` (the survival calibration of
  both packages cut to 256 genealogies over 200 kb); the ``-alpha 0.5``
  loop's ``.recomb.gz`` with JAX's columns and windows and its guided
  iteration's LogL within 2% of JAX's.
- The structured state: ``gather_particles``, ``checkpoint`` and
  ``convert`` carry the trees' buffers, the ring of delayed factors and
  the ring of local events together.
- ``calibrate_survival`` with two populations and migration against
  JAX's (``has_migration``) at 1024 genealogies over 200 kb in 10
  windows: each epoch's median within one bin of the 64-bin histogram
  (seeds 0-2 of both packages: the youngest epoch within one bin, the
  others equal).
"""

import functools
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu import calibrate as jcal
from smcsmc_tpu import em as jem
from smcsmc_tpu import smc as jsmc
from smcsmc_tpu.demography import Demography as JDemography
from smcsmc_tpu.kernels import transition as jtr
from smcsmc_tpu.kernels import tree as jtree
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu_torch import calibrate as tcal
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.checkpoint import load_state, save_state
from smcsmc_tpu_torch.convert import state_from_numpy, trees_from_numpy
from smcsmc_tpu_torch.demography import Demography as TDemography
from smcsmc_tpu_torch.kernels import migration as tmig
from smcsmc_tpu_torch.kernels import tree as ttree
from smcsmc_tpu_torch.kernels.bias import BiasedPass, guide_branch_rates
from smcsmc_tpu_torch.kernels.local import LocalPass
from smcsmc_tpu_torch.kernels.trip import segment_pass_plain
from smcsmc_tpu_torch.segio import SegData
from smcsmc_tpu_torch.smc import PFConfig, gather_particles, init_state

torch.set_num_threads(1)

MU, RHO, NE = 1e-8, 1e-9, 10000.0
INF = 3e38
FRONT = 10000.0
HEIGHTS = (0.0, 2000.0, INF)  # -bias_heights 0 0.05 at N0 10,000
STRENGTHS = (4.0, 1.0)


def _model(cls, E=8, m=5e-5, L=2e5, sample_pops=(0, 0, 1, 1)):
    """bench.py's twopop_demo over L bp."""
    change = (np.array([0.0]) if E == 1 else
              np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]))
    mig = np.zeros((E, 2, 2))
    mig[:, 0, 1] = mig[:, 1, 0] = m
    return cls(change_times=change, pop_sizes=np.full((E, 2), NE),
               mig_rates=mig, sample_pops=np.array(sample_pops, np.int32),
               mutation_rate=MU, recombination_rate=RHO, sequence_length=L)


class _Pass:
    """Structured trees with buffers and the inputs of a migration segment
    pass on the CPU, made from a seed (the port's initial trees or JAX's
    through ``convert``)."""

    def __init__(self, P, n=4, E=8, Mw=16, m=5e-5, seed=0, jax_trees=False):
        pops = tuple([0] * (n // 2) + [1] * (n - n // 2))
        self.demo = _model(TDemography, E=E, m=m, sample_pops=pops)
        self.epochs = ttree.epochs_from_demography(self.demo, "cpu")
        g = torch.Generator().manual_seed(seed)
        if jax_trees:
            jd = _model(JDemography, E=E, m=m, sample_pops=pops)
            tr = jtree.make_initial_trees(
                jax.random.PRNGKey(seed), jtree.epochs_from_demography(jd), P,
                jnp.asarray(jd.sample_pops), max_mig=Mw)
            self.trees = trees_from_numpy(
                jax.tree_util.tree_map(np.asarray, tr)._asdict(), "cpu", Mw)
        else:
            self.trees = ttree.make_initial_trees(g, self.epochs, P, pops,
                                                  max_mig=Mw)
        self.P, self.n, self.E, self.Mw = P, n, E, Mw
        self.g = g
        self.K = tmig.stats_offsets(E, 2)["width"]
        self.tables = tmig.migration_tables(self.epochs)
        self.key = torch.tensor([1234, 5678], dtype=torch.int32)

    def state(self, nr):
        t = self.trees
        return dict(time=t.time.clone(), parent=t.parent.clone(),
                    child0=t.child0.clone(), child1=t.child1.clone(),
                    pop=t.pop.clone(), mig_time=t.mig_time.clone(),
                    mig_dest=t.mig_dest.clone(), next_rec=nr.clone(),
                    log_w=torch.zeros(self.P),
                    fifo=torch.zeros((self.P, 2, self.K)),
                    tl=torch.zeros(self.P),
                    diag=torch.zeros(2, dtype=torch.float64))

    def run(self, u, st, L, biased=None, local=None, guide=None, ls=1):
        mp = tmig.MigrationPass(st["pop"], st["mig_time"], st["mig_dest"],
                                st["diag"], self.key, *self.tables)
        segment_pass_plain(
            u, ls, st["time"], st["parent"], st["child0"], st["child1"],
            st["next_rec"], st["log_w"], st["fifo"], torch.ones(self.K),
            st["tl"], L, MU, RHO, self.epochs.start, self.epochs.inv2ne,
            torch.ones(self.n, dtype=torch.bool), biased, mp, guide=guide,
            local=local)
        return st


def _ring(P, D=32):
    return dict(log_pilot=torch.zeros(P), df_pos=torch.full((P, D), INF),
                df_logf=torch.zeros((P, D)), df_delta=torch.zeros((P, D)),
                df_k=torch.zeros((P, D), dtype=torch.int32))


def _biased(ring, E, heights, strengths, delay="recomb"):
    return BiasedPass(ring["log_pilot"], ring["df_pos"], ring["df_logf"],
                      ring["df_delta"], ring["df_k"],
                      torch.tensor(heights, dtype=torch.float32),
                      torch.tensor(strengths, dtype=torch.float32),
                      torch.linspace(3000.0, 30000.0, E), FRONT, delay)


# ---------------------------------------------------------------------------
# the pass's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 8])
def test_unit_strengths_give_the_unbiased_pass(n):
    """One section of strength 1 is the uniform point bit for bit, so a
    chain of trips is the migration pass without the proposal's: trees,
    buffers, weights and statistics equal, no factor pushed."""
    c = _Pass(64, n=n, seed=n)
    L = 50000.0
    nr = torch.rand(64, generator=c.g) * 0.1 * L
    u = torch.rand((64, 64, 4), generator=c.g)
    plain = c.run(u, c.state(nr), L)
    ring = _ring(64)
    got = c.run(u, c.state(nr), L,
                biased=_biased(ring, c.E, (0.0, INF), (1.0,)))
    for k in plain:
        assert torch.equal(got[k], plain[k]), k
    assert torch.equal(ring["df_pos"], torch.full((64, 32), INF))
    assert int(plain["fifo"][:, 0, tmig.stats_offsets(
        c.E, 2)["recomb_cnt"]:].sum()) > 64  # chains of trips ran


@pytest.mark.parametrize("guided", [False, True])
def test_first_trip_point_matches_jax(guided):
    """(c, h_r, log_iw, strength, log_iw_bias) of the migration pass's
    point against JAX's ``_sample_recomb_point_biased`` on JAX's
    structured trees with JAX's uniforms, with and without the guide's
    rates (themselves equal to JAX's)."""
    P = 256
    c = _Pass(P, seed=3, jax_trees=True, Mw=16)
    t = c.trees
    heights = np.array([0.0, 300.0, 2000.0, INF], np.float32)
    strengths = np.array([3.0, 4.0, 1.0], np.float32)
    br_t = br_j = None
    if guided:
        rates = np.random.default_rng(1).uniform(0.2, 3.0, (P, 4)).astype(
            np.float32)
        br_j = jax.vmap(jtr.guide_branch_rates)(
            jnp.asarray(t.time.numpy()), jnp.asarray(t.parent.numpy()),
            jnp.asarray(t.child0.numpy()), jnp.asarray(t.child1.numpy()),
            jnp.asarray(rates))
        br_t = guide_branch_rates(t.time, t.parent, t.child0, t.child1,
                                  torch.from_numpy(rates))
        np.testing.assert_array_equal(br_t.numpy(), np.asarray(br_j))
    keys = jax.random.split(jax.random.PRNGKey(7 + guided), P)
    ref = jax.vmap(lambda k, tt, p, b: jtr._sample_recomb_point_biased(
        k, tt, p, jnp.asarray(heights), jnp.asarray(strengths), b),
        in_axes=(0, 0, 0, None if br_j is None else 0))(
        keys, jnp.asarray(t.time.numpy()), jnp.asarray(t.parent.numpy()),
        br_j)
    u = jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=1e-7, maxval=1.0 - 1e-7))(keys)
    got = tmig.biased_point_seq(torch.from_numpy(np.array(u)), t.time,
                                t.parent, torch.from_numpy(heights),
                                torch.from_numpy(strengths), br_t)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for k in (1, 2, 4):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5)


def _first_trip(c, u, nr, heights, strengths, local=False):
    """(c, h_r, log_iw, strength, log_iw_bias) of the first trip's point
    and its walk's (t_c, ev_t), recomputed outside the pass on the same
    inputs."""
    t = c.trees
    uu = u[0].clamp(1e-7, 1.0 - 1e-7)
    if local:
        cc, h_r = tmig.uniform_point(uu[:, 0], t.time, t.parent)
        pt = None
    else:
        pt = tmig.biased_point_seq(uu[:, 0], t.time, t.parent,
                                   torch.tensor(heights, dtype=torch.float32),
                                   torch.tensor(strengths,
                                                dtype=torch.float32))
        cc, h_r = pt[0], pt[1]
    mp = tmig.MigrationPass(t.pop, t.mig_time, t.mig_dest,
                            torch.zeros(2, dtype=torch.float64), c.key,
                            *c.tables)
    out = tmig.walk_mig(mp, 0, t.time, t.parent, cc, h_r, nr < 1e9,
                        c.epochs.start, torch.zeros((c.P, c.K)), c.E, 2)
    return cc, h_r, pt, out[0], out[3]


def test_delay_migr_pushes_jax_factor(monkeypatch):
    """Under ``-delay_migr`` each trip's delayed factor is JAX's: the delay
    height min(t_c, first hop), its epoch by ``_epoch_index``, the factor
    by ``_push_delayed``; some first hops lie below their coalescence and
    there the factor differs from the one keyed by the coalescence."""
    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    P = 512
    heights = (0.0, 8000.0, INF)  # most delay heights in the biased one
    c = _Pass(P, seed=5, m=5e-4)
    nr = torch.full((P,), 10.0)
    u = torch.rand((1, P, 4), generator=c.g)
    rings = {}
    for delay in ("migr", "coal"):
        # a segment that ends before any factor is due: none is drained
        rings[delay] = _ring(P)
        c.run(u, c.state(nr), 100.0,
              biased=_biased(rings[delay], c.E, heights, STRENGTHS, delay))
    cc, h_r, pt, t_c, ev_t = _first_trip(c, u, nr, heights, STRENGTHS)
    log_iw = pt[2].numpy()
    first = ev_t[:, 0].numpy()
    d_h = np.minimum(t_c.numpy(), first)
    below = first < t_c.numpy()
    assert below.sum() > 20, below.sum()
    e = np.asarray(jtr._epoch_index(jnp.asarray(c.epochs.start.numpy()),
                                    jnp.asarray(d_h)))
    delays = np.linspace(3000.0, 30000.0, c.E).astype(np.float32)
    strength_h = np.asarray(STRENGTHS, np.float32)[
        np.clip(np.searchsorted(np.asarray(heights, np.float32), d_h,
                                side="right") - 1, 0, 1)]
    late = np.where(np.abs(strength_h - 1.0) < 1e-6, 0.0, log_iw)
    empty = _ring(P)
    ref = jsmc._push_delayed(
        jnp.asarray(empty["df_pos"].numpy()),
        jnp.asarray(empty["df_logf"].numpy()),
        jnp.asarray(empty["df_delta"].numpy()),
        jnp.asarray(empty["df_k"].numpy()), jnp.asarray(np.abs(late) > 1e-9),
        jnp.asarray(np.float32(FRONT) + nr.numpy()),
        jnp.asarray(delays[e]), jnp.asarray(late, jnp.float32), 3)
    got = rings["migr"]
    for k, r in zip(("df_pos", "df_logf", "df_delta"), ref[:3]):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), rtol=1e-6)
    np.testing.assert_array_equal(got["df_k"].numpy(), np.asarray(ref[3]))
    pushed = got["df_k"][:, 0] > 0
    assert int(pushed.sum()) > 100
    # where the first hop is below the coalescence the key differs
    moved = (rings["coal"]["df_pos"][:, 0] != got["df_pos"][:, 0]).numpy()
    assert (moved & below).sum() > 0 and not (moved & ~below).any()


def test_local_ring_pushes_jax_events(monkeypatch):
    """Each event the local migration pass pushes is JAX's
    ``_push_local_event`` of the trip's position, due position (a lag of
    h_r's epoch later), height and the leaves below c in the tree before
    the trip, into a ring 30% in use (its first 16 rows full: dropped)."""
    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    P, R = 128, 32
    c = _Pass(P, seed=9)
    g = c.g
    used = torch.rand((P, R), generator=g) < 0.3
    used[:16] = True
    pos0 = FRONT - 2e4 * torch.rand((P, R), generator=g)
    ring = dict(lr_pos=torch.where(used, pos0, INF),
                lr_due=torch.where(used, pos0 + 3e4, INF),
                lr_time=torch.where(used, 1e3, 0.0),
                lr_desc=torch.where(used, 3, 0).to(torch.int64),
                lr_dropped=torch.zeros((), dtype=torch.int32))
    start = {k: v.clone() for k, v in ring.items()}
    lags = torch.linspace(2000.0, 40000.0, c.E)
    nr = torch.full((P,), 10.0)
    u = torch.rand((1, P, 4), generator=g)
    c.run(u, c.state(nr), 20000.0,
          local=LocalPass(*ring.values(), lags, torch.zeros(P), FRONT))
    cc, h_r, _, _, _ = _first_trip(c, u, nr, None, None, local=True)
    desc = ttree.descendant_bitmask(c.trees.parent)
    desc_c = desc.gather(1, cc.long()[:, None])[:, 0].numpy()
    e = np.asarray(jtr._epoch_index(jnp.asarray(c.epochs.start.numpy()),
                                    jnp.asarray(h_r.numpy())))
    pos = np.float32(FRONT) + nr.numpy()
    ref = jsmc._push_local_event(
        (jnp.asarray(start["lr_pos"].numpy()),
         jnp.asarray(start["lr_due"].numpy()),
         jnp.asarray(start["lr_time"].numpy()),
         jnp.asarray(start["lr_desc"].numpy().astype(np.uint32)[..., None]),
         jnp.int32(0)),
        jnp.ones(P, bool), jnp.asarray(pos), jnp.asarray(pos + lags.numpy()[e]),
        jnp.asarray(h_r.numpy()),
        jnp.asarray(desc_c.astype(np.uint32)[:, None]))
    for k, r in zip(("lr_pos", "lr_due", "lr_time"), ref[:3]):
        np.testing.assert_allclose(ring[k].numpy(), np.asarray(r), rtol=1e-6)
    np.testing.assert_array_equal(ring["lr_desc"].numpy(),
                                  np.asarray(ref[3])[..., 0].astype(np.int64))
    assert int(ring["lr_dropped"]) == int(ref[4]) == 16
    assert int((ring["lr_pos"] != start["lr_pos"]).sum()) == P - 16


def test_no_data_posterior_equals_prior_under_bias():
    """All sites missing under the production proposal: the weights hold
    the importance weights alone, and the statistics they weigh are the
    proposal's corrected to the prior: pooled Ne and migration rate within
    15% of the model."""
    td = _model(TDemography, E=1, m=5e-5)
    n_seg = 16
    seg = SegData(
        positions=1 + np.arange(n_seg) * 12500,
        lengths=np.full(n_seg, 12500), states=np.zeros(n_seg, np.int8),
        alleles=np.full((n_seg, 4), -1, np.int8), phased=np.ones(4, bool))
    cfg = tem.EMConfig(num_particles=256, lag=20000.0, device="cpu",
                       bias_heights=(2000.0,), bias_strengths=(4.0, 1.0),
                       delay_type="migr")
    stats, _, logl, diag = tem.run_chunk(td, seg, cfg, seed=5)
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert ne_hat == pytest.approx(NE, rel=0.15)
    m_hat = float(stats.mig_cnt.sum() / stats.mig_opp.sum())
    assert m_hat == pytest.approx(5e-5, rel=0.15)
    assert diag["walks_capped"] == 0


@pytest.mark.parametrize("vb", [False, True])
@pytest.mark.parametrize("biased,guided,local", [
    (True, False, False), (True, True, False), (False, False, True),
    (True, False, True), (True, True, True)])
def test_launch_args_name_each_proposal_variant(biased, guided, local, vb):
    """What ``segment_pass`` hands the library for each proposal variant of
    the migration pass (no launch): every tensor checked, the variant's
    launch count by its own name, ``-delay_migr`` as the migration pass's
    own delay code (the coalescence's without migration)."""
    from smcsmc_tpu_torch.kernels import bias as tbias
    from smcsmc_tpu_torch.kernels import guide as tguide
    from smcsmc_tpu_torch.kernels import trip as ttrip

    P = 6
    c = _Pass(P, seed=1)
    st = c.state(torch.zeros(P))
    ring = _ring(P)
    b = (_biased(ring, c.E, HEIGHTS, STRENGTHS, "migr") if biased or guided
         else None)
    g = (tguide.guide_tables(np.full(8, RHO), np.ones((8, 4)), RHO, 100.0,
                             "cpu") if guided else None)
    lp = (LocalPass(torch.full((P, 32), INF), torch.full((P, 32), INF),
                    torch.zeros((P, 32)), torch.zeros((P, 32),
                                                      dtype=torch.int64),
                    torch.zeros((), dtype=torch.int32),
                    torch.linspace(2000.0, 40000.0, c.E), torch.zeros(P),
                    FRONT) if local else None)
    tables = ((torch.zeros((c.E, 2)), torch.zeros((c.E, 2, 2))) if vb
              else None)
    mp = tmig.MigrationPass(st["pop"], st["mig_time"], st["mig_dest"],
                            st["diag"], c.key, *c.tables)
    name, args = ttrip.segment_pass_launch_args(
        torch.zeros((1, P, 4)), 1, st["time"], st["parent"], st["child0"],
        st["child1"], st["next_rec"], st["log_w"], st["fifo"],
        torch.ones(c.K), st["tl"], 100.0, MU, RHO, c.epochs.start,
        c.epochs.inv2ne, torch.ones(4, dtype=torch.bool), b, mp, tables, g,
        lp)
    assert name == ttrip.launch_count(b is not None, True, vb, guided, local)
    assert name in ttrip.LAUNCH_COUNTS and name.startswith("migration_")
    if b is not None:
        assert args[33] == tbias.MIGR_DELAY == 2  # the delay code
        assert tbias.delay_code("migr", False) == 1


@pytest.mark.cuda
def test_cuda_proposal_variants_match_plain(monkeypatch):
    """On the card each proposal variant's kernel against its plain
    version at P=1001 (``chip_smoke.mig_proposal_one`` on
    ``MIG_PROPOSAL_CASES``): trees and buffers bit for bit, floats within
    tolerance, rings equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from smcsmc_tpu_torch.kernels.trip import segment_pass

    monkeypatch.setattr(cs, "DEVICE", "cuda")
    for case in cs.MIG_PROPOSAL_CASES:
        assert cs.mig_proposal_one(segment_pass, segment_pass_plain, {},
                                   *case, P=1001, caps_P=1001), case


# ---------------------------------------------------------------------------
# whole chunks
# ---------------------------------------------------------------------------


def _small_calibration(monkeypatch):
    """Both packages' survival calibration at 256 genealogies over 200 kb
    in 10 windows."""
    kw = dict(num_particles=256, distance=2e5, num_windows=10)
    monkeypatch.setattr(jcal, "calibrate_survival",
                        functools.partial(jcal.calibrate_survival, **kw))
    monkeypatch.setattr(tcal, "calibrate_survival",
                        functools.partial(tcal.calibrate_survival, **kw))


def _summary(runs, E):
    """Mean LogL, Ne of each population over the interior epochs, pooled
    migration rate."""
    ne = [sum(r[0].coal_opp[1:E - 1, q].sum() for r in runs)
          / (2.0 * sum(r[0].coal_cnt[1:E - 1, q].sum() for r in runs))
          for q in range(2)]
    mig = (sum(r[0].mig_cnt.sum() for r in runs)
           / sum(r[0].mig_opp.sum() for r in runs))
    return np.mean([r[2] for r in runs]), ne, mig


def test_production_proposal_run_chunk_agrees_with_jax(monkeypatch):
    """``-bias_heights 0 0.05 -calibrate_lag 2 -delay_migr`` on bench.py's
    twopop model over 200 kb: LogL mean within 2%, Ne of each population
    (interior epochs pooled) within 30% and the pooled migration rate
    within 50% of JAX's over seeds 1-3."""
    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    _small_calibration(monkeypatch)
    E = 8
    jd, td = _model(JDemography, E=E), _model(TDemography, E=E)
    seg = simulate_seg(jd, seed=13)
    kw = dict(num_particles=64, bias_heights=(2000.0,), calibrate_lag=True,
              delay_type="migr")
    res = {"jax": [], "torch": []}
    for s in (1, 2, 3):
        res["jax"].append(jem.run_chunk(
            jd, seg, jem.EMConfig(block_size=512, **kw), seed=s))
        res["torch"].append(tem.run_chunk(
            td, seg, tem.EMConfig(device="cpu", **kw), seed=s))
    for runs in res.values():
        assert all(np.isfinite(r[2]) and r[2] < 0 for r in runs)
    (lj, nj, mj), (lt, nt, mt) = (_summary(res[k], E) for k in ("jax",
                                                                 "torch"))
    assert abs(lt - lj) <= 0.02 * abs(lj), (lj, lt)
    for q in range(2):
        assert nt[q] == pytest.approx(nj[q], rel=0.3), (nj, nt)
    assert mt == pytest.approx(mj, rel=0.5), (mj, mt)
    assert all(r[3]["num_resamples"] > 0 for r in res["torch"])


def _recomb_rows(path):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines()
    return lines[0].split("\t"), [ln.split("\t") for ln in lines[1:]]


def test_alpha_loop_matches_jax(monkeypatch, tmp_path):
    """The guide loop (``-alpha 0.5 -EM 1``) on bench.py's twopop model
    over 200 kb: iteration 0's ``.recomb.gz`` has JAX's columns and
    windows (the same loci and sizes), iteration 1 sweeps on the smoothed
    guide, and its LogL is within 2% of JAX's."""
    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    jd, td = _model(JDemography), _model(TDemography)
    seg = simulate_seg(jd, seed=13)
    out = {}
    for side, em, cfg in (
            ("jax", jem, jem.EMConfig(num_particles=64, block_size=512,
                                      em_iters=1, alpha=0.5, seed=3,
                                      outdir=str(tmp_path / "jax"))),
            ("torch", tem, tem.EMConfig(num_particles=64, em_iters=1,
                                        alpha=0.5, seed=3, device="cpu",
                                        outdir=str(tmp_path / "torch")))):
        res = em.run_em(td if side == "torch" else jd, seg, cfg)
        out[side] = (res.log_likelihoods, _recomb_rows(
            tmp_path / side / "emiter0" / "chunk0.recomb.gz"))
        assert os.path.exists(tmp_path / side / "emiter1"
                               / "chunk0.recomb_guide.gz")
    (lj, (hj, rj)), (lt, (ht, rt)) = out["jax"], out["torch"]
    assert ht == hj
    assert len(rt) == len(rj) > 0
    assert [r[:2] for r in rt] == [r[:2] for r in rj]
    assert all(np.isfinite(lt)) and len(lt) == len(lj) == 2
    assert abs(lt[1] - lj[1]) <= 0.02 * abs(lj[1]), (lj, lt)


# ---------------------------------------------------------------------------
# the structured state, the calibration
# ---------------------------------------------------------------------------


def test_structured_state_carries_buffers_and_both_rings(tmp_path):
    """A structured state under bias with local recording:
    ``gather_particles`` takes each particle's trees, buffers, delayed
    factors and pending local events from its ancestor; ``save_state``
    and ``load_state`` give every field back bit for bit; ``convert`` reads
    JAX's such state with all three."""
    P = 16
    td = _model(TDemography)
    ep = ttree.epochs_from_demography(td, "cpu")
    cfg = PFConfig(num_particles=P, num_leaves=4, use_bias=True,
                   has_migration=True, max_mig=16, num_windows=5)
    g = torch.Generator().manual_seed(3)
    st = init_state(g, ep, cfg, td.sample_pops, RHO)
    st = st._replace(df_pos=torch.rand(st.df_pos.shape, generator=g),
                     lr_pos=torch.rand(st.lr_pos.shape, generator=g),
                     lr_desc=torch.randint(0, 15, st.lr_desc.shape,
                                           generator=g))
    idx = torch.randint(0, P, (P,), generator=g)
    got = gather_particles(st, idx)
    for k in ("mig_time", "mig_dest", "pop", "time"):
        assert torch.equal(getattr(got.trees, k),
                           getattr(st.trees, k)[idx]), k
    for k in ("df_pos", "df_logf", "df_delta", "df_k", "lr_pos", "lr_due",
              "lr_time", "lr_desc", "next_rec", "fifo"):
        assert torch.equal(getattr(got, k), getattr(st, k)[idx]), k
    path = str(tmp_path / "ckpt")
    save_state(path, got, g)
    back, _ = load_state(path, torch.Generator(), "cpu")
    for k in got._fields:
        a, b = getattr(got, k), getattr(back, k)
        if k == "trees":
            for x, y in zip(a, b):
                assert (x is None and y is None) or torch.equal(x, y)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), k
    jd = _model(JDemography)
    jcfg = jsmc.PFConfig(num_particles=P, num_leaves=4, use_bias=True,
                         has_migration=True, max_mig=16, num_windows=5)
    js = jsmc.init_state(jax.random.PRNGKey(2),
                         jtree.epochs_from_demography(jd), jcfg,
                         jd.sample_pops, RHO)
    conv = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu",
                            16)
    assert conv.trees.mig_time.shape == (P, 7, 16)
    np.testing.assert_array_equal(conv.trees.mig_time.numpy(),
                                  np.asarray(js.trees.mig_time))
    assert conv.df_pos.shape == tuple(js.df_pos.shape)
    assert conv.lr_pos.shape == tuple(js.lr_pos.shape)


@pytest.mark.parametrize("seed", [0])
def test_structured_survival_medians_match_jax(monkeypatch, seed):
    """With two populations and migration the genealogies advance through
    the migration pass (one trip per launch): each epoch's median within
    one bin of JAX's (``has_migration``; at 1024 genealogies seeds 0-2 of
    both packages put the youngest epoch within one bin and the others
    in the same bin)."""
    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    change = (0.0, 2000.0, 8000.0, 30000.0)
    E = len(change)
    mig = np.zeros((E, 2, 2))
    mig[:, 0, 1] = mig[:, 1, 0] = 5e-5
    kw = dict(change_times=np.asarray(change),
              pop_sizes=np.full((E, 2), NE), mig_rates=mig,
              sample_pops=np.array([0, 0, 1, 1], np.int32),
              mutation_rate=MU, recombination_rate=RHO, sequence_length=2e5)
    jd, td = JDemography(**kw), TDemography(**kw)
    cal = dict(num_particles=1024, distance=2e5, num_windows=10)
    ref = jcal.calibrate_survival(jax.random.PRNGKey(seed),
                                  jtree.epochs_from_demography(jd),
                                  jd.sample_pops, RHO, has_migration=True,
                                  **cal)
    from smcsmc_tpu_torch.kernels import trip as trip_mod

    before = trip_mod.trip.launches
    got = tcal.calibrate_survival(torch.Generator().manual_seed(seed),
                                  ttree.epochs_from_demography(td, "cpu"),
                                  td.sample_pops, RHO, **cal)
    assert trip_mod.trip.launches == before  # no trip: the migration pass
    edges = np.logspace(2, np.log10(2e6), 63)
    bins = np.searchsorted(edges, got), np.searchsorted(edges, ref)
    assert np.all(np.abs(bins[0] - bins[1]) <= 1), bins
    assert np.all(np.diff(got) < 0), got
