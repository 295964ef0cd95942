"""The port's recombination guide (``-guide`` and the guide loop of
``-alpha``) against the JAX package, on the CPU.

- ``guide_branch_rates``: equal to JAX's exactly (means of two and maxima),
  at n = 2, 4, 8, 16 and 64, with tied internal node times.
- The guided ``biased_point`` against JAX's ``_sample_recomb_point_biased``
  with JAX's uniform from the same key: ``c`` equal; ``h_r``, ``log_iw``
  and ``log_iw_bias`` within rtol 1e-5 (the running sums of the weighted
  segments are summed in another order).
- ``cum_mass`` equal to JAX's bit for bit (``guide.xla_cumsum`` runs the
  order of ``jnp.cumsum`` on the CPU); ``mass``, ``inv_mass``, ``draw_gap``
  and ``span_log_iw`` against JAX's own closures of ``make_segment_step``,
  on a guide that is not constant (random rates over 500 windows), at
  positions next to window edges and up to 2e6 bp: positions and masses
  within a few ulp of their magnitude (rtol 1e-6), the survival weight
  within ``rho tl`` times four ulp of the positions (its ``dm - dx``
  cancels there).
- One step with a chain of trips against JAX's XLA step with
  ``use_guide`` and ``num_windows`` > 0: (guide, bias), (guide, no bias),
  (local, plain) and (guide, local, bias, VB).
- ``run_chunk`` on a guide file that is not constant against JAX's
  (statistical, three seeds, the bands of test_torch_bias.py), and the
  guide loop of ``run_em`` (JAX's TestGuideLoop on the port).
"""

import functools
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu import em as jem
from smcsmc_tpu import smc as jsmc
from smcsmc_tpu.demography import Demography as JDemography
from smcsmc_tpu.kernels import transition as jtr
from smcsmc_tpu.kernels.tree import epochs_from_demography as j_epochs
from smcsmc_tpu.simulate import simulate_seg as j_simulate
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.demography import Demography as TDemography
from smcsmc_tpu_torch.kernels import guide as tguide
from smcsmc_tpu_torch.kernels.bias import biased_point, guide_branch_rates
from smcsmc_tpu_torch.kernels.tree import epochs_from_demography as t_epochs
from smcsmc_tpu_torch.simulate import simulate_seg

torch.set_num_threads(1)

MU, RHO = 1e-8, 1e-9


def _demo(cls, E=3, n=4, L=2e5):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]))
    return cls(change_times=change, pop_sizes=np.full((E, 1), 10000.0),
               mig_rates=np.zeros((E, 1, 1)),
               sample_pops=np.zeros(n, np.int32), mutation_rate=MU,
               recombination_rate=RHO, sequence_length=L)


@functools.lru_cache(maxsize=None)
def _jax_trees(n, P, seed):
    st = jsmc.init_state(jax.random.PRNGKey(seed), j_epochs(_demo(JDemography,
                                                                   n=n)),
                         jsmc.PFConfig(num_particles=P, num_leaves=n),
                         np.zeros(n, np.int32), RHO)
    return jax.tree_util.tree_map(np.asarray, st.trees)


def _guide_rates(W, n, seed):
    rng = np.random.default_rng(seed)
    g_rate = (RHO * rng.uniform(0.05, 4.0, W)).astype(np.float32)
    g_leaf = rng.uniform(0.1, 3.0, (W, n)).astype(np.float32)
    return g_rate, g_leaf


# ---------------------------------------------------------------------------
# branch rates and the guided point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8, 16, 64])
def test_guide_branch_rates_equal_jax(n):
    P = 96
    tr = _jax_trees(n, P, 10 + n)
    time = tr.time.copy()
    if n > 2:
        # ties among internal times: the stable order decides which node
        # is merged first (and which is "the root")
        time[::2, n + 1] = time[::2, n]
        time[1::4, -1] = time[1::4, n]
    rates = np.random.default_rng(n).uniform(0.1, 3.0, (P, n)).astype(
        np.float32)
    ref = jax.vmap(jtr.guide_branch_rates)(
        jnp.asarray(time), tr.parent, tr.child0, tr.child1,
        jnp.asarray(rates))
    got = guide_branch_rates(*(torch.from_numpy(np.array(x)) for x in (
        time, tr.parent, tr.child0, tr.child1, rates)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("heights,strengths", [
    ((), (1.0,)),
    ((2000.0,), (3.0, 1.0)),
    ((300.0, 3000.0, 9000.0), (1.0, 4.0, 1.0, 2.0)),
])
def test_guided_biased_point_matches_jax(heights, strengths):
    P, n = 256, 6
    tr = _jax_trees(n, P, 3)
    bh = np.concatenate([[0.0], heights, [3e38]]).astype(np.float32)
    bs = np.asarray(strengths, np.float32)
    rates = np.random.default_rng(len(heights)).uniform(
        0.2, 3.0, (P, n)).astype(np.float32)
    br = jax.vmap(jtr.guide_branch_rates)(tr.time, tr.parent, tr.child0,
                                          tr.child1, jnp.asarray(rates))
    keys = jax.random.split(jax.random.PRNGKey(len(heights) + 5), P)
    c, h_r, log_iw, s, log_iw_bias = jax.vmap(
        lambda k, t, p, b: jtr._sample_recomb_point_biased(
            k, t, p, jnp.asarray(bh), jnp.asarray(bs), b))(
        keys, tr.time, tr.parent, br)
    u = jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=1e-7, maxval=1.0 - 1e-7))(keys)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got = biased_point(t(u), t(tr.time), t(tr.parent), t(bh), t(bs),
                       t(np.asarray(br)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(c))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(s))
    N = tr.time.shape[1]
    ulps = 1e-7 * N * float(np.max(tr.time)) * max(strengths) * 3.0
    np.testing.assert_allclose(got[1].numpy(), np.asarray(h_r), rtol=1e-5,
                               atol=ulps)
    for k, ref in ((2, log_iw), (4, log_iw_bias)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    # the guide's rates move the weight: the whole weight is not its
    # height-bias part
    assert np.abs(np.asarray(log_iw) - np.asarray(log_iw_bias)).max() > 0.05


# ---------------------------------------------------------------------------
# the guide's mass functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [500, 20000])
def test_cum_mass_is_jax_cumsum_bit_for_bit(W):
    g_rate, _ = _guide_rates(W, 4, W)
    g_rel = g_rate / np.float32(RHO)
    ref = np.asarray(jnp.concatenate([jnp.zeros(1), jnp.cumsum(
        jnp.asarray(g_rel) * 100.0)]))
    got = tguide.guide_tables(g_rate, np.ones((W, 4), np.float32), RHO,
                              100.0, "cpu")
    np.testing.assert_array_equal(got.g_rel.numpy(), g_rel)
    np.testing.assert_array_equal(got.cum_mass.numpy(), ref)


def _jax_closures(g_rate, g_leaf, P):
    """JAX's ``mass``, ``inv_mass``, ``draw_gap`` and ``span_log_iw``:
    the closures of its guided ``make_segment_step``."""
    E = 3
    demo = _demo(JDemography, E=E)
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=4, use_guide=True)
    step = jsmc.make_segment_step(
        cfg, j_epochs(demo), MU, jnp.float32(RHO), jnp.ones(E) * 1e4,
        delays=jnp.ones(E), guide=(jnp.asarray(g_rate), jnp.asarray(g_leaf)))
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    span_log_iw, draw_gap = cells["span_log_iw"], cells["draw_gap"]
    inner = dict(zip(draw_gap.__code__.co_freevars,
                     (c.cell_contents for c in draw_gap.__closure__)))
    return inner["mass"], inner["inv_mass"], draw_gap, span_log_iw


def test_mass_functions_match_jax():
    P, W, ws = 512, 500, 100.0
    g_rate, g_leaf = _guide_rates(W, 4, 1)
    mass, inv_mass, draw_gap, span_log_iw = _jax_closures(g_rate, g_leaf, P)
    g = tguide.guide_tables(g_rate, g_leaf, RHO, ws, "cpu")
    rng = np.random.default_rng(2)
    # next to window edges (a few ulp either side), inside windows, beyond
    # the last window and out to 2e6 bp
    edges = rng.integers(0, W + 1, P // 2) * ws
    x = np.concatenate([
        np.nextafter(edges[: P // 8].astype(np.float32), np.float32(-1)),
        np.nextafter(edges[P // 8: P // 4].astype(np.float32),
                     np.float32(3e38)),
        rng.uniform(0.0, W * ws, P // 4),
        rng.uniform(W * ws, 2e6, P // 4),
        np.full(P - P // 4 * 3, 2e6)]).astype(np.float32)
    x = np.abs(x)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    m_ref = np.asarray(mass(jnp.asarray(x)))
    m_got = tguide.mass(g, t(x)).numpy()
    np.testing.assert_allclose(m_got, m_ref, rtol=1e-6)
    np.testing.assert_allclose(tguide.inv_mass(g, t(m_ref)).numpy(),
                               np.asarray(inv_mass(jnp.asarray(m_ref))),
                               rtol=1e-6, atol=1e-3)
    # a gap from each position, on JAX's exponential of the same key
    tl = rng.uniform(2e3, 8e4, P).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref_gap = np.asarray(draw_gap(key, jnp.asarray(tl), jnp.asarray(x)))
    expo = np.asarray(jax.random.exponential(key, (P,)))
    got_gap = tguide.draw_gap(g, t(expo), RHO, t(tl), t(x)).numpy()
    np.testing.assert_allclose(got_gap + x, ref_gap + x, rtol=1e-6)
    # survival weights over spans that start and end anywhere above
    x1 = (x + rng.uniform(0.0, 3e4, P)).astype(np.float32)
    ref_iw = np.asarray(span_log_iw(jnp.asarray(tl), jnp.asarray(x),
                                    jnp.asarray(x1)))
    got_iw = tguide.span_log_iw(g, RHO, t(tl), t(x), t(x1)).numpy()
    ulp = np.spacing(np.maximum(np.abs(x1), 1.0).astype(np.float32))
    np.testing.assert_allclose(got_iw, ref_iw, rtol=1e-5,
                               atol=float((RHO * tl * 4 * ulp).max()))
    assert np.abs(ref_iw).max() > 1e-3  # the guide is not the target


def test_guided_init_gap_matches_jax():
    """``init_state``'s first gap in guide mass (smc.py:294-303)."""
    from smcsmc_tpu_torch import smc as tsmc

    P, W = 256, 500
    g_rate, g_leaf = _guide_rates(W, 4, 7)
    g = tguide.guide_tables(g_rate, g_leaf, RHO, 100.0, "cpu")
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=4, use_guide=True)
    st = jsmc.init_state(jax.random.PRNGKey(1), j_epochs(_demo(JDemography)),
                         cfg, np.zeros(4, np.int32), RHO,
                         guide=(g_rate, g_leaf))
    plain = jsmc.init_state(jax.random.PRNGKey(1),
                            j_epochs(_demo(JDemography)),
                            jsmc.PFConfig(num_particles=P, num_leaves=4),
                            np.zeros(4, np.int32), RHO)
    got = tguide.inv_mass(g, torch.from_numpy(np.array(plain.next_rec)))
    np.testing.assert_allclose(got.numpy(), np.asarray(st.next_rec),
                               rtol=1e-6)
    # and the port's own init_state draws it the same way
    tcfg = tsmc.PFConfig(num_particles=P, num_leaves=4, use_guide=True)
    gen = torch.Generator().manual_seed(0)
    a = tsmc.init_state(gen, t_epochs(_demo(TDemography), "cpu"), tcfg,
                        np.zeros(4, np.int32), RHO, guide=g)
    gen = torch.Generator().manual_seed(0)
    b = tsmc.init_state(gen, t_epochs(_demo(TDemography), "cpu"),
                        tsmc.PFConfig(num_particles=P, num_leaves=4),
                        np.zeros(4, np.int32), RHO)
    torch.testing.assert_close(a.next_rec, tguide.inv_mass(g, b.next_rec))
    assert a.df_pos.shape == (P, tcfg.delay_slots)
    assert a.log_pilot is not a.log_w


# ---------------------------------------------------------------------------
# run_chunk and the guide loop
# ---------------------------------------------------------------------------


def _write_guide(path, L, n, seed, rows=40):
    """A guide file that is not constant: ``rows`` rows of random rates
    around rho and random leaf rates."""
    rng = np.random.default_rng(seed)
    size = int(np.ceil(L / rows))
    with gzip.open(path, "wt") as fh:
        fh.write("locus\tsize\trecomb_rate"
                 + "".join(f"\t{i + 1}" for i in range(n)) + "\n")
        for r in range(rows):
            leaf = rng.uniform(0.3, 2.0, n)
            fh.write(f"{1 + r * size}\t{size}\t{RHO * rng.uniform(0.3, 3):.4e}"
                     + "".join(f"\t{v:.3f}" for v in leaf) + "\n")


def test_guided_run_chunk_agrees_with_jax(tmp_path):
    E = 8
    jd, td = _demo(JDemography, E=E), _demo(TDemography, E=E)
    seg = simulate_seg(td, seed=5)
    jseg = j_simulate(jd, seed=5)
    gpath = str(tmp_path / "g.recomb_guide.gz")
    _write_guide(gpath, 2e5, 4, 9)
    kw = dict(num_particles=64, bias_heights=(1000.0,),
              bias_strengths=(3.0, 1.0))
    res = {"jax": [], "torch": []}
    for s in (1, 2, 3):
        res["jax"].append(jem.run_chunk(
            jd, jseg, jem.EMConfig(block_size=512, **kw), seed=s,
            guide_file=gpath))
        res["torch"].append(tem.run_chunk(
            td, seg, tem.EMConfig(device="cpu", **kw), seed=s,
            guide_file=gpath))
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


def test_alpha_produces_and_consumes_guide(tmp_path):
    """JAX's TestGuideLoop on the port: -alpha 0.7 writes iteration 0's
    .recomb.gz, smooths it into iteration 1's guide and sweeps guided;
    the LogLs are finite and Ne within 50% (P=100 over 500 kb)."""
    truth = 10000.0
    demo = _demo(TDemography, E=1, n=4, L=5e5)
    seg = simulate_seg(demo, seed=51)
    cfg = tem.EMConfig(num_particles=100, em_iters=1, alpha=0.7,
                       outdir=str(tmp_path), seed=3, device="cpu")
    seen = []
    real = tem.run_chunk

    def spy(*args, guide_file=None, **kw):
        seen.append(guide_file)
        return real(*args, guide_file=guide_file, **kw)

    tem.run_chunk, saved = spy, tem.run_chunk
    try:
        result = tem.run_em(demo, seg, cfg)
    finally:
        tem.run_chunk = saved
    assert os.path.exists(tmp_path / "emiter0" / "chunk0.recomb.gz")
    guide = tmp_path / "emiter1" / "chunk0.recomb_guide.gz"
    assert os.path.exists(guide)
    assert seen == [None, str(guide)]
    assert all(np.isfinite(result.log_likelihoods))
    stats = result.stats[-1]
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert ne_hat == pytest.approx(truth, rel=0.5)
    with gzip.open(tmp_path / "emiter1" / "chunk0.recomb.gz", "rt") as fh:
        rows = fh.read().splitlines()
    assert len(rows) == 1 + int(np.ceil((float(seg.end)
                                         - int(seg.positions[0])) / 100.0))


@pytest.mark.parametrize("extra", [
    dict(),
    dict(bias_heights=(1000.0,), bias_strengths=(3.0, 1.0), vb=True),
    dict(calibrate_lag=True, lag_fraction=1.0, delay_type="coal"),
    dict(apf=2),
], ids=["guide", "bias+vb", "calibrated+coal", "apf"])
def test_guide_runs_with_every_combination(tmp_path, extra):
    """-guide with each option the JAX package takes alongside it, on a
    short sweep: finite LogL, guided launches only."""
    demo = _demo(TDemography, E=3, n=4, L=3e4)
    seg = simulate_seg(demo, seed=2)
    gpath = str(tmp_path / "g.recomb_guide.gz")
    _write_guide(gpath, 3e4, 4, 1, rows=6)
    cfg = tem.EMConfig(num_particles=32, device="cpu", guide_file=gpath,
                       alpha=0.5, apf_trees=2000, **extra)
    stats, _, logl, diag = tem.run_chunk(demo, seg, cfg, seed=4,
                                         guide_file=gpath)
    assert np.isfinite(logl) and logl < 0
    lr = diag["local_recomb"]
    assert lr["leaf_cnt"].shape == (300, 4) and lr["leaf_cnt"].sum() > 0
