"""The port's auxiliary particle filter (``-apf``) against the JAX package.

- The lookahead scan: the port's gcc build of ``csrc/lookahead.c`` against
  JAX's Python oracle ``compute_lookahead_py``, every column exactly, on
  hand-made segments (those of tests/test_apf.py) and on simulated data
  with missing windows and unphased pairs.
- ``lookahead_loglik`` at levels 1-4, n=4 and n=8, with unphased pairs and
  missing data, on the same trees as JAX's: rtol 1e-5 and atol 1e-5 (a
  sum of n + D logs of order 1-10 in f32, in another order).
- The terminal branch quantiles: the reduction exactly on the same trees;
  the trees drawn on the device statistically, each quantile with its own
  tolerance (5 standard deviations of a sample quantile in probability
  units, from the number of trees), the mean tree length within 5 standard
  errors.
- One APF step (the ESS of the effective pilot, the resampling on it and
  the auxiliary reweight) against JAX's step on the same state: ESS rtol
  1e-4, weights rtol 1e-5 and atol 1e-5, ancestors and trees exactly.
- Analogues of tests/test_apf.py::TestAPFNoDataInvariance and
  TestAPFGuidesResampling, at a size that runs in seconds on the CPU, with
  the JAX tests' bands.
- ``-apf`` and ``-vb`` parse as in the JAX command line and run on every
  path of the port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu import calibrate as jcal
from smcsmc_tpu import cli as jcli
from smcsmc_tpu import smc as jsmc
from smcsmc_tpu.demography import Demography as JDemography
from smcsmc_tpu.kernels import lookahead as jla
from smcsmc_tpu.kernels.tree import (
    epochs_from_demography as j_epochs,
    make_initial_trees as j_initial_trees,
    total_branch_length,
)
from smcsmc_tpu.lookahead import compute_lookahead_py
from smcsmc_tpu.segio import SegData as JSegData
from smcsmc_tpu_torch import calibrate as tcal
from smcsmc_tpu_torch import cli as tcli
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch import smc as tsmc
from smcsmc_tpu_torch.convert import (
    segment_from_numpy,
    state_from_numpy,
    state_to_numpy,
    trees_from_numpy,
)
from smcsmc_tpu_torch.demography import Demography as TDemography
from smcsmc_tpu_torch.kernels import lookahead as tla
from smcsmc_tpu_torch.kernels.tree import (
    branch_lengths,
    epochs_from_demography as t_epochs,
)
from smcsmc_tpu_torch.segio import SegData, write_seg
from smcsmc_tpu_torch.simulate import simulate_seg
from smcsmc_tpu_torch.sweep_profile import twopop_data, twopop_flags

torch.set_num_threads(1)

CPU = torch.device("cpu")
MU, RHO = 1e-8, 1e-9
P = 64
LA_FIELDS = ("fsd", "rel_mu", "unphased", "dbl_s1", "dbl_s2", "dbl_first",
             "dbl_last", "dbl_unph1", "dbl_unph2", "split_dist",
             "split_alleles", "split_k")


def _demo(cls, n=4, L=1e6, E=1, ne=10000.0):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]))
    return cls(change_times=change, pop_sizes=np.full((E, 1), ne),
               mig_rates=np.zeros((E, 1, 1)),
               sample_pops=np.zeros(n, np.int32), mutation_rate=MU,
               recombination_rate=RHO, sequence_length=L)


def _seg(rows, n, phased=None):
    """rows: (position, length, alleles) as in tests/test_apf.py."""
    return SegData(
        positions=np.array([r[0] for r in rows], np.int64),
        lengths=np.array([r[1] for r in rows], np.int64),
        states=np.zeros(len(rows), np.int8),
        alleles=np.array([r[2] for r in rows], np.int8),
        phased=np.ones(n, bool) if phased is None else np.asarray(phased))


def _as_jax_seg(seg):
    return JSegData(positions=seg.positions, lengths=seg.lengths,
                    states=seg.states, alleles=seg.alleles,
                    phased=seg.phased)


def _variable(seg, pair=True, missing_every=3):
    """``seg`` with missing windows of leaf 2 (and every leaf in one window
    of four) and, with ``pair``, the heterozygous pair 0/1 unphased, as
    bench.py's feature_apf8 and tests/test_apf.py make them."""
    al = seg.alleles.copy()
    al[(seg.positions // 50_000) % missing_every == 1, 2] = -1
    al[(seg.positions // 100_000) % 4 == 3] = -1
    phased = np.ones(al.shape[1], bool)
    if pair:
        het = (al[:, 0] + al[:, 1] == 1) & (al[:, 0] >= 0)
        al[het, 0] = 2
        al[het, 1] = 2
        phased[:2] = False
    return SegData(positions=seg.positions, lengths=seg.lengths,
                   states=seg.states, alleles=al, phased=phased)


HAND_MADE = {
    "singletons": ([(0, 100, [0, 0, 0, 0]), (100, 200, [1, 0, 0, 0]),
                    (300, 300, [0, 1, 1, 0]), (600, 400, [0, 0, 0, 1])],
                   None),
    "doubleton": ([(0, 100, [0, 0, 0, 0]), (100, 200, [0, 1, 1, 0]),
                   (300, 300, [0, 1, 1, 0]), (600, 400, [0, 0, 0, 0])],
                  None),
    "incompatible": ([(0, 100, [0, 0, 0, 0]), (100, 200, [0, 1, 1, 0]),
                      (300, 300, [0, 1, 0, 1]), (600, 400, [0, 1, 1, 0])],
                     None),
    "phasing-aware": ([(0, 100, [1, 1, 0, 0]), (100, 200, [2, 2, 1, 0]),
                       (300, 300, [1, 1, 0, 0])],
                      [False, False, True, True]),
    "bare het": ([(0, 100, [1, 1, 0, 0]), (100, 200, [2, 2, 0, 0]),
                  (300, 300, [1, 1, 0, 0])], [False, False, True, True]),
    "unphased singleton": ([(0, 100, [0, 0, 0, 0]), (100, 200, [2, 2, 0, 0]),
                            (300, 100, [0, 0, 1, 0])],
                           [False, False, True, True]),
    "split": ([(0, 100, [0] * 6), (100, 200, [1, 1, 1, 0, 0, 0]),
               (300, 100, [0] * 6)], None),
    "missing": ([(0, 100, [0, -1, 0, 0]), (100, 200, [1, -1, 0, 0])], None),
    "long missing": ([(0, 1_500_000, [0, -1, 0, 0]),
                      (1_500_000, 1_500_000, [0, -1, 0, 0]),
                      (3_000_000, 100, [0, 1, 0, 0])], None),
}


def _assert_same_scan(got, ref):
    for f in LA_FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.shape == r.shape and g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize("case", HAND_MADE)
def test_native_scan_equals_the_oracle_on_hand_made_segments(case):
    rows, phased = HAND_MADE[case]
    seg = _seg(rows, len(rows[0][2]), phased)
    _assert_same_scan(tem.compute_lookahead(seg),
                      compute_lookahead_py(_as_jax_seg(seg)))


@pytest.mark.parametrize("n,seed", [(4, 41), (8, 43)])
def test_native_scan_equals_the_oracle_on_variable_data(n, seed):
    demo = _demo(TDemography, n=n, L=5e5)
    seg = _variable(simulate_seg(demo, seed=seed))
    assert (seg.alleles == 2).any() and (seg.alleles == -1).any()
    got = tem.compute_lookahead(seg)
    _assert_same_scan(got, compute_lookahead_py(_as_jax_seg(seg)))
    assert (got.dbl_s1 >= 0).any() and got.unphased.any()
    if n == 8:
        assert (got.split_dist > 0).any()


def test_failed_lookahead_build_raises(monkeypatch, tmp_path):
    """A gcc that fails raises with its output; nothing falls back to the
    Python oracle."""
    from smcsmc_tpu_torch.kernels import _build

    bad = tmp_path / "lookahead.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(_build, "LOOKAHEAD_SOURCE", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="gcc failed"):
        _build.build_lookahead_library()


# ---------------------------------------------------------------------------
# the lookahead log-likelihood on the same trees
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_trees(n, seed):
    epochs = j_epochs(_demo(JDemography, n=n, E=4))
    st = jsmc.init_state(jax.random.PRNGKey(seed), epochs,
                         jsmc.PFConfig(num_particles=P, num_leaves=n),
                         np.zeros(n, np.int32), RHO)
    return jax.tree_util.tree_map(np.asarray, st.trees)


def _quantiles(n, seed):
    """Increasing quantiles per leaf (generations) and JAX's bin widths."""
    rng = np.random.default_rng(seed)
    q = np.sort(rng.uniform(50.0, 40000.0, (n, len(jla.TBLQ_PROBS))), axis=1)
    return (q.astype(np.float32), jla.tblq_bin_widths().astype(np.float32),
            float(rng.uniform(5e4, 2e5)))


@pytest.mark.parametrize("apf", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [4, 8])
def test_lookahead_loglik_matches_jax(n, apf):
    jtrees = _jax_trees(n, 5 + n)
    ttrees = trees_from_numpy(jtrees, CPU)
    tl = branch_lengths(ttrees.time, ttrees.parent).sum(dim=1)
    seg = _variable(simulate_seg(_demo(TDemography, n=n, L=5e5), seed=3 + n))
    la = tem.compute_lookahead(seg)
    cols = tem.lookahead_columns(la, CPU)
    q_len, q_w, etbl = _quantiles(n, n)
    quant = tla.Quantiles(torch.from_numpy(q_len), torch.from_numpy(q_w),
                          etbl, float(np.mean(q_len[:, -1])))
    jt = jax.tree_util.tree_map(jnp.asarray, jtrees)
    # segments with doubletons, unphased singletons, splits and none
    pick = np.unique(np.concatenate([
        np.flatnonzero(la.dbl_s1[:, 0] >= 0)[:3],
        np.flatnonzero(la.unphased.any(axis=1))[:3],
        np.flatnonzero(la.split_dist > 0)[:3],
        np.flatnonzero(la.split_dist < 0)[:2],
        np.flatnonzero((la.fsd < 0).any(axis=1))[:2]]))
    assert len(pick) >= 5
    for s in pick:
        j_seg = tuple(jnp.asarray(getattr(la, f)[s]) for f in LA_FIELDS)
        ref = np.asarray(jla.lookahead_loglik(
            jt, jnp.asarray(tl.numpy()), j_seg, jnp.asarray(q_len),
            jnp.asarray(q_w), etbl, jnp.float32(MU), jnp.float32(RHO), apf))
        got = tla.lookahead_loglik(ttrees, tl, tuple(c[s] for c in cols),
                                   quant, MU, RHO, apf).numpy()
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"segment {s}")


# ---------------------------------------------------------------------------
# terminal branch quantiles
# ---------------------------------------------------------------------------


def test_quantile_reduction_equals_jax_on_the_same_trees():
    """JAX's terminal_branch_quantiles and the port's reduction of the
    trees JAX drew (replayed from the same keys): equal exactly."""
    n, num, batch = 4, 2000, 500
    jd = _demo(JDemography, n=n, E=4)
    ep = j_epochs(jd)
    key = jax.random.PRNGKey(17)
    ref = jcal.terminal_branch_quantiles(key, ep, jd.sample_pops,
                                         num_trees=num, batch=batch)
    pts, tls = [], []
    for _ in range(num // batch):
        key, sub = jax.random.split(key)
        tr = j_initial_trees(sub, ep, batch, jnp.asarray(jd.sample_pops),
                             max_mig=0)
        pts.append(np.asarray(jnp.take_along_axis(
            tr.time, jnp.clip(tr.parent[:, :n], 0, None), axis=1)))
        tls.append(np.asarray(jax.vmap(total_branch_length)(tr.time,
                                                            tr.parent)))
    got = tcal.reduce_terminal_branches(np.concatenate(pts),
                                        np.concatenate(tls))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]


def test_simulated_terminal_branches_match_jax_statistically():
    """The port's trees drawn on the device against JAX's: for each leaf
    and quantile p, the share of the port's leaf parent heights below
    JAX's quantile is p within 5 sd, sd = sqrt(p (1 - p) (1/T + 1/T')) for
    T, T' trees; the mean tree length within 5 standard errors."""
    n, T = 4, 20000
    jd, td = _demo(JDemography, n=n, E=4), _demo(TDemography, n=n, E=4)
    ref_len, _, ref_etbl = jcal.terminal_branch_quantiles(
        jax.random.PRNGKey(3), j_epochs(jd), jd.sample_pops, num_trees=T,
        batch=10000)
    gen = torch.Generator().manual_seed(4)
    pt, tl = tcal.simulate_terminal_branches(
        gen, t_epochs(td, CPU), td.sample_pops, num_trees=T, batch=10000)
    assert pt.shape == (T, n) and tl.shape == (T,)
    for i, p in enumerate(jla.TBLQ_PROBS):
        sd = np.sqrt(p * (1 - p) * 2.0 / T)
        share = (pt < ref_len[:, i][None, :]).mean(axis=0)
        np.testing.assert_allclose(share, p, atol=5 * sd, err_msg=f"p={p}")
    se = tl.std() * np.sqrt(2.0 / T)
    assert abs(tl.mean() - ref_etbl) < 5 * se
    quant = tcal.terminal_branch_quantiles(
        torch.Generator().manual_seed(4), t_epochs(td, CPU), td.sample_pops,
        num_trees=T, batch=10000)
    np.testing.assert_array_equal(
        quant.lengths.numpy(),
        tcal.reduce_terminal_branches(pt, tl)[0])
    assert quant.l_mean == pytest.approx(float(np.mean(
        quant.lengths.numpy()[:, -1])), rel=1e-6)


# ---------------------------------------------------------------------------
# the APF step
# ---------------------------------------------------------------------------


def _jax_state(seed, L, n=4, E=3):
    demo = _demo(JDemography, n=n, E=E)
    epochs = j_epochs(demo)
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=n, apf=2)
    st = jsmc.init_state(jax.random.PRNGKey(seed), epochs, cfg,
                         demo.sample_pops, RHO)
    rng = np.random.default_rng(seed)
    lw = rng.normal(0.0, 1.0, P)
    lw = (lw - np.log(np.exp(lw - lw.max()).sum()) - lw.max()).astype(
        np.float32)
    K = jsmc.stats_width(E, 1)
    st = st._replace(
        log_w=jnp.asarray(lw), log_pilot=jnp.asarray(lw),
        fifo=jnp.asarray(rng.uniform(0, 1, (P, cfg.fifo_slots, K)),
                         jnp.float32),
        front=jnp.float32(40000.0),
        next_rec=jnp.asarray(L + rng.uniform(1.0, 1e4, P), jnp.float32))
    return demo, epochs, cfg, st


@pytest.mark.parametrize("resample", [False, True])
def test_apf_step_matches_jax(resample, monkeypatch):
    """One segment step without trips under -apf 2: the ESS of the
    effective pilot, and with resampling forced the ancestors, the
    auxiliary reweight (w / pilot_eff)[ancestor] / P and the uniform pilot,
    against JAX's step on the same state and resampling uniform."""
    L, dist_mut, n = 800, 3000.0, 4
    demo, epochs, cfg, st = _jax_state(11 + resample, L)
    thr = 1.01 if resample else 0.0
    cfg = dataclasses.replace(cfg, ess_threshold=thr)
    lags = np.array([3000.0, 9000.0, 40000.0], np.float32)
    data = _variable(simulate_seg(_demo(TDemography, n=n, L=5e5), seed=9))
    la = tem.compute_lookahead(data)
    s = int(np.flatnonzero(la.dbl_s1[:, 0] >= 0)[0])
    alleles = np.where(data.alleles[s] == 2, 1, data.alleles[s]).astype(
        np.int8)
    q_len, q_w, etbl = _quantiles(n, 2)

    # a segment without a site at its end (state 1): the lookahead alone
    # moves the pilot away from the posterior
    step = jsmc.make_segment_step(cfg, epochs, MU, RHO, jnp.asarray(lags),
                                  tblq=(jnp.asarray(q_len),
                                        jnp.asarray(q_w), etbl))
    seg = (jnp.int32(L), jnp.asarray(alleles)[None], jnp.int32(1),
           jnp.int8(1), jnp.int8(1), jnp.float32(dist_mut)) + tuple(
        jnp.asarray(getattr(la, f)[s]) for f in LA_FIELDS)
    ref_state, (ref_ess, ref_need, _) = jax.jit(step)(st, seg)
    ref = jax.tree_util.tree_map(np.asarray, ref_state)
    assert bool(ref_need) == resample

    # the resampling uniform JAX draws (do_resample: split into 3, the
    # second key to systematic_resample)
    k1 = jax.random.split(st.key, 3)[1]
    u_jax = float(jax.random.uniform(k1, (), minval=0.0, maxval=1.0))
    seen = []
    real = tsmc.systematic_resample

    def with_jax_uniform(log_w, u):
        seen.append(1)
        return real(log_w, u_jax)

    monkeypatch.setattr(tsmc, "systematic_resample", with_jax_uniform)
    tcfg = tsmc.PFConfig(num_particles=P, num_leaves=n, ess_threshold=thr,
                         apf=2)
    quant = tla.Quantiles(torch.from_numpy(q_len), torch.from_numpy(q_w),
                          etbl, float(np.mean(q_len[:, -1])))
    t_step = tsmc.make_segment_step(
        tcfg, t_epochs(_demo(TDemography, n=n, E=3), CPU), MU, RHO, lags,
        torch.Generator().manual_seed(0), quantiles=quant)
    tseg = segment_from_numpy(jax.tree_util.tree_map(np.asarray, seg),
                              lags, CPU)
    for a, b in zip(tseg.lookahead, (c[s] for c in tem.lookahead_columns(
            la, CPU))):
        assert type(a) is type(b) and np.array_equal(np.asarray(a),
                                                     np.asarray(b))
    got_state, (ess, need, _) = t_step(
        state_from_numpy(jax.tree_util.tree_map(np.asarray, st), CPU), tseg)
    got = state_to_numpy(got_state)
    assert need == resample and len(seen) == int(resample)
    np.testing.assert_allclose(ess, float(ref_ess), rtol=1e-4)
    # the lookahead moved the ESS away from the posterior's
    w = np.exp(ref.log_w if not resample else np.asarray(st.log_w))
    assert abs(float(ref_ess) - 1.0 / np.sum(w * w)) > 1e-3 * P
    np.testing.assert_allclose(got["log_w"], ref.log_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["log_pilot"], ref.log_pilot, rtol=1e-5,
                               atol=1e-5)
    if resample:
        for k in ("parent", "child0", "child1"):
            np.testing.assert_array_equal(got["trees"][k],
                                          getattr(ref.trees, k), err_msg=k)
        np.testing.assert_array_equal(got["trees"]["time"], ref.trees.time)
        np.testing.assert_allclose(got["log_pilot"], -np.log(np.float32(P)))
        assert np.ptp(got["log_w"]) > 0.1  # the reweight is not uniform


# ---------------------------------------------------------------------------
# the sweep: tests/test_apf.py's invariance and guidance on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("apf", [1, 2])
def test_apf_posterior_equals_prior_without_data(apf):
    """The lookahead enters the pilot only and is divided back out at each
    resampling: with every leaf missing the posterior is the prior (the
    JAX test's bands), resampling at every segment."""
    ne = 10000.0
    demo = _demo(TDemography, n=4, L=1e6, ne=ne)
    n_seg = 40
    seg = SegData(positions=1 + np.arange(n_seg) * 25000,
                  lengths=np.full(n_seg, 25000),
                  states=np.zeros(n_seg, np.int8),
                  alleles=np.full((n_seg, 4), -1, np.int8),
                  phased=np.ones(4, bool))
    cfg = tem.EMConfig(num_particles=300, lag=20000.0, apf=apf,
                       apf_trees=20000, ess_threshold=1.01, device="cpu")
    stats, _, logl, diag = tem.run_chunk(demo, seg, cfg, seed=4)
    assert diag["num_resamples"] > 0
    assert logl == pytest.approx(0.0, abs=0.8)
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert ne_hat == pytest.approx(ne, rel=0.08)


def test_apf_guides_resampling_on_missing_data():
    """On data with missing stretches the lookahead moves the resampling
    criterion (the pilot ESS trace of -apf 2 differs from -apf 0's) while
    the estimates stay consistent (the JAX test's band)."""
    demo = _demo(TDemography, n=4, L=4e5)
    seg = simulate_seg(demo, seed=51)
    al = seg.alleles.copy()
    al[(seg.positions // 100_000) % 2 == 1] = -1
    seg = SegData(positions=seg.positions, lengths=seg.lengths,
                  states=seg.states, alleles=al, phased=seg.phased)
    res = {}
    for apf in (0, 2):
        cfg = tem.EMConfig(num_particles=200, apf=apf, apf_trees=20000,
                           lag=20000.0, device="cpu")
        stats, _, logl, diag = tem.run_chunk(demo, seg, cfg, seed=9)
        res[apf] = (diag["ess"], logl,
                    float(stats.coal_opp.sum() / (2 * stats.coal_cnt.sum())))
    assert not np.allclose(res[0][0], res[2][0])
    assert np.isfinite(res[2][1])
    assert res[2][2] == pytest.approx(res[0][2], rel=0.35)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["-vb"], ["-apf", "0"], ["-apf", "1"], ["-apf", "2"], ["-apf", "3"],
    ["-apf", "4"], ["-vb", "-apf", "2", "-xc", "1"],
    ["-apf", "2", "-bias_heights", "0", "0.05", "-calibrate_lag", "2"],
], ids=" ".join)
def test_vb_and_apf_parse_as_in_the_jax_cli(argv):
    tcfg, tio = tcli.parse_args(argv)
    jcfg, _, jio = jcli.parse_smc2_args(argv)
    for name in ("vb", "apf", "apf_trees", "vb_pseudocount", "xc_epochs",
                 "calibrate_lag", "bias_strengths"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
        assert type(getattr(tcfg, name)) is type(getattr(jcfg, name)), name
    assert tio["bias_heights"] == jio["bias_heights"]


def _write(tmp_path, data):
    path = str(tmp_path / "t.seg")
    write_seg(path, data)
    return path


@pytest.mark.parametrize("path", ["plain", "biased", "twopop", "genome"])
def test_vb_and_apf_run_on_every_path(tmp_path, path):
    """smc2-torch -vb -apf 3 runs on the plain, biased, twopop and
    (unphased, missing, chunked) genome paths on the CPU; -EM 1 so that
    iteration 1 uses the tables of iteration 0's counts."""
    demo_flags = ["-N0", "10000", "-mu", "1e-8", "-rho", "1e-9", "-P", "133",
                  "133016", "3*1"]
    extra = []
    if path == "twopop":
        seg = _write(tmp_path, twopop_data(L=3e4)[1])
        demo_flags = twopop_flags()
    elif path == "genome":
        data = _variable(simulate_seg(_demo(TDemography, n=8, L=2e5),
                                      seed=5))
        seg = _write(tmp_path, data)
        extra = ["-chunks", "2", "-minseg", "50000"]
    else:
        seg = _write(tmp_path, simulate_seg(_demo(TDemography, L=6e4),
                                            seed=5))
        if path == "biased":
            extra = ["-bias_heights", "0", "0.05"]
    out = str(tmp_path / "out")
    assert tcli.smcsmc_main(["-seg", seg, "-o", out, "-Np", "16", "-EM", "1",
                             *demo_flags, *extra, "-vb", "-apf", "3",
                             "-seed", "3", "-device", "cpu"]) == 0
    text = open(f"{out}/result.out").read()
    assert text.count("LogL") == 2
