"""The torch port's EM loop against smcsmc_tpu/em.py.

The host helpers copied from em.py must give identical results.  The sweep
draws from other RNG streams, so ``run_chunk`` is held to JAX's
statistically: same data, three filter seeds per side, P=64.  The bands
were calibrated from six seeds per side on this data: the per-seed spread
of LogL is about 15 (on -1770), of the pooled Ne about 15% and of the
recombination rate about 25%; the bands are about three standard errors of
the difference of the 3-seed means.
"""

import os

import numpy as np
import pytest
import torch

from smcsmc_tpu import em as jem
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.segio import SegData
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu_torch import em as tem

torch.set_num_threads(1)


def _demo(E=8, n=4, L=2e5, ne=10000.0):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]))
    return Demography(
        change_times=change, pop_sizes=np.full((E, 1), ne),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L,
    )


def _tcfg(**kw):
    return tem.EMConfig(device="cpu", **kw)


def test_host_helpers_match_jax():
    demo = _demo(E=5)
    for a, b in zip(tem.prior_pseudostats(demo), jem.prior_pseudostats(demo)):
        np.testing.assert_array_equal(a, b)
    al = np.random.default_rng(0).choice([0, 1, -1], size=(50, 6)).astype(
        np.int8)
    al[3] = -1
    al[4] = 1
    np.testing.assert_array_equal(tem._leaf_status(al), jem._leaf_status(al))


def test_m_step_matches_jax():
    demo = _demo(E=6)
    rng = np.random.default_rng(1)
    stats = jem.SuffStats(
        coal_opp=rng.uniform(1e3, 1e5, (6, 1)),
        coal_cnt=rng.uniform(0.1, 20.0, (6, 1)),
        mig_opp=np.ones((6, 1)), mig_cnt=np.zeros((6, 1, 1)),
        recomb_opp=rng.uniform(1e9, 1e10, 6), recomb_cnt=rng.uniform(1, 9, 6),
    )
    ref = jem.m_step(demo, stats, jem.EMConfig())
    got = tem.m_step(demo, stats)
    np.testing.assert_array_equal(got.pop_sizes, ref.pop_sizes)
    np.testing.assert_array_equal(got.mig_rates, ref.mig_rates)
    assert got.recombination_rate == ref.recombination_rate


def test_no_data_posterior_equals_prior():
    """All data missing: the sweep leaves the coalescent prior untouched
    (the test_e2e.py no-data gate)."""
    ne = 10000.0
    demo = _demo(E=1, n=4, L=1e6, ne=ne)
    seg = SegData(
        positions=np.array([1]), lengths=np.array([int(1e6)]),
        states=np.zeros(1, dtype=np.int8),
        alleles=np.full((1, 4), -1, dtype=np.int8), phased=np.ones(4, bool),
    )
    stats, _, logl, _ = tem.run_chunk(
        demo, seg, _tcfg(num_particles=300, lag=20000.0), seed=4)
    assert logl == pytest.approx(0.0, abs=1e-3)
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert ne_hat == pytest.approx(ne, rel=0.1)


def test_run_chunk_agrees_with_jax():
    demo = _demo()
    seg = simulate_seg(demo, seed=5)
    res = {"jax": [], "torch": []}
    for s in (1, 2, 3):
        res["jax"].append(jem.run_chunk(
            demo, seg, jem.EMConfig(num_particles=64, block_size=512), seed=s))
        res["torch"].append(tem.run_chunk(
            demo, seg, _tcfg(num_particles=64), seed=s))
    summary = {}
    for side, runs in res.items():
        logl = np.mean([r[2] for r in runs])
        ne = (sum(r[0].coal_opp.sum() for r in runs)
              / (2.0 * sum(r[0].coal_cnt.sum() for r in runs)))
        rho = (sum(r[0].recomb_cnt.sum() for r in runs)
               / sum(r[0].recomb_opp.sum() for r in runs))
        summary[side] = (logl, ne, rho)
        assert all(np.isfinite(r[2]) and r[2] < 0 for r in runs)
        assert all(r[3]["num_resamples"] > 0 for r in runs)
    (lj, nj, rj), (lt, nt, rt) = summary["jax"], summary["torch"]
    assert abs(lt - lj) <= 0.02 * abs(lj), summary
    assert nt == pytest.approx(nj, rel=0.3), summary
    assert rt == pytest.approx(rj, rel=0.5), summary


def _rows(path):
    with open(path) as fh:
        lines = [ln.split() for ln in fh.read().strip().split("\n")]
    header = lines[0]
    keys = [tuple(ln[:2]) + tuple(ln[4:7]) for ln in lines[1:]]
    return header, keys


def test_run_em_writes_the_same_out_rows_as_jax(tmp_path):
    demo = _demo(L=1e5)
    seg = simulate_seg(demo, seed=8)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jem.run_em(demo, seg, jem.EMConfig(num_particles=64, block_size=512,
                                       em_iters=1, outdir=str(jdir)))
    res = tem.run_em(demo, seg, _tcfg(num_particles=64, em_iters=1,
                                      outdir=str(tdir)))
    assert len(res.log_likelihoods) == 2 and len(res.estep_seconds) == 2
    for name in ("result.out", os.path.join("emiter0", "chunkfinal.out"),
                 os.path.join("emiter1", "chunkfinal.out")):
        assert _rows(tdir / name) == _rows(jdir / name), name


def test_sweep_profile_reports_on_cpu():
    """The profile of steady segments runs end to end on the CPU (no device
    operations there, so no device time and no kernel launches)."""
    from smcsmc_tpu_torch.sweep_profile import (
        bench_data,
        profile_sweep,
        report_lines,
    )

    demo, seg = bench_data(L=2e5)
    rep = profile_sweep(demo, seg, 32, "cpu", warm=4, timed=8, profiled=8)
    assert rep["segments"] == 8 and rep["ms_per_segment"] > 0
    assert rep["device_busy_share"] == 0 and rep["device_ms_per_segment"] == 0
    assert rep["pass_launches"] == 0
    assert rep["launches_per_segment"] == 0 and rep["top_device_ops"] == []
    assert len(report_lines(rep)) == 2
