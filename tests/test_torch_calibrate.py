"""The port's calibration pre-passes against ``smcsmc_tpu/calibrate.py``
on the CPU.  The RNG streams differ, so the comparisons are statistical:

- bias strengths from 20,000 trees per side within 10% per section (the
  section means of branch length carry about 1% of sampling error), the
  last section exactly 1;
- the survival medians of 1024 genealogies over 2e5 bp in 10 windows
  within one bin of the 64-bin log-spaced histogram (a bin is a factor
  1.17; over seeds 0-3 each package's median of the youngest epoch, where
  deaths are fewest, spread over three bins);
- the composition of lags and delays exactly.
"""

import jax
import numpy as np
import pytest
import torch

from smcsmc_tpu import calibrate as jcal
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.kernels.tree import epochs_from_demography as j_epochs
from smcsmc_tpu_torch import calibrate as tcal
from smcsmc_tpu_torch.kernels import trip as trip_mod
from smcsmc_tpu_torch.kernels.tree import epochs_from_demography as t_epochs

torch.set_num_threads(1)

RHO = 1e-9


def _demo(change=(0.0, 2000.0, 8000.0, 30000.0), n=4):
    E = len(change)
    return Demography(
        change_times=np.asarray(change), pop_sizes=np.full((E, 1), 10000.0),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=RHO, sequence_length=2e5)


@pytest.mark.parametrize("heights", [(1000.0,), (1000.0, 5000.0)])
def test_default_bias_strengths_match_jax(heights):
    demo = _demo()
    ref = jcal.default_bias_strengths(jax.random.PRNGKey(0), j_epochs(demo),
                                      demo.sample_pops, heights)
    got = tcal.default_bias_strengths(torch.Generator().manual_seed(0),
                                      t_epochs(demo, "cpu"),
                                      demo.sample_pops, heights)
    assert len(got) == len(heights) + 1 and got[-1] == 1.0
    np.testing.assert_allclose(got, ref, rtol=0.1)
    assert got[0] > 1.0  # the youngest section is upweighted


def test_survival_medians_match_jax():
    demo = _demo()
    kw = dict(num_particles=1024, distance=2e5, num_windows=10)
    ref = jcal.calibrate_survival(jax.random.PRNGKey(0), j_epochs(demo),
                                  demo.sample_pops, RHO, **kw)
    launches = trip_mod.trip.launches
    got = tcal.calibrate_survival(torch.Generator().manual_seed(0),
                                  t_epochs(demo, "cpu"), demo.sample_pops,
                                  RHO, **kw)
    assert trip_mod.trip.launches == launches  # the plain trip on the CPU
    edges = np.logspace(2, np.log10(2e6), 63)
    bins = np.searchsorted(edges, got), np.searchsorted(edges, ref)
    assert np.all(np.abs(bins[0] - bins[1]) <= 1), bins
    # older nodes are cut sooner: the medians fall with the epoch
    assert np.all(np.diff(got) < 0), got


def test_hist_median_as_in_jax():
    centers = np.arange(64, dtype=np.float64) * 10.0 + 5.0
    rng = np.random.default_rng(1)
    for counts in (rng.integers(0, 5, 64), np.eye(64)[7] * 3,
                   np.zeros(64)):
        ref = jcal._hist_median(counts.astype(np.float64), centers)
        got = float(tcal._hist_median(torch.from_numpy(counts.astype(
            np.float64)), torch.from_numpy(centers)))
        assert got == ref or (np.isnan(ref) and np.isnan(got))


def test_lags_and_delays_compose_as_in_jax(monkeypatch):
    surv = np.array([30000.0, np.nan, 4000.0])
    monkeypatch.setattr(tcal, "calibrate_survival", lambda *a, **k: surv)
    monkeypatch.setattr(jcal, "calibrate_survival", lambda *a, **k: surv)
    got = tcal.calibrated_lags_and_delays(None, None, None, RHO,
                                          lag_fraction=1.5, delay=0.25)
    ref = jcal.calibrated_lags_and_delays(None, None, None, RHO,
                                          lag_fraction=1.5, delay=0.25)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], [45000.0, 30000.0, 6000.0])
