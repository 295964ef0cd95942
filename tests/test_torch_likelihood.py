"""The torch port's site likelihood against smcsmc_tpu/kernels/likelihood.py
on identical trees and alleles: n=4 and 8 take the unrolled form, n=10 the
data-dependent loop.

Tolerance: rtol 1e-5 and atol 1e-5, plus the conditioning of the f32
formula.  The no-mutation probability p = exp(-mu t) of a branch of length
t lies within mu t of 1, so 1 - p carries an absolute f32 error of about
one ulp of 1 (2^-24), and XLA's and torch's f32 ``exp`` may differ in that
ulp.  A site log-likelihood moves by d(1-p)/(1-p) per branch, so each
particle gets an extra atol of 4 * 2^-24 * sum_b 1/(1 - exp(-mu t_b)).  At
mu = 2e-5 (mu t of order 0.1) that term is below 1e-5; at a realistic
mu = 1e-8 it reaches 1e-2 on trees with short branches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.kernels.likelihood import site_log_likelihood
from smcsmc_tpu.kernels import tree as jtree
from smcsmc_tpu.kernels.tree import epochs_from_demography
from smcsmc_tpu.smc import PFConfig, init_state
from smcsmc_tpu_torch.convert import trees_from_numpy
from smcsmc_tpu_torch.kernels.likelihood import (
    site_log_likelihood as torch_sll,
)

torch.set_num_threads(1)

P = 64
jax_sll = jax.jit(site_log_likelihood, static_argnames=("ancestral_aware",))


def _trees(n, seed):
    demo = Demography(
        change_times=np.array([0.0, 2000.0]),
        pop_sizes=np.array([[10000.0], [20000.0]]),
        mig_rates=np.zeros((2, 1, 1)), sample_pops=np.zeros(n, np.int32),
    )
    st = init_state(jax.random.PRNGKey(seed), epochs_from_demography(demo),
                    PFConfig(num_particles=P, num_leaves=n),
                    demo.sample_pops, 1e-9)
    return st.trees


@pytest.mark.parametrize("ancestral_aware", [False, True])
@pytest.mark.parametrize("n", [4, 8, 10])
def test_site_log_likelihood_matches_jax(n, ancestral_aware):
    jt = _trees(n, seed=n)
    tt = trees_from_numpy(jax.tree_util.tree_map(np.asarray, jt),
                          torch.device("cpu"))
    rng = np.random.default_rng(n + 2 * ancestral_aware)
    bl = np.asarray(jax.vmap(jtree.branch_lengths)(jt.time, jt.parent),
                    np.float64)
    for mu in (1e-8, 2e-5):
        inv = np.where(bl > 0, 1.0 / -np.expm1(-mu * np.maximum(bl, 1e-30)),
                       0.0)
        atol = 1e-5 + 4 * 2.0 ** -24 * inv.sum(axis=1)
        for _ in range(3):
            alleles = rng.choice([0, 1, -1], size=n, p=[0.45, 0.35, 0.2])
            alleles = alleles.astype(np.int8)
            ref = np.asarray(jax_sll(jt, jnp.asarray(alleles),
                                     jnp.float32(mu),
                                     ancestral_aware=ancestral_aware))
            got = torch_sll(tt, torch.from_numpy(alleles), mu,
                            ancestral_aware).numpy()
            assert np.all(np.abs(got - ref) <= 1e-5 * np.abs(ref) + atol), (
                np.max(np.abs(got - ref) - 1e-5 * np.abs(ref) - atol))


def test_all_missing_site_has_zero_log_likelihood():
    jt = _trees(6, seed=1)
    tt = trees_from_numpy(jax.tree_util.tree_map(np.asarray, jt),
                          torch.device("cpu"))
    got = torch_sll(tt, torch.full((6,), -1, dtype=torch.int8), 1e-8)
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-6)
