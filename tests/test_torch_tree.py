"""The torch port's tree primitives against smcsmc_tpu/kernels/tree.py.

Deterministic functions are compared on identical trees (from the JAX
initial sampler): integer results exactly, floats to rtol 1e-5.  The
initial sampler draws from another RNG stream, so it is held to the JAX
sampler statistically: mean TMRCA and mean tree length at P=4096 within 3%
(each mean has a Monte-Carlo standard error of about 1% there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.kernels import tree as jtree
from smcsmc_tpu.smc import PFConfig, _tree_summaries, init_state
from smcsmc_tpu_torch.convert import trees_from_numpy
from smcsmc_tpu_torch.kernels import tree as ttree

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _demo(E, n, piecewise=False):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(3.0, 4.5, E - 1)]))
    sizes = np.full((E, 1), 10000.0)
    if piecewise:
        sizes[:, 0] = np.linspace(5000.0, 20000.0, E)
    return Demography(
        change_times=change, pop_sizes=sizes, mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(n, np.int32), mutation_rate=1e-8,
        recombination_rate=1e-9, sequence_length=1e6,
    )


@functools.lru_cache(maxsize=None)
def _jax_trees(n, E, P=64, seed=0):
    demo = _demo(E, n)
    epochs = jtree.epochs_from_demography(demo)
    st = init_state(jax.random.PRNGKey(seed), epochs,
                    PFConfig(num_particles=P, num_leaves=n),
                    demo.sample_pops, 1e-9)
    return demo, epochs, st.trees


def _torch_trees(jt):
    return trees_from_numpy(jax.tree_util.tree_map(np.asarray, jt), CPU)


@pytest.mark.parametrize("leaf_status", [-1, 0, 1])
@pytest.mark.parametrize("n", [4, 8])
def test_tree_summaries_match_jax(n, leaf_status):
    demo, epochs, jt = _jax_trees(n, 5)
    hd = np.ones(n, bool)
    hd[[0, n - 2]] = False  # partial data
    tl, tle, B = _tree_summaries(jt, epochs, jnp.int8(leaf_status),
                                 jnp.asarray(hd))
    t_epochs = ttree.epochs_from_demography(demo, CPU)
    tl2, tle2, B2 = ttree.tree_summaries(_torch_trees(jt), t_epochs,
                                         leaf_status, torch.from_numpy(hd))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(tl), rtol=1e-5)
    np.testing.assert_allclose(tle2.numpy(), np.asarray(tle), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(B2.numpy(), np.asarray(B), rtol=1e-5)


@pytest.mark.parametrize("n", [4, 8, 10])
def test_primitives_match_jax(n):
    demo, epochs, jt = _jax_trees(n, 3)
    tt = _torch_trees(jt)
    hd = np.array([i % 3 != 1 for i in range(n)])
    vm = jax.vmap
    np.testing.assert_array_equal(
        ttree.parent_time(tt.time, tt.parent).numpy(),
        np.asarray(vm(jtree.parent_time)(jt.time, jt.parent)))
    np.testing.assert_array_equal(
        ttree.leaf_ancestor_ids(tt.parent).numpy(),
        np.asarray(vm(jtree.leaf_ancestor_ids)(jt.parent)))
    np.testing.assert_array_equal(
        ttree.count_data_leaves_below(tt.parent, torch.from_numpy(hd)).numpy(),
        np.asarray(vm(lambda t, p: jtree.count_data_leaves_below(
            None, t, jnp.asarray(hd), p))(jt.time, jt.parent)))
    np.testing.assert_allclose(
        ttree.data_branch_length(tt.time, tt.parent,
                                 torch.from_numpy(hd)).numpy(),
        np.asarray(vm(lambda t, p: jtree.data_branch_length(
            t, p, None, jnp.asarray(hd)))(jt.time, jt.parent)), rtol=1e-5)
    te = ttree.epochs_from_demography(demo, CPU)
    np.testing.assert_allclose(
        ttree.branch_length_per_epoch(tt.time, tt.parent, te.start,
                                      te.end).numpy(),
        np.asarray(vm(lambda t, p: jtree.branch_length_per_epoch(
            t, p, epochs.start, epochs.end))(jt.time, jt.parent)),
        rtol=1e-5, atol=1e-3)


def _valid(trees):
    par = trees.parent.numpy()
    t = trees.time.numpy()
    c0 = trees.child0.numpy()
    c1 = trees.child1.numpy()
    P, N = par.shape
    n = (N + 1) // 2
    assert np.all(np.sum(par < 0, axis=1) == 1)  # exactly one root
    rows = np.arange(P)[:, None]
    has_p = par >= 0
    assert np.all(t[rows, np.where(has_p, par, 0)][has_p] >= t[has_p])
    assert np.all(c0[:, :n] < 0) and np.all(c1[:, :n] < 0)
    assert np.all(c0[:, n:] >= 0) and np.all(c0[:, n:] != c1[:, n:])
    for c in (c0, c1):
        assert np.all(par[rows, c[:, n:]] == np.arange(n, N)[None, :])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_make_initial_trees_are_valid(n):
    gen = torch.Generator().manual_seed(3)
    epochs = ttree.epochs_from_demography(_demo(4, n, piecewise=True), CPU)
    _valid(ttree.make_initial_trees(gen, epochs, 256, np.zeros(n, np.int32)))


def test_make_initial_trees_ancient_samples_are_valid():
    n = 4
    gen = torch.Generator().manual_seed(5)
    epochs = ttree.epochs_from_demography(_demo(3, n), CPU)
    st = np.array([0.0, 0.0, 500.0, 2000.0])
    trees = ttree.make_initial_trees(gen, epochs, 256, np.zeros(n, np.int32),
                                     sample_time=st)
    _valid(trees)
    np.testing.assert_array_equal(trees.time.numpy()[:, :n],
                                  np.broadcast_to(st, (256, n)))


@pytest.mark.parametrize("piecewise", [False, True])
def test_initial_tree_moments_match_jax(piecewise):
    P, n, E = 4096, 4, 6
    demo = _demo(E, n, piecewise=piecewise)
    jt = jtree.make_initial_trees(
        jax.random.PRNGKey(1), jtree.epochs_from_demography(demo), P,
        jnp.zeros(n, jnp.int32), max_mig=0)
    tt = ttree.make_initial_trees(torch.Generator().manual_seed(1),
                                  ttree.epochs_from_demography(demo, CPU), P,
                                  np.zeros(n, np.int32))
    j_tmrca = np.asarray(jt.time).max(axis=1).mean()
    t_tmrca = float(tt.time.max(dim=1).values.mean())
    j_len = np.asarray(jax.vmap(jtree.total_branch_length)(jt.time,
                                                           jt.parent)).mean()
    t_len = float(ttree.branch_lengths(tt.time, tt.parent).sum(1).mean())
    assert t_tmrca == pytest.approx(j_tmrca, rel=0.03)
    assert t_len == pytest.approx(j_len, rel=0.03)


def test_multi_population_is_refused():
    """Several populations have device epochs (the migration pass), and
    with them the port runs height bias, calibrated lags, the guide and
    ``-alpha`` on any device; what the card still refuses with them is
    ``-arg`` under height bias, citing item 16 (the biased migration pass
    has no ARG variant), while the CPU runs it."""
    import dataclasses

    from smcsmc_tpu_torch import em as tem

    demo = Demography(
        change_times=np.array([0.0]), pop_sizes=np.array([[1e4, 1e4]]),
        mig_rates=np.zeros((1, 2, 2)), sample_pops=np.array([0, 1]),
    )
    ep = ttree.epochs_from_demography(demo, CPU)
    assert ep.structured and tuple(ep.mig.shape) == (1, 2, 2)
    assert not hasattr(tem, "refuse_unported")
    for kw in (dict(bias_heights=(100.0,)), dict(calibrate_lag=True),
               dict(guide_file="g.recomb_guide.gz"), dict(alpha=0.5)):
        for device in ("cuda", "cpu"):
            tem.refuse_caps(demo, tem.EMConfig(device=device, **kw))
    cfg = tem.EMConfig(bias_heights=(100.0,), record_arg=True,
                       device="cuda")
    with pytest.raises(NotImplementedError, match="-arg with -bias_heights "
                       "with several populations.*item 16"):
        tem.refuse_caps(demo, cfg)
    tem.refuse_caps(demo, dataclasses.replace(cfg, device="cpu"))