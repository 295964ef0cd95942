"""The torch port's sweep building blocks against smcsmc_tpu/smc.py, on the
same state (carried across with ``convert.state_from_numpy``).

Resampling indices must be equal; floats agree to f32 tolerance (rtol
1e-5; the Kahan compensation term to a few ulps of the log-likelihood it
compensates).  The whole segment step is compared with ``next_rec`` beyond
the segment (no recombination trips, so the step is deterministic) and
``ess_threshold=0`` (no resampling), also at an unphased site (several
phase configurations), with some and with all leaves missing, with the
recording masks of -xc/-xr and with ``ancestral_aware``; the segment goes
to the port through ``convert.segment_from_numpy``.  The mutation rate 2e-6 keeps
1 - exp(-mu t) well conditioned in f32 (see test_torch_likelihood.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu import smc as jsmc
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.kernels.tree import epochs_from_demography as j_epochs
from smcsmc_tpu_torch import smc as tsmc
from smcsmc_tpu_torch.convert import (
    segment_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from smcsmc_tpu_torch.kernels.tree import epochs_from_demography as t_epochs

torch.set_num_threads(1)

CPU = torch.device("cpu")
P, N_LEAVES, E = 64, 4, 3
MU, RHO = 2e-6, 1e-9


def _demo():
    return Demography(
        change_times=np.array([0.0, 1500.0, 8000.0]),
        pop_sizes=np.array([[8000.0], [12000.0], [20000.0]]),
        mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(N_LEAVES, np.int32),
        mutation_rate=MU, recombination_rate=RHO, sequence_length=1e6,
    )


def _jax_state(seed, L=None):
    """A JAX PFState with random weights, FIFO and statistics."""
    demo = _demo()
    epochs = j_epochs(demo)
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=N_LEAVES, ess_threshold=0.0)
    st = jsmc.init_state(jax.random.PRNGKey(seed), epochs, cfg,
                         demo.sample_pops, RHO)
    rng = np.random.default_rng(seed)
    K = jsmc.stats_width(E, 1)
    lw = rng.normal(0.0, 2.0, P)
    lw = (lw - np.log(np.exp(lw - lw.max()).sum()) - lw.max()).astype(np.float32)
    st = st._replace(
        log_w=jnp.asarray(lw), log_pilot=jnp.asarray(lw),
        fifo=jnp.asarray(rng.uniform(0, 1, (P, cfg.fifo_slots, K)), jnp.float32),
        stats=jnp.asarray(rng.uniform(0, 5, K), jnp.float32),
        stats_wt=jnp.asarray(rng.uniform(0, 1, K), jnp.float32),
        ln_norm=jnp.float32(-1234.567), ln_norm_c=jnp.float32(1.5e-5),
        front=jnp.float32(40000.0),
        slot_open=jnp.asarray([39500.0, 30000.0, 39990.0], jnp.float32),
    )
    if L is not None:  # no recombination inside the segment
        st = st._replace(next_rec=jnp.asarray(
            L + rng.uniform(1.0, 1e4, P), jnp.float32))
    return demo, epochs, cfg, st


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def test_systematic_resample_matches_jax():
    rng = np.random.default_rng(0)
    for seed in range(5):
        lw = rng.normal(0.0, 3.0, 257).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        u = float(jax.random.uniform(key, (), minval=0.0, maxval=1.0))
        ref = np.asarray(jsmc.systematic_resample(key, jnp.asarray(lw)))
        got = tsmc.systematic_resample(torch.from_numpy(lw), u).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rot", [[True, False, True], [False, True, False]])
def test_commit_slot_matches_jax(rot):
    _, _, cfg, st = _jax_state(1)
    rot = np.array(rot)
    ref = _np(jsmc._commit_slot(st, jnp.asarray(rot), cfg.fifo_slots - 1))
    got = state_to_numpy(tsmc.commit_slot(state_from_numpy(_np(st), CPU), rot,
                                          cfg.fifo_slots - 1))
    for k in ("stats", "stats_wt", "fifo"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                   err_msg=k)


def test_flush_pending_matches_jax():
    _, _, _, st = _jax_state(2)
    ref = _np(jsmc.flush_pending(st))
    got = state_to_numpy(tsmc.flush_pending(state_from_numpy(_np(st), CPU)))
    for k in ("stats", "stats_wt", "fifo"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                   err_msg=k)


def test_default_lags_match_jax():
    demo = _demo()
    np.testing.assert_array_equal(
        tsmc.default_lags(demo.change_times, RHO),
        jsmc.default_lags(j_epochs(demo), RHO))


@pytest.mark.parametrize("leaf_status,seg_state", [
    (1, 0), (0, 0), (-1, 0), (1, 1)])
def test_segment_step_matches_jax(leaf_status, seg_state):
    L, dist_mut = 800, 3000.0
    demo, epochs, cfg, st = _jax_state(3 + leaf_status, L=L)
    lags = np.array([3000.0, 9000.0, 40000.0], np.float32)
    rng = np.random.default_rng(7)
    alleles = rng.integers(0, 2, N_LEAVES).astype(np.int8)
    if leaf_status == 0:
        alleles[[0, 2]] = -1
    elif leaf_status == -1:
        alleles[:] = -1

    step = jsmc.make_segment_step(cfg, epochs, MU, RHO, jnp.asarray(lags))
    seg = (jnp.int32(L), jnp.asarray(alleles)[None], jnp.int32(1),
           jnp.int8(seg_state), jnp.int8(leaf_status), jnp.float32(dist_mut))
    ref_state, (ref_ess, ref_need, _) = jax.jit(step)(st, seg)
    ref = _np(ref_state)
    assert not bool(ref_need)

    tcfg = tsmc.PFConfig(num_particles=P, num_leaves=N_LEAVES,
                         ess_threshold=0.0)
    t_step = tsmc.make_segment_step(tcfg, t_epochs(demo, CPU), MU, RHO, lags,
                                    torch.Generator().manual_seed(0))
    al = torch.from_numpy(alleles)
    tseg = tsmc.Segment(
        L, seg_state, leaf_status, al[None], al >= 0,
        torch.from_numpy(tsmc.fifo_gate_masks(np.array([dist_mut]), lags)[0]))
    got_state, (ess, need, front) = t_step(state_from_numpy(_np(st), CPU), tseg)
    _assert_same_step(got_state, (ess, need, front), ref, ref_ess)


def _assert_same_step(got_state, got_out, ref, ref_ess):
    ess, need, front = got_out
    got = state_to_numpy(got_state)
    assert not need
    assert front == float(ref.front)
    np.testing.assert_allclose(ess, float(ref_ess), rtol=1e-4)
    np.testing.assert_allclose(got["log_w"], ref.log_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["next_rec"], ref.next_rec, rtol=1e-5)
    np.testing.assert_allclose(got["ln_norm"], ref.ln_norm, rtol=1e-6)
    eps = 4 * np.finfo(np.float32).eps * abs(float(ref.ln_norm))
    np.testing.assert_allclose(got["ln_norm_c"], ref.ln_norm_c, atol=eps)
    for k in ("fifo", "stats", "stats_wt"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["slot_open"], ref.slot_open)
    # trees are untouched without trips
    np.testing.assert_array_equal(got["trees"]["parent"], ref.trees.parent)


@pytest.mark.parametrize("alleles,masks,ancestral_aware", [
    ([2, 2, 2, 2], None, False),  # leaf status 1, 4 phase configurations
    ([2, 2, 0, 1], None, True),  # 2 configurations, allele 0 ancestral
    ([2, 2, -1, -1], None, False),  # leaf status 0, 2 configurations
    ([-1, 2, 2, -1], None, False),  # leaf status 0, 2 configurations
    ([-1, -1, -1, -1], None, False),  # leaf status -1: no site
    ([2, 2, 1, -1], ((1,), (0, 2)), False),  # with -xc 1 and -xr 0, 2
])
def test_segment_step_unphased_matches_jax(alleles, masks, ancestral_aware):
    """One step at an unphased site: the JAX step loops over the padded
    configurations and masks; the port takes the site's own in one pass."""
    from smcsmc_tpu.em import _leaf_status, _phase_configs

    L, dist_mut = 800, 3000.0
    alleles = np.array(alleles, np.int8)
    leaf_status = int(_leaf_status(alleles[None])[0])
    configs, n_configs = _phase_configs(alleles[None], 8, False)
    demo, epochs, cfg, st = _jax_state(11 + leaf_status, L=L)
    import dataclasses

    cfg = dataclasses.replace(cfg, ancestral_aware=ancestral_aware)
    lags = np.array([3000.0, 9000.0, 40000.0], np.float32)
    xc, xr = masks or ((), ())
    rec_masks = None
    if masks:
        rec_masks = tuple(jnp.asarray(
            [0.0 if e in x else 1.0 for e in range(E)], jnp.float32)
            for x in (xc, xr))
    step = jsmc.make_segment_step(cfg, epochs, MU, RHO, jnp.asarray(lags),
                                  rec_masks=rec_masks)
    seg = (jnp.int32(L), jnp.asarray(configs[0]), jnp.int32(n_configs[0]),
           jnp.int8(0), jnp.int8(leaf_status), jnp.float32(dist_mut))
    ref_state, (ref_ess, ref_need, _) = jax.jit(step)(st, seg)
    assert not bool(ref_need)

    tcfg = tsmc.PFConfig(num_particles=P, num_leaves=N_LEAVES,
                         ess_threshold=0.0, ancestral_aware=ancestral_aware)
    t_step = tsmc.make_segment_step(tcfg, t_epochs(demo, CPU), MU, RHO, lags,
                                    torch.Generator().manual_seed(0))
    tseg = segment_from_numpy(_np(seg), lags, CPU, xc, xr)
    assert tseg.configs.shape == (int(n_configs[0]), N_LEAVES)
    got_state, out = t_step(state_from_numpy(_np(st), CPU), tseg)
    _assert_same_step(got_state, out, _np(ref_state), ref_ess)
