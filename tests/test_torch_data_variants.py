"""Unphased, mixed and missing data in the torch port against the JAX
package: the phase-configuration enumeration (exact), the phase-averaged
site likelihood (rtol 1e-5, atol 1e-6 plus the conditioning term of
test_torch_likelihood.py), a chunk's prepared segments (exact), the
recording masks of -xc/-xr and a whole chunk sweep (statistical: the two
packages draw from other RNG streams).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu import em as jem
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.kernels import tree as jtree
from smcsmc_tpu.kernels.likelihood import site_log_likelihood
from smcsmc_tpu.kernels.tree import epochs_from_demography
from smcsmc_tpu.segio import SegData, define_chunks, slice_seg
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu.smc import PFConfig, default_lags, init_state
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.convert import trees_from_numpy
from smcsmc_tpu_torch.kernels.likelihood import phase_averaged_log_likelihood
from smcsmc_tpu_torch.sweep_profile import unphase_and_blank

torch.set_num_threads(1)

CPU = torch.device("cpu")
jax_sll = jax.jit(site_log_likelihood, static_argnames=("ancestral_aware",))


def _demo(E=8, n=4, L=2e5, ne=10000.0):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]))
    return Demography(
        change_times=change, pop_sizes=np.full((E, 1), ne),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L,
    )


@pytest.mark.parametrize("dephase", [False, True])
@pytest.mark.parametrize("max_configs", [1, 2, 8])
def test_phase_configs_match_jax(max_configs, dephase):
    rng = np.random.default_rng(10 * max_configs + dephase)
    for n in (4, 8):
        al = rng.choice([-1, 0, 1], size=(200, n)).astype(np.int8)
        # unphased pairs come as 2,2
        pair = rng.random((200, n // 2)) < 0.3
        al[np.repeat(pair, 2, axis=1)] = 2
        got = tem._phase_configs(al, max_configs, dephase)
        ref = jem._phase_configs(al, max_configs, dephase)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[0].dtype == ref[0].dtype and got[1].dtype == ref[1].dtype
    # every pair unphased at n=8: 3 of the 4 pairs are enumerated
    al = np.full((1, 8), 2, np.int8)
    _, n_configs = tem._phase_configs(al, max_configs, False)
    assert n_configs[0] == max_configs


@pytest.mark.parametrize("ancestral_aware", [False, True])
@pytest.mark.parametrize("n", [4, 8])
def test_phase_averaged_likelihood_matches_jax(n, ancestral_aware):
    P = 64
    demo = Demography(
        change_times=np.array([0.0, 2000.0]),
        pop_sizes=np.array([[10000.0], [20000.0]]),
        mig_rates=np.zeros((2, 1, 1)), sample_pops=np.zeros(n, np.int32),
    )
    jt = init_state(jax.random.PRNGKey(n), epochs_from_demography(demo),
                    PFConfig(num_particles=P, num_leaves=n),
                    demo.sample_pops, 1e-9).trees
    tt = trees_from_numpy(jax.tree_util.tree_map(np.asarray, jt), CPU)
    bl = np.asarray(jax.vmap(jtree.branch_lengths)(jt.time, jt.parent),
                    np.float64)
    rng = np.random.default_rng(n + 2 * ancestral_aware)
    for mu in (1e-8, 2e-5):
        inv = np.where(bl > 0, 1.0 / -np.expm1(-mu * np.maximum(bl, 1e-30)),
                       0.0)
        atol = 1e-6 + 4 * 2.0 ** -24 * inv.sum(axis=1)
        for unphased_pairs in range(1, n // 2 + 1):
            al = rng.choice([0, 1, -1], size=n, p=[0.45, 0.35, 0.2])
            al = al.astype(np.int8)
            al[:2 * unphased_pairs] = 2
            configs, n_configs = jem._phase_configs(al[None], 8, False)
            configs, C = configs[0], int(n_configs[0])
            assert C == 2 ** min(unphased_pairs, 3)
            # the JAX step: one pass per configuration, masked logsumexp
            per_cfg = jnp.stack([
                jax_sll(jt, jnp.asarray(configs[i]), jnp.float32(mu),
                        ancestral_aware=ancestral_aware)
                for i in range(configs.shape[0])])
            mask = (jnp.arange(configs.shape[0]) < C)[:, None]
            ref = np.asarray(jax.scipy.special.logsumexp(
                jnp.where(mask, per_cfg, -jnp.inf), axis=0)
                - jnp.log(jnp.float32(C)))
            got = phase_averaged_log_likelihood(
                tt, torch.from_numpy(configs[:C]), mu, ancestral_aware).numpy()
            assert got.shape == (P,)
            assert np.all(np.abs(got - ref) <= 1e-5 * np.abs(ref) + atol), (
                np.max(np.abs(got - ref) - 1e-5 * np.abs(ref) - atol))


def _genome(n=4, L=4e5, seed=3):
    """Simulated data as an unphased VCF with gaps gives it: het pairs
    2,2; sample 1 missing over 60 kb; all missing over 30 kb."""
    seg = simulate_seg(_demo(E=1, n=n, L=L), seed=seed)
    return unphase_and_blank(seg, [(150_000, 180_000)], (250_000, 310_000), 1)


@pytest.mark.parametrize("dephase", [False, True])
def test_prepare_segments_matches_prepare_blocks(dephase):
    """A chunk cut out of the middle of the data (its first segment is
    clipped to the chunk start): every per-segment array equals the JAX
    package's block arrays."""
    seg = _genome()
    demo = _demo(n=4, L=4e5)
    assert np.any(seg.alleles == 2) and np.any(seg.alleles == -1)
    chunks = define_chunks(seg, 3, minseg=1000)
    lags = np.asarray(default_lags(epochs_from_demography(demo),
                                   demo.recombination_rate))
    for c in chunks:
        sl = slice_seg(seg, c.start, c.end)
        S = sl.num_segments
        ref = next(jem.prepare_blocks(sl, S + 5, c.start, max_configs=8,
                                      dephase=dephase))
        lengths, configs, n_configs, states, leaf_status, dist_mut = (
            np.asarray(x)[:S] for x in ref)
        got = tem.prepare_segments(sl, c.start, lags, CPU, max_configs=8,
                                   dephase=dephase)
        assert len(got) == S
        np.testing.assert_array_equal(got.lengths, lengths)
        np.testing.assert_array_equal(got.states, states)
        np.testing.assert_array_equal(got.leaf_status, leaf_status)
        np.testing.assert_array_equal(got.dist_mut, dist_mut)
        np.testing.assert_array_equal(got.n_configs, n_configs)
        np.testing.assert_array_equal(got.configs.numpy(), configs)
        np.testing.assert_array_equal(got.has_data.numpy(),
                                      configs[:, 0] >= 0)
        # a segment hands the step its own configurations only
        s = int(np.argmax(n_configs))
        assert got[s].configs.shape == (n_configs[s], 4)
        assert got[s].length == lengths[s]
    # the middle chunk starts inside a segment
    mid = slice_seg(seg, chunks[1].start, chunks[1].end)
    assert int(mid.positions[0]) < chunks[1].start


def test_excluded_epochs_record_only_pseudocounts():
    """-xc / -xr gate the recording (pfparam.cpp:82-99): the excluded
    epochs' committed statistics are exactly the pseudocounts, as in the
    JAX run_chunk."""
    demo = _demo(E=5, n=4, L=1e5)
    seg = simulate_seg(demo, seed=2)
    xc, xr = (1, 3), (0, 2)
    pseudo = tem.prior_pseudostats(demo)
    ref = jem.run_chunk(demo, seg, jem.EMConfig(
        num_particles=32, block_size=256, xc_epochs=xc, xr_epochs=xr), seed=1)
    got = tem.run_chunk(demo, seg, tem.EMConfig(
        num_particles=32, device="cpu", xc_epochs=xc, xr_epochs=xr), seed=1)
    for stats in (ref[0], got[0]):
        for name in tem.SuffStats._fields:
            recorded = xr if name.startswith("recomb") else xc
            x, p = getattr(stats, name), getattr(pseudo, name)
            for e in recorded:
                np.testing.assert_array_equal(x[e], p[e], err_msg=name)
        # the other epochs did record
        for name, excluded in (("coal_opp", xc), ("recomb_opp", xr)):
            rest = [e for e in range(5) if e not in excluded]
            x, p = getattr(stats, name), getattr(pseudo, name)
            assert np.all(x[rest] >= p[rest]) and np.any(x[rest] > p[rest])


def test_unphased_mixed_run_chunk_agrees_with_jax():
    """Unphased data with a mixed and an all-missing stretch end to end:
    the rule of test_torch_em.py::test_run_chunk_agrees_with_jax (three
    filter seeds per side, P=64, the same bands)."""
    demo = _demo(n=4, L=2e5)
    seg = unphase_and_blank(simulate_seg(_demo(E=1, n=4, L=2e5), seed=5),
                            [(80_000, 100_000)], (120_000, 160_000), 0)
    res = {"jax": [], "torch": []}
    for s in (1, 2, 3):
        res["jax"].append(jem.run_chunk(
            demo, seg, jem.EMConfig(num_particles=64, block_size=512), seed=s))
        res["torch"].append(tem.run_chunk(
            demo, seg, tem.EMConfig(num_particles=64, device="cpu"), seed=s))
    diag = res["torch"][0][3]
    assert min(diag["leaf_status_counts"].values()) > 0
    assert diag["unphased_sites"] > 10
    summary = {}
    for side, runs in res.items():
        logl = np.mean([r[2] for r in runs])
        ne = (sum(r[0].coal_opp.sum() for r in runs)
              / (2.0 * sum(r[0].coal_cnt.sum() for r in runs)))
        rho = (sum(r[0].recomb_cnt.sum() for r in runs)
               / sum(r[0].recomb_opp.sum() for r in runs))
        summary[side] = (logl, ne, rho)
        assert all(np.isfinite(r[2]) and r[2] < 0 for r in runs)
    (lj, nj, rj), (lt, nt, rt) = summary["jax"], summary["torch"]
    assert abs(lt - lj) <= 0.02 * abs(lj), summary
    assert nt == pytest.approx(nj, rel=0.3), summary
    assert rt == pytest.approx(rj, rel=0.5), summary


def test_unphased_data_is_data():
    """Code 2 counts as data: leaf status 1, has_data true."""
    seg = SegData(positions=np.array([1, 1001]), lengths=np.array([1000, 500]),
                  states=np.zeros(2, np.int8),
                  alleles=np.array([[2, 2, 0, 1], [2, 2, -1, -1]], np.int8),
                  phased=np.zeros(4, bool))
    got = tem.prepare_segments(seg, 1, np.full(3, 1e4, np.float32), CPU,
                               max_configs=8)
    np.testing.assert_array_equal(got.leaf_status, [1, 0])
    np.testing.assert_array_equal(got.has_data.numpy(),
                                  [[True] * 4, [True, True, False, False]])
    np.testing.assert_array_equal(got.n_configs, [2, 2])
