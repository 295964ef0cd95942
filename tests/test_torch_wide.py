"""The torch port above 8 haplotypes, where the card runs the wide kernels
(``csrc/trip.cu``, 9 to 64 leaves), against the JAX package on the CPU.

The JAX package's Pallas trip stops at 8 leaves (smc.py:748); above, it
runs the XLA twin of the trip: ``transition.recombination_transition``
(the point ``_sample_recomb_point`` or ``_sample_recomb_point_biased``, the
re-coalescence ``_walk_fast``, the SPR ``_apply_spr``) and
``smc._tree_summaries``.  That twin draws from per-particle keys; the
uniforms it drew are recovered from the same keys (the point's and the
hazard's) and from its coalescence target (its rank among the branches
crossing t_c), so that the port's plain trip runs on the same numbers.
Trees are held exactly, floats within ``kernels.trip.float_tolerances``
(rtol 1e-4).  Then the site likelihood at 16, 33 and 64 leaves (its
n - 1 passes equal the data-dependent loop bit for bit), valid initial
trees, ``run_chunk`` at n=16 against JAX's statistically (with and
without ``-alpha``), and ``em.refuse_caps`` over every wide and narrow
path.  The ``cuda`` tests
hold the wide kernels to the plain version in float64 on the card and
skip here.

JAX is imported on use, so that the ``cuda`` tests also run where only
torch is installed (``pytest --noconftest -m cuda tests/test_torch_wide.py``).
"""

import numpy as np
import pytest
import torch

from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.demography import Demography as TDemography
from smcsmc_tpu_torch.kernels import likelihood as tlik
from smcsmc_tpu_torch.kernels import tree as ttree
from smcsmc_tpu_torch.kernels import trip as ttrip

torch.set_num_threads(1)

MU, RHO, NE = 1e-8, 1e-9, 10000.0
L_SEG = 20000.0
CPU = torch.device("cpu")


def _jax():
    import jax
    import jax.numpy as jnp

    from smcsmc_tpu import em as jem
    from smcsmc_tpu import smc as jsmc
    from smcsmc_tpu.demography import Demography
    from smcsmc_tpu.kernels import transition as jtr
    from smcsmc_tpu.kernels import tree as jtree

    return jax, jnp, jem, jsmc, Demography, jtr, jtree


def _change(E):
    """The -P 133 133016 grid of E epochs."""
    return np.concatenate(
        [[0.0], np.logspace(np.log10(133.0), np.log10(133016.0), E - 1)])


def _demo(cls, n, E=9, L=2e5):
    return cls(change_times=_change(E), pop_sizes=np.full((E, 1), NE),
               mig_rates=np.zeros((E, 1, 1)),
               sample_pops=np.zeros(n, np.int32), mutation_rate=MU,
               recombination_rate=RHO, sequence_length=L)


def _has_data(n, leaf_status):
    hd = np.ones(n, bool)
    if leaf_status == 0:
        hd[0] = hd[n // 2] = False
    elif leaf_status == -1:
        hd[:] = False
    return hd


BIAS = (np.array([0.0, 2000.0, 3e38], np.float32),
        np.array([4.0, 1.0], np.float32))


def _jax_trip(n, P, leaf_status, biased, seed):
    """One trip of JAX's XLA twin on JAX's initial trees; returns the
    port's inputs, the uniforms that reproduce the twin's draws, and the
    expected outputs under the port's names."""
    jax, jnp, _, jsmc, Demography, jtr, jtree = _jax()
    demo = _demo(Demography, n)
    epochs = jtree.epochs_from_demography(demo)
    trees = jsmc.init_state(jax.random.PRNGKey(seed), epochs,
                            jsmc.PFConfig(num_particles=P, num_leaves=n),
                            demo.sample_pops, RHO).trees
    hd = _has_data(n, leaf_status)
    ls = jnp.int8(leaf_status)
    tl, tle, B = jsmc._tree_summaries(trees, epochs, ls, jnp.asarray(hd))
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), P)
    bias = (dict(bias_heights=jnp.asarray(BIAS[0]),
                 bias_strengths=jnp.asarray(BIAS[1])) if biased else {})
    new, rec = jax.jit(lambda k, t: jtr.recombination_transition(
        k, t, epochs, jnp.ones(P, bool), **bias))(keys, trees)
    tl2, tle2, B2 = jsmc._tree_summaries(new, epochs, ls, jnp.asarray(hd))

    # the uniforms behind the twin's draws (recombination_transition splits
    # each key into the point's and the walk's; _walk_fast splits the
    # walk's into the hazard's and the target's)
    def unif(k):
        return jax.random.uniform(k, (), minval=1e-7, maxval=1.0 - 1e-7)

    split = jax.vmap(jax.random.split)(keys)
    u_pt = np.asarray(jax.vmap(unif)(split[:, 0]))
    u_exp = np.asarray(jax.vmap(lambda k: unif(jax.random.split(k)[0]))(
        split[:, 1]))
    time, parent = np.asarray(trees.time), np.asarray(trees.parent)
    pt = np.where(parent < 0, np.float32(3e38),
                  np.take_along_axis(time, np.maximum(parent, 0), 1))
    t_c, d = np.asarray(rec.coal_height), np.asarray(rec.d_node)
    cross = (time <= t_c[:, None]) & (t_c[:, None] < pt)
    kc = cross.sum(1)
    rank = (np.cumsum(cross, 1) - 1)[np.arange(P), d]
    u_tgt = (rank + 0.5) / np.maximum(kc, 1)
    rng = np.random.default_rng(seed)
    u_gap = rng.uniform(size=P)
    u = np.stack([u_pt, u_exp, u_tgt, u_gap], 1).astype(np.float32)[None]

    E = epochs.num_epochs
    nr = rng.uniform(0.0, 0.9 * L_SEG, P).astype(np.float32)
    lw = rng.normal(size=P).astype(np.float32)
    inp = dict(time=time, parent=parent, child0=np.asarray(trees.child0),
               child1=np.asarray(trees.child1), next_rec=nr,
               upd=np.zeros(P, np.float32), log_w=lw, tl=np.asarray(tl),
               B=np.asarray(B), tl_e=np.asarray(tle),
               pending=np.zeros((P, 6 * E), np.float32))
    tl2 = np.asarray(tl2)
    gap = (-np.log1p(-u_gap.astype(np.float32))
           / (np.float32(RHO) * tl2)).astype(np.float32)
    ref = dict(time=np.asarray(new.time), parent=np.asarray(new.parent),
               child0=np.asarray(new.child0), child1=np.asarray(new.child1),
               next_rec=nr + gap, upd=nr,
               log_w=lw - np.float32(MU) * np.asarray(B) * nr,
               tl=tl2, B=np.asarray(B2), tl_e=np.asarray(tle2),
               pending=np.concatenate([
                   np.asarray(rec.coal_opp)[:, :, 0],
                   np.asarray(rec.coal_cnt)[:, :, 0],
                   np.asarray(rec.mig_opp)[:, :, 0], np.zeros((P, E)),
                   nr[:, None] * np.asarray(tle),
                   np.asarray(rec.recomb_cnt)], 1).astype(np.float32))
    return demo, hd, u, inp, ref, rec


@pytest.mark.parametrize("n,leaf_status,biased", [
    (16, 1, False), (16, 0, False), (16, -1, False),
    (64, 1, False), (64, 0, False), (64, -1, False),
    (16, 1, True), (16, 0, True)])
def test_wide_trip_matches_the_jax_xla_twin(n, leaf_status, biased):
    """The port's plain trip (the biased point with ``biased``) at 16 and
    64 leaves against one trip of JAX's XLA twin on the twin's uniforms:
    trees equal, floats within ``float_tolerances``; the biased trip's
    importance weight and section strength too."""
    P = 48 if n == 16 else 24
    demo, hd, u, inp, ref, rec = _jax_trip(n, P, leaf_status, biased,
                                           seed=n + 3 * leaf_status + biased)
    ep = ttree.epochs_from_demography(demo, CPU)
    est = ep.start
    eend = torch.cat([est[1:], est.new_full((1,), ttree.INF)])
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    f32 = (lambda x: torch.tensor(x, dtype=torch.float32))  # noqa: E731
    outs, trec = ttrip._trip(
        torch.from_numpy(u[0]), leaf_status, *(t[k] for k in ttrip.FIELDS),
        f32(L_SEG), f32(MU), f32(RHO), est, eend, ep.inv2ne,
        torch.from_numpy(hd),
        bias=tuple(torch.from_numpy(x) for x in BIAS) if biased else None)
    got = dict(zip(ttrip.FIELDS, outs))
    refs = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    trees_d, floats_d, errs = ttrip.disagreement(got, refs, L_SEG, MU, 1e-4)
    assert not trees_d.any(), int(trees_d.sum())
    assert not floats_d.any(), errs
    moved = (got["parent"] != t["parent"]).any(1)
    assert int(moved.sum()) > P // 4
    if biased:
        np.testing.assert_array_equal(trec.strength.numpy(),
                                      np.asarray(rec.point_strength))
        np.testing.assert_allclose(trec.log_iw.numpy(),
                                   np.asarray(rec.log_iw), rtol=1e-5,
                                   atol=1e-5)


def test_wide_biased_point_matches_jax():
    """``bias.biased_point`` at 16 leaves against
    ``_sample_recomb_point_biased`` on the same uniforms: node and section
    exactly, height within a few ulp of the weighted tree length."""
    from smcsmc_tpu_torch.kernels.bias import biased_point

    jax, jnp, _, jsmc, Demography, jtr, jtree = _jax()
    P, n = 128, 16
    demo = _demo(Demography, n)
    st = jsmc.init_state(jax.random.PRNGKey(5),
                         jtree.epochs_from_demography(demo),
                         jsmc.PFConfig(num_particles=P, num_leaves=n),
                         demo.sample_pops, RHO)
    bh = np.array([0.0, 500.0, 5000.0, 3e38], np.float32)
    bs = np.array([8.0, 2.5, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), P)
    c, h_r, log_iw, s, _ = jax.vmap(
        lambda k, t, p: jtr._sample_recomb_point_biased(
            k, t, p, jnp.asarray(bh), jnp.asarray(bs)))(
        keys, st.trees.time, st.trees.parent)
    u = jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=1e-7, maxval=1.0 - 1e-7))(keys)
    got = biased_point(torch.from_numpy(np.array(u)),
                       torch.from_numpy(np.array(st.trees.time)),
                       torch.from_numpy(np.array(st.trees.parent)),
                       torch.from_numpy(bh), torch.from_numpy(bs))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(c))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(s))
    N = st.trees.time.shape[1]
    ulps = 1e-7 * N * float(np.max(st.trees.time)) * float(bs.max())
    np.testing.assert_allclose(got[1].numpy(), np.asarray(h_r), rtol=1e-5,
                               atol=ulps)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(log_iw),
                               rtol=1e-5, atol=1e-5)
    assert len(np.unique(np.asarray(s))) == len(bs)


def _jax_trees(n, P, seed):
    jax, _, _, jsmc, Demography, _, jtree = _jax()
    demo = _demo(Demography, n)
    return jsmc.init_state(jax.random.PRNGKey(seed),
                           jtree.epochs_from_demography(demo),
                           jsmc.PFConfig(num_particles=P, num_leaves=n),
                           demo.sample_pops, RHO).trees


@pytest.mark.parametrize("n", [16, 33, 64])
def test_wide_site_likelihood_matches_jax(n):
    """The site likelihood at 16, 33 and 64 leaves against the JAX
    package's, with the tolerance of tests/test_torch_likelihood.py, whose
    atol linearises a one-ulp difference of 1 - exp(-mu t) in the two
    packages' ``exp``.  At 64 leaves the youngest branches are about 10
    generations long, so at mu = 1e-8 1 - exp(-mu t) is one or two ulps of
    1 and rounds to 0 in one package where it does not in the other (a
    site reads -790.17 in JAX and -204.01 in the port where float64 reads
    -204.81); there the rates are 1e-6 and 2e-5, where it spans hundreds
    of ulps."""
    from smcsmc_tpu.kernels.likelihood import site_log_likelihood

    from smcsmc_tpu_torch.convert import trees_from_numpy

    jax, jnp, _, _, _, _, jtree = _jax()
    P = 32
    jt = _jax_trees(n, P, seed=n)
    tt = trees_from_numpy(jax.tree_util.tree_map(np.asarray, jt), CPU)
    bl = np.asarray(jax.vmap(jtree.branch_lengths)(jt.time, jt.parent),
                    np.float64)
    rng = np.random.default_rng(n)
    sll = jax.jit(site_log_likelihood, static_argnames=("ancestral_aware",))
    for mu in ((1e-8, 2e-5) if n < 64 else (1e-6, 2e-5)):
        inv = np.where(bl > 0, 1.0 / -np.expm1(-mu * np.maximum(bl, 1e-30)),
                       0.0)
        atol = 1e-5 + 4 * 2.0 ** -24 * inv.sum(axis=1)
        for aware in (False, True):
            alleles = rng.choice([0, 1, -1], size=n,
                                 p=[0.45, 0.35, 0.2]).astype(np.int8)
            ref = np.asarray(sll(jt, jnp.asarray(alleles), jnp.float32(mu),
                                 ancestral_aware=aware))
            got = tlik.site_log_likelihood(tt, torch.from_numpy(alleles), mu,
                                           aware).numpy()
            assert np.all(np.abs(got - ref) <= 1e-5 * np.abs(ref) + atol), (
                np.max(np.abs(got - ref) - 1e-5 * np.abs(ref) - atol))


def _prune_until_ready(trees, al, mutation_rate, prior):
    """The port's pruning as it was above 8 leaves before the passes were
    fixed at n - 1: stop once every node is ready (a host read per pass)."""
    time, parent, c0, c1 = trees.time, trees.parent, trees.child0, trees.child1
    P, N = time.shape
    n = (N + 1) // 2
    al = al.to(torch.int32)
    C = al.shape[0]
    mu = torch.tensor(mutation_rate, dtype=torch.float32)
    prior = torch.tensor(prior, dtype=torch.float32)
    l0 = torch.where(al == 1, 0.0, 1.0)
    l1 = torch.where(al == 0, 0.0, 1.0)
    pad = torch.zeros((C, n - 1))
    leaf_part = torch.stack([torch.cat([l0, pad], 1), torch.cat([l1, pad], 1)],
                            2)
    partial = leaf_part[:, None].expand(C, P, N, 2)
    is_leaf = c0 < 0
    ready = is_leaf
    i0, i1 = c0.clamp(min=0).long(), c1.clamp(min=0).long()
    has0, has1 = c0 >= 0, c1 >= 0
    zero = torch.zeros_like(time)
    t0 = time - torch.where(has0, time.gather(1, i0), zero)
    t1 = time - torch.where(has1, time.gather(1, i1), zero)
    p0 = torch.exp(-t0 * mu)[:, :, None]
    p1 = torch.exp(-t1 * mu)[:, :, None]
    idx0 = i0[None, :, :, None].expand(C, P, N, 2)
    idx1 = i1[None, :, :, None].expand(C, P, N, 2)
    acc = torch.zeros((C, P))
    for _ in range(n):
        if not bool((~ready).any()):
            break
        zp = torch.zeros_like(partial)
        a0 = torch.where(has0[:, :, None], partial.gather(2, idx0), zp)
        a1 = torch.where(has1[:, :, None], partial.gather(2, idx1), zp)
        r0 = has0 & ready.gather(1, i0)
        r1 = has1 & ready.gather(1, i1)
        can = ~ready & ~is_leaf & r0 & r1
        m0 = a0 * p0 + a0.flip(-1) * (1.0 - p0)
        m1 = a1 * p1 + a1.flip(-1) * (1.0 - p1)
        val = m0 * m1
        sc = torch.maximum(val[..., 0], val[..., 1]).clamp(min=1e-30)
        partial = torch.where(can[:, :, None], val / sc[..., None], partial)
        acc = acc + torch.where(can, torch.log(sc), torch.zeros_like(sc)).sum(2)
        ready = ready | can
    root = (parent < 0)[:, :, None]
    root_part = torch.where(root, partial, torch.zeros_like(partial)).sum(2)
    return root_part[..., 0] * prior[0] + root_part[..., 1] * prior[1], acc


@pytest.mark.parametrize("n", [9, 16, 33, 64])
def test_fixed_passes_equal_the_data_dependent_loop(n):
    """n - 1 pruning passes with no host read give what the loop that stops
    once every node is ready gave, bit for bit: a pass after that changes
    nothing."""
    gen = torch.Generator().manual_seed(n)
    ep = ttree.epochs_from_demography(_demo(TDemography, n), CPU)
    trees = ttree.make_initial_trees(gen, ep, 48, np.zeros(n, np.int32))
    al = torch.from_numpy(np.random.default_rng(n).choice(
        [0, 1, -1], size=(3, n), p=[0.45, 0.35, 0.2]).astype(np.int8))
    for prior in ((0.5, 0.5), (1.0, 0.0)):
        for mu in (1e-8, 2e-5):
            got = tlik._prune(trees, al, mu, prior)
            ref = _prune_until_ready(trees, al, mu, prior)
            for g, r in zip(got, ref):
                assert torch.equal(g, r)


def _valid(trees):
    par, t = trees.parent.numpy(), trees.time.numpy()
    c0, c1 = trees.child0.numpy(), trees.child1.numpy()
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


@pytest.mark.parametrize("n", [16, 64])
def test_make_initial_trees_are_valid_wide(n):
    """Initial trees at 16 and 64 leaves: one root, parents above their
    children, the child pointers the parents' inverse; the leaves' mean
    time to the root within 10% of JAX's sampler's."""
    gen = torch.Generator().manual_seed(n)
    ep = ttree.epochs_from_demography(_demo(TDemography, n), CPU)
    trees = ttree.make_initial_trees(gen, ep, 512, np.zeros(n, np.int32))
    _valid(trees)
    jt = _jax_trees(n, 512, seed=n)
    assert float(trees.time.max(dim=1).values.mean()) == pytest.approx(
        float(np.asarray(jt.time).max(axis=1).mean()), rel=0.1)


def _wide_run_chunks(alpha=0.0):
    """``run_chunk`` of both packages at n=16 (P=64, 100 kb, seeds 1-4),
    with ``-alpha`` where given: {"jax": [...], "torch": [...]}."""
    from smcsmc_tpu_torch.simulate import simulate_seg

    _, _, jem, _, Demography, _, _ = _jax()
    E = 8
    kw = dict(change_times=np.concatenate([[0.0], np.logspace(2.5, 5.0,
                                                              E - 1)]),
              pop_sizes=np.full((E, 1), NE), mig_rates=np.zeros((E, 1, 1)),
              sample_pops=np.zeros(16, np.int32), mutation_rate=MU,
              recombination_rate=RHO, sequence_length=1e5)
    jd, td = Demography(**kw), TDemography(**kw)
    seg = simulate_seg(td, seed=5)
    res = {"jax": [], "torch": []}
    for s in (1, 2, 3, 4):
        res["jax"].append(jem.run_chunk(
            jd, seg, jem.EMConfig(num_particles=64, block_size=512,
                                  alpha=alpha), seed=s))
        res["torch"].append(tem.run_chunk(
            td, seg, tem.EMConfig(num_particles=64, device="cpu",
                                  alpha=alpha), seed=s))
    return res


def _check_run_chunk_bands(res):
    """The mean log-likelihood within three standard errors of the
    difference of the two means, the pooled coalescence Ne within 30% and
    the recombination rate within 50%."""
    summary = {}
    for side, runs in res.items():
        logl = np.array([r[2] for r in runs])
        assert np.all(np.isfinite(logl) & (logl < 0))
        summary[side] = (
            logl.mean(), logl.var(ddof=1) / len(logl),
            sum(r[0].coal_opp.sum() for r in runs)
            / (2.0 * sum(r[0].coal_cnt.sum() for r in runs)),
            sum(r[0].recomb_cnt.sum() for r in runs)
            / sum(r[0].recomb_opp.sum() for r in runs))
    (lj, vj, nj, rj), (lt, vt, nt, rt) = summary["jax"], summary["torch"]
    assert abs(lt - lj) <= 3.0 * np.sqrt(vj + vt), summary
    assert nt == pytest.approx(nj, rel=0.3), summary
    assert rt == pytest.approx(rj, rel=0.5), summary


def test_wide_run_chunk_agrees_with_jax():
    """``run_chunk`` at n=16 (P=64, 100 kb, four seeds each) against
    JAX's: the mean log-likelihood within three standard errors of the
    difference of the two means (at this size one seed's LogL spreads by
    about 7% either way, against under 1% at n=4), the pooled coalescence
    Ne within 30% and the recombination rate within 50%, as
    tests/test_torch_bias.py holds the biased sweep."""
    _check_run_chunk_bands(_wide_run_chunks())


def test_wide_run_chunk_with_alpha_agrees_with_jax():
    """``run_chunk`` at n=16 with ``-alpha 0.5`` (the local pass, which
    records each trip's event for the windows of ``.recomb.gz``) against
    JAX's, in the bands of :func:`test_wide_run_chunk_agrees_with_jax`;
    the windows' summed leaf counts, pooled over the seeds, within 50% of
    JAX's, and every one of the 16 leaf columns counted."""
    res = _wide_run_chunks(alpha=0.5)
    _check_run_chunk_bands(res)
    leaf = {side: sum(r[3]["local_recomb"]["leaf_cnt"] for r in runs)
            for side, runs in res.items()}
    assert leaf["torch"].shape == leaf["jax"].shape == (1000, 16)
    assert np.all(leaf["torch"].sum(axis=0) > 0)
    assert leaf["torch"].sum() == pytest.approx(leaf["jax"].sum(), rel=0.5)


# ---------------------------------------------------------------------------
# em.refuse_caps: the wide kernels take the plain and biased paths
# ---------------------------------------------------------------------------

PATHS = {
    "plain": {}, "vb": dict(vb=True),
    "biased": dict(bias_heights=(2000.0,), calibrate_lag=True),
    "chunks": dict(chunks=4, dephase=True),
    "migration": "structured", "guide": dict(guide_file="g.gz"),
    "alpha": dict(alpha=0.5), "apf": dict(apf=2)}
NARROW_ONLY = ("migration", "apf")


def _refuse_demo(n, path):
    E, Pp = 9, 2 if path == "migration" else 1
    mig = np.full((E, Pp, Pp), 1e-5 if Pp > 1 else 0.0)
    return TDemography(
        change_times=_change(E), pop_sizes=np.full((E, Pp), NE),
        mig_rates=mig, sample_pops=(np.arange(n) % Pp).astype(np.int32),
        mutation_rate=MU, recombination_rate=RHO, sequence_length=1e5)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("n", [8, 9, 16, 64, 65])
def test_refuse_caps_wide_and_narrow(n, path, device):
    """On the card: up to 8 haplotypes every path runs; from 9 to 64 the
    plain, biased, guided and local paths (with -vb, calibrated lags,
    chunks, -guide, -alpha) run and migration and -apf are refused by
    name; above 64 every path is refused at WIDE_MAX_LEAVES.  The CPU runs
    every size.  Nothing here touches a card."""
    opts = PATHS[path]
    cfg = tem.EMConfig(device=device, **(opts if isinstance(opts, dict)
                                         else {}))
    demo = _refuse_demo(n, path)
    if device == "cpu" or n <= 8 or (n <= 64 and path not in NARROW_ONLY):
        tem.refuse_caps(demo, cfg)
        return
    if n > 64 and path not in NARROW_ONLY:
        match = r"65 haplotypes on the card.*at most 64 \(WIDE_MAX_LEAVES\)"
    else:
        what = {"migration": "several populations or migration",
                "apf": "-apf"}[path]
        match = rf"{n} haplotypes with {what} on the card.*at most 8 " \
            r"\(MAX_LEAVES\)"
    with pytest.raises(NotImplementedError, match=match):
        tem.refuse_caps(demo, cfg)


def test_segment_pass_refuses_the_narrow_only_variants_above_8():
    """The wrappers' caps: above 8 leaves the migration pass and its
    variants and the biased ARG pass are refused by name before any CUDA
    call, and the guided and local passes (which have wide forms) are not;
    65 leaves by everything."""
    with pytest.raises(ValueError, match="migration kernel supports 2..8"):
        ttrip._check_caps(17, 9, 2, 8, "migration")
    with pytest.raises(ValueError, match="migration guided local kernel "
                                         "supports 2..8"):
        ttrip._check_caps(17, 9, variant=ttrip.narrow_variant(
            True, True, True, True))
    with pytest.raises(ValueError, match="biased ARG kernel supports 2..8"):
        ttrip._check_caps(17, 9, variant=ttrip.narrow_variant(
            biased=True, arg=True))
    for flags in (dict(biased=True, guide=True), dict(local=True),
                  dict(biased=True, local=True),
                  dict(biased=True, guide=True, local=True)):
        assert ttrip.narrow_variant(**flags) is None
        assert ttrip._check_caps(127, 9,
                                 variant=ttrip.narrow_variant(**flags)) == 64
    with pytest.raises(ValueError, match="trip kernel supports 2..64"):
        ttrip._check_caps(129, 9)
    assert ttrip._check_caps(127, 64) == 64
    assert ttrip.launch_count(wide=True) == "wide_launches"
    assert ttrip.launch_count(True, vb=True, wide=True) in ttrip.LAUNCH_COUNTS


# ---------------------------------------------------------------------------
# on the card: the wide kernels against the plain version in float64
# ---------------------------------------------------------------------------


def _double(x):
    return x.double() if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("n,E", [(16, 9), (17, 9), (64, 9), (64, 64)])
def test_cuda_wide_segment_pass_matches_plain(n, E, biased):
    """The wide plain and biased passes on the card against the plain
    version run in float64 on the same inputs: one trip with no tree
    mismatch and every float within ``float_tolerances``; 64 trips with at
    most 0.1% of the particles apart; the wide count moves, the narrow
    one does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smcsmc_tpu_torch.kernels.bias import BiasedPass

    dev = torch.device("cuda")
    Pc = 1001 if E == 64 else 2001
    gen = torch.Generator(device=dev).manual_seed(n + E)
    ep = ttree.epochs_from_demography(_demo(TDemography, n, E), dev)
    trees = ttree.make_initial_trees(gen, ep, Pc, np.zeros(n, np.int32))
    hd = torch.from_numpy(_has_data(n, 0)).to(dev)
    start, inv2ne = ep.start.contiguous(), ep.inv2ne.contiguous()
    mask = (torch.rand(6 * E, generator=gen, device=dev) < 0.7).float()
    bh, bs = (torch.from_numpy(x).to(dev) for x in BIAS)
    delays = torch.linspace(3000.0, 30000.0, E, device=dev)
    for T, L, nr_scale in ((1, 20000.0, 1.5), (64, 50000.0, 0.1)):
        used = torch.rand((Pc, 32), generator=gen, device=dev) < 0.3
        base = dict(time=trees.time, parent=trees.parent,
                    child0=trees.child0, child1=trees.child1,
                    next_rec=torch.rand(Pc, generator=gen, device=dev)
                    * nr_scale * L,
                    log_w=torch.zeros(Pc, device=dev),
                    fifo=torch.zeros((Pc, 4, 6 * E), device=dev),
                    tl=torch.empty(Pc, device=dev),
                    log_pilot=torch.zeros(Pc, device=dev),
                    df_pos=torch.where(used, 1e4 + 2 * L * torch.rand(
                        (Pc, 32), generator=gen, device=dev), ttree.INF),
                    df_logf=torch.where(used, 0.5, 0.0),
                    df_delta=torch.where(used, 1000.0, 0.0),
                    df_k=torch.where(used, 2, 0).to(torch.int32))
        u = torch.rand((T, Pc, 4), generator=gen, device=dev)
        outs = {}
        for name, fn, conv in (("kernel", ttrip.segment_pass, lambda x: x),
                               ("plain", ttrip.segment_pass_plain, _double)):
            st = {k: conv(v.clone().contiguous()) for k, v in base.items()}
            b = (BiasedPass(st["log_pilot"], st["df_pos"], st["df_logf"],
                            st["df_delta"], st["df_k"], conv(bh), conv(bs),
                            conv(delays), 1e4) if biased else None)
            counts = (ttrip.segment_pass.launches,
                      getattr(ttrip.segment_pass, ttrip.launch_count(
                          biased, wide=True)))
            fn(conv(u), 0, *(st[k] for k in ("time", "parent", "child0",
                                             "child1", "next_rec", "log_w")),
               st["fifo"], conv(mask), st["tl"], L, MU, RHO, conv(start),
               conv(inv2ne), hd, b)
            after = (ttrip.segment_pass.launches,
                     getattr(ttrip.segment_pass, ttrip.launch_count(
                         biased, wide=True)))
            assert after == (counts[0], counts[1] + (name == "kernel"))
            keys = ("time", "parent", "child0", "child1", "next_rec",
                    "log_w") + (ttrip.BIAS_FIELDS if biased else ())
            outs[name] = dict({k: st[k] for k in keys}, tl=st["tl"],
                              pending=st["fifo"][:, 0])
        torch.cuda.synchronize()
        ref = {k: v.float() if v.dtype == torch.float64 else v
               for k, v in outs["plain"].items()}
        trees_d, floats_d, errs = ttrip.disagreement(outs["kernel"], ref, L,
                                                     MU)
        if T == 1:
            assert not trees_d.any() and not floats_d.any(), errs
        else:
            assert int((trees_d | floats_d).sum()) <= 0.001 * Pc, errs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 17, 64])
def test_cuda_wide_trip_matches_plain(n):
    """The wide ``trip`` on the card against ``trip_plain`` in float64,
    one trip and 64; 64 trips in one launch equal 64 launches of one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    Pc, E, L = 2001, 9, 50000.0
    gen = torch.Generator(device=dev).manual_seed(n)
    ep = ttree.epochs_from_demography(_demo(TDemography, n, E), dev)
    trees = ttree.make_initial_trees(gen, ep, Pc, np.zeros(n, np.int32))
    hd = torch.ones(n, dtype=torch.bool, device=dev)
    tl, tle, B = ttree.tree_summaries(trees, ep, 1, hd)
    base = dict(time=trees.time, parent=trees.parent, child0=trees.child0,
                child1=trees.child1,
                next_rec=torch.rand(Pc, generator=gen, device=dev) * 0.1 * L,
                upd=torch.zeros(Pc, device=dev),
                log_w=torch.zeros(Pc, device=dev), tl=tl, B=B, tl_e=tle,
                pending=torch.zeros((Pc, 6 * E), device=dev))
    start, inv2ne = ep.start.contiguous(), ep.inv2ne.contiguous()
    for T in (1, 64):
        u = torch.rand((T, Pc, 4), generator=gen, device=dev)
        got = {k: v.clone().contiguous() for k, v in base.items()}
        wide = ttrip.trip.wide_launches
        ttrip.trip(u, 1, *(got[k] for k in ttrip.FIELDS), L, MU, RHO, start,
                   inv2ne, hd)
        assert ttrip.trip.wide_launches == wide + 1
        ref = {k: _double(v.clone()) for k, v in base.items()}
        ttrip.trip_plain(u.double(), 1, *(ref[k] for k in ttrip.FIELDS), L,
                         MU, RHO, start.double(), inv2ne.double(), hd)
        torch.cuda.synchronize()
        ref = {k: v.float() if v.dtype == torch.float64 else v
               for k, v in ref.items()}
        trees_d, floats_d, errs = ttrip.disagreement(got, ref, L, MU)
        if T == 1:
            assert not trees_d.any() and not floats_d.any(), errs
        else:
            assert int((trees_d | floats_d).sum()) <= 0.001 * Pc, errs
            seq = {k: v.clone().contiguous() for k, v in base.items()}
            for j in range(T):
                ttrip.trip(u[j:j + 1].contiguous(), 1,
                           *(seq[k] for k in ttrip.FIELDS), L, MU, RHO,
                           start, inv2ne, hd)
            assert all(torch.equal(got[k], seq[k]) for k in ttrip.FIELDS)
