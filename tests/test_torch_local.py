"""The port's local recombination recording (the windows behind
``.recomb.gz``) and its guided step against the JAX package, on the CPU.

- ``descendant_bitmask``: JAX's 32-bit and 64-bit bitmasks as one int64,
  exactly (n = 4, 8, 40).
- The ring: ``push_local_event`` equal to JAX's ``_push_local_event`` (a
  ring full, one empty, one with a free slot among used ones), counts of
  dropped events included; ``add_window_opportunity`` (one window,
  several, a span ending on a window edge, the last window) and
  ``commit_due_local`` within rtol 1e-6 of JAX's (at 64 leaves too, leaf
  63 the int64's sign bit); ``flush_pending`` commits every pending
  event.
- ``state_from_numpy`` / ``state_to_numpy`` carry JAX's ``win_*`` and
  ``lr_*`` there and back; the mid-sweep checkpoint keeps them.
- One step with a chain of trips against JAX's XLA step with
  ``use_guide`` and ``num_windows`` > 0, its transitions the port's on the
  port's uniforms (through ``jax.pure_callback``, as
  tests/test_torch_vb.py does): (guide, bias), (guide, no bias), (local,
  plain), (guide, local, bias, VB) at n=4, and (guide, bias), (local,
  plain), (guide, local, bias, VB) at n=16 and 33 (at mu 1e-6 there: at
  1e-8 the float32 site likelihood of young branches parts the two
  packages, ROADMAP section 3).  log_w and log_pilot within rtol 1e-5
  and atol 1e-5; next_rec within rtol 1e-5; trees equal; the ring's slots
  in use and counts equal, its floats within rtol 1e-5; window
  accumulators within rtol 1e-5; the FIFO within rtol 1e-5, its
  recombination opportunity (guided positions carry ulps of themselves)
  within ``float_tolerances``' atol for it.
- The ``.recomb.gz`` of a run has JAX's ``write_recomb`` columns and window
  count for the same accumulators.
"""

import gzip
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smcsmc_tpu import em as jem
from smcsmc_tpu import smc as jsmc
from smcsmc_tpu.demography import Demography as JDemography
from smcsmc_tpu.kernels import tree as jtree
from smcsmc_tpu.kernels.tree import epochs_from_demography as j_epochs
from smcsmc_tpu.recombio import write_recomb as j_write_recomb
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch import smc as tsmc
from smcsmc_tpu_torch.checkpoint import load_state, save_state
from smcsmc_tpu_torch.convert import (
    desc_words_to_int64,
    segment_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from smcsmc_tpu_torch.demography import Demography as TDemography
from smcsmc_tpu_torch.kernels import guide as tguide
from smcsmc_tpu_torch.kernels import likelihood as tlik
from smcsmc_tpu_torch.kernels import local as tlocal
from smcsmc_tpu_torch.kernels import trip as ttrip
from smcsmc_tpu_torch.kernels.tree import INF, descendant_bitmask
from smcsmc_tpu_torch.kernels.tree import epochs_from_demography as t_epochs
from smcsmc_tpu_torch.simulate import simulate_seg

torch.set_num_threads(1)

MU, RHO = 1e-8, 1e-9
P = 64


def _demo(cls, E=4, n=4, L=1e5):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(3.2, 4.5, E - 1)]))
    return cls(change_times=change, pop_sizes=np.full((E, 1), 10000.0),
               mig_rates=np.zeros((E, 1, 1)),
               sample_pops=np.zeros(n, np.int32), mutation_rate=MU,
               recombination_rate=RHO, sequence_length=L)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [4, 8, 40])
def test_descendant_bitmask_equals_jax(n):
    st = jsmc.init_state(jax.random.PRNGKey(n), j_epochs(_demo(JDemography,
                                                                n=n)),
                         jsmc.PFConfig(num_particles=32, num_leaves=n),
                         np.zeros(n, np.int32), RHO)
    tr = jax.tree_util.tree_map(np.asarray, st.trees)
    if n <= 32:
        ref = jax.vmap(lambda t, p: jtree.descendant_bitmask(None, t, p))(
            tr.time, tr.parent)
        words = np.asarray(ref)[..., None]
    else:
        lo, hi = jax.vmap(lambda t, p: jtree.descendant_bitmask64(None, t, p)
                          )(tr.time, tr.parent)
        words = np.stack([np.asarray(lo), np.asarray(hi)], axis=-1)
    got = descendant_bitmask(_t(tr.parent)).numpy()
    np.testing.assert_array_equal(got, desc_words_to_int64(words))
    root = np.asarray(tr.parent) < 0
    assert (got[root] == (1 << n) - 1).all()


def _ring(rng, front, R=8, case="mixed", n=4):
    """A ring of pending events [P, R]: some slots free, some due soon;
    the leaves below in JAX's words (two above 32 leaves, the last leaf
    below half of the cuts)."""
    used = {"mixed": rng.uniform(size=(P, R)) < 0.5,
            "full": np.ones((P, R), bool),
            "empty": np.zeros((P, R), bool)}[case]
    if case == "mixed":
        used[: P // 4] = True  # full rings among them
    pos = np.where(used, rng.uniform(front - 2e4, front, (P, R)), INF)
    due = np.where(used, pos + rng.uniform(0.0, 3e4, (P, R)), INF)
    time = np.where(used, rng.uniform(10.0, 5e4, (P, R)), 0.0)
    if n <= 32:
        desc = np.where(used, rng.integers(1, 1 << n, (P, R)), 0)
        words = desc.astype(np.uint32)[..., None]
    else:
        lo = rng.integers(0, 1 << 32, (P, R), dtype=np.uint64)
        hi = rng.integers(1, 1 << (n - 32), (P, R), dtype=np.uint64)
        top = np.uint64(1 << (n - 33))
        hi = np.where(rng.uniform(size=(P, R)) < 0.5, hi | top, hi & ~top)
        words = np.stack([np.where(used, lo, 0), np.where(used, hi, 0)],
                         axis=-1).astype(np.uint32)
    return (pos.astype(np.float32), due.astype(np.float32),
            time.astype(np.float32), words)


@pytest.mark.parametrize("case", ["mixed", "full", "empty"])
def test_push_local_event_equals_jax(case):
    rng = np.random.default_rng(3)
    pos, due, time, desc = _ring(rng, 5e4, case=case)
    mask = rng.uniform(size=P) < 0.7
    e_pos = rng.uniform(5e4, 6e4, P).astype(np.float32)
    e_due = (e_pos + 1000.0).astype(np.float32)
    e_h = rng.uniform(1.0, 1e4, P).astype(np.float32)
    e_desc = rng.integers(1, 16, P).astype(np.uint32)
    ref = jsmc._push_local_event(
        tuple(jnp.asarray(x) for x in (pos, due, time, desc)) + (
            jnp.int32(5),), jnp.asarray(mask), jnp.asarray(e_pos),
        jnp.asarray(e_due), jnp.asarray(e_h), jnp.asarray(e_desc[:, None]))
    got = tlocal.push_local_event(
        _t(pos), _t(due), _t(time), _t(desc_words_to_int64(desc)),
        torch.tensor(5, dtype=torch.int32), _t(mask), _t(e_pos), _t(e_due),
        _t(e_h), _t(desc_words_to_int64(e_desc[:, None])))
    for k in range(3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_array_equal(got[3].numpy(),
                                  desc_words_to_int64(np.asarray(ref[3])))
    assert int(got[4]) == int(ref[4])
    if case == "full":
        assert int(got[4]) == 5 + mask.sum()


@pytest.mark.parametrize("x_start,x_end", [
    (1234.5, 1290.0),  # one window
    (1234.5, 1890.25),  # several
    (1200.0, 1500.0),  # on window edges
    (99_850.0, 100_000.0),  # the last window and the end
    (41_000.0, 41_100.0),  # exactly one window, edge to edge
])
def test_add_window_opportunity_matches_jax(x_start, x_end):
    W = 1000
    rng = np.random.default_rng(1)
    base = rng.uniform(-1.0, 1.0, W + 1).astype(np.float32)
    total = np.float32(37.75)
    ref = jsmc._add_window_opportunity(jnp.asarray(base),
                                       jnp.float32(x_start),
                                       jnp.float32(x_end), jnp.float32(total),
                                       100.0)
    got = _t(base)
    tlocal.add_window_opportunity(got, np.float32(x_start), np.float32(x_end),
                                  torch.tensor(total), 100.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert not np.array_equal(got.numpy(), base)


def _local_jax_state(rng, front, W=1000, n=4, R=8):
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=n, num_windows=W,
                        local_ring=R)
    st = jsmc.init_state(jax.random.PRNGKey(2),
                         j_epochs(_demo(JDemography, n=n)), cfg,
                         np.zeros(n, np.int32), RHO)
    pos, due, time, desc = _ring(rng, front, R, n=n)
    return st._replace(
        lr_pos=jnp.asarray(pos), lr_due=jnp.asarray(due),
        lr_time=jnp.asarray(time), lr_desc=jnp.asarray(desc),
        win_leaf_cnt=jnp.asarray(rng.uniform(0, 1, (W, n)), jnp.float32),
        win_time_cnt=jnp.asarray(rng.uniform(0, 1, W), jnp.float32),
        win_logtime_cnt=jnp.asarray(rng.uniform(0, 1, W), jnp.float32))


def test_commit_due_local_matches_jax():
    rng = np.random.default_rng(8)
    front = 5e4
    st = _local_jax_state(rng, front)
    w = rng.dirichlet(np.ones(P)).astype(np.float32)
    ref = jax.tree_util.tree_map(np.asarray, jsmc._commit_due_local(
        st, jnp.asarray(w), jnp.float32(front + 1e4), 100.0))
    got = state_from_numpy(jax.tree_util.tree_map(np.asarray, st), "cpu")
    tlocal.commit_due_local(got.win_cnt, got.lr_pos, got.lr_due, got.lr_time,
                            got.lr_desc, _t(w), front + 1e4, 100.0)
    out = state_to_numpy(got)
    for k in ("win_leaf_cnt", "win_time_cnt", "win_logtime_cnt"):
        np.testing.assert_allclose(out[k], getattr(ref, k), rtol=1e-6,
                                   err_msg=k)
        assert not np.array_equal(out[k], getattr(st, k)), k
    for k in ("lr_pos", "lr_due"):
        np.testing.assert_array_equal(out[k], getattr(ref, k))
    assert (out["lr_pos"] < INF).sum() < (np.asarray(st.lr_pos) < INF).sum()


def test_commit_due_local_matches_jax_at_64_leaves():
    """At 64 leaves the leaves below a cut are JAX's two words, one int64
    in the port: leaf 63 is its sign bit, and the commit counts it as leaf
    63 (its column of the window accumulators) where it lies below a
    cut."""
    rng = np.random.default_rng(12)
    front, n = 5e4, 64
    st = _local_jax_state(rng, front, n=n)
    w = rng.dirichlet(np.ones(P)).astype(np.float32)
    at = front + 1e4
    desc = desc_words_to_int64(np.asarray(st.lr_desc))
    due = (np.asarray(st.lr_due) <= at) & (np.asarray(st.lr_pos) < INF)
    assert (desc[due] < 0).any() and (desc[due] > 0).any()
    ref = jax.tree_util.tree_map(np.asarray, jsmc._commit_due_local(
        st, jnp.asarray(w), jnp.float32(at), 100.0))
    got = state_from_numpy(jax.tree_util.tree_map(np.asarray, st), "cpu")
    tlocal.commit_due_local(got.win_cnt, got.lr_pos, got.lr_due, got.lr_time,
                            got.lr_desc, _t(w), at, 100.0)
    out = state_to_numpy(got)
    for k in ("win_leaf_cnt", "win_time_cnt", "win_logtime_cnt"):
        np.testing.assert_allclose(out[k], getattr(ref, k), rtol=1e-6,
                                   err_msg=k)
    moved = out["win_leaf_cnt"] != np.asarray(st.win_leaf_cnt)
    assert moved[:, n - 1].any() and moved[:, 0].any()
    for k in ("lr_pos", "lr_due"):
        np.testing.assert_array_equal(out[k], getattr(ref, k))


def test_flush_pending_commits_every_event():
    rng = np.random.default_rng(9)
    st = _local_jax_state(rng, 5e4)
    ref = jax.tree_util.tree_map(np.asarray, jsmc.flush_pending(st, 100.0))
    got = state_to_numpy(tsmc.flush_pending(
        state_from_numpy(jax.tree_util.tree_map(np.asarray, st), "cpu"),
        100.0))
    assert (got["lr_pos"] >= INF).all() and (got["lr_due"] >= INF).all()
    for k in ("win_leaf_cnt", "win_time_cnt", "win_logtime_cnt"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-6,
                                   err_msg=k)


def test_flush_leaves_freed_slots_alone():
    """A slot that an earlier commit freed keeps its height and bitmask.
    JAX's flush (``lr_due <= INF``) takes every such slot as an event once
    more and adds it, weighted, to the last window, a fault of the
    reference (ROADMAP §3); the port's flush commits only the slots in
    use.  So the port's windows are JAX's but for the last, which JAX has
    the freed slots' stale counts more."""
    rng = np.random.default_rng(11)
    st = _local_jax_state(rng, 5e4)
    pos = np.array(st.lr_pos)
    freed = (pos >= INF) & (rng.uniform(size=pos.shape) < 0.7)
    time = np.where(freed, rng.uniform(10.0, 5e4, pos.shape),
                    np.array(st.lr_time)).astype(np.float32)
    desc = np.where(freed[..., None],
                    rng.integers(1, 16, pos.shape + (1,)),
                    np.array(st.lr_desc)).astype(np.uint32)
    st = st._replace(lr_time=jnp.asarray(time), lr_desc=jnp.asarray(desc))
    ref = jax.tree_util.tree_map(np.asarray, jsmc.flush_pending(st, 100.0))
    got = state_to_numpy(tsmc.flush_pending(
        state_from_numpy(jax.tree_util.tree_map(np.asarray, st), "cpu"),
        100.0))
    w = np.exp(np.array(st.log_w, np.float64) - np.log(np.exp(
        np.array(st.log_w, np.float64)).sum()))
    bits = (desc[..., 0][:, :, None] >> np.arange(4)) & 1
    stale = (freed[:, :, None] * w[:, None, None] * bits
             / np.maximum(bits.sum(-1, keepdims=True), 1)).sum(axis=(0, 1))
    assert stale.sum() > 1.0
    for k in ("win_leaf_cnt", "win_time_cnt", "win_logtime_cnt"):
        np.testing.assert_allclose(got[k][:-1], getattr(ref, k)[:-1],
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(ref.win_leaf_cnt[-1],
                               got["win_leaf_cnt"][-1] + stale, rtol=1e-5)


def test_local_state_round_trips_and_checkpoints(tmp_path):
    rng = np.random.default_rng(4)
    st = jax.tree_util.tree_map(np.asarray, _local_jax_state(rng, 5e4))
    port = state_from_numpy(st, "cpu")
    back = state_to_numpy(port)
    for k in ("win_opp_diff", "win_leaf_cnt", "win_time_cnt",
              "win_logtime_cnt", "lr_pos", "lr_due", "lr_time"):
        np.testing.assert_array_equal(back[k], getattr(st, k), err_msg=k)
    np.testing.assert_array_equal(back["lr_desc"],
                                  desc_words_to_int64(st.lr_desc))
    gen = torch.Generator().manual_seed(1)
    save_state(str(tmp_path / "ck"), port, gen, {"segments": 3})
    loaded, done = load_state(str(tmp_path / "ck"), gen, "cpu")
    assert done == {"segments": 3}
    for k in ("win_opp_diff", "win_cnt", "lr_pos", "lr_due", "lr_time",
              "lr_desc", "lr_dropped"):
        torch.testing.assert_close(getattr(loaded, k), getattr(port, k))


def test_recomb_file_has_jax_columns_and_windows(tmp_path):
    """A small run's ``.recomb.gz`` against JAX's ``write_recomb`` of the
    same accumulators: the same header, rows, loci and columns."""
    demo = _demo(TDemography, E=3, n=4, L=3e4)
    seg = simulate_seg(demo, seed=6)
    out = tmp_path / "out"
    tem.run_em(demo, seg, tem.EMConfig(num_particles=32, alpha=0.5,
                                       outdir=str(out), device="cpu"))
    _, _, _, diag = tem.run_chunk(demo, seg, tem.EMConfig(
        num_particles=32, alpha=0.5, device="cpu"), seed=1)
    lr = diag["local_recomb"]
    ref_path = str(tmp_path / "ref.recomb.gz")
    j_write_recomb(ref_path, 0, lr["window_size"], lr["opp_diff"],
                   lr["leaf_cnt"], lr["time_cnt"], lr["logtime_cnt"],
                   start_position=lr["start"])
    with gzip.open(out / "emiter0" / "chunk0.recomb.gz", "rt") as fh:
        got = fh.read().splitlines()
    with gzip.open(ref_path, "rt") as fh:
        ref = fh.read().splitlines()
    assert got == ref  # the run_em sweep is run_chunk's with seed 1
    W = int(np.ceil((float(seg.end) - int(seg.positions[0])) / 100.0))
    assert len(got) == W + 1 and got[0].split("\t")[-2:] == ["time",
                                                             "log_time"]
    assert lr["leaf_cnt"].sum() > 0 and lr["dropped"] == 0


# ---------------------------------------------------------------------------
# one guided / recording step with trips: the port's step against JAX's
# ---------------------------------------------------------------------------


def _normed(x):
    return (x - np.log(np.exp(x - x.max()).sum()) - x.max()).astype(np.float32)


def _key_chain(key, T):
    firsts, gap_u = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        firsts.append(np.asarray(jax.random.split(sub, P)[0]).tobytes())
        key, sub = jax.random.split(key)
        gap_u.append(np.asarray(jax.random.uniform(sub, (P,))))
    return {k: j for j, k in enumerate(firsts)}, np.stack(gap_u)


@pytest.mark.parametrize("guide,local,biased,vb,n", [
    (True, False, True, False, 4), (True, False, False, False, 4),
    (False, True, False, False, 4), (True, True, True, True, 4)] + [
    (True, False, True, False, n) for n in (16, 33)] + [
    (False, True, False, False, n) for n in (16, 33)] + [
    (True, True, True, True, n) for n in (16, 33)],
    ids=["guide+bias", "guide", "local", "guide+local+bias+vb"] + [
        f"{v}-n{n}" for v in ("guide+bias", "local", "guide+local+bias+vb")
        for n in (16, 33)])
def test_step_with_trips_matches_jax_step(guide, local, biased, vb, n,
                                          monkeypatch):
    """One segment step with several trips per particle: the port's step
    (its plain pass) against JAX's XLA step (``make_segment_step`` with
    ``use_guide`` and ``num_windows`` > 0), from one state, on one chain
    of trips.  JAX's transitions are the port's on the port's uniforms of
    that trip (JAX's keys draw other numbers); the gap uniforms are JAX's
    own.  What runs in JAX is then all its step does around the
    transitions: the extensions with the guide's survival weight, the
    guided gaps, the split of the importance weight, the ring of delayed
    factors, the pushes of local events, the window opportunity and the
    commit of due events, the site likelihood (above 8 leaves the port's,
    see below) and the normalisations."""
    from smcsmc_tpu.kernels import transition as jtr

    E, L, dist_mut, seed = 4, 50000, 3000.0, 80
    # above 8 leaves the weights after the no-mutation term (some 90 nats
    # at MU, its tree length summed in another order in each package)
    # carry 1-2 of its ulps (7.6e-6 each), and where no guide concentrates
    # the weights, the plain local pass's window counts then part by
    # 1.5e-5 relative, beyond their rtol: that pass runs at 1e-6 there; the
    # guided passes, local recording among them, run at MU
    mu = MU if n <= 8 or guide else 1e-6
    W, R = 1000, 8
    jd, td = _demo(JDemography, E, n), _demo(TDemography, E, n)
    epochs, t_ep = j_epochs(jd), t_epochs(td, "cpu")
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=n, ess_threshold=0.0,
                        use_bias=biased, use_guide=guide, use_vb=vb,
                        num_windows=W if local else 0, local_ring=R)
    rng = np.random.default_rng(seed)
    g_rate = (RHO * rng.uniform(0.1, 4.0, W)).astype(np.float32)
    g_leaf = rng.uniform(0.2, 3.0, (W, n)).astype(np.float32)
    st = jsmc.init_state(jax.random.PRNGKey(seed), epochs, cfg,
                         jd.sample_pops, RHO)
    front = 40000.0
    lw = _normed(rng.normal(0.0, 2.0, P))
    K = jsmc.stats_width(E, 1)
    st = st._replace(
        log_w=jnp.asarray(lw),
        log_pilot=jnp.asarray(_normed(rng.normal(0.0, 2.0, P))
                              if guide or biased else lw),
        fifo=jnp.asarray(rng.uniform(0, 1, (P, cfg.fifo_slots, K)),
                         jnp.float32),
        front=jnp.float32(front),
        next_rec=jnp.asarray(rng.uniform(0.0, 0.4 * L, P), jnp.float32))
    if local:
        pos, due, time, desc = _ring(rng, front, R, n=n)
        full = rng.uniform(size=P) < 0.2  # rings that fill and drop
        for a, v in ((pos, front - 10.0), (due, 3e37), (time, 5.0),
                     (desc, 1)):
            a[full] = v
        st = st._replace(lr_pos=jnp.asarray(pos), lr_due=jnp.asarray(due),
                         lr_time=jnp.asarray(time), lr_desc=jnp.asarray(desc))
    lags = np.array([3000.0, 9000.0, 20000.0, 40000.0], np.float32)
    bh, bs = (np.array([0.0, 2000.0, 3e38], np.float32),
              np.array([3.0, 1.0], np.float32))
    delays = lags * 0.25
    alleles = np.random.default_rng(7).integers(0, 2, n).astype(np.int8)
    counts = (rng.uniform(0.05, 5.0, (E, 1)), rng.uniform(0.05, 5.0,
                                                          (E, 1, 1)))
    ref_coal, ref_mig = jem.vb_log_tables(jd, counts)
    gt = tguide.guide_tables(g_rate, g_leaf, RHO, 100.0, "cpu")

    # ---- the port's step, on uniforms of the test's choosing -------------
    T = tsmc.MAX_RECOMB_ITERS
    index, gap_u = _key_chain(st.key, T)
    U = torch.from_numpy(rng.uniform(size=(T, P, 4)).astype(np.float32))
    U[:, :, 3] = torch.from_numpy(gap_u)
    real_pass = tsmc.segment_pass

    def with_uniforms(uniforms, *args, **kw):
        assert uniforms.shape == U.shape
        return real_pass(U, *args, **kw)

    monkeypatch.setattr(tsmc, "segment_pass", with_uniforms)
    tcfg = tsmc.PFConfig(num_particles=P, num_leaves=n, ess_threshold=0.0,
                         use_bias=biased, use_guide=guide,
                         num_windows=W if local else 0, local_ring=R)
    t_step = tsmc.make_segment_step(
        tcfg, t_ep, mu, RHO, lags, torch.Generator().manual_seed(0),
        bias_heights=bh if biased else None,
        bias_strengths=bs if biased else None,
        delays=delays if (biased or guide) else None,
        vb_tables=(tem.vb_pass_tables(td, counts, tem.EMConfig(vb=True))
                   if vb else None),
        guide=gt if guide else None)
    seg = (jnp.int32(L), jnp.asarray(alleles)[None], jnp.int32(1),
           jnp.int8(0), jnp.int8(1), jnp.float32(dist_mut))
    seg_np = jax.tree_util.tree_map(np.asarray, seg)
    st_np = jax.tree_util.tree_map(np.asarray, st)
    got_state, (ess, need, front_out) = t_step(
        state_from_numpy(st_np, "cpu"), segment_from_numpy(seg_np, lags,
                                                           "cpu"))
    got = state_to_numpy(got_state)

    # ---- JAX's step, its transitions the port's ---------------------------
    est = t_ep.start
    eend = torch.cat([est[1:], est.new_full((1,), INF)])
    has_data = torch.from_numpy(alleles >= 0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    trips = []

    def port_trip(key0, time, parent, c0, c1, active, leaf_rates):
        j = index[np.asarray(key0).tobytes()]
        act = torch.from_numpy(np.array(active))
        tr = [torch.from_numpy(np.array(x)) for x in (time, parent, c0, c1)]
        nr = torch.where(act, 0.0, 2.0 * L)
        zeros = torch.zeros(P)
        pend = torch.zeros((P, K))
        point = None
        if biased or guide:
            point = ((_t(bh), _t(bs)) if biased else
                     (torch.tensor([0.0, INF]), torch.tensor([1.0])))
            if guide:
                point += (_t(leaf_rates),)
        out, rec = ttrip._trip(
            U[j], 1, *tr, nr, zeros, zeros, torch.ones(P), zeros,
            torch.zeros((P, E)), pend, f32(L), f32(mu), f32(RHO), est, eend,
            t_ep.inv2ne, has_data, point)
        trips.append(j)
        ev = [torch.where(act, x, 0.0).numpy() for x in rec[:5]]
        c = torch.where(act, rec.c, 0).numpy().astype(np.int32)
        return (*(x.numpy() for x in out[:4]), out[10].numpy(), *ev, c)

    def transition(keys, trees, epochs_, active, leaf_rates=None, **kw):
        shapes = [jax.ShapeDtypeStruct(x.shape, x.dtype) for x in (
            trees.time, trees.parent, trees.child0, trees.child1)]
        shapes += [jax.ShapeDtypeStruct((P, K), jnp.float32)]
        shapes += [jax.ShapeDtypeStruct((P,), jnp.float32)] * 5
        shapes += [jax.ShapeDtypeStruct((P,), jnp.int32)]
        lrates = (jnp.zeros((P, n), jnp.float32) if leaf_rates is None
                  else leaf_rates)
        (time, parent, c0, c1, pend, h_r, t_c, log_iw, strength, iw_bias,
         c) = jax.pure_callback(port_trip, tuple(shapes), keys[0],
                                trees.time, trees.parent, trees.child0,
                                trees.child1, active, lrates)
        s = jsmc.unpack_stats(pend, E, 1)
        zi = jnp.zeros((P,), jnp.int32)
        rec = jtr.TransitionRecord(
            coal_opp=s.coal_opp, coal_cnt=s.coal_cnt, mig_opp=s.mig_opp,
            mig_cnt=s.mig_cnt, recomb_cnt=s.recomb_cnt, recomb_height=h_r,
            coal_height=t_c, log_iw=log_iw, log_iw_bias=iw_bias,
            point_strength=jnp.where(active, strength, 1.0), c_node=c,
            d_node=zi, coal_pop=zi, walk_capped=jnp.zeros(P),
            buf_dropped=jnp.zeros(P))
        return trees._replace(time=time, parent=parent, child0=c0,
                              child1=c1), rec

    monkeypatch.setattr(jsmc, "recombination_transition", transition)
    if n > 8:
        # above 8 leaves the young branches put the site likelihood's
        # float32 1 - exp(-mu t) within a few ulps of 0 at MU, where the two
        # packages round it apart (ROADMAP section 3, open in both;
        # tests/test_torch_wide.py holds the site likelihood at 1e-6): JAX's
        # step takes the port's site likelihood here, so that both steps
        # add the same one to the same trees
        def port_site(time, parent, c0, c1, alleles):
            trees = types.SimpleNamespace(**{
                k: torch.from_numpy(np.array(x)) for k, x in (
                    ("time", time), ("parent", parent), ("child0", c0),
                    ("child1", c1))})
            return tlik.site_log_likelihood(
                trees, torch.from_numpy(np.array(alleles)), mu).numpy()

        def site(trees, alleles, mutation_rate, ancestral_aware=False):
            assert not ancestral_aware  # mutation_rate: the step's, mu
            return jax.pure_callback(
                port_site, jax.ShapeDtypeStruct((P,), jnp.float32),
                trees.time, trees.parent, trees.child0, trees.child1,
                alleles)

        monkeypatch.setattr(jsmc, "site_log_likelihood", site)
    step = jsmc.make_segment_step(
        cfg, epochs, mu, RHO, jnp.asarray(lags),
        *((jnp.asarray(bh), jnp.asarray(bs)) if biased else (None, None)),
        jnp.asarray(delays) if (biased or guide) else None,
        guide=(jnp.asarray(g_rate), jnp.asarray(g_leaf)) if guide else None,
        vb_tables=((jnp.asarray(ref_coal), jnp.asarray(ref_mig)) if vb
                   else None))
    ref_state, (ref_ess, ref_need, _) = jax.jit(step)(st, seg)
    ref = jax.tree_util.tree_map(np.asarray, ref_state)

    assert len(trips) >= 4 and not bool(ref_need) and not need
    assert front_out == float(ref.front)
    np.testing.assert_allclose(ess, float(ref_ess), rtol=1e-4)
    for k in ("parent", "child0", "child1"):
        np.testing.assert_array_equal(got["trees"][k],
                                      getattr(ref.trees, k), err_msg=k)
    np.testing.assert_array_equal(got["trees"]["time"], ref.trees.time)
    for k in ("log_w", "log_pilot"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["next_rec"] + L, ref.next_rec + L,
                               rtol=1e-5)
    if biased or guide:
        for k in ("df_pos", "df_logf", "df_delta"):
            np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got["df_k"], ref.df_k)
        assert not np.allclose(ref.log_pilot, ref.log_w, atol=1e-3)
    np.testing.assert_allclose(got["ln_norm"], ref.ln_norm, rtol=1e-6)
    # the recombination opportunity sums delta * tl_e over the trips; under
    # the guide each gap goes through mass and back, so its positions carry
    # a few ulp of themselves (not of the gap): that column takes
    # float_tolerances' atol for it (bp x generations)
    atol = np.full(K, 1e-6)
    off = jsmc.stats_width(E, 1) - 2 * E
    atol[off:off + E] = ttrip.float_tolerances(
        {"time": _t(ref.trees.time), "pending": torch.zeros((1, K))},
        float(L), mu)["pending"][off:off + E].numpy()
    err = np.abs(got["fifo"] - ref.fifo) - 1e-5 * np.abs(ref.fifo)
    assert (err <= atol).all(), np.argwhere(err > atol)[:5]
    if local:
        np.testing.assert_array_equal(got["lr_pos"] < INF, ref.lr_pos < INF)
        for k in ("lr_pos", "lr_due", "lr_time"):
            np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_array_equal(got["lr_desc"],
                                      desc_words_to_int64(ref.lr_desc))
        assert int(got["lr_dropped"]) == int(ref.lr_dropped) > 0
        for k in ("win_opp_diff", "win_leaf_cnt", "win_time_cnt",
                  "win_logtime_cnt"):
            np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert ref.win_leaf_cnt.sum() > 0 and np.abs(ref.win_opp_diff).sum()


# ---------------------------------------------------------------------------
# the wrapper's refusals, and the kernels against their plain versions on
# the card
# ---------------------------------------------------------------------------


def test_segment_pass_refuses_a_guide_without_the_biased_pass():
    """The guide runs in the biased pass only: refused by name, on any
    device; the biased migration pass has no ARG variant on the card
    (its wrapper's arguments are refused before any tensor is read)."""
    from smcsmc_tpu_torch.kernels.migration import MigrationPass

    P, N, E = 4, 7, 2
    args = (torch.zeros((1, P, 4)), 1, torch.zeros((P, N)),
            torch.zeros((P, N), dtype=torch.int32),
            torch.zeros((P, N), dtype=torch.int32),
            torch.zeros((P, N), dtype=torch.int32), torch.zeros(P),
            torch.zeros(P), torch.zeros((P, 4, 6 * E)), torch.ones(6 * E),
            torch.zeros(P), 100.0, MU, RHO, torch.zeros(E), torch.ones(E),
            torch.ones(4, dtype=torch.bool))
    gt = tguide.guide_tables(np.full(3, RHO), np.ones((3, 4)), RHO, 100.0,
                             "cpu")
    with pytest.raises(ValueError, match="guide runs in the biased pass"):
        ttrip.segment_pass(*args, guide=gt)
    mig = MigrationPass(*([None] * 10))
    with pytest.raises(ValueError, match="no ARG variant of the biased "
                                         "migration pass"):
        ttrip.segment_pass_launch_args(*args, biased=object(), migration=mig,
                                       arg=object())


@pytest.mark.parametrize("args,kw,match", [
    (("segment_pass", 4, 9), dict(guide=True), "guided variant"),
    (("trip", 4, 9), dict(local=True), "record locally"),
    (("trip", 8, 33), dict(local=True), "record locally"),
    (("trip", 16, 9), dict(local=True), "record locally"),
    (("trip", 64, 9), dict(local=True), "record locally"),
    (("segment_pass", 16, 9), dict(guide=True), "guided variant"),
    (("segment_pass", 16, 9), dict(arg=True, local=True), "record the ARG"),
])
def test_kernel_resources_refuses_missing_variants(monkeypatch, args, kw,
                                                   match):
    """Only the biased and migration passes have a guided variant, and
    only the plain, biased and migration passes a local one (trip none, at
    any n): refused before the library is loaded."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(ttrip, "load_trip_library", no_library)
    with pytest.raises(ValueError, match=match):
        ttrip.kernel_resources(*args, **kw)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("variant,kw", [
    ("segment_pass", dict(local=True)), ("segment_pass", dict(local=True,
                                                             vb=True)),
    ("biased", dict(local=True)), ("biased", dict(guide=True)),
    ("biased", dict(guide=True, local=True, vb=True))])
def test_kernel_resources_takes_the_wide_guided_and_local_passes(
        monkeypatch, n, variant, kw):
    """Above 8 leaves the guided and local passes have wide forms:
    ``kernel_resources`` checks them through and asks the library (which
    this test replaces, as there is no card here)."""
    class Reached(Exception):
        pass

    def library():
        raise Reached

    monkeypatch.setattr(ttrip, "load_trip_library", library)
    with pytest.raises(Reached):
        ttrip.kernel_resources(variant, n, 9, **kw)


def test_launch_counts_name_every_variant():
    """Every variant of the kernel has its own launch count, at 0 on
    import, named as ``launch_count`` names it (the wide plain and biased
    passes, the wide guided and local passes, the ARG variants and the
    migration pass's proposal variants, with and without VB, among
    them)."""
    assert len(set(ttrip.LAUNCH_COUNTS)) == 44
    for b, m, g, lo, vb, name in [
            (True, False, True, False, False, "biased_guide_launches"),
            (True, False, True, True, True, "biased_guide_local_vb_launches"),
            (False, False, False, True, False, "local_launches"),
            (True, False, False, True, False, "biased_local_launches"),
            (True, True, False, False, False, "migration_biased_launches"),
            (True, True, True, True, True,
             "migration_biased_guide_local_vb_launches"),
            (False, True, False, True, False, "migration_local_launches")]:
        assert ttrip.launch_count(b, m, vb, g, lo) == name
        assert name in ttrip.LAUNCH_COUNTS
        assert isinstance(getattr(ttrip.segment_pass, name), int)
    for b, g, lo, vb, name in [
            (False, False, True, False, "wide_local_launches"),
            (True, False, True, True, "biased_wide_local_vb_launches"),
            (True, True, False, False, "biased_wide_guide_launches"),
            (True, True, True, True, "biased_wide_guide_local_vb_launches")]:
        assert ttrip.launch_count(b, False, vb, g, lo, wide=True) == name
        assert name in ttrip.LAUNCH_COUNTS
        assert isinstance(getattr(ttrip.segment_pass, name), int)
