"""The port's ARG recording (``-arg``, the ring behind ``.trees.gz``)
against the JAX package, on the CPU.

- ``init_arg_ring`` equals ``_init_arg_ring`` exactly: one population at
  n = 4 and n = 36 (two u32 words in JAX, one int64 here), and structured
  trees whose buffers give M rows.
- ``push_arg_event`` equals ``_push_arg_event`` exactly, through rings
  that wrap (``arg_n`` past the capacity, the newest rows kept).
- One segment step with a chain of trips against JAX's XLA step with
  ``record_arg``, its transitions the port's on the port's uniforms
  (through ``jax.pure_callback``, as tests/test_torch_local.py does):
  plain, biased, and with migration (``SMCSMC_MIG_WALK=loop``, the port's
  loop walk and buffer routing).  Codes, populations, leaves and
  ``arg_n`` exactly; positions and heights within rtol 1e-5.
- ``_sample_arg_particle`` draws the same index from the same weights
  and seed; the ``.trees.gz`` text of a ring equals JAX's ``write_trees``'
  on the same ring, at n = 64 with leaf 63 set.
- The port's own ``run_chunk`` at small P: the analogues of
  tests/test_features.py's ``TestArgSweep`` (n = 4 and 36),
  tests/test_tskit_conversion.py's table checks (one population and an
  island model) and tests/test_migration_inference.py's
  ``TestMigrationTracts``; ``smc2-torch -arg`` writes
  ``emiter{it}/chunk{ci}.trees.gz``; a mid-sweep checkpoint carries the
  ring bit for bit; ``refuse_caps`` refuses on the card what has no ARG
  kernel.
- ``cuda``: the ARG kernels against their plain versions on the card
  (chip_smoke.compare_arg at a smaller P); skipped here.

JAX is imported on use, so that the ``cuda`` tests also run where only
torch is installed.
"""

import dataclasses
import gzip
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smcsmc_tpu_torch import argout as targout
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch import smc as tsmc
from smcsmc_tpu_torch.checkpoint import load_state, save_state
from smcsmc_tpu_torch.cli import smcsmc_main
from smcsmc_tpu_torch.demography import Demography as TDemography
from smcsmc_tpu_torch.kernels import arg as targ
from smcsmc_tpu_torch.kernels import migration as tmig
from smcsmc_tpu_torch.kernels import trip as ttrip
from smcsmc_tpu_torch.kernels.tree import INF
from smcsmc_tpu_torch.kernels.tree import epochs_from_demography as t_epochs
from smcsmc_tpu_torch.segio import write_seg
from smcsmc_tpu_torch.simulate import simulate_seg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MU, RHO = 1e-8, 1e-9


def _single(cls, n=4, E=1, L=1e5):
    change = (np.array([0.0]) if E == 1 else
              np.concatenate([[0.0], np.logspace(2.5, 4.5, E - 1)]))
    return cls(change_times=change, pop_sizes=np.full((E, 1), 10000.0),
               mig_rates=np.zeros((E, 1, 1)),
               sample_pops=np.zeros(n, dtype=np.int32), mutation_rate=MU,
               recombination_rate=RHO, sequence_length=L)


def _island(cls, m=1e-4, E=1, L=1e5):
    change = (np.array([0.0]) if E == 1 else
              np.concatenate([[0.0], np.logspace(2.5, 4.5, E - 1)]))
    mig = np.zeros((E, 2, 2))
    mig[:, 0, 1] = mig[:, 1, 0] = m
    return cls(change_times=change, pop_sizes=np.full((E, 2), 10000.0),
               mig_rates=mig, sample_pops=np.array([0, 0, 1, 1], np.int32),
               mutation_rate=MU, recombination_rate=RHO, sequence_length=L)


def _ring_of(d):
    """A JAX ring (dict or state) as the port's numpy fields."""
    from smcsmc_tpu_torch.convert import desc_words_to_int64

    get = (lambda k: d[k]) if isinstance(d, dict) else \
        (lambda k: getattr(d, k))
    out = {k: np.asarray(get(k)) for k in targ.ARG_FIELDS}
    out["arg_desc"] = desc_words_to_int64(out["arg_desc"])
    return out


def _assert_rings_equal(got, ref, rtol=0.0):
    """Codes, populations, leaves and ``arg_n`` exactly; positions and
    heights exactly or within ``rtol``."""
    for k in ("arg_code", "arg_from", "arg_to", "arg_desc", "arg_n"):
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)
    for k in ("arg_pos", "arg_time"):
        if rtol:
            np.testing.assert_allclose(np.asarray(got[k]), ref[k], rtol=rtol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), ref[k],
                                          err_msg=k)


# ---------------------------------------------------------------------------
# the ring: initial rows and pushes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["n=4", "n=36", "structured"])
def test_init_arg_ring_equals_jax(case):
    import jax
    import jax.numpy as jnp

    from smcsmc_tpu import smc as jsmc
    from smcsmc_tpu.demography import Demography as JDemography
    from smcsmc_tpu.kernels import tree as jtree
    from smcsmc_tpu_torch.convert import trees_from_numpy

    P = 24
    structured = case == "structured"
    jd = (_island(JDemography, m=2e-4) if structured
          else _single(JDemography, int(case[2:]), E=3))
    ep = jtree.epochs_from_demography(jd)
    trees = jtree.make_initial_trees(
        jax.random.PRNGKey(3), ep, P, jnp.asarray(jd.sample_pops),
        max_mig=8 if structured else 0)
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=jd.num_samples,
                        record_arg=True, has_migration=structured)
    ref = _ring_of(jsmc._init_arg_ring(trees, cfg))
    got = targ.init_arg_ring(
        trees_from_numpy(jax.tree_util.tree_map(np.asarray, trees), "cpu"),
        cfg.arg_slots)
    _assert_rings_equal({k: v.numpy() for k, v in got.items()}, ref)
    if structured:
        assert (ref["arg_code"] == targ.ARG_MIG).any()
    if jd.num_samples > 32:
        assert (ref["arg_desc"] >> 32 > 0).any()


def test_push_arg_event_wraps_as_jax():
    """Masked pushes into rings of 8 slots whose counts start below, at and
    past the capacity: every field after each push as JAX's."""
    import jax.numpy as jnp

    from smcsmc_tpu import smc as jsmc

    rng = np.random.default_rng(5)
    P, A = 16, 8
    n0 = rng.integers(0, 20, P).astype(np.int32)
    n0[:3] = (7, 8, 15)
    ring = dict(arg_pos=rng.uniform(0, 1e4, (P, A)).astype(np.float32),
                arg_code=rng.integers(0, 3, (P, A)).astype(np.int8),
                arg_time=rng.uniform(0, 5e4, (P, A)).astype(np.float32),
                arg_from=rng.integers(-1, 2, (P, A)).astype(np.int8),
                arg_to=rng.integers(-1, 2, (P, A)).astype(np.int8),
                arg_desc=rng.integers(0, 1 << 40, (P, A)).astype(np.int64),
                arg_n=n0)
    words = np.stack([ring["arg_desc"] & 0xFFFFFFFF, ring["arg_desc"] >> 32],
                     axis=-1).astype(np.uint32)
    jring = tuple(jnp.asarray(ring[k] if k != "arg_desc" else words)
                  for k in targ.ARG_FIELDS)
    tring = tuple(torch.from_numpy(ring[k].copy()) for k in targ.ARG_FIELDS)
    for j in range(12):
        mask = rng.uniform(size=P) < 0.7
        pos = rng.uniform(0, 1e5, P).astype(np.float32)
        time = rng.uniform(0, 5e4, P).astype(np.float32)
        frm = rng.integers(0, 2, P).astype(np.int32)
        desc = rng.integers(1, 1 << 36, P).astype(np.int64)
        dw = np.stack([desc & 0xFFFFFFFF, desc >> 32], -1).astype(np.uint32)
        code, to = j % 3, (-1 if j % 3 < 2 else 1)
        jring = jsmc._push_arg_event(jring, jnp.asarray(mask),
                                     jnp.asarray(pos), code,
                                     jnp.asarray(time), jnp.asarray(frm),
                                     to, jnp.asarray(dw), A)
        tring = targ.push_arg_event(tring, torch.from_numpy(mask),
                                    torch.from_numpy(pos), code,
                                    torch.from_numpy(time),
                                    torch.from_numpy(frm), to,
                                    torch.from_numpy(desc))
        _assert_rings_equal(
            {k: v.numpy() for k, v in zip(targ.ARG_FIELDS, tring)},
            _ring_of(dict(zip(targ.ARG_FIELDS, jring))))
    assert (tring[6] > A).sum() > P // 2


# ---------------------------------------------------------------------------
# one step with trips against JAX's XLA step
# ---------------------------------------------------------------------------


def _key_chain(key, T, P):
    import jax

    firsts, gap_u = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        firsts.append(np.asarray(jax.random.split(sub, P)[0]).tobytes())
        key, sub = jax.random.split(key)
        gap_u.append(np.asarray(jax.random.uniform(sub, (P,))))
    return {k: j for j, k in enumerate(firsts)}, np.stack(gap_u)


def _normed(x):
    return (x - np.log(np.exp(x - x.max()).sum()) - x.max()).astype(np.float32)


@pytest.mark.parametrize("kind", ["plain", "biased", "migration"])
def test_step_with_trips_records_as_jax_step(kind, monkeypatch):
    """One segment step with several trips per particle and a ring near
    its capacity: the port's step (its plain pass with ARG recording)
    against JAX's XLA step with ``record_arg``, from one state, on one
    chain of trips.  JAX's transitions are the port's on the port's
    uniforms of that trip (for migration the port's loop walk on the
    port's Philox key, and its buffer routing); JAX's gap uniforms are fed
    to the port.  What JAX then runs is its step around the transitions:
    the ARG pushes from the transition's record (R, C and the M rows of
    the walk's hops), with the leaves of its own descendant bitmasks."""
    import jax
    import jax.numpy as jnp

    from smcsmc_tpu import smc as jsmc
    from smcsmc_tpu.demography import Demography as JDemography
    from smcsmc_tpu.kernels import transition as jtr
    from smcsmc_tpu.kernels.tree import epochs_from_demography as j_epochs
    from smcsmc_tpu_torch.convert import (
        segment_from_numpy,
        state_from_numpy,
        state_to_numpy,
    )
    from smcsmc_tpu_torch.kernels.bias import epoch_index

    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    P, L, dist_mut, seed, A = 48, 50000, 3000.0, 90, 16
    mig = kind == "migration"
    biased = kind == "biased"
    if mig:
        jd, td = _island(JDemography, 3e-4, E=4), _island(TDemography, 3e-4,
                                                          E=4)
    else:
        jd, td = _single(JDemography, 4, E=4), _single(TDemography, 4, E=4)
    E, Pp, n = jd.num_epochs, jd.num_populations, jd.num_samples
    epochs, t_ep = j_epochs(jd), t_epochs(td, "cpu")
    cfg = jsmc.PFConfig(num_particles=P, num_leaves=n, ess_threshold=0.0,
                        use_bias=biased, has_migration=mig, max_mig=8,
                        record_arg=True, arg_slots=A)
    rng = np.random.default_rng(seed)
    st = jsmc.init_state(jax.random.PRNGKey(seed), epochs, cfg,
                         jd.sample_pops, RHO)
    front = 40000.0
    lw = _normed(rng.normal(0.0, 2.0, P))
    K = jsmc.stats_width(E, Pp)
    st = st._replace(
        log_w=jnp.asarray(lw),
        log_pilot=jnp.asarray(_normed(rng.normal(0.0, 2.0, P))
                              if biased else lw),
        fifo=jnp.asarray(rng.uniform(0, 1, (P, cfg.fifo_slots, K)),
                         jnp.float32),
        front=jnp.float32(front),
        next_rec=jnp.asarray(rng.uniform(0.0, 0.4 * L, P), jnp.float32),
        # rings about to wrap, and some that did
        arg_n=jnp.asarray(rng.integers(A - 4, 3 * A, P), jnp.int32))
    lags = np.linspace(3000.0, 40000.0, E).astype(np.float32)
    bh, bs = (np.array([0.0, 2000.0, 3e38], np.float32),
              np.array([3.0, 1.0], np.float32))
    delays = lags * 0.25
    alleles = np.random.default_rng(7).integers(0, 2, n).astype(np.int8)

    # ---- the port's step, on uniforms of the test's choosing -------------
    T = tsmc.MAX_RECOMB_ITERS
    index, gap_u = _key_chain(st.key, T, P)
    U = torch.from_numpy(rng.uniform(size=(T, P, 4)).astype(np.float32))
    U[:, :, 3] = torch.from_numpy(gap_u)
    real_pass = tsmc.segment_pass
    seen = {}

    def with_uniforms(uniforms, *args, **kw):
        assert uniforms.shape == U.shape and "arg" in kw
        seen["migration"] = args[17]
        return real_pass(U, *args, **kw)

    monkeypatch.setattr(tsmc, "segment_pass", with_uniforms)
    tcfg = tsmc.PFConfig(num_particles=P, num_leaves=n, ess_threshold=0.0,
                         use_bias=biased, has_migration=mig, max_mig=8,
                         record_arg=True, arg_slots=A)
    t_step = tsmc.make_segment_step(
        tcfg, t_ep, MU, RHO, lags, torch.Generator().manual_seed(0),
        bias_heights=bh if biased else None,
        bias_strengths=bs if biased else None,
        delays=delays if biased else None)
    seg = (jnp.int32(L), jnp.asarray(alleles)[None], jnp.int32(1),
           jnp.int8(0), jnp.int8(1), jnp.float32(dist_mut))
    seg_np = jax.tree_util.tree_map(np.asarray, seg)
    st_np = jax.tree_util.tree_map(np.asarray, st)
    got_state, (_, need, front_out) = t_step(
        state_from_numpy(st_np, "cpu"),
        segment_from_numpy(seg_np, lags, "cpu", Pp=Pp))
    got = state_to_numpy(got_state)

    # ---- JAX's step, its transitions the port's ---------------------------
    est = t_ep.start
    eend = torch.cat([est[1:], est.new_full((1,), INF)])
    has_data = torch.from_numpy(alleles >= 0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    trips = []

    def port_trip(key0, time, parent, c0, c1, active):
        j = index[np.asarray(key0).tobytes()]
        act = torch.from_numpy(np.array(active))
        tr = [torch.from_numpy(np.array(x)) for x in (time, parent, c0, c1)]
        nr = torch.where(act, 0.0, 2.0 * L)
        zeros = torch.zeros(P)
        point = (torch.from_numpy(bh), torch.from_numpy(bs)) if biased \
            else None
        out, rec = ttrip._trip(
            U[j], 1, *tr, nr, zeros, zeros, torch.ones(P), zeros,
            torch.zeros((P, E)), torch.zeros((P, K)), f32(L), f32(MU),
            f32(RHO), est, eend, t_ep.inv2ne, has_data, point)
        trips.append(j)
        ev = [torch.where(act, x, 0.0).numpy() for x in rec[:5]]
        cd = [torch.where(act, x, 0).numpy().astype(np.int32)
              for x in (rec.c, rec.d)]
        return (*(x.numpy() for x in out[:4]), out[10].numpy(), *ev, *cd)

    def port_mig_trip(key0, time, parent, c0, c1, pop, mig_time, mig_dest,
                      active):
        j = index[np.asarray(key0).tobytes()]
        act = torch.from_numpy(np.array(active))
        time, parent, c0, c1, pop, mig_time, mig_dest = (
            torch.from_numpy(np.array(x)) for x in (
                time, parent, c0, c1, pop, mig_time, mig_dest))
        u = U[j].clamp(1e-7, 1.0 - 1e-7)
        c, h_r = tmig.uniform_point(u[:, 0], time, parent)
        mp = seen["migration"]._replace(pop=pop, mig_time=mig_time,
                                        mig_dest=mig_dest)
        pend = torch.zeros((P, K))
        t_c, d, fpop, ev_t, ev_d, rev_t, rev_d, capped, _ = tmig.walk_mig(
            mp, j, time, parent, c, h_r, act, est, pend, E, Pp)
        off = tmig.stats_offsets(E, Pp)
        e_r = epoch_index(est, h_r)
        pend[:, off["recomb_cnt"]:off["recomb_cnt"] + E] += (
            (torch.arange(E)[None, :] == e_r[:, None]) & act[:, None]).float()
        out = tmig.apply_spr_mig(parent, time, c0, c1, pop, mig_time,
                                 mig_dest, c, d, t_c, fpop, h_r, ev_t, ev_d,
                                 rev_t, rev_d)
        new = [torch.where(act.view(-1, *([1] * (v.dim() - 1))), v, old)
               for v, old in zip(out[:7], (parent, time, c0, c1, pop,
                                           mig_time, mig_dest))]
        p0 = tmig.start_pop(mig_time, mig_dest, pop, c, h_r)
        ev_from = torch.cat([p0[:, None], ev_d[:, :-1]], dim=1)
        trips.append(j)
        f = (lambda x: torch.where(act, x, 0.0).numpy())  # noqa: E731
        i = (lambda x: torch.where(act, x, 0).numpy().astype(np.int32))  # noqa
        return (new[1].numpy(), new[0].numpy(), new[2].numpy(),
                new[3].numpy(), new[4].numpy(), new[5].numpy(),
                new[6].numpy(), pend.numpy(), f(h_r), f(t_c), i(c), i(d),
                i(fpop), f((capped & act).float()), f(out[7].float()),
                ev_t.numpy(), ev_from.numpy().astype(np.int32),
                ev_d.numpy().astype(np.int32))

    def transition(keys, trees, epochs_, active, **kw):
        S = jax.ShapeDtypeStruct
        shapes = [S(x.shape, x.dtype) for x in (
            trees.time, trees.parent, trees.child0, trees.child1)]
        if not mig:
            shapes += [S((P, K), jnp.float32)] + [S((P,), jnp.float32)] * 5
            shapes += [S((P,), jnp.int32)] * 2
            (time, parent, c0, c1, pend, h_r, t_c, log_iw, strength,
             iw_bias, c, d) = jax.pure_callback(
                port_trip, tuple(shapes), keys[0], trees.time, trees.parent,
                trees.child0, trees.child1, active)
            zi = jnp.zeros((P,), jnp.int32)
            extra = dict(coal_pop=zi, walk_capped=jnp.zeros(P),
                         buf_dropped=jnp.zeros(P), log_iw=log_iw,
                         log_iw_bias=iw_bias,
                         point_strength=jnp.where(active, strength, 1.0))
        else:
            W = 2 * trees.mig_time.shape[2]
            shapes += [S(x.shape, x.dtype) for x in (
                trees.pop, trees.mig_time, trees.mig_dest)]
            shapes += [S((P, K), jnp.float32)] + [S((P,), jnp.float32)] * 2
            shapes += [S((P,), jnp.int32)] * 3 + [S((P,), jnp.float32)] * 2
            shapes += [S((P, W), jnp.float32)] + [S((P, W), jnp.int32)] * 2
            (time, parent, c0, c1, pop, mt, md, pend, h_r, t_c, c, d, fpop,
             capped, dropped, ev_t, ev_from, ev_to) = jax.pure_callback(
                port_mig_trip, tuple(shapes), keys[0], trees.time,
                trees.parent, trees.child0, trees.child1, trees.pop,
                trees.mig_time, trees.mig_dest, active)
            zf = jnp.zeros((P,), jnp.float32)
            extra = dict(coal_pop=fpop, walk_capped=capped,
                         buf_dropped=dropped, log_iw=zf, log_iw_bias=zf,
                         point_strength=jnp.ones(P), mig_ev_t=ev_t,
                         mig_ev_from=ev_from, mig_ev_to=ev_to)
            trees = trees._replace(pop=pop, mig_time=mt, mig_dest=md)
        s = jsmc.unpack_stats(pend, E, Pp)
        rec = jtr.TransitionRecord(
            coal_opp=s.coal_opp, coal_cnt=s.coal_cnt, mig_opp=s.mig_opp,
            mig_cnt=s.mig_cnt, recomb_cnt=s.recomb_cnt, recomb_height=h_r,
            coal_height=t_c, c_node=c, d_node=d, **extra)
        return trees._replace(time=time, parent=parent, child0=c0,
                              child1=c1), rec

    monkeypatch.setattr(jsmc, "recombination_transition", transition)
    step = jsmc.make_segment_step(
        cfg, epochs, MU, RHO, jnp.asarray(lags),
        *((jnp.asarray(bh), jnp.asarray(bs)) if biased else (None, None)),
        jnp.asarray(delays) if biased else None)
    ref_state, (_, ref_need, _) = jax.jit(step)(st, seg)
    ref = jax.tree_util.tree_map(np.asarray, ref_state)

    assert len(trips) >= 4 and not bool(ref_need) and not need
    assert front_out == float(ref.front)
    for k in ("parent", "child0", "child1", "time"):
        np.testing.assert_array_equal(got["trees"][k],
                                      getattr(ref.trees, k), err_msg=k)
    if mig:
        for k in ("pop", "mig_time", "mig_dest"):
            np.testing.assert_array_equal(got["trees"][k],
                                          getattr(ref.trees, k), err_msg=k)
    for k in ("log_w", "log_pilot"):
        np.testing.assert_allclose(got[k], getattr(ref, k), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["next_rec"] + L, ref.next_rec + L,
                               rtol=1e-5)
    _assert_rings_equal(got, _ring_of(ref), rtol=1e-5)
    pushed = ref.arg_n - st_np.arg_n
    assert pushed.sum() >= 2 * len(trips) and (ref.arg_n > A).any()
    if mig:
        assert (ref.arg_code == targ.ARG_MIG).any()
        assert (pushed % 2).any()  # some trips pushed M rows


# ---------------------------------------------------------------------------
# the sampled particle and the .trees.gz text
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 7, 1000])
def test_sample_arg_particle_equals_jax(seed):
    from smcsmc_tpu import em as jem

    lw = np.random.default_rng(seed).normal(0.0, 3.0, 500).astype(np.float32)
    assert tem._sample_arg_particle(lw, seed) == \
        jem._sample_arg_particle(lw, seed)


def test_trees_text_equals_jax_write_trees(tmp_path):
    """The port's sampled ring at n = 64 (its leaves one int64 viewed as
    u64) written by the port's ``write_trees`` and, as JAX's two u32 words
    combined, by JAX's: the same text, leaf 63 included."""
    from smcsmc_tpu import argout as jargout
    from smcsmc_tpu import em as jem

    demo = _single(TDemography, 64, L=1e4)
    _, _, _, diag = tem.run_chunk(
        demo, simulate_seg(demo, seed=5),
        tem.EMConfig(num_particles=4, record_arg=True, device="cpu"), seed=3)
    a = diag["arg"]
    assert a["desc"].dtype == np.uint64
    assert (a["desc"] >> np.uint64(63)).any()
    words = np.stack([a["desc"] & np.uint64(0xFFFFFFFF),
                      a["desc"] >> np.uint64(32)], axis=1).astype(np.uint32)
    paths = [str(tmp_path / f"{k}.trees.gz") for k in ("port", "jax")]
    targout.write_trees(paths[0], a["pos"], a["code"], a["time"], a["from"],
                        a["to"], a["desc"], a["n"], start_position=a["start"])
    jargout.write_trees(paths[1], a["pos"], a["code"], a["time"], a["from"],
                        a["to"], jem._combine_desc_words(words), a["n"],
                        start_position=a["start"])
    texts = [gzip.open(p, "rt").read() for p in paths]
    assert texts[0] == texts[1]
    assert "1" * 64 in texts[0]


# ---------------------------------------------------------------------------
# the port's own sweeps
# ---------------------------------------------------------------------------


def _arg_run(demo, seed, fseed, tmp_path, P=16):
    cfg = tem.EMConfig(num_particles=P, record_arg=True, device="cpu")
    _, _, _, diag = tem.run_chunk(demo, simulate_seg(demo, seed=seed), cfg,
                                  seed=fseed)
    a = diag["arg"]
    path = str(tmp_path / "chunk0.trees.gz")
    targout.write_trees(path, a["pos"], a["code"], a["time"], a["from"],
                        a["to"], a["desc"], a["n"], start_position=a["start"])
    return path


@pytest.mark.parametrize("n", [4, 36])
def test_sweep_records_desc(n):
    """tests/test_features.py::TestArgSweep on the port: every R/C row of
    the sampled ring carries leaves, within the full mask, and above 32
    leaves the word reaches past bit 32."""
    demo = _single(TDemography, n, L=3e4)
    seg = simulate_seg(demo, seed=17)
    cfg = tem.EMConfig(num_particles=8, record_arg=True, device="cpu")
    _, _, _, diag = tem.run_chunk(demo, seg, cfg, seed=2)
    a = diag["arg"]
    assert a["n"] > n - 1
    desc = a["desc"][: min(a["n"], len(a["desc"]))]
    assert desc.dtype == np.uint64
    assert np.all(desc > 0)
    assert np.max(desc) <= np.uint64((1 << n) - 1)
    if n > 32:
        assert np.any(desc >> np.uint64(32) > 0)


def _check_trees_valid(tb, L, n):
    """Every genome position carries a full binary tree: 2n-2 edges, each
    non-root node with exactly one parent
    (tests/test_tskit_conversion.py)."""
    edges = tb["edges"]
    assert len(edges) >= 2 * n - 2
    assert np.all(edges["right"] > edges["left"])
    for x in np.linspace(1.0, L - 1.0, 7):
        cover = edges[(edges["left"] <= x) & (x < edges["right"])]
        assert len(cover) == 2 * n - 2, (x, len(cover))
        children, counts = np.unique(cover["child"], return_counts=True)
        assert np.all(counts == 1), "a child has two parents at one site"
        assert set(range(n)) <= set(children.tolist())
        t = tb["nodes"]["time"]
        assert np.all(t[cover["parent"]] > t[cover["child"]])


def test_single_pop_tables(tmp_path):
    n, L = 4, 1e5
    ev = targout.read_trees(_arg_run(_single(TDemography, n, L=L), 61, 8,
                                     tmp_path))
    first = ev[ev["pos"] == ev["pos"][0]]
    assert np.sum(first["code"] == "C") == n - 1
    tb = targout.build_tables(ev, L)
    assert tb["num_leaves"] == n
    assert len(tb["nodes"]["time"]) >= 2 * n - 1
    _check_trees_valid(tb, L, n)


def test_island_tables_and_migrations(tmp_path):
    L = 1e5
    ev = targout.read_trees(_arg_run(_island(TDemography, L=L), 62, 9,
                                     tmp_path))
    assert np.sum(ev["code"] == "M") > 0
    tb = targout.build_tables(ev, L)
    _check_trees_valid(tb, L, 4)
    migs = tb["migrations"]
    assert len(migs) > 0
    assert np.all(migs["right"] > migs["left"])
    assert np.all(migs["source"] != migs["dest"])


def test_tract_fraction_bounded(tmp_path):
    L = 5e4
    path = _arg_run(_island(TDemography, m=5e-4, L=L), 63, 10, tmp_path,
                    P=8)
    for tr in (targout.find_segments(path, 0, 1, sequence_length=L),
               targout.find_segments(path, 1, 0, sequence_length=L)):
        if len(tr):
            assert 0.0 <= targout.tract_fraction(tr, L, 4) <= 1.0


def test_tskit_assembly_or_skip(tmp_path):
    pytest.importorskip("tskit")
    L = 1e5
    path = _arg_run(_single(TDemography, L=L), 64, 11, tmp_path)
    ts = targout.trees_to_tskit(path, L).tree_sequence()
    assert ts.num_samples == 4
    assert ts.num_trees >= 1


def test_m_rows_and_tracts(tmp_path):
    """tests/test_migration_inference.py::TestMigrationTracts on the port:
    M rows with a direction and leaves, and tracts of positive length."""
    L = 1e5
    path = _arg_run(_island(TDemography, m=1e-4, L=L), 41, 13, tmp_path)
    ev = targout.read_trees(path)
    mrow = ev[ev["code"] == "M"]
    assert len(mrow) > 0
    assert np.all(mrow["from"] != mrow["to"])
    assert np.all(mrow["desc"] > 0)
    tr01 = targout.find_segments(path, 0, 1, sequence_length=L)
    tr10 = targout.find_segments(path, 1, 0, sequence_length=L)
    tracts = tr01 if len(tr01) else tr10
    assert len(tracts) > 0
    assert np.all(tracts["right"] > tracts["left"])
    frac = targout.tract_fraction(tracts, L, 4)
    assert np.isfinite(frac) and frac > 0.0


def test_cli_writes_trees_per_iteration_and_chunk(tmp_path):
    """``smc2-torch -arg`` on two chunks and two iterations writes
    ``emiter{it}/chunk{ci}.trees.gz``, each starting with the initial
    tree's C rows at its chunk's start."""
    demo = _single(TDemography, 4, L=4e5)
    seg = str(tmp_path / "t.seg")
    write_seg(seg, simulate_seg(demo, seed=3))
    out = str(tmp_path / "out")
    assert smcsmc_main(["-seg", seg, "-o", out, "-Np", "16", "-EM", "1",
                        "-N0", "10000", "-mu", "1e-8", "-rho", "1e-9",
                        "-chunks", "2", "-minseg", "100000", "-seed", "5",
                        "-arg", "-device", "cpu"]) == 0
    starts = set()
    for it in (0, 1):
        for ci in (0, 1):
            ev = targout.read_trees(
                str(Path(out) / f"emiter{it}" / f"chunk{ci}.trees.gz"))
            assert np.sum(ev["code"][:3] == "C") == 3
            assert np.all(np.diff(ev["pos"]) >= 0)
            starts.add(float(ev["pos"][0]))
    assert len(starts) == 2


def test_mid_sweep_checkpoint_keeps_the_ring(tmp_path):
    """A sweep saved half way and resumed in a sweep set up from another
    seed ends with the same ARG ring, bit for bit, and the same
    ``.trees.gz`` row, as the uninterrupted sweep."""
    demo = _island(TDemography, m=2e-4, L=1e5)
    seg = simulate_seg(demo, seed=8)
    cfg = tem.EMConfig(num_particles=8, record_arg=True, device="cpu")
    ref = tem.start_sweep(demo, seg, cfg, seed=5)
    st = ref.state
    half = len(ref.segs) // 2
    path = str(tmp_path / "ckpt")
    for s in range(len(ref.segs)):
        if s == half:
            save_state(path, st, ref.generator, {"segments": half})
        st, _ = ref.step(st, ref.segs[s])
    other = tem.start_sweep(demo, seg, cfg, seed=9)
    st2, done = load_state(path, other.generator, "cpu")
    assert done["segments"] == half
    for s in range(half, len(other.segs)):
        st2, _ = other.step(st2, other.segs[s])
    for k in targ.ARG_FIELDS:
        assert torch.equal(getattr(st2, k), getattr(st, k)), k
    assert int(st.arg_n.min()) > 3 and (st.arg_code == targ.ARG_MIG).any()


# ---------------------------------------------------------------------------
# what the card refuses, and the kernels on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,kw,what", [
    (4, dict(guide_file="g.recomb_guide.gz"), "-guide"),
    (4, dict(alpha=0.5), "-alpha"),
    (16, dict(bias_heights=(2000.0,)), "-bias_heights at 16 haplotypes"),
], ids=["guide", "alpha", "wide-bias"])
def test_refuse_caps_refuses_arg_without_a_kernel(n, kw, what):
    """On the card, ``-arg`` with a pass that has no ARG variant is refused
    by name, citing item 16; the CPU runs it."""
    demo = _single(TDemography, n)
    cfg = tem.EMConfig(record_arg=True, device="cuda", **kw)
    with pytest.raises(NotImplementedError,
                       match=f"-arg with {what} on the card.*item 16"):
        tem.refuse_caps(demo, cfg)
    tem.refuse_caps(demo, dataclasses.replace(cfg, device="cpu"))


@pytest.mark.parametrize("demo,kw", [
    (_single(TDemography, 4), dict(vb=True, apf=2)),
    (_single(TDemography, 8), dict(bias_heights=(2000.0,))),
    (_island(TDemography), {}),
    (_single(TDemography, 64), {}),
], ids=["vb-apf", "biased", "migration", "n=64"])
def test_refuse_caps_lets_arg_run_where_a_kernel_is(demo, kw):
    tem.refuse_caps(demo, tem.EMConfig(record_arg=True, device="cuda", **kw))


def test_wrapper_and_resources_refuse_missing_arg_variants():
    """``segment_pass`` on the card refuses ARG with the guide or local
    recording before it checks a tensor; ``kernel_resources`` names the
    biased ARG pass's leaf cap and refuses ARG for trip."""
    meta = torch.empty((2, 7), device="meta")
    args = [None, 1, meta] + [None] * 14
    for kw in (dict(biased=object(), guide=object()), dict(local=object())):
        with pytest.raises(ValueError, match="no guided or local ARG"):
            ttrip.segment_pass_launch_args(*args, arg=object(), **kw)
    with pytest.raises(ValueError, match="biased ARG kernel supports 2..8"):
        ttrip.kernel_resources("biased", 16, 9, arg=True)
    with pytest.raises(ValueError, match="record the ARG"):
        ttrip.kernel_resources("trip", 4, 9, arg=True)
    with pytest.raises(ValueError, match="record the ARG"):
        ttrip.kernel_resources("biased", 4, 9, guide=True, arg=True)
    assert ttrip.launch_count(biased=True, vb=True, arg=True) == \
        "biased_arg_vb_launches"
    assert ttrip.launch_count(wide=True, arg=True) == "wide_arg_launches"
    for name in ("arg_launches", "migration_arg_vb_launches",
                 "wide_arg_vb_launches"):
        assert name in ttrip.LAUNCH_COUNTS


@pytest.mark.cuda
def test_cuda_arg_kernels_match_plain_versions():
    """chip_smoke.compare_arg at P = 2001: each ARG kernel (plain, biased,
    migration, wide plain; VB off and on) against its plain version on
    identical inputs, the migration pass's trees, buffers and rings' heights
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    assert cs.compare_arg(ttrip.segment_pass, ttrip.segment_pass_plain, {},
                          P=2001, wide_P=(2001, 301))


@pytest.mark.cuda
def test_cuda_arg_run_chunk_counts_the_arg_pass():
    """A short sweep on the card with ``record_arg`` launches the ARG pass
    once per segment and the pass without ARG never; the sampled ring's
    R/C rows carry leaves within the full mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    demo = _single(TDemography, 4, L=5e4)
    seg = simulate_seg(demo, seed=4)
    for count in ttrip.LAUNCH_COUNTS:
        setattr(ttrip.segment_pass, count, 0)
    _, _, _, diag = tem.run_chunk(
        demo, seg, tem.EMConfig(num_particles=500, record_arg=True,
                                device="cuda"), seed=3)
    assert ttrip.segment_pass.arg_launches == diag["num_segments"]
    assert ttrip.segment_pass.launches == 0
    a = diag["arg"]
    desc = a["desc"][: min(a["n"], len(a["desc"]))]
    assert np.all(desc > 0) and np.max(desc) <= 15
