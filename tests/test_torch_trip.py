"""The torch port's recombination trip against the Pallas trip kernel, and
its segment pass against the composition it replaced in the sweep.

``fused_trip(..., interpret=True)`` runs the TPU kernel's math on the CPU;
the port's plain version must reproduce it on identical trees and
uniforms: tree arrays exactly, floats to f32 tolerance: rtol 1e-5, and on
node heights and the opportunity sums ``pending``/``tl_e`` an atol of 1e-5
times the tallest node (at least 1e-2, as in tests/test_pallas_trip.py).
The hazard sums run in another order than XLA's, and the re-coalescence
time divides their last-bit difference by a rate of order 1/(2 Ne), so the
new node height carries an absolute difference of order 2 Ne * 1e-7; every
overlap that height bounds carries it too.  The mixed-data branch length B is held
against the XLA path's ``_tree_summaries`` instead: the Pallas kernel's
ancestor-chain walk restarts at node 0 after passing the root.
"""

import functools

import numpy as np
import pytest
import torch

from smcsmc_tpu.demography import Demography
from smcsmc_tpu_torch.kernels.trip import (
    disagreement,
    float_tolerances,
    segment_pass,
    segment_pass_plain,
    trip,
    trip_plain,
)

torch.set_num_threads(1)


def _jax():
    """The JAX reference, imported on use: the ``cuda`` test below needs no
    JAX, so this file also runs where only torch is installed
    (``pytest --noconftest -m cuda tests/test_torch_trip.py``)."""
    import jax
    import jax.numpy as jnp

    from smcsmc_tpu.kernels import pallas_trip, tree
    from smcsmc_tpu import smc

    return jax, jnp, pallas_trip, tree, smc

P = 64
L_SEG = 30000.0
MU, RHO = 1e-8, 1e-9


def _demo(E, n):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(3.2, 4.5, E - 1)]))
    return Demography(
        change_times=change, pop_sizes=np.full((E, 1), 10000.0),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=MU, recombination_rate=RHO, sequence_length=2e5,
    )


def _has_data(n, leaf_status):
    hd = np.ones(n, bool)
    if leaf_status == 0:
        hd[0] = False  # leaf 0 without data exercises the ancestor walk
        hd[n // 2] = False
    return hd


@functools.lru_cache(maxsize=None)
def _jax_trees(n, E, seed):
    jax, _, _, tree, smc = _jax()
    epochs = tree.epochs_from_demography(_demo(E, n))
    st = smc.init_state(jax.random.PRNGKey(seed), epochs,
                        smc.PFConfig(num_particles=P, num_leaves=n),
                        np.zeros(n, np.int32), RHO)
    return epochs, st.trees, np.asarray(st.log_w)


def _inputs(n, E, leaf_status, seed=0, L=L_SEG):
    """Shared numpy inputs: trees from the JAX initial sampler, summaries
    from the JAX XLA path, a mix of active and inactive particles."""
    _, jnp, _, _, smc = _jax()
    epochs, trees, log_w = _jax_trees(n, E, seed)
    hd = _has_data(n, leaf_status)
    tl, tle, B = smc._tree_summaries(trees, epochs, jnp.int8(leaf_status),
                                     jnp.asarray(hd))
    rng = np.random.default_rng(seed + 10 * n + E)
    K = 6 * E
    d = dict(
        time=np.asarray(trees.time), parent=np.asarray(trees.parent),
        child0=np.asarray(trees.child0), child1=np.asarray(trees.child1),
        next_rec=rng.uniform(0.0, 1.5 * L, P).astype(np.float32),
        upd=np.zeros(P, np.float32), log_w=log_w.astype(np.float32),
        tl=np.asarray(tl), B=np.asarray(B), tl_e=np.asarray(tle),
        pending=rng.uniform(0.0, 1.0, (P, K)).astype(np.float32),
    )
    return epochs, hd, d


_ORDER = ("time", "parent", "child0", "child1", "next_rec", "upd", "log_w",
          "tl", "B", "tl_e", "pending")


def _run_jax(u, leaf_status, epochs, hd, d, L=L_SEG):
    _, jnp, pallas_trip, _, _ = _jax()
    n = hd.shape[0]
    out = pallas_trip.fused_trip(
        jnp.asarray(u), leaf_status,
        *(jnp.asarray(d[k]) for k in _ORDER),
        jnp.float32(L), jnp.float32(MU), jnp.float32(RHO), epochs.start,
        1.0 / (2.0 * epochs.ne[:, 0]), jnp.asarray(hd.astype(np.float32)),
        N=2 * n - 1, E=epochs.num_epochs, BLK=P, interpret=True,
    )
    return dict(zip(_ORDER, (np.asarray(x) for x in out)))


def _run_torch(u, leaf_status, epochs, hd, d, L=L_SEG, fn=trip):
    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    fn(torch.from_numpy(np.asarray(u, np.float32)), leaf_status,
       *(t[k] for k in _ORDER), L, MU, RHO,
       torch.from_numpy(np.array(epochs.start)),
       torch.from_numpy(np.array(1.0 / (2.0 * epochs.ne[:, 0]))),
       torch.from_numpy(hd))
    return {k: v.numpy() for k, v in t.items()}


def _assert_match(got, ref, epochs, hd, leaf_status):
    for k in ("parent", "child0", "child1"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("next_rec", "upd", "log_w", "tl"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    atol = max(1e-2, 1e-5 * float(ref["time"].max()))
    for k in ("time", "tl_e", "pending"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=atol,
                                   err_msg=k)
    if leaf_status != 0:
        np.testing.assert_allclose(got["B"], ref["B"], rtol=1e-5)
    else:
        _, jnp, _, tree, smc = _jax()
        trees2 = tree.Trees(parent=jnp.asarray(ref["parent"]),
                        time=jnp.asarray(ref["time"]),
                        pop=jnp.zeros_like(jnp.asarray(ref["parent"])),
                        child0=jnp.asarray(ref["child0"]),
                        child1=jnp.asarray(ref["child1"]))
        _, _, B_xla = smc._tree_summaries(trees2, epochs, jnp.int8(0),
                                      jnp.asarray(hd))
        active = ref["upd"] != 0.0  # trip taken: B refreshed
        np.testing.assert_allclose(got["B"][active],
                                   np.asarray(B_xla)[active], rtol=1e-5)
        np.testing.assert_array_equal(got["B"][~active], ref["B"][~active])


@pytest.mark.parametrize("leaf_status", [1, 0, -1])
@pytest.mark.parametrize("E", [1, 3, 8])
@pytest.mark.parametrize("n", [4, 8])
def test_plain_trip_matches_pallas_interpret(n, E, leaf_status):
    epochs, hd, d = _inputs(n, E, leaf_status)
    u = np.random.default_rng(100 + n + E).uniform(size=(P, 4)).astype(
        np.float32)
    ref = _run_jax(u, leaf_status, epochs, hd, d)
    got = _run_torch(u[None], leaf_status, epochs, hd, d)
    assert (d["next_rec"] < L_SEG).sum() > P // 2  # most particles trip
    _assert_match(got, ref, epochs, hd, leaf_status)
    # inactive particles keep every value
    idle = d["next_rec"] >= L_SEG
    for k in _ORDER:
        np.testing.assert_array_equal(got[k][idle], d[k][idle], err_msg=k)


def test_multi_trip_matches_sequential_pallas_trips():
    """trips=T in one call equals T JAX kernel calls in a row."""
    T, L = 6, 80000.0
    epochs, hd, d = _inputs(4, 3, 1, seed=3, L=L)
    d["next_rec"] = d["next_rec"] * 0.2
    u = np.random.default_rng(7).uniform(size=(T, P, 4)).astype(np.float32)
    ref = d
    for j in range(T):
        ref = _run_jax(u[j], 1, epochs, hd, ref, L=L)
    got = _run_torch(u, 1, epochs, hd, d, L=L)
    _assert_match(got, ref, epochs, hd, 1)


@pytest.mark.parametrize("leaf_status", [1, 0])
def test_trips_call_equals_single_trips(leaf_status):
    T, L = 8, 80000.0
    epochs, hd, d = _inputs(8, 3, leaf_status, seed=5, L=L)
    d["next_rec"] = d["next_rec"] * 0.1
    u = np.random.default_rng(11).uniform(size=(T, P, 4)).astype(np.float32)
    once = _run_torch(u, leaf_status, epochs, hd, d, L=L)
    step = d
    for j in range(T):
        step = _run_torch(u[j:j + 1], leaf_status, epochs, hd, step, L=L)
        if j == 0:
            assert np.sum(step["next_rec"] < L) > P // 4  # repeat trippers
    for k in _ORDER:
        np.testing.assert_array_equal(once[k], step[k], err_msg=k)


def test_disagreement_holds_each_field_in_its_own_units():
    """The kernel-vs-plain check: a float off by less than its tolerance
    passes, by more fails, and a tree difference is counted apart."""
    epochs, hd, d = _inputs(4, 3, 1)
    ref = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    L = L_SEG
    atol = float_tolerances(ref, L, MU)
    E = ref["tl_e"].shape[1]
    h = 1e-5 * float(ref["time"].max())
    assert atol["time"] == pytest.approx(h)
    assert atol["log_w"] == pytest.approx(MU * L * 7 * h)
    assert atol["next_rec"] == pytest.approx(1e-5 * L)
    assert float(atol["pending"][4 * E]) == pytest.approx(L * 7 * h)
    assert float(atol["pending"][E]) == 0.5  # counts: half an event

    def nudged(k, p, by, col=None):
        got = {key: v.clone() for key, v in ref.items()}
        if col is None:
            got[k][p] += by
        else:
            got[k][p, col] += by
        return disagreement(got, ref, L, MU)

    trees, floats, _ = disagreement(ref, ref, L, MU)
    assert not trees.any() and not floats.any()
    tol_lw = 1e-4 * abs(float(ref["log_w"][3])) + atol["log_w"]
    assert not nudged("log_w", 3, 0.5 * tol_lw)[1].any()
    assert nudged("log_w", 3, 2.0 * tol_lw)[1].nonzero().flatten().tolist() == [3]
    assert nudged("pending", 5, 1.0, col=E)[1].nonzero().flatten().tolist() == [5]
    trees, floats, errs = nudged("parent", 9, 1, col=0)
    assert trees.nonzero().flatten().tolist() == [9] and not floats.any()
    assert errs["time"] == (0.0, 0.0)


_SEG_ORDER = ("time", "parent", "child0", "child1", "next_rec", "log_w")
F_SLOTS = 3


def _segment_inputs(n, E, leaf_status, seed, T, L):
    """Torch inputs of a segment pass: trees and weights from the JAX
    initial sampler, a random FIFO and gate, uniforms for T trips."""
    epochs, hd, d = _inputs(n, E, leaf_status, seed=seed, L=L)
    rng = np.random.default_rng(50 + seed + n + E)
    K = 6 * E
    st = {k: torch.from_numpy(np.array(d[k])) for k in _SEG_ORDER}
    st["next_rec"] = st["next_rec"] * 0.3  # several trips per particle
    st["fifo"] = torch.from_numpy(
        rng.uniform(0.0, 1.0, (P, F_SLOTS, K)).astype(np.float32))
    st["tl"] = torch.zeros(P)
    const = dict(
        u=torch.from_numpy(rng.uniform(size=(T, P, 4)).astype(np.float32)),
        mask=torch.from_numpy((rng.uniform(size=K) < 0.7).astype(np.float32)),
        start=torch.from_numpy(np.array(epochs.start)),
        inv2ne=torch.from_numpy(np.array(1.0 / (2.0 * epochs.ne[:, 0]))),
        hd=torch.from_numpy(hd if leaf_status != -1
                            else np.zeros_like(hd)))
    return st, const


def _old_composition(st, c, leaf_status, L):
    """The segment step's tree pass as the sweep spelled it out before
    ``segment_pass``: tree summaries, trips, final extension, FIFO push."""
    from smcsmc_tpu_torch.kernels.tree import Epochs, Trees, tree_summaries

    E = c["start"].shape[0]
    trees = Trees(parent=st["parent"], time=st["time"], child0=st["child0"],
                  child1=st["child1"])
    epochs = Epochs(start=c["start"], ne=(0.5 / c["inv2ne"])[:, None])
    tl, tl_e, B = tree_summaries(trees, epochs, leaf_status, c["hd"])
    tl, tl_e, B = tl.contiguous(), tl_e.contiguous(), B.contiguous()
    log_w, next_rec = st["log_w"], st["next_rec"]
    upd = torch.zeros(P)
    pending = torch.zeros((P, 6 * E))
    if L > 0:
        trip_plain(c["u"], leaf_status, trees.time, trees.parent,
                   trees.child0, trees.child1, next_rec, upd, log_w, tl, B,
                   tl_e, pending, L, MU, RHO, c["start"], c["inv2ne"],
                   c["hd"])
    delta = L - upd
    log_w = log_w - MU * B * delta
    pending[:, 4 * E:5 * E] += delta[:, None] * tl_e
    next_rec = next_rec - L
    fifo = st["fifo"]
    fifo[:, 0] += pending * c["mask"][None, :]
    return dict(time=trees.time, parent=trees.parent, child0=trees.child0,
                child1=trees.child1, next_rec=next_rec, log_w=log_w,
                fifo=fifo, tl=tl)


@pytest.mark.parametrize("leaf_status", [1, 0, -1])
@pytest.mark.parametrize("n", [4, 8])
def test_segment_pass_plain_equals_the_old_composition(n, leaf_status):
    """Bit for bit: ``segment_pass_plain`` is the moved lines, not new math;
    on CPU tensors ``segment_pass`` is ``segment_pass_plain``."""
    T, L = 8, 60000.0
    for fn in (segment_pass_plain, segment_pass):
        st, c = _segment_inputs(n, 3, leaf_status, seed=n + leaf_status, T=T,
                                L=L)
        ref = _old_composition({k: v.clone() for k, v in st.items()}, c,
                               leaf_status, L)
        assert int((st["next_rec"] < L).sum()) > P // 2
        launches = segment_pass.launches
        fn(c["u"], leaf_status, *(st[k] for k in _SEG_ORDER), st["fifo"],
           c["mask"], st["tl"], L, MU, RHO, c["start"], c["inv2ne"], c["hd"])
        assert segment_pass.launches == launches  # no kernel on the CPU
        for k in ref:
            assert torch.equal(st[k], ref[k]), k
    assert not torch.equal(ref["fifo"][:, 0], _segment_inputs(
        n, 3, leaf_status, seed=n + leaf_status, T=T, L=L)[0]["fifo"][:, 0])


def test_segment_pass_without_trips_only_extends():
    """No uniforms (a segment of length 0 draws none): trees and FIFO rows
    of closed epochs stay, the summaries are still written."""
    st, c = _segment_inputs(4, 3, 1, seed=9, T=0, L=0.0)
    before = {k: v.clone() for k, v in st.items()}
    segment_pass(c["u"], 1, *(st[k] for k in _SEG_ORDER), st["fifo"],
                 c["mask"], st["tl"], 0.0, MU, RHO, c["start"], c["inv2ne"],
                 c["hd"])
    for k in ("time", "parent", "child0", "child1", "next_rec", "log_w",
              "fifo"):
        assert torch.equal(st[k], before[k]), k
    from smcsmc_tpu_torch.kernels.tree import branch_lengths

    np.testing.assert_allclose(
        st["tl"].numpy(),
        branch_lengths(st["time"], st["parent"]).sum(dim=1).numpy(),
        rtol=1e-5)


def test_segment_pass_rejects_other_devices():
    meta = torch.empty((2, 7), device="meta")
    vec = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segment_pass(torch.empty((1, 2, 4), device="meta"), 1, meta, meta,
                     meta, meta, vec, vec,
                     torch.empty((2, 4, 6), device="meta"),
                     torch.empty(6, device="meta"), vec, 1.0, 1e-8, 1e-9,
                     torch.empty(1, device="meta"),
                     torch.empty(1, device="meta"),
                     torch.empty(4, device="meta"))


def _cuda_case(leaf_status, Pc=4096, n=8, E=8):
    """Trees, epochs and data flags on the card from the port's own
    sampler (no JAX)."""
    from smcsmc_tpu_torch.kernels.tree import (
        epochs_from_demography,
        make_initial_trees,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(21 + leaf_status)
    epochs = epochs_from_demography(_demo(E, n), dev)
    trees = make_initial_trees(gen, epochs, Pc, [0] * n)
    hd = torch.from_numpy(_has_data(n, leaf_status)).to(dev)
    if leaf_status == -1:
        hd[:] = False
    return gen, epochs, trees, hd


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_status", [1, 0, -1])
def test_cuda_segment_pass_matches_plain(leaf_status):
    """``segment_pass`` on the card against ``segment_pass_plain``, held as
    the trip kernel is below; FIFO slot 0 starts empty so that it ends as
    pending x mask, and the other slots must come back untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    Pc, n, E = 4096, 8, 8
    gen, epochs, trees, hd = _cuda_case(leaf_status, Pc, n, E)
    dev = hd.device
    start, inv2ne = epochs.start.contiguous(), epochs.inv2ne.contiguous()
    fifo0 = torch.rand((Pc, F_SLOTS, 6 * E), generator=gen, device=dev)
    fifo0[:, 0] = 0.0
    mask = (torch.rand(6 * E, generator=gen, device=dev) < 0.7).float()
    for T, L, nr_scale in ((1, 20000.0, 1.5), (64, 50000.0, 0.1)):
        base = dict(time=trees.time, parent=trees.parent,
                    child0=trees.child0, child1=trees.child1,
                    next_rec=torch.rand(Pc, generator=gen, device=dev)
                    * nr_scale * L,
                    log_w=torch.zeros(Pc, device=dev))
        u = torch.rand((T, Pc, 4), generator=gen, device=dev)
        outs = {}
        for name, fn in (("plain", segment_pass_plain),
                         ("kernel", segment_pass)):
            st = {k: v.clone().contiguous() for k, v in base.items()}
            fifo, tl = fifo0.clone(), torch.empty(Pc, device=dev)
            launches = segment_pass.launches
            fn(u, leaf_status, *(st[k] for k in _SEG_ORDER), fifo, mask, tl,
               L, MU, RHO, start, inv2ne, hd)
            assert segment_pass.launches == launches + (name == "kernel")
            assert torch.equal(fifo[:, 1:], fifo0[:, 1:])
            outs[name] = dict(st, tl=tl, pending=fifo[:, 0])
        torch.cuda.synchronize()
        trees_d, floats_d, errs = disagreement(outs["kernel"], outs["plain"],
                                               L, MU)
        assert int(trees_d.sum()) <= 0.001 * Pc, (T, int(trees_d.sum()))
        if T == 1:
            assert not floats_d.any(), errs
        else:
            assert int((trees_d | floats_d).sum()) <= 0.001 * Pc, errs


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_status", [1, 0, -1])
def test_cuda_kernel_matches_plain(leaf_status):
    """Kernel vs plain version on the card, inputs from the port's own
    initial trees (no JAX), floats held to rtol 1e-4 plus an atol in each
    field's own units (``float_tolerances``), as in chip_smoke.py.  One
    trip: trees equal in >= 99.9% of particles and every float within
    tolerance where they are.  64 trips over the sweep's longest segment
    (50 kb): >= 99.9% of particles agree in trees and floats, since a chain
    of trips can amplify a last-bit difference in a node height."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smcsmc_tpu_torch.kernels.tree import tree_summaries

    Pc, n, E = 4096, 8, 8
    gen, epochs, trees, hd = _cuda_case(leaf_status, Pc, n, E)
    dev = hd.device
    tl, tle, B = tree_summaries(trees, epochs, leaf_status, hd)
    for T, L, nr_scale in ((1, 20000.0, 1.5), (64, 50000.0, 0.1)):
        base = dict(time=trees.time, parent=trees.parent,
                    child0=trees.child0, child1=trees.child1,
                    next_rec=torch.rand(Pc, generator=gen, device=dev)
                    * nr_scale * L,
                    upd=torch.zeros(Pc, device=dev),
                    log_w=torch.zeros(Pc, device=dev), tl=tl, B=B, tl_e=tle,
                    pending=torch.zeros((Pc, 6 * E), device=dev))
        u = torch.rand((T, Pc, 4), generator=gen, device=dev)
        outs = {}
        for name, fn in (("plain", trip_plain), ("kernel", trip)):
            st = {k: v.clone().contiguous() for k, v in base.items()}
            fn(u, leaf_status, *(st[k] for k in _ORDER), L, MU, RHO,
               epochs.start.contiguous(), epochs.inv2ne.contiguous(), hd)
            outs[name] = st
        torch.cuda.synchronize()
        trees_d, floats_d, errs = disagreement(outs["kernel"], outs["plain"],
                                               L, MU)
        assert int(trees_d.sum()) <= 0.001 * Pc, (T, int(trees_d.sum()))
        if T == 1:
            assert not floats_d.any(), errs
        else:
            assert int((trees_d | floats_d).sum()) <= 0.001 * Pc, errs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["n8E8", "caps"])
@pytest.mark.parametrize("leaf_status", [1, 0, -1])
@pytest.mark.parametrize("delay_type", ["recomb", "coal"])
def test_cuda_biased_segment_pass_matches_plain(leaf_status, delay_type,
                                                shape):
    """The biased ``segment_pass`` on the card against its plain version,
    held as the plain pass is above, with the pilot weight and the ring of
    delayed factors (some slots free, some due at the segment end, some
    rings full) compared too; at n=8, E=8 with 3 sections, and at the
    kernel's caps (n=8, E=64, 8 sections, 32 slots, a particle count that
    leaves the last block ragged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.tree import INF

    if shape == "caps":
        Pc, n, E, D = 4097, 8, 64, 32
        bounds = [0.0, 300.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0,
                  32000.0, INF]
        strengths = [6.0, 5.0, 4.0, 3.0, 1.0, 2.0, 1.5, 1.25]
    else:
        Pc, n, E, D = 4096, 8, 8, 32
        bounds, strengths = [0.0, 2000.0, 20000.0, INF], [4.0, 2.0, 1.0]
    gen, epochs, trees, hd = _cuda_case(leaf_status, Pc, n, E)
    dev = hd.device
    start, inv2ne = epochs.start.contiguous(), epochs.inv2ne.contiguous()
    fifo0 = torch.rand((Pc, F_SLOTS, 6 * E), generator=gen, device=dev)
    fifo0[:, 0] = 0.0
    mask = (torch.rand(6 * E, generator=gen, device=dev) < 0.7).float()
    heights = torch.tensor(bounds, device=dev)
    strengths = torch.tensor(strengths, device=dev)
    delays = torch.linspace(3000.0, 9000.0, E, device=dev)
    front = 10000.0
    for T, L, nr_scale in ((1, 20000.0, 1.5), (64, 50000.0, 0.1)):
        used = torch.rand((Pc, D), generator=gen, device=dev) < 0.3
        used[:16] = True  # full rings: the factor goes to the pilot at once
        ring0 = (torch.where(used, front + torch.rand(
                     (Pc, D), generator=gen, device=dev) * 2 * L,
                     torch.full((Pc, D), INF, device=dev)),
                 torch.randn((Pc, D), generator=gen, device=dev),
                 torch.rand((Pc, D), generator=gen, device=dev) * 3000.0,
                 torch.randint(1, 4, (Pc, D), generator=gen, device=dev,
                               dtype=torch.int32))
        base = dict(time=trees.time, parent=trees.parent,
                    child0=trees.child0, child1=trees.child1,
                    next_rec=torch.rand(Pc, generator=gen, device=dev)
                    * nr_scale * L,
                    log_w=torch.randn(Pc, generator=gen, device=dev))
        lp0 = torch.randn(Pc, generator=gen, device=dev)
        u = torch.rand((T, Pc, 4), generator=gen, device=dev)
        outs = {}
        for name, fn in (("plain", segment_pass_plain),
                         ("kernel", segment_pass)):
            st = {k: v.clone().contiguous() for k, v in base.items()}
            fifo, tl = fifo0.clone(), torch.empty(Pc, device=dev)
            b = BiasedPass(lp0.clone(), *(x.clone() for x in ring0), heights,
                           strengths, delays, front, delay_type)
            launches = segment_pass.biased_launches
            fn(u, leaf_status, *(st[k] for k in _SEG_ORDER), fifo, mask, tl,
               L, MU, RHO, start, inv2ne, hd, b)
            assert segment_pass.biased_launches == launches + (
                name == "kernel")
            assert torch.equal(fifo[:, 1:], fifo0[:, 1:])
            outs[name] = dict(st, tl=tl, pending=fifo[:, 0],
                              log_pilot=b.log_pilot, df_pos=b.df_pos,
                              df_logf=b.df_logf, df_delta=b.df_delta,
                              df_k=b.df_k)
        torch.cuda.synchronize()
        assert not torch.equal(outs["plain"]["df_pos"], ring0[0])
        trees_d, floats_d, errs = disagreement(outs["kernel"], outs["plain"],
                                               L, MU)
        assert int(trees_d.sum()) <= 0.001 * Pc, (T, int(trees_d.sum()))
        if T == 1:
            assert not floats_d.any(), errs
        else:
            assert int((trees_d | floats_d).sum()) <= 0.001 * Pc, errs


@pytest.mark.cuda
def test_cuda_kernel_resources_of_every_variant():
    """``kernel_resources`` reports every field for every kernel variant,
    at the main path's and the genome path's shape: registers, a stack,
    shared bytes and what fits on an SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smcsmc_tpu_torch.kernels.trip import (
        RESOURCE_VARIANTS,
        RESOURCES,
        kernel_resources,
    )

    for n, E in ((4, 9), (8, 33)):
        for variant in RESOURCE_VARIANTS:
            kw = dict(Pp=2, Mw=56) if variant == "migration" else {}
            res = kernel_resources(variant, n, E, **kw)
            assert set(RESOURCES) | {"particles_per_sm",
                                     "waves_at_10000"} == set(res), variant
            assert res["registers"] > 0 and res["local_bytes"] >= 0
            assert res["dynamic_shared_bytes"] > 0
            assert res["blocks_per_sm"] >= 1 and res["sms"] >= 1
            assert res["particles_per_sm"] == (res["blocks_per_sm"]
                                               * res["particles_per_block"])
            assert res["waves_at_10000"] >= 1


@pytest.mark.parametrize("args,match", [
    (("bogus", 4, 9), "unknown kernel variant"),
    (("segment_pass", 65, 9), "leaves"),
    (("migration", 9, 8, 2, 56), "leaves"),
    (("trip", 8, 65), "epochs"),
    (("biased", 8, 33, 1, 0, 9), "sections"),
    (("migration", 4, 8, 5, 56), "populations"),
    (("migration", 4, 8, 2, 97), "buffers"),
    (("migration", 4, 8, 2, 0), "buffers"),
])
def test_kernel_resources_refuses_before_any_cuda_call(monkeypatch, args,
                                                       match):
    """An unknown variant or a shape beyond the kernels' caps is refused
    by name before the library is loaded or the card asked."""
    import smcsmc_tpu_torch.kernels.trip as trip_mod

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(trip_mod, "load_trip_library", no_library)
    with pytest.raises(ValueError, match=match):
        trip_mod.kernel_resources(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["twopop", "overflow", "capped", "caps"])
@pytest.mark.parametrize("leaf_status", [1, 0, -1])
def test_cuda_migration_segment_pass_matches_plain(leaf_status, case):
    """The migration ``segment_pass`` on the card against its plain version
    on trees of bench.py's two-population model with filled buffers (for
    ``overflow``, m = 2e-4 into 16-event buffers, so that events are
    dropped; for ``capped``, walks bounded at 3 events, so that some
    force-coalesce onto the root lineage; for ``caps``, the kernel's caps,
    ``sweep_profile.caps_demo`` with 96-event buffers, at a particle count
    that leaves the last block ragged): one trip and 64 trips.  No tree
    mismatch; node times, populations and the buffers' times and
    destinations bit for bit; the walk diagnostics equal; floats within
    ``float_tolerances``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smcsmc_tpu_torch.kernels.migration import (
        MAX_WALK_EVENTS,
        MigrationPass,
        migration_tables,
        stats_offsets,
    )
    from smcsmc_tpu_torch.kernels.tree import (
        epochs_from_demography,
        make_initial_trees,
    )
    from smcsmc_tpu_torch.kernels.trip import kernel_resources
    from smcsmc_tpu_torch.sweep_profile import caps_demo, twopop_demo

    if case == "caps":
        demo, Pc, Mw = caps_demo(), 4097, 96
    else:
        m, Mw = (2e-4, 16) if case == "overflow" else (5e-5, 56)
        demo, Pc = twopop_demo(L=1e4, m=m), 4096
    n, E, Pp = demo.num_samples, demo.num_epochs, demo.num_populations
    if case == "caps":
        assert Pc % kernel_resources("migration", n, E, Pp, Mw)[
            "particles_per_block"] != 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(31 + leaf_status)
    epochs = epochs_from_demography(demo, dev)
    trees = make_initial_trees(gen, epochs, Pc, demo.sample_pops, max_mig=Mw)
    hd = torch.from_numpy(_has_data(n, leaf_status)).to(dev)
    if leaf_status == -1:
        hd[:] = False
    K = stats_offsets(E, Pp)["width"]
    start, inv2ne = epochs.start.contiguous(), epochs.inv2ne.contiguous()
    fifo0 = torch.rand((Pc, F_SLOTS, K), generator=gen, device=dev)
    fifo0[:, 0] = 0.0
    mask = (torch.rand(K, generator=gen, device=dev) < 0.7).float()
    tables = migration_tables(epochs)
    for T, L, nr_scale in ((1, 20000.0, 1.5), (64, 50000.0, 0.1)):
        base = dict(time=trees.time, parent=trees.parent,
                    child0=trees.child0, child1=trees.child1,
                    next_rec=torch.rand(Pc, generator=gen, device=dev)
                    * nr_scale * L,
                    log_w=torch.randn(Pc, generator=gen, device=dev))
        u = torch.rand((T, Pc, 4), generator=gen, device=dev)
        key = torch.randint(0, 2 ** 31 - 1, (2,), generator=gen, device=dev,
                            dtype=torch.int32)
        outs = {}
        for name, fn in (("plain", segment_pass_plain),
                         ("kernel", segment_pass)):
            st = {k: v.clone().contiguous() for k, v in base.items()}
            fifo, tl = fifo0.clone(), torch.empty(Pc, device=dev)
            mp = MigrationPass(trees.pop.clone(), trees.mig_time.clone(),
                               trees.mig_dest.clone(),
                               torch.zeros(2, dtype=torch.float64,
                                           device=dev), key, *tables,
                               3 if case == "capped" else MAX_WALK_EVENTS)
            launches = segment_pass.migration_launches
            fn(u, leaf_status, *(st[k] for k in _SEG_ORDER), fifo, mask, tl,
               L, MU, RHO, start, inv2ne, hd, None, mp)
            assert segment_pass.migration_launches == launches + (
                name == "kernel")
            assert torch.equal(fifo[:, 1:], fifo0[:, 1:])
            outs[name] = dict(st, tl=tl, pending=fifo[:, 0], pop=mp.pop,
                              mig_time=mp.mig_time, mig_dest=mp.mig_dest,
                              diag=mp.diag)
        torch.cuda.synchronize()
        trees_d, floats_d, errs = disagreement(outs["kernel"], outs["plain"],
                                               L, MU, Pp=Pp)
        assert int(trees_d.sum()) == 0, (T, int(trees_d.sum()))
        assert not floats_d.any(), errs
        for k in ("time", "parent", "child0", "child1", "pop", "mig_time",
                  "mig_dest", "diag"):
            assert torch.equal(outs["kernel"][k], outs["plain"][k]), (T, k)
        if case == "overflow" and T == 64:
            assert float(outs["plain"]["diag"][1]) > 0
        if case == "capped":
            assert float(outs["plain"]["diag"][0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("vb", [False, True])
@pytest.mark.parametrize("variant", ["guide", "guide+local", "biased+local",
                                     "local"])
def test_cuda_guided_and_local_passes_match_plain(variant, vb):
    """Each guided or local variant of ``segment_pass`` on the card against
    its plain version, on a guide that is not constant and a ring of
    pending events 30% in use (16 rings full): one trip with no tree
    mismatch, every float within ``float_tolerances`` and the rings equal
    (bitmasks and drops exactly), on a guide that changes in every window;
    64 trips with at most 0.1% of the particles apart, on a guide that
    changes every 50 windows.  The kernel's count of its variant goes up by one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smcsmc_tpu_torch import em as tem
    from smcsmc_tpu_torch.demography import Demography as TDemography
    from smcsmc_tpu_torch.kernels import guide as tguide
    from smcsmc_tpu_torch.kernels import local as tlocal
    from smcsmc_tpu_torch.kernels import trip as ttrip
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.tree import (
        INF,
        epochs_from_demography as t_epochs,
        make_initial_trees,
    )

    biased = variant != "local"
    guide = variant.startswith("guide")
    local = variant.endswith("local")
    Pc, n, E, R = 4096, 4, 9, 32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    demo = _demo(E, n)
    demo = TDemography(**{k: getattr(demo, k) for k in (
        "change_times", "pop_sizes", "mig_rates", "sample_pops",
        "mutation_rate", "recombination_rate", "sequence_length")})
    epochs = t_epochs(demo, dev)
    trees = make_initial_trees(gen, epochs, Pc, [0] * n)
    hd = torch.ones(n, dtype=torch.bool, device=dev)
    start, inv2ne = epochs.start.contiguous(), epochs.inv2ne.contiguous()
    front = 10000.0
    rng = np.random.default_rng(2)
    Wg = int(np.ceil((front + 1e5) / 100.0))
    rate, leaf = RHO * rng.uniform(0.2, 3.0, Wg), rng.uniform(0.3, 2.0,
                                                               (Wg, n))
    # chains of trips on a guide that changes every 50 windows (as a
    # smoothed one does at its change points; chip_smoke.GUIDE_CHAIN_ROWS)
    guides = {1: tguide.guide_tables(rate, leaf, RHO, 100.0, dev),
              64: tguide.guide_tables(np.repeat(rate[::50], 50)[:Wg],
                                      np.repeat(leaf[::50], 50, axis=0)[:Wg],
                                      RHO, 100.0, dev)}
    vb_t = ((tem.vb_pass_tables(demo, (
        rng.uniform(0.05, 5.0, (E, 1)), rng.uniform(0.05, 5.0, (E, 1, 1))),
        tem.EMConfig(vb=True))) if vb else None)
    if vb_t is not None:
        vb_t = tuple(torch.as_tensor(x, device=dev) for x in vb_t)
    name = ttrip.launch_count(biased, False, vb, guide, local)
    for T, L, nr_scale in ((1, 20000.0, 1.5), (64, 50000.0, 0.1)):
        used = torch.rand((Pc, R), generator=gen, device=dev) < 0.3
        used[:16] = True
        pos = front - 2e4 * torch.rand((Pc, R), generator=gen, device=dev)
        ring0 = (torch.where(used, pos, INF),
                 torch.where(used, pos + 3e4, INF),
                 torch.where(used, 1e4 * torch.rand(
                     (Pc, R), generator=gen, device=dev), 0.0),
                 torch.where(used, torch.randint(1, 16, (Pc, R), generator=gen,
                                                 device=dev), 0))
        dfs = (torch.full((Pc, 32), INF, device=dev),
               torch.zeros((Pc, 32), device=dev),
               torch.zeros((Pc, 32), device=dev),
               torch.zeros((Pc, 32), dtype=torch.int32, device=dev))
        base = dict(time=trees.time, parent=trees.parent,
                    child0=trees.child0, child1=trees.child1,
                    next_rec=torch.rand(Pc, generator=gen, device=dev)
                    * nr_scale * L,
                    log_w=torch.randn(Pc, generator=gen, device=dev))
        u = torch.rand((T, Pc, 4), generator=gen, device=dev)
        fifo0 = torch.zeros((Pc, 4, 6 * E), device=dev)
        mask = torch.ones(6 * E, device=dev)
        outs = {}
        for which, fn in (("plain", ttrip.segment_pass_plain),
                          ("kernel", ttrip.segment_pass)):
            st = {k: v.clone().contiguous() for k, v in base.items()}
            fifo, tl = fifo0.clone(), torch.empty(Pc, device=dev)
            b = (BiasedPass(torch.zeros(Pc, device=dev),
                            *(x.clone() for x in dfs),
                            torch.tensor([0.0, 2000.0, INF], device=dev),
                            torch.tensor([3.0, 1.0], device=dev),
                            torch.linspace(3000.0, 9000.0, E, device=dev),
                            front) if biased else None)
            lp = (tlocal.LocalPass(
                *(x.clone() for x in ring0),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.linspace(2000.0, 40000.0, E, device=dev),
                torch.zeros(Pc, device=dev), front) if local else None)
            before = getattr(ttrip.segment_pass, name)
            fn(u, 1, *(st[k] for k in ("time", "parent", "child0", "child1",
                                        "next_rec", "log_w")), fifo, mask,
               tl, L, MU, RHO, start, inv2ne, hd, b, vb=vb_t,
               guide=guides[T] if guide else None, local=lp)
            assert getattr(ttrip.segment_pass, name) == before + (
                which == "kernel")
            outs[which] = dict(st, tl=tl, pending=fifo[:, 0], ring=lp)
            if biased:
                outs[which].update(log_pilot=b.log_pilot, df_pos=b.df_pos,
                                   df_logf=b.df_logf, df_delta=b.df_delta,
                                   df_k=b.df_k)
        torch.cuda.synchronize()
        rings = [outs[w].pop("ring") for w in ("kernel", "plain")]
        trees_d, floats_d, errs = ttrip.disagreement(
            outs["kernel"], outs["plain"], L, MU)
        if T == 1:
            assert not trees_d.any() and not floats_d.any(), errs
            if local:
                tol = ttrip.float_tolerances(outs["plain"], L, MU)
                a, r = rings
                assert torch.equal(a.lr_desc, r.lr_desc)
                assert int(a.lr_dropped) == int(r.lr_dropped) > 0
                for k, atol in (("lr_pos", tol["next_rec"]),
                                ("lr_due", tol["next_rec"]),
                                ("lr_time", tol["time"]),
                                ("ropp", float(tol["pending"][4 * E]))):
                    torch.testing.assert_close(getattr(a, k), getattr(r, k),
                                               rtol=1e-4, atol=atol)
        else:
            assert int((trees_d | floats_d).sum()) <= 0.001 * Pc, errs
