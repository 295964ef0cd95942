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
@pytest.mark.parametrize("leaf_status", [1, 0, -1])
@pytest.mark.parametrize("delay_type", ["recomb", "coal"])
def test_cuda_biased_segment_pass_matches_plain(leaf_status, delay_type):
    """The biased ``segment_pass`` on the card against its plain version,
    held as the plain pass is above, with the pilot weight and the ring of
    delayed factors (some slots free, some due at the segment end, some
    rings full) compared too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.tree import INF

    Pc, n, E, D = 4096, 8, 8, 32
    gen, epochs, trees, hd = _cuda_case(leaf_status, Pc, n, E)
    dev = hd.device
    start, inv2ne = epochs.start.contiguous(), epochs.inv2ne.contiguous()
    fifo0 = torch.rand((Pc, F_SLOTS, 6 * E), generator=gen, device=dev)
    fifo0[:, 0] = 0.0
    mask = (torch.rand(6 * E, generator=gen, device=dev) < 0.7).float()
    heights = torch.tensor([0.0, 2000.0, 20000.0, INF], device=dev)
    strengths = torch.tensor([4.0, 2.0, 1.0], device=dev)
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
