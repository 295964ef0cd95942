"""Hold the segment pass of ``csrc/trip.cu`` to another commit's, bit for bit,
on the CPU: no chip, no nvcc.

    python3 tools/rehearse/rehearse.py [--against COMMIT] [--quick] [--vb]
        [--guide] [--wide] [--arg] [--mig-proposal]

Builds the working tree's ``smcsmc_tpu_torch/csrc/trip.cu`` and COMMIT's
(``git show``, default HEAD) as host C++ with g++ against the stand-in
``cuda_runtime.h`` beside this file (every lane a thread, so that the
kernels' shuffles, ballots and warp syncs run as written), into
``build/rehearse/``, and runs ``smc_segment_pass_launch`` of both on
identical CPU tensors.  Every output must be equal bit for bit: the trees,
``next_rec``, ``log_w``, ``log_pilot``, the ring's four rows, the FIFO and
``tl_out``.  Cases of the biased pass (P of 150-203, so that the last block
is ragged): (n=8, E=33, 2 sections), (n=4, E=9, 2) and the caps (n=8,
E=64, 8) x leaf status 1, 0, -1 x (one trip at 20 kb, 64 trips at 50 kb)
x delay type 0 and 1; then at (8, 33, 2) 64 trips with every ring full,
every ring empty, factors due exactly at the segment end, and delay k 1
and 5, each with both delay types.  The ring is ``chip_smoke``'s (30% of
the slots in use, the first 16 rings full, positions in [front, front +
2L)).  The plain pass runs on every sixth case's inputs too.  ``--quick``
runs every fifth case.  Exits 1 if any case differs.  The arithmetic is the
host's (its ``logf`` is not the card's), so hold a change to a commit, not
to the plain version.

``--guide`` holds the working tree's GUIDE and LOCAL variants (guided
biased pass with and without local recording, local biased and plain
passes; every fourth case plus one with every ring full, a 2 Mb table of
20,000 windows with the segment at its middle, a table that ends a
segment after the front, trees whose first internal node is tied in
time with its parent of lower index; a third of them with VB) to their
plain versions on a guide that is not constant and a ring 30% in use:
trees equal, floats within ``float_tolerances`` (rtol 1e-4), the ring's
positions, due positions, heights and the segment's opportunity within
their tolerances, its bitmasks, slots in use and drop count equal; and
every output bit for bit COMMIT's (``--against``) on the same inputs.

``--wide`` holds the working tree's wide kernels (more than 8 leaves: the
plain and biased passes with and without VB, and ``trip``) to their plain
versions: n of 9, 16, 33 and 64 at 9 and 64 epochs, leaf status 1, 0 and
-1, one trip at 20 kb and 64 trips at 50 kb, the biased pass with 2
sections at 9 epochs and 8 at 64 and a ring 30% in use, VB on every other
case, P ragged against the block; trees equal, floats within
``float_tolerances`` (rtol 1e-4), against the plain version run in
float64 (``chip_smoke._in_double``): the wide kernels compute a trip in
double,
and a float32 chain of 64 trips of the plain version itself drifts from
the float64 one by up to 2.4 node units at 64 leaves.  ``--quick`` runs
every third case.

``--arg`` holds the working tree's ARG variants (the plain, biased,
migration and wide plain passes, each with and without VB) to their plain
versions: ``chip_smoke.compare_arg`` itself on CPU tensors, at P of 160
(161 for the ragged cases and the rings of 1 and 3 slots) and at (161,
16) and (23, 64) for the wide pass, each launch going through
``trip.segment_pass_launch_args`` into the host build: trees, floats and
rings as the chip holds them (the migration pass's times within
tolerance, as the host's ``log1pf`` is not the card's), every output but
the ring bit for bit the same kernel's without ARG.  ``--quick`` takes P
of 48.  Every launch of those cases (the ARG variant's and the same
pass's without ARG) also runs COMMIT's kernel (``--against``) on a copy
of its inputs, and every tensor, the ring included, must be bit for bit
COMMIT's.

``--mig-proposal`` holds the working tree's proposal variants of the
migration pass (biased, guided, local, biased local and guided local, each
with and without VB) to their plain versions: ``chip_smoke``'s
``compare_mig_proposal`` on CPU tensors (its cases: twopop at each leaf
status, one trip and 64, the caps corner with 8 sections, the three delay
types, a ring of delayed factors and one of local events 30% in use, a
guide that is not constant), at P of 161 and 49 at the caps (``--quick``:
49 and 23), trees, buffers' destinations, floats, walk diagnostics and
rings as the chip holds them but the times within tolerance (the host's
``log1pf`` is not the card's).  Then the migration pass without the
proposal, with and without VB, on ``chip_smoke.MIG_CASES`` at those
particle counts (one trip and 64), and its ARG variant at one case each.
Every launch, the proposal variants' too, also runs COMMIT's kernel
(``--against``) on a copy of its inputs: every tensor bit for bit
COMMIT's.

``--vb`` holds the working tree's VB variants instead (every fifth case,
biased and plain pass): with VB tables of zeros bit for bit the pass
without VB; with ``chip_smoke.vb_tables``'s small-count tables against the
plain version with the same tables, trees equal and floats within
``float_tolerances`` (rtol 1e-4), as ``chip_smoke.py`` holds them."""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from smcsmc_tpu_torch.kernels.tree import (  # noqa: E402
    INF,
    epochs_from_demography,
    make_initial_trees,
)

SOURCE = "smcsmc_tpu_torch/csrc/trip.cu"
LOCAL_STATE = ("lr_pos", "lr_due", "lr_time", "lr_desc", "lr_dropped")
OUT = ROOT / "build" / "rehearse"
# the source's device launches, as host loops
LAUNCHES = (
    ("kernel<<<grid, threads, bytes, stream>>>(a);",
     "host_launch(kernel, grid, threads, bytes, a);"),
    ("noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();", ""),
    ("extern __shared__ float smem[];", "float* smem = g_smem;"),
)


def build(text: str, name: str, out: Path = OUT) -> ctypes.CDLL:
    """``text`` (a trip.cu) as a host library ``<out>/<name>.so``."""
    out.mkdir(parents=True, exist_ok=True)
    for old, new in LAUNCHES:
        text = text.replace(old, new)
    src = out / f"{name}.cpp"
    src.write_text(text)
    lib = out / f"{name}.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
         "-shared", "-fPIC", f"-I{HERE}", "-include", "cuda_runtime.h",
         "-o", str(lib), str(src), str(HERE / "host_glue.cpp")], check=True)
    dll = ctypes.CDLL(str(lib))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # a source with VB takes its two tables before the stream, one with
    # the guide and local recording their eight pointers (nine with the
    # guide's search pivots) and three sizes
    dll.vb = "vb_coal" in text
    dll.gl = "cum_mass" in text
    dll.top = "g_top" in text  # the guide's search pivots among its tables
    dll.arg = "arg_desc" in text
    dll.smc_segment_pass_launch.argtypes = [
        vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        cf, cf, cf, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ci, ci, cf, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ci, ci, ci] + [vp, vp] * dll.vb + (
            [vp, vp, vp] + [vp] * dll.top
            + [ci, cf, vp, vp, vp, vp, vp, vp, vp, ci]) * dll.gl + [
            vp, vp, vp, vp, vp, vp, vp, ci] * dll.arg + [vp]
    dll.smc_segment_pass_launch.restype = ci
    dll.smc_trip_launch.argtypes = [
        vp, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        cf, cf, cf, vp, vp, vp, vp]
    dll.smc_trip_launch.restype = ci
    return dll


def case(P, n, E, S, ls, T, L, nr_scale, seed, full=False, empty=False,
         due_at_end=False, delay_type=0, delay_k=3, D=32,
         front=cs.BIAS_FRONT):
    """A biased segment pass's state and inputs on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)
    ep = epochs_from_demography(cs._demo(n, E), "cpu")
    trees = make_initial_trees(g, ep, P, [0] * n)
    hd = torch.ones(n, dtype=torch.bool)
    if ls == 0:
        hd[0] = hd[n // 2] = False
    elif ls == -1:
        hd[:] = False
    used = torch.rand((P, D), generator=g) < 0.3
    used[:16] = True
    if full:
        used[:] = True
    if empty:
        used[:] = False
    pos = front + 2 * L * torch.rand((P, D), generator=g)
    if due_at_end:
        pos[::3, ::2] = float(np.float32(front) + np.float32(L))
    st = dict(
        time=trees.time.clone(), parent=trees.parent.clone(),
        child0=trees.child0.clone(), child1=trees.child1.clone(),
        next_rec=torch.rand(P, generator=g) * nr_scale * L,
        log_w=torch.randn(P, generator=g),
        fifo=torch.rand((P, cs.FIFO_SLOTS, 6 * E), generator=g),
        tl=torch.zeros(P), log_pilot=torch.randn(P, generator=g),
        df_pos=torch.where(used, pos, torch.full((P, D), INF)),
        df_logf=torch.where(used, torch.randn((P, D), generator=g), 0.0),
        df_delta=torch.where(used, 3000.0 * torch.rand((P, D), generator=g),
                             0.0),
        df_k=torch.where(used, torch.randint(1, 4, (P, D), generator=g,
                                             dtype=torch.int32), 0))
    st["fifo"][:, 0] = 0.0
    heights, strengths = ((cs.BIAS_HEIGHTS, cs.BIAS_STRENGTHS) if S == 2
                          else (cs.BIAS_CAPS_HEIGHTS, cs.BIAS_CAPS_STRENGTHS))
    fix = dict(u=torch.rand((T, P, 4), generator=g),
               mask=(torch.rand(6 * E, generator=g) < 0.75).float(),
               start=ep.start.contiguous(), inv2ne=ep.inv2ne.contiguous(),
               hd=hd, heights=torch.tensor(heights),
               strengths=torch.tensor(strengths),
               delays=torch.linspace(3000.0, 30000.0, E), P=P, n=n, E=E,
               S=S, D=D, ls=ls, T=T, L=L, front=front,
               delay_type=delay_type, delay_k=delay_k)
    return st, fix


def _clone(x):
    """``x`` with every tensor in it (in tuples, named tuples, lists and
    dicts) cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _tensors(x):
    """The tensors in ``x``, in :func:`_clone`'s order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _same_bits(a, b) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def host_pass(lib, old=None, apart=None):
    """``segment_pass``'s interface on CPU tensors, launching ``lib``'s
    kernel (a host build): the wrapper's own argument packing, then
    ``smc_segment_pass_launch``.  With ``old`` (another build) each call
    first runs ``old`` on a copy of every argument, then appends to
    ``apart`` whether any tensor, every output and the ring included,
    differs from ``lib``'s in a bit."""
    from smcsmc_tpu_torch.kernels.trip import segment_pass_launch_args

    def launch(which, args, kw):
        _, packed = segment_pass_launch_args(*args, **kw)
        err = which.smc_segment_pass_launch(*packed, None)
        if err != 0:
            raise SystemExit(f"smc_segment_pass_launch returned {err}")

    def segment_pass(*args, **kw):
        if old is not None:
            args2, kw2 = _clone(args), _clone(kw)
            launch(old, args2, kw2)
        launch(lib, args, kw)
        if old is not None:
            apart.append(not all(_same_bits(x, y) for x, y in zip(
                _tensors((args, kw)), _tensors((args2, kw2)))))
    return segment_pass


def rehearse_arg(quick: bool, against: str) -> int:
    """The ``--arg`` check of the module docstring."""
    from smcsmc_tpu_torch.kernels.trip import segment_pass_plain

    cs.DEVICE = "cpu"
    new = build((ROOT / SOURCE).read_text(), "tree")
    old = build(subprocess.run(["git", "show", f"{against}:{SOURCE}"],
                               cwd=ROOT, capture_output=True, text=True,
                               check=True).stdout, "against")
    P = 48 if quick else 160
    apart = []
    ok = cs.compare_arg(host_pass(new, old, apart), segment_pass_plain, {},
                        P=P, wide_P=(P + 1, 23), mig_exact=False)
    cases = len(cs.arg_cases(P, (P + 1, 23)))
    print(f"{len(apart)} launches over {cases} ARG cases (ARG and without): "
          f"{sum(apart)} apart from {against}'s kernel in any bit")
    print("every ARG case holds" if ok else "some ARG case FAILS")
    return 0 if ok and not any(apart) else 1


def rehearse_mig_proposal(quick: bool, against: str) -> int:
    """The ``--mig-proposal`` check of the module docstring."""
    from smcsmc_tpu_torch.kernels.trip import segment_pass_plain

    cs.DEVICE = "cpu"
    new = build((ROOT / SOURCE).read_text(), "tree")
    old = build(subprocess.run(["git", "show", f"{against}:{SOURCE}"],
                               cwd=ROOT, capture_output=True, text=True,
                               check=True).stdout, "against")
    P, caps_P = (49, 23) if quick else (161, 49)
    apart = []
    ok = cs.compare_mig_proposal(host_pass(new, old, apart),
                                 segment_pass_plain, {}, P=P, caps_P=caps_P,
                                 exact=False)
    print(f"{len(apart)} launches of the proposal variants: {sum(apart)} "
          f"apart from {against}'s kernel in any bit", flush=True)
    proposal_apart = sum(apart)
    apart = []
    same = host_pass(new, old, apart)
    for label, kw, ls in cs.MIG_CASES:
        kw = {k: v for k, v in kw.items() if k != "P"}
        Pc = caps_P if kw.get("caps") else P
        for T, L, nr_scale in ((1, 20000.0, 1.5), (64, cs.MAX_SEG, 0.1)):
            c = cs.MigCase(Pc, ls, L, nr_scale, seed=13 * Pc + T + ls, **kw)
            u = c.uniforms(T)
            for vb in (None, cs.vb_tables(c.demo, T + ls)):
                c.run(same, u, c.fresh(), vb)
            print(f"migration {label} P={Pc} leaf_status={ls} trips={T}: "
                  f"{sum(apart[-2:])} of 2 launches apart from {against}'s",
                  flush=True)
    for vb in (False, True):
        cs.arg_migration(same, segment_pass_plain, {}, P, 1, 64, vb,
                         mig_exact=False)
    print(f"{len(apart)} launches of the migration pass without the "
          f"proposal: {sum(apart)} apart from {against}'s kernel in any bit")
    print("every proposal case holds" if ok else "some proposal case FAILS")
    return 0 if ok and not any(apart) and not proposal_apart else 1


def run(lib, st, f, biased=True, vb=None, guide=None, local=False):
    """One segment pass of ``lib`` on a copy of ``st``; ``vb`` = its VB
    table [E] (a library with VB only); ``guide`` a ``GuideTables`` and
    ``local`` the local ring of ``st`` (a library with them only)."""
    st = {k: v.clone() for k, v in st.items()}
    p = (lambda x: ctypes.c_void_p(x.data_ptr()))
    tables = ((p(vb), p(vb)) if vb is not None else (None, None)) * lib.vb
    if lib.gl:
        g = ((p(guide.g_rel), p(guide.cum_mass), p(guide.g_leaf))
             + (p(guide.pivots),) * lib.top
             + (guide.g_rel.shape[0], guide.ws) if guide is not None
             else (None,) * (3 + lib.top) + (0, 0.0))
        lo = ((*(p(st[k]) for k in LOCAL_STATE), p(f["lags"]),
               p(st["ropp"]), st["lr_pos"].shape[1]) if local
              else (None,) * 7 + (0,))
        tables = tables + g + lo
    if lib.arg:
        tables = tables + (None,) * 7 + (0,)
    bias = ((p(st["log_pilot"]), p(st["df_pos"]), p(st["df_logf"]),
             p(st["df_delta"]), p(st["df_k"]), p(f["heights"]),
             p(f["strengths"]), p(f["delays"]), f["D"], f["S"], f["front"],
             f["delay_type"], f["delay_k"]) if biased
            else (None,) * 8 + (0, 0, f["front"] if local else 0.0, 0, 0))
    err = lib.smc_segment_pass_launch(
        p(f["u"]), f["T"], f["P"], f["n"], f["E"], cs.FIFO_SLOTS, f["ls"],
        p(st["time"]), p(st["parent"]), p(st["child0"]), p(st["child1"]),
        p(st["next_rec"]), p(st["log_w"]), p(st["fifo"]), p(f["mask"]),
        p(st["tl"]), f["L"], cs.MU, cs.RHO, p(f["start"]), p(f["inv2ne"]),
        p(f["hd"]), *bias, *((None,) * 9), 0, 0, 0, *tables, None)
    if err != 0:
        raise SystemExit(f"smc_segment_pass_launch returned {err}")
    return st


def differing(a, b):
    """The fields of two outputs that are not equal bit for bit."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]


def cases():
    out = []
    for n, E, S, P in ((8, 33, 2, 203), (4, 9, 2, 150), (8, 64, 8, 161)):
        for ls in (1, 0, -1):
            for T, L, nr_scale in ((1, 20000.0, 1.5), (64, cs.MAX_SEG, 0.1)):
                for dt in (0, 1):
                    out.append(dict(P=P, n=n, E=E, S=S, ls=ls, T=T, L=L,
                                    nr_scale=nr_scale, delay_type=dt))
    for extra in (dict(full=True), dict(empty=True), dict(due_at_end=True),
                  dict(delay_k=1), dict(delay_k=5)):
        for dt in (0, 1):
            out.append(dict(P=203, n=8, E=33, S=2, ls=1, T=64, L=cs.MAX_SEG,
                            nr_scale=0.1, delay_type=dt, **extra))
    return out


def vb_table(E, seed):
    """[E] a VB table from counts in [0.05, 5], epoch 1 excluded."""
    from smcsmc_tpu_torch.em import EMConfig, vb_pass_tables

    counts = np.random.default_rng(seed).uniform(0.05, 5.0, (E, 1))
    demo = cs._demo(4, E)
    return torch.from_numpy(vb_pass_tables(
        demo, (counts, counts[:, :, None]),
        EMConfig(vb=True, xc_epochs=(1,)))[0][:, 0].copy())


def rehearse_vb() -> int:
    """The ``--vb`` check of the module docstring."""
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.trip import disagreement, segment_pass_plain

    new = build((ROOT / SOURCE).read_text(), "tree")
    failed = 0
    for j, c in enumerate(cases()[::5]):
        st, f = case(seed=300 + j, **c)
        vb = vb_table(f["E"], j)
        for biased in (True, False):
            zero = run(new, st, f, biased, torch.zeros_like(vb))
            bad = differing(zero, run(new, st, f, biased))
            got = run(new, st, f, biased, vb)
            ref = {k: v.clone() for k, v in st.items()}
            b = (BiasedPass(ref["log_pilot"], ref["df_pos"], ref["df_logf"],
                            ref["df_delta"], ref["df_k"], f["heights"],
                            f["strengths"], f["delays"], f["front"],
                            ("recomb", "coal")[f["delay_type"]], f["delay_k"])
                 if biased else None)
            segment_pass_plain(
                f["u"], f["ls"], *(ref[k] for k in cs.SEGMENT_STATE),
                ref["fifo"], f["mask"], ref["tl"], f["L"], cs.MU, cs.RHO,
                f["start"], f["inv2ne"], f["hd"], b,
                vb=(vb[:, None], torch.zeros((f["E"], 1, 1))))
            keys = cs.SEGMENT_STATE + (("log_pilot", "df_pos", "df_logf",
                                        "df_delta", "df_k") if biased else ())
            res = [{**{k: x[k] for k in keys}, "tl": x["tl"],
                    "pending": x["fifo"][:, 0]} for x in (got, ref)]
            trees, floats, errs = disagreement(*res, f["L"], cs.MU, 1e-4)
            moved = float((got["log_w"] - zero["log_w"]).abs().max())
            good = (not bad and not trees.any() and not floats.any()
                    and moved > 1e-3)
            print(f"vb {'biased' if biased else 'plain'} {c}: zero tables "
                  f"{'bit for bit' if not bad else f'DIFFER in {bad}'}; vs "
                  f"plain version {int(trees.sum())} trees, "
                  f"{int(floats.sum())} floats apart (log_w moved by "
                  f"{moved:.3g}) -> {'ok' if good else 'FAIL'}", flush=True)
            failed += not good
    print(f"{failed} of the VB cases fail")
    return 1 if failed else 0


def local_ring(st, f, seed, R=32, full_rows=16):
    """Add a ring of pending local events to ``st`` (30% of the slots in
    use, the first ``full_rows`` rings full, positions before the front and
    due anywhere from the front to two segments on) and the lags to
    ``f``."""
    g = torch.Generator().manual_seed(seed)
    P, n, front, L = f["P"], f["n"], f["front"], f["L"]
    used = torch.rand((P, R), generator=g) < 0.3
    used[:full_rows] = True
    pos = front - 2e4 * torch.rand((P, R), generator=g)
    st.update(
        lr_pos=torch.where(used, pos, torch.full((P, R), INF)),
        lr_due=torch.where(used, pos + 2e4 + 2 * L * torch.rand(
            (P, R), generator=g), torch.full((P, R), INF)),
        lr_time=torch.where(used, 5e4 * torch.rand((P, R), generator=g),
                            0.0),
        lr_desc=torch.where(used, torch.randint(1, 1 << n, (P, R),
                                                generator=g), 0),
        lr_dropped=torch.tensor(3, dtype=torch.int32),
        ropp=torch.zeros(P))
    f["lags"] = torch.linspace(2000.0, 40000.0, f["E"])


def guide_of(f, seed, windows=None):
    """A guide that is not constant: random rates around rho by 100-bp
    window, random leaf rates, over [0, front + 2L) or over ``windows``
    windows."""
    from smcsmc_tpu_torch.kernels.guide import guide_tables

    rng = np.random.default_rng(seed)
    W = windows or int(np.ceil((f["front"] + 2 * f["L"]) / 100.0))
    return guide_tables(cs.RHO * rng.uniform(0.2, 3.0, W),
                        rng.uniform(0.3, 2.0, (W, f["n"])), cs.RHO, 100.0,
                        "cpu")


def tie_first_node(st, n):
    """Give each tree's first internal node (n) its parent's time and swap
    the two nodes' labels, so that the parent has the lower index and the
    stable order of the internal nodes' times takes it before its child
    (which it then reads at rate 0)."""
    P, N = st["time"].shape
    for i in range(P):
        p = int(st["parent"][i, n])
        if p < 0:
            continue
        lab = list(range(N))
        lab[n], lab[p] = p, n
        rows = {k: st[k][i].clone() for k in ("time", "parent", "child0",
                                                "child1")}
        for j in range(N):
            st["time"][i, lab[j]] = rows["time"][j]
            for k in ("parent", "child0", "child1"):
                x = int(rows[k][j])
                st[k][i, lab[j]] = lab[x] if x >= 0 else -1
        st["time"][i, p] = st["time"][i, n]


# the variants of the --guide check: (biased, guide, local)
GUIDE_VARIANTS = ((True, True, False), (True, True, True),
                  (True, False, True), (False, False, True))


def guide_case(c, j, tied=False, windows=None, vb=False):
    """Case ``j`` of the --guide check: :func:`case` ``c`` (seed 500 + j)
    with a ring of pending local events (seed 700 + j; every ring full
    with ``full``), a guide that is not constant (seed j; of ``windows``
    windows where given), each tree's first internal node tied with its
    parent where ``tied``, and with ``vb`` a VB table (seed j).  Returns
    (state, inputs, guide, VB table or None)."""
    st, f = case(seed=500 + j, **c)
    local_ring(st, f, 700 + j, full_rows=f["P"] if c.get("full") else 16)
    if tied:
        tie_first_node(st, f["n"])
    return (st, f, guide_of(f, j, windows),
            vb_table(f["E"], j) if vb else None)


def check_guide(lib, st, f, gt, vb=None, old=None, variants=GUIDE_VARIANTS,
                label=""):
    """Each of ``variants`` of ``lib`` on state ``st`` and inputs ``f``,
    with the guide ``gt`` and VB table ``vb``, against its plain version:
    trees equal, floats within ``float_tolerances`` (rtol 1e-4), the local
    ring's positions, due positions, heights and the segment's
    opportunity within their tolerances, its bitmasks, slots in use and
    drop count equal; with ``old`` (another build) every output bit for bit
    ``old``'s.  Prints a line for each; returns [(name, good)]."""
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.local import LocalPass
    from smcsmc_tpu_torch.kernels.trip import (
        disagreement,
        float_tolerances,
        segment_pass_plain,
    )

    out = []
    for biased, guide, local in variants:
        got = run(lib, st, f, biased, vb, gt if guide else None, local)
        ref = {k: v.clone() for k, v in st.items()}
        b = (BiasedPass(ref["log_pilot"], ref["df_pos"], ref["df_logf"],
                        ref["df_delta"], ref["df_k"], f["heights"],
                        f["strengths"], f["delays"], f["front"],
                        ("recomb", "coal")[f["delay_type"]], f["delay_k"])
             if biased else None)
        lp = (LocalPass(*(ref[k] for k in LOCAL_STATE), f["lags"],
                        ref["ropp"], f["front"]) if local else None)
        segment_pass_plain(
            f["u"], f["ls"], *(ref[k] for k in cs.SEGMENT_STATE),
            ref["fifo"], f["mask"], ref["tl"], f["L"], cs.MU, cs.RHO,
            f["start"], f["inv2ne"], f["hd"], b,
            vb=None if vb is None else (vb[:, None],
                                        torch.zeros((f["E"], 1, 1))),
            guide=gt if guide else None, local=lp)
        keys = cs.SEGMENT_STATE + (("log_pilot", "df_pos", "df_logf",
                                    "df_delta", "df_k") if biased else ())
        res = [{**{k: x[k] for k in keys}, "tl": x["tl"],
                "pending": x["fifo"][:, 0]} for x in (got, ref)]
        trees, floats, errs = disagreement(*res, f["L"], cs.MU, 1e-4)
        ring_bad = []
        if local:
            tol = float_tolerances(res[1], f["L"], cs.MU)
            ro_atol = float(tol["pending"][4 * f["E"]])
            for k, atol in (("lr_pos", tol["next_rec"]),
                            ("lr_due", tol["next_rec"]),
                            ("lr_time", tol["time"]), ("ropp", ro_atol)):
                if not torch.allclose(got[k], ref[k], rtol=1e-4, atol=atol):
                    ring_bad.append(k)
            for k in ("lr_desc", "lr_dropped"):
                if not torch.equal(got[k], ref[k]):
                    ring_bad.append(k)
            if not torch.equal(got["lr_pos"] < INF, ref["lr_pos"] < INF):
                ring_bad.append("slots in use")
        pushed = int((ref["lr_pos"] != st["lr_pos"]).sum()) if local else 0
        apart = (differing(got, run(old, st, f, biased, vb,
                                    gt if guide else None, local))
                 if old is not None else [])
        good = (not trees.any() and not floats.any() and not ring_bad
                and not apart)
        name = (f"{'biased' if biased else 'plain'}"
                f"{' guide' if guide else ''}{' local' if local else ''}"
                f"{' vb' if vb is not None else ''}")
        against = ("" if old is None else "; against the commit "
                   + ("bit for bit" if not apart else f"DIFFER in {apart}"))
        print(f"{name}{label}: {int(trees.sum())} trees, "
              f"{int(floats.sum())} floats apart, ring "
              f"{'ok' if not ring_bad else ring_bad} ({pushed} slots "
              f"pushed, dropped {int(ref['lr_dropped']) if local else 0})"
              f"{against} -> {'ok' if good else 'FAIL'}", flush=True)
        out.append((name, good))
    return out


def guide_cases():
    """The ``--guide`` cases: (case, options of :func:`guide_case`)."""
    out = [(c, {}) for c in cases()[::4]]
    out.append((dict(P=203, n=8, E=33, S=2, ls=1, T=64, L=cs.MAX_SEG,
                     nr_scale=0.1, delay_type=0, full=True), {}))
    # a 2 Mb table, the segment at its middle: the search's full depth
    for n, T, L, nr in ((4, 64, cs.MAX_SEG, 0.1), (8, 1, 20000.0, 1.5)):
        out.append((dict(P=150, n=n, E=9, S=2, ls=1, T=T, L=L, nr_scale=nr,
                         delay_type=0, front=1e6), dict(windows=20000)))
    # a table that ends a segment after the front: gaps past its last
    # window
    out.append((dict(P=150, n=4, E=9, S=2, ls=1, T=64, L=1500.0,
                     nr_scale=0.5, delay_type=0), {}))
    # parents tied in time with a child of higher index
    for n, P in ((4, 150), (8, 203)):
        out.append((dict(P=P, n=n, E=9, S=2, ls=1, T=1, L=20000.0,
                         nr_scale=1.5, delay_type=0), dict(tied=True)))
    return out


def rehearse_guide(against: str) -> int:
    """The ``--guide`` check: the GUIDE and LOCAL variants against their
    plain versions on the same inputs, and bit for bit against
    ``against``'s."""
    new = build((ROOT / SOURCE).read_text(), "tree")
    old = build(subprocess.run(["git", "show", f"{against}:{SOURCE}"],
                               cwd=ROOT, capture_output=True, text=True,
                               check=True).stdout, "against")
    failed = 0
    for j, (c, opts) in enumerate(guide_cases()):
        st, f, gt, vb = guide_case(c, j, vb=j % 3 == 1, **opts)
        failed += sum(not good for _, good in check_guide(
            new, st, f, gt, vb, old, label=f" {c} {opts}"))
    print(f"{failed} of the guide and local cases fail")
    return 1 if failed else 0


def wide_cases():
    """The ``--wide`` cases: (n, E, P) x leaf status x (trips, L)."""
    out = []
    for n, E, P in ((9, 9, 45), (16, 9, 70), (16, 64, 37), (17, 9, 25),
                    (33, 64, 30), (64, 9, 26), (64, 64, 23)):
        for ls in (1, 0, -1):
            for T, L, nr_scale in ((1, 20000.0, 1.5), (64, cs.MAX_SEG, 0.1)):
                out.append(dict(P=P, n=n, E=E, S=2 if E == 9 else 8, ls=ls,
                                T=T, L=L, nr_scale=nr_scale, delay_type=0))
    return out


def run_trip(lib, st, f):
    """``trip`` of ``lib`` on a copy of ``st``'s trees from the tree
    summaries, with the FIFO's slot 0 as ``pending``."""
    from smcsmc_tpu_torch.kernels.tree import Epochs, Trees, tree_summaries

    st = {k: v.clone() for k, v in st.items()}
    trees = Trees(st["parent"], st["time"], st["child0"], st["child1"])
    tl, tle, B = tree_summaries(trees, Epochs(f["start"], (
        0.5 / f["inv2ne"])[:, None]), f["ls"], f["hd"])
    st.update(upd=torch.zeros(f["P"], dtype=tl.dtype), tl=tl.contiguous(),
              B=B.contiguous(), tl_e=tle.contiguous(),
              pending=torch.zeros((f["P"], 6 * f["E"]), dtype=tl.dtype))
    if lib is None:
        from smcsmc_tpu_torch.kernels.trip import trip_plain

        trip_plain(f["u"], f["ls"], *(st[k] for k in TRIP_FIELDS), f["L"],
                   cs.MU, cs.RHO, f["start"], f["inv2ne"], f["hd"])
        return st
    p = (lambda x: ctypes.c_void_p(x.data_ptr()))
    err = lib.smc_trip_launch(
        p(f["u"]), f["T"], f["P"], f["n"], f["E"], f["ls"],
        *(p(st[k]) for k in TRIP_FIELDS), f["L"], cs.MU, cs.RHO,
        p(f["start"]), p(f["inv2ne"]), p(f["hd"]), None)
    if err != 0:
        raise SystemExit(f"smc_trip_launch returned {err}")
    return st


TRIP_FIELDS = ("time", "parent", "child0", "child1", "next_rec", "upd",
               "log_w", "tl", "B", "tl_e", "pending")


def check_wide(lib, c, seed, vb_seed=None):
    """One ``--wide`` case ``c`` (a dict of :func:`case`'s arguments) made
    from ``seed``: the plain and the biased pass of ``lib`` (with a VB
    table drawn from ``vb_seed`` where one is given) and its ``trip``
    against their plain versions run in float64.  Prints a line for each
    and returns a list of (name, good, worst share of a tolerance)."""
    from smcsmc_tpu_torch.kernels.bias import BiasedPass
    from smcsmc_tpu_torch.kernels.trip import disagreement, segment_pass_plain

    st, f = case(seed=seed, **c)
    vb = vb_table(f["E"], vb_seed) if vb_seed is not None else None
    # the reference: the plain version in float64
    st_r, f_r, vb_r = (cs._in_double(x) for x in (st, f, vb))
    results = []
    for biased in (False, True):
        got = run(lib, st, f, biased, vb)
        ref = {k: v.clone() for k, v in st_r.items()}
        b = (BiasedPass(ref["log_pilot"], ref["df_pos"], ref["df_logf"],
                        ref["df_delta"], ref["df_k"], f_r["heights"],
                        f_r["strengths"], f_r["delays"], f["front"],
                        ("recomb", "coal")[f["delay_type"]], f["delay_k"])
             if biased else None)
        segment_pass_plain(
            f_r["u"], f["ls"], *(ref[k] for k in cs.SEGMENT_STATE),
            ref["fifo"], f_r["mask"], ref["tl"], f["L"], cs.MU, cs.RHO,
            f_r["start"], f_r["inv2ne"], f["hd"], b,
            vb=None if vb is None else (
                vb_r[:, None], torch.zeros((f["E"], 1, 1),
                                           dtype=vb_r.dtype)))
        keys = cs.SEGMENT_STATE + (("log_pilot", "df_pos", "df_logf",
                                    "df_delta", "df_k") if biased else ())
        results.append((f"{'biased' if biased else 'plain'}"
                        f"{' vb' if vb is not None else ''}",
                        [{**{k: x[k] for k in keys}, "tl": x["tl"],
                          "pending": x["fifo"][:, 0]}
                         for x in (got, ref)]))
    got, ref = run_trip(lib, st, f), run_trip(None, st_r, f_r)
    results.append(("trip", [{k: x[k] for k in TRIP_FIELDS}
                             for x in (got, ref)]))
    out = []
    for name, res in results:
        # the float64 answer as the float32 the kernel stores
        res[1] = {k: v.float() if v.dtype == torch.float64 else v
                  for k, v in res[1].items()}
        trees, floats, errs = disagreement(*res, f["L"], cs.MU, 1e-4)
        moved = int((res[1]["parent"] != st["parent"]).any(1).sum())
        good = not trees.any() and not floats.any()
        worst = max(errs, key=lambda k: errs[k][1])
        print(f"wide {name} {c}: {int(trees.sum())} trees, "
              f"{int(floats.sum())} floats apart ({moved} trees moved; "
              f"worst {worst} at {errs[worst][1]:.3g} of its "
              f"tolerance) -> {'ok' if good else 'FAIL'}", flush=True)
        out.append((name, good, errs[worst][1]))
    return out


def rehearse_wide(quick: bool) -> int:
    """The ``--wide`` check of the module docstring."""
    lib = build((ROOT / SOURCE).read_text(), "tree")
    failed = 0
    todo = wide_cases()[::3] if quick else wide_cases()
    for j, c in enumerate(todo):
        failed += sum(not good for _, good, _ in check_wide(
            lib, c, 900 + j, j if j % 2 else None))
    print(f"{failed} of the wide cases fail")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default="HEAD")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--vb", action="store_true")
    ap.add_argument("--guide", action="store_true")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--arg", action="store_true")
    ap.add_argument("--mig-proposal", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.mig_proposal:
        return rehearse_mig_proposal(args.quick, args.against)
    if args.arg:
        return rehearse_arg(args.quick, args.against)
    if args.wide:
        return rehearse_wide(args.quick)
    if args.vb:
        return rehearse_vb()
    if args.guide:
        return rehearse_guide(args.against)
    old = subprocess.run(["git", "show", f"{args.against}:{SOURCE}"],
                         cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    ref = build(old, "against")
    new = build((ROOT / SOURCE).read_text(), "tree")
    todo = cases()[::5] if args.quick else cases()
    failed = 0
    for j, c in enumerate(todo):
        st, f = case(seed=100 + j, **c)
        bad = differing(run(ref, st, f), run(new, st, f))
        moved = int((run(ref, st, f)["df_pos"] != st["df_pos"]).sum()) \
            if not bad else -1
        print(f"biased {c}: ring slots moved {moved} -> "
              + ("bit for bit" if not bad else f"DIFFER in {bad}"),
              flush=True)
        failed += bool(bad)
        if j % 6 == 0 and not args.quick:
            bad = differing(run(ref, st, f, False), run(new, st, f, False))
            print("  plain pass, same inputs -> "
                  + ("bit for bit" if not bad else f"DIFFER in {bad}"),
                  flush=True)
            failed += bool(bad)
    print(f"{failed} of the cases differ from {args.against}'s kernel")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
