"""The torch port's EM loop against smcsmc_tpu/em.py.

The host helpers copied from em.py must give identical results.  The sweep
draws from other RNG streams, so ``run_chunk`` is held to JAX's
statistically: same data, three filter seeds per side, P=64.  The bands
were calibrated from six seeds per side on this data: the per-seed spread
of LogL is about 15 (on -1770), of the pooled Ne about 15% and of the
recombination rate about 25%; the bands are about three standard errors of
the difference of the 3-seed means.

``run_em`` over several chunks is held to the JAX ``run_em`` in what does
not depend on the RNG stream: the chunk windows, the seeds, the rows,
columns and Clump values of ``chunkfinal.out``, ``result.out`` and the
``.resample`` format; and to itself in what does: the aggregate is the sum
of the chunks' rows, and a second run on the same ``outdir`` sweeps nothing
and returns what the first returned.
"""

import os

import numpy as np
import pytest
import torch

from smcsmc_tpu import em as jem
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.segio import SegData
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.demography import Demography as PortDemography

torch.set_num_threads(1)


def _demo(E=8, n=4, L=2e5, ne=10000.0):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]))
    return Demography(
        change_times=change, pop_sizes=np.full((E, 1), ne),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L,
    )


def _tcfg(**kw):
    return tem.EMConfig(device="cpu", **kw)


def test_host_helpers_match_jax():
    demo = _demo(E=5)
    for a, b in zip(tem.prior_pseudostats(demo), jem.prior_pseudostats(demo)):
        np.testing.assert_array_equal(a, b)
    al = np.random.default_rng(0).choice([0, 1, -1], size=(50, 6)).astype(
        np.int8)
    al[3] = -1
    al[4] = 1
    np.testing.assert_array_equal(tem._leaf_status(al), jem._leaf_status(al))


@pytest.mark.parametrize("options", [
    {},
    {"use_cap": True, "ne_cap": 3000.0},
    {"xc_epochs": (0, 4)},
    {"xr_epochs": (1, 2, 5)},
    {"infer_recomb": False},
    {"use_cap": True, "ne_cap": 900.0, "xc_epochs": (2,), "xr_epochs": (0,)},
])
def test_m_step_matches_jax(options):
    demo = _demo(E=6)
    demo.pop_sizes[:, 0] = [9e3, 1.1e4, 1.2e4, 8e3, 1e4, 2e4]
    rng = np.random.default_rng(1)
    stats = jem.SuffStats(
        coal_opp=rng.uniform(1e3, 1e5, (6, 1)),
        coal_cnt=rng.uniform(0.1, 20.0, (6, 1)),
        mig_opp=np.ones((6, 1)), mig_cnt=np.zeros((6, 1, 1)),
        recomb_opp=rng.uniform(1e9, 1e10, 6), recomb_cnt=rng.uniform(1, 9, 6),
    )
    ref = jem.m_step(demo, stats, jem.EMConfig(**options))
    got = tem.m_step(demo, stats, _tcfg(**options))
    # float64 host arithmetic on both sides
    np.testing.assert_allclose(got.pop_sizes, ref.pop_sizes, rtol=1e-12)
    np.testing.assert_allclose(got.mig_rates, ref.mig_rates, rtol=1e-12)
    np.testing.assert_allclose(got.recombination_rate,
                               ref.recombination_rate, rtol=1e-12)
    if "xc_epochs" in options:
        for e in options["xc_epochs"]:
            assert got.pop_sizes[e, 0] == demo.pop_sizes[e, 0]
    if options.get("infer_recomb") is False:
        assert got.recombination_rate == demo.recombination_rate


def test_m_step_with_migration_matches_jax():
    """The migration branch (host numpy; it runs for two populations, which
    the port's sweep does not take yet) with -xc."""
    rng = np.random.default_rng(2)
    demo = Demography(
        change_times=np.array([0.0, 1000.0, 5000.0]),
        pop_sizes=rng.uniform(5e3, 2e4, (3, 2)),
        mig_rates=rng.uniform(1e-5, 1e-4, (3, 2, 2)),
        sample_pops=np.array([0, 0, 1, 1], np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=1e5,
    )
    stats = jem.SuffStats(
        coal_opp=rng.uniform(1e3, 1e5, (3, 2)),
        coal_cnt=rng.uniform(0.1, 20.0, (3, 2)),
        mig_opp=rng.uniform(1e3, 1e5, (3, 2)),
        mig_cnt=rng.uniform(0.1, 5.0, (3, 2, 2)),
        recomb_opp=rng.uniform(1e9, 1e10, 3), recomb_cnt=rng.uniform(1, 9, 3),
    )
    for options in ({}, {"xc_epochs": (1,)}, {"infer_migration": False}):
        ref = jem.m_step(demo, stats, jem.EMConfig(**options))
        got = tem.m_step(demo, stats, _tcfg(**options))
        np.testing.assert_allclose(got.pop_sizes, ref.pop_sizes, rtol=1e-12)
        np.testing.assert_allclose(got.mig_rates, ref.mig_rates, rtol=1e-12)


def test_no_data_posterior_equals_prior():
    """All data missing: the sweep leaves the coalescent prior untouched
    (the test_e2e.py no-data gate)."""
    ne = 10000.0
    demo = _demo(E=1, n=4, L=1e6, ne=ne)
    seg = SegData(
        positions=np.array([1]), lengths=np.array([int(1e6)]),
        states=np.zeros(1, dtype=np.int8),
        alleles=np.full((1, 4), -1, dtype=np.int8), phased=np.ones(4, bool),
    )
    stats, _, logl, _ = tem.run_chunk(
        demo, seg, _tcfg(num_particles=300, lag=20000.0), seed=4)
    assert logl == pytest.approx(0.0, abs=1e-3)
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert ne_hat == pytest.approx(ne, rel=0.1)


def test_run_chunk_agrees_with_jax():
    demo = _demo()
    seg = simulate_seg(demo, seed=5)
    res = {"jax": [], "torch": []}
    for s in (1, 2, 3):
        res["jax"].append(jem.run_chunk(
            demo, seg, jem.EMConfig(num_particles=64, block_size=512), seed=s))
        res["torch"].append(tem.run_chunk(
            demo, seg, _tcfg(num_particles=64), seed=s))
    summary = {}
    for side, runs in res.items():
        logl = np.mean([r[2] for r in runs])
        ne = (sum(r[0].coal_opp.sum() for r in runs)
              / (2.0 * sum(r[0].coal_cnt.sum() for r in runs)))
        rho = (sum(r[0].recomb_cnt.sum() for r in runs)
               / sum(r[0].recomb_opp.sum() for r in runs))
        summary[side] = (logl, ne, rho)
        assert all(np.isfinite(r[2]) and r[2] < 0 for r in runs)
        assert all(r[3]["num_resamples"] > 0 for r in runs)
    (lj, nj, rj), (lt, nt, rt) = summary["jax"], summary["torch"]
    assert abs(lt - lj) <= 0.02 * abs(lj), summary
    assert nt == pytest.approx(nj, rel=0.3), summary
    assert rt == pytest.approx(rj, rel=0.5), summary


def _rows(path):
    with open(path) as fh:
        lines = [ln.split() for ln in fh.read().strip().split("\n")]
    header = lines[0]
    keys = [tuple(ln[:2]) + tuple(ln[4:7]) for ln in lines[1:]]
    return header, keys


def test_run_em_writes_the_same_out_rows_as_jax(tmp_path):
    demo = _demo(L=1e5)
    seg = simulate_seg(demo, seed=8)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jem.run_em(demo, seg, jem.EMConfig(num_particles=64, block_size=512,
                                       em_iters=1, outdir=str(jdir)))
    res = tem.run_em(demo, seg, _tcfg(num_particles=64, em_iters=1,
                                      outdir=str(tdir)))
    assert len(res.log_likelihoods) == 2 and len(res.estep_seconds) == 2
    for name in ("result.out", os.path.join("emiter0", "chunkfinal.out"),
                 os.path.join("emiter1", "chunkfinal.out")):
        assert _rows(tdir / name) == _rows(jdir / name), name


def test_twopop_run_em_writes_the_same_out_rows_as_jax(tmp_path,
                                                      monkeypatch, capsys):
    """Two populations with migration: the same rows (Coal per population,
    Migr both ways per epoch, Recomb, LogL, ...) and columns as JAX's; the
    repeatability summary reads JAX's ``result.out`` as the port's."""
    from smcsmc_tpu_torch import repeatability
    from smcsmc_tpu_torch.demography import Demography as TDemography
    from smcsmc_tpu_torch.sweep_profile import twopop_data

    monkeypatch.setenv("SMCSMC_MIG_WALK", "loop")
    demo_t, _ = twopop_data(L=5e4, E=3)
    fields = dict(change_times=demo_t.change_times,
                  pop_sizes=demo_t.pop_sizes, mig_rates=demo_t.mig_rates,
                  sample_pops=demo_t.sample_pops, mutation_rate=1e-8,
                  recombination_rate=1e-9, sequence_length=5e4)
    demo = Demography(**fields)
    seg = simulate_seg(demo, seed=4)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jem.run_em(demo, seg, jem.EMConfig(num_particles=16, block_size=512,
                                       em_iters=1, outdir=str(jdir)))
    tem.run_em(TDemography(**fields), seg, _tcfg(num_particles=16,
                                                  em_iters=1,
                                                  outdir=str(tdir)))
    for name in ("result.out", os.path.join("emiter1", "chunkfinal.out")):
        header, keys = _rows(tdir / name)
        assert (header, keys) == _rows(jdir / name), name
        # keys are (Iter, Epoch, Type, From, To)
        kinds = {k[2] for k in keys}
        assert {"Coal", "Migr", "Recomb", "LogL"} <= kinds
        assert {k[3] for k in keys if k[2] == "Coal"} == {"0", "1"}
        assert {(k[3], k[4]) for k in keys if k[2] == "Migr"} >= {
            ("0", "1"), ("1", "0")}
    shown = []
    for d in (jdir, tdir):
        repeatability.main(["--summary", "twopop", str(d / "result.out")])
        shown.append(capsys.readouterr().out.splitlines())
        assert len(shown[-1]) == 3  # LogL, then iterations 0 and 1
        assert shown[-1][2].startswith("  iteration 1: population 0 epoch:")
        assert "pooled migration rate" in shown[-1][2]
    assert [ln.split(":")[0] for ln in shown[0][1:]] == [
        ln.split(":")[0] for ln in shown[1][1:]]
    # an iteration's own file holds that iteration only
    repeatability.main(["--summary", "twopop",
                        str(jdir / "emiter1" / "chunkfinal.out")])
    assert capsys.readouterr().out.splitlines()[1].startswith(
        "  iteration 1: population 0 epoch:")


def _gapped(L=6e5, n=4, seed=9):
    """Data with an all-missing stretch longer than the test's -maxgap."""
    from smcsmc_tpu_torch.sweep_profile import unphase_and_blank

    seg = simulate_seg(_demo(E=1, n=n, L=L), seed=seed)
    return unphase_and_blank(seg, [(250_000, 300_000)], (100_000, 150_000), 0)


CHUNKED = dict(num_particles=32, em_iters=1, chunks=3, maxgap=20000,
               minseg=50000, record_ess=True, seed=5)


@pytest.fixture(scope="module")
def chunked_runs(tmp_path_factory):
    """run_em over 3 chunks of gapped, unphased data in both packages, with
    the chunk windows and seeds each handed to run_chunk."""
    demo, seg = _demo(E=5, L=6e5), _gapped()
    calls = {"jax": [], "torch": []}

    def recording(side, run_chunk):
        def wrapped(demo, seg, cfg, chunk=(None, None), seed=1, **kw):
            calls[side].append((tuple(chunk), seed))
            return run_chunk(demo, seg, cfg, chunk=chunk, seed=seed, **kw)
        return wrapped

    root = tmp_path_factory.mktemp("chunked")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jem, "run_chunk", recording("jax", jem.run_chunk))
        mp.setattr(tem, "run_chunk", recording("torch", tem.run_chunk))
        jem.run_em(demo, seg, jem.EMConfig(
            block_size=256, outdir=str(root / "jax"), chunk_workers=1,
            **CHUNKED))
        res = tem.run_em(demo, seg, _tcfg(outdir=str(root / "torch"),
                                          **CHUNKED))
    finally:
        mp.undo()
    return demo, seg, root, calls, res


def test_run_em_chunks_match_jax(chunked_runs):
    """The same chunk windows and seeds; chunkfinal.out with the same rows,
    columns and Clump values; result.out with the aggregates only."""
    _, seg, root, calls, res = chunked_runs
    assert calls["torch"] == calls["jax"]
    windows = [c for c, _ in calls["torch"][:3]]
    assert len(set(windows)) == 3 and res.chunks == windows
    # the all-missing stretch splits; seeds are seed + 1000*it + ci
    assert any(a[1] < b[0] for a, b in zip(windows, windows[1:]))
    assert [s for _, s in calls["torch"]] == [5, 6, 7, 1005, 1006, 1007]
    for name in ("result.out", os.path.join("emiter0", "chunkfinal.out"),
                 os.path.join("emiter1", "chunkfinal.out")):
        th, tk = _rows(root / "torch" / name)
        jh, jk = _rows(root / "jax" / name)
        assert th == jh and th[-1] == "Clump", name
        assert tk == jk, name
        with open(root / "torch" / name) as fh:
            clumps = [ln.split()[-1] for ln in fh.read().strip().split("\n")[1:]]
        with open(root / "jax" / name) as fh:
            assert clumps == [ln.split()[-1]
                              for ln in fh.read().strip().split("\n")[1:]]
        if name == "result.out":
            assert set(clumps) == {"-1"}
        else:
            assert set(clumps) == {"-1", "0", "1", "2"}


def test_run_em_aggregate_is_the_sum_of_the_chunks(chunked_runs):
    from smcsmc_tpu_torch.outfmt import parse_outfile

    _, _, root, _, res = chunked_runs
    for it in (0, 1):
        data = parse_outfile(str(root / "torch" / f"emiter{it}"
                                 / "chunkfinal.out"))
        keys = {k[0][:4] for k in data if k[0][4] == -1
                and k[0][0] in ("Coal", "Recomb", "Resamp", "LogL")}
        assert len(keys) == 5 + 3
        for key in keys:
            for col in ("Opp", "Count"):
                if key[0] in ("Resamp", "LogL") and col == "Opp":
                    continue  # the sequence length / 1, not a sum
                total = data[((*key, -1), col)]
                parts = sum(data[((*key, ci), col)] for ci in range(3))
                # the .out prints 8 significant digits, or two decimals
                assert parts == pytest.approx(total, rel=1e-6, abs=0.02), (
                    it, key, col)
        assert res.log_likelihoods[it] == pytest.approx(
            data[(("LogL", -1, -1, -1, -1), "Count")], rel=1e-6)


def test_chunk_loglikelihoods_agree_with_jax(chunked_runs):
    """LogL per chunk of iteration 0 (the same model on both sides) within
    the spread test_run_chunk_agrees_with_jax allows (2% of the value; the
    per-seed spread at P=32 is wider than at its P=64, and these are single
    seeds, so the band is doubled)."""
    from smcsmc_tpu_torch.outfmt import parse_outfile

    _, _, root, _, _ = chunked_runs
    path = os.path.join("emiter0", "chunkfinal.out")
    t = parse_outfile(str(root / "torch" / path))
    j = parse_outfile(str(root / "jax" / path))
    for ci in range(3):
        key = (("LogL", -1, -1, -1, ci), "Count")
        assert t[key] < 0 and abs(t[key] - j[key]) <= 0.04 * abs(j[key]), ci


def test_resample_file_has_one_row_per_event(chunked_runs):
    from smcsmc_tpu_torch.outfmt import parse_outfile

    _, seg, root, _, _ = chunked_runs
    for it in (0, 1):
        d = root / "torch" / f"emiter{it}"
        with open(d / "chunkfinal.resample") as fh:
            rows = fh.read().strip().split("\n")
        data = parse_outfile(str(d / "chunkfinal.out"))
        assert len(rows) == data[(("Resamp", -1, -1, -1, -1), "Count")] > 0
        for ln in rows:
            pos, ess = ln.split("\t")  # position<TAB>ESS
            assert str(int(pos)) == pos and 0 <= int(pos) <= seg.end
            assert 0.0 < float(ess) < 0.5 * CHUNKED["num_particles"]
        with open(root / "jax" / f"emiter{it}" / "chunkfinal.resample") as fh:
            jrow = fh.readline().rstrip("\n").split("\t")
        assert len(jrow) == 2 and str(int(jrow[0])) == jrow[0]


def test_resume_sweeps_nothing_and_returns_the_same(chunked_runs, monkeypatch):
    """A second run_em on the same outdir runs no sweep for the finished
    iterations and returns the same stats, stats_wt (from the ESS column)
    and demos as the first, to the digits the .out prints; the port's .out
    parses with the JAX package's load_iteration to the same table."""
    from smcsmc_tpu import checkpoint as jckpt
    from smcsmc_tpu_torch import checkpoint as tckpt

    demo, seg, root, _, first = chunked_runs
    out = str(root / "torch")
    with open(root / "torch" / "result.out") as fh:
        result_before = fh.read()

    def no_sweep(*a, **k):
        raise AssertionError("a finished iteration was swept again")

    monkeypatch.setattr(tem, "run_chunk", no_sweep)
    again = tem.run_em(demo, seg, _tcfg(outdir=out, **CHUNKED))
    assert again.estep_seconds == [0.0, 0.0] and again.num_segments == [0, 0]
    assert first.num_segments[0] > 100
    with open(root / "torch" / "result.out") as fh:
        assert fh.read() == result_before
    for it in (0, 1):
        assert tckpt.have_outfile(out, it) and jckpt.have_outfile(out, it)
        assert dict(tckpt.load_iteration(out, it)) == dict(
            jckpt.load_iteration(out, it))
        assert again.log_likelihoods[it] == pytest.approx(
            first.log_likelihoods[it], rel=1e-6)
        # Opp and Count are printed with 8 significant digits or two
        # decimals; Wt comes back as Opp/ESS, and the ESS column has three
        # decimals of a value >= 1
        for got, ref, rtol in ((again.stats[it], first.stats[it], 1e-6),
                               (again.stats_wt[it], first.stats_wt[it], 1e-3)):
            for name in ("coal_opp", "coal_cnt"):
                if rtol == 1e-3 and name == "coal_cnt":
                    continue  # the .out has no column for it
                np.testing.assert_allclose(
                    getattr(got, name), getattr(ref, name), rtol=rtol,
                    atol=0.006, err_msg=name)
            for name in ("recomb_opp", "recomb_cnt"):  # one aggregate row
                if rtol == 1e-3 and name == "recomb_cnt":
                    continue
                assert getattr(got, name).sum() == pytest.approx(
                    getattr(ref, name).sum(), rel=rtol, abs=0.006), name
    # the w^2 statistics are not the posterior statistics: the ESS column
    # would read 1 everywhere if they were mixed up
    assert not np.allclose(again.stats_wt[0].coal_opp, again.stats[0].coal_opp)
    # the resumed model: the M-step of the statistics the .out prints
    np.testing.assert_allclose(again.demos[0].pop_sizes,
                               first.demos[0].pop_sizes, rtol=0.05)
    np.testing.assert_allclose(
        again.demos[0].pop_sizes,
        tem.m_step(demo, again.stats[0], _tcfg(**CHUNKED)).pop_sizes,
        rtol=1e-12)
    assert not tckpt.have_outfile(out, 2)


def test_chunk_workers_get_their_own_device(monkeypatch):
    """One worker per visible GPU, each chunk's config naming its device;
    one device or -nothreads runs the chunks one after another."""
    seen = []

    def fake_run_chunk(demo, seg, cfg, chunk=(None, None), seed=1,
                       vb_counts=None, guide_file=None):
        assert vb_counts is None and guide_file is None
        seen.append((cfg.device, chunk, seed))
        return seed

    monkeypatch.setattr(tem, "run_chunk", fake_run_chunk)
    monkeypatch.setattr(tem, "_worker_devices",
                        lambda device: ["cuda:0", "cuda:1"])
    chunks = [(0, 10), (10, 20), (20, 30)]
    cfg = tem.EMConfig(seed=3, device="cuda")
    assert tem.run_chunks(None, None, cfg, chunks) == [3, 4, 5]
    assert sorted(seen) == [("cuda:0", (0, 10), 3), ("cuda:0", (20, 30), 5),
                            ("cuda:1", (10, 20), 4)]
    seen.clear()
    serial = tem.EMConfig(seed=3, device="cuda", chunk_workers=1)
    assert tem.run_chunks(None, None, serial, chunks, seeds=[7, 8, 9]) == [
        7, 8, 9]
    assert seen == [("cuda", c, s) for c, s in zip(chunks, (7, 8, 9))]
    monkeypatch.undo()
    assert tem._worker_devices("cpu") == ["cpu"]


def _structured_demo(n=8, E=64, Pp=4):
    """n haplotypes spread over Pp populations, E epochs, migration between
    every pair: the CUDA kernels' caps by default."""
    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)])
    return PortDemography(
        change_times=change, pop_sizes=np.full((E, Pp), 10000.0),
        mig_rates=np.full((E, Pp, Pp), 1e-5),
        sample_pops=(np.arange(n) % Pp).astype(np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=1e5)


@pytest.mark.parametrize("device,over,cap", [
    ("cuda", {"n": 9}, r"9 haplotypes.*at most 8 \(MAX_LEAVES\)"),
    ("cuda", {"E": 65}, r"65 epochs.*at most 64 \(MAX_EPOCHS\)"),
    ("cuda", {"Pp": 5}, r"5 populations.*at most 4 \(MAX_POPS\)"),
    ("cuda", {"mig_buffer": 97}, r"97 -migbuf.*at most 96 \(MAX_MIG\)"),
    ("cuda", {}, None),  # exactly at the caps
    ("cpu", {"n": 9, "E": 65, "Pp": 5, "mig_buffer": 97}, None),
    # one population above 8 haplotypes: -guide and -alpha run on the
    # wide guided and local passes; -arg with -alpha has no ARG variant
    ("cuda", {"n": 16, "Pp": 1, "guide_file": "g.gz"}, None),
    ("cuda", {"n": 16, "Pp": 1, "alpha": 0.5}, None),
    ("cuda", {"n": 64, "Pp": 1, "alpha": 0.5, "guide_file": "g.gz"}, None),
    ("cuda", {"n": 16, "Pp": 1, "alpha": 0.5, "record_arg": True},
     r"-arg with -alpha on the card.*item 16"),
])
def test_kernel_caps_are_refused_on_the_card(device, over, cap):
    """``em.refuse_caps`` refuses, by quantity and cap, what the CUDA
    kernels do not hold when the run is on the card (it does not resolve
    the device, so no GPU is needed here); at the caps, and on the CPU at
    any size, it passes.  Above 8 haplotypes in one population ``-guide``
    and ``-alpha`` pass; ``-arg -alpha`` is refused."""
    over = dict(over)
    options = {k: over.pop(k) for k in ("guide_file", "alpha", "record_arg")
               if k in over}
    cfg = tem.EMConfig(device=device, mig_buffer=over.pop("mig_buffer", 96),
                       **options)
    demo = _structured_demo(**over)
    if cap is None:
        tem.refuse_caps(demo, cfg)
    else:
        with pytest.raises(NotImplementedError, match=cap):
            tem.refuse_caps(demo, cfg)


@pytest.mark.parametrize("n,options,cap", [
    (65, {}, "WIDE_MAX_LEAVES"), (9, {"apf": 2}, "-apf.*MAX_LEAVES")])
def test_run_em_refuses_the_caps_before_any_tree(monkeypatch, n, options,
                                                 cap):
    """``run_em`` on the card refuses 65 haplotypes, and 9 with ``-apf``
    (refused above 8 haplotypes on the card), before it sets up a sweep:
    nothing is built or swept."""
    def reached(*args, **kwargs):
        raise AssertionError("the sweep was set up")

    monkeypatch.setattr(tem, "run_chunks", reached)
    monkeypatch.setattr(tem, "epochs_from_demography", reached)
    seg = simulate_seg(_demo(L=2e4), seed=1)
    with pytest.raises(NotImplementedError, match=cap):
        tem.run_em(_structured_demo(n=n, Pp=1), seg,
                   tem.EMConfig(device="cuda", **options))


def test_sweep_profile_reports_on_cpu():
    """The profile of steady segments runs end to end on the CPU (no device
    operations there, so no device time and no kernel launches)."""
    from smcsmc_tpu_torch.sweep_profile import (
        bench_data,
        profile_sweep,
        report_lines,
    )

    demo, seg = bench_data(L=2e5)
    rep = profile_sweep(demo, seg, 32, "cpu", warm=4, timed=8, profiled=8)
    assert rep["segments"] == 8 and rep["ms_per_segment"] > 0
    assert rep["device_busy_share"] == 0 and rep["device_ms_per_segment"] == 0
    assert rep["pass_launches"] == 0
    assert rep["launches_per_segment"] == 0 and rep["top_device_ops"] == []
    assert len(report_lines(rep)) == 2


def test_repeatability_reports_on_cpu(capsys, monkeypatch):
    """The repeatability measurement runs end to end on the CPU at a tiny
    size: the reductions repeat bit for bit there, and a run prints its
    log-likelihood, with the resampler's scan and with torch.cumsum, and
    a two-population run its estimates per iteration."""
    from smcsmc_tpu_torch import repeatability, smc, sweep_profile

    lines = repeatability.reductions(64, "cpu", repeats=5)
    assert [ln.split(":")[0] for ln in lines] == [
        "repeat block scan P=64", "repeat cumsum P=64",
        "repeat logsumexp P=64", "repeat weighted sum P=64",
        "repeat local commit P=64"]
    assert all(" 0 of 5 results differ" in ln for ln in lines)
    short = sweep_profile.bench_data(L=1e5)
    monkeypatch.setattr(repeatability, "bench_data", lambda: short)
    repeatability.run_cli("main", 7, 16, "cpu")
    shown = capsys.readouterr().out
    assert "main path seed 7 (block): LogL by iteration ['-" in shown
    monkeypatch.setattr(smc, "systematic_resample", smc.systematic_resample)
    repeatability.run_cli("main", 7, 16, "cpu", scan="cumsum")
    assert "(cumsum): LogL by iteration ['-" in capsys.readouterr().out
    assert repeatability.first_divergence(
        *short, 16, "cpu").startswith("equal bit for bit after every one of")
    twopop = sweep_profile.twopop_data(L=4e4)
    monkeypatch.setattr(repeatability, "twopop_data", lambda: twopop)
    repeatability.run_cli("twopop", 7, 16, "cpu")
    shown = capsys.readouterr().out
    assert "twopop path seed 7 (block): LogL by iteration ['-" in shown
    assert shown.count("pooled migration rate") == 3  # iterations 0-2
    # the data's own genealogy, replayed: its sites are the data's, every
    # local tree's three coalescences are counted once, and the pooled
    # epochs cover each (epoch, population) reading
    demo = sweep_profile.twopop_demo(L=4e4)
    opp, cnt, trees = repeatability.genealogy(demo, 13, twopop[1])
    assert trees >= 1 and cnt.sum() == pytest.approx(3 * 4e4)
    assert (opp >= 0).all() and (opp[cnt > 0] > 0).all()
    line = repeatability.genealogy_report(demo, 13, twopop[1])
    assert "its sites equal to the data" in line
    assert "pooled over populations" in line
    with pytest.raises(RuntimeError, match="not the data's"):
        repeatability.genealogy(demo, 14, twopop[1])
    gen = torch.Generator().manual_seed(1)
    for n in (1000, 256, 5):
        x = torch.rand(n, generator=gen)
        torch.testing.assert_close(smc.block_scan(x), x.cumsum(0), rtol=1e-6,
                                   atol=1e-6)
