"""``smc2-torch`` takes the flags of the whole-genome path and of the
biased proposal as ``smc2`` does: every flag parses to the same ``EMConfig``
fields and io values as ``smcsmc_tpu.cli.parse_smc2_args`` gives, and the
command runs end to end on unphased data with missing stretches in several
files and chunks, twice (the second run sweeps nothing), and with
``-bias_heights 0 0.05 -calibrate_lag 2`` on the CPU.
"""

import dataclasses
import functools
import gzip
import logging
import os
import re

import numpy as np
import pytest
import torch

from smcsmc_tpu import cli as jcli
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu_torch import cli as tcli
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.segio import write_seg
from smcsmc_tpu_torch.sweep_profile import (
    twopop_data,
    twopop_flags,
    unphase_and_blank,
)

torch.set_num_threads(1)

PORT_FIELDS = [f.name for f in dataclasses.fields(tem.EMConfig)
               if f.name != "device"]
IO_KEYS = ("segs", "out", "pattern", "maxgap", "minseg", "startpos", "length",
           "mu", "rho", "N0", "nsam", "logfile", "bias_heights", "alpha")


@pytest.mark.parametrize("argv", [
    ["-segs", "a.seg", "b.seg", "c.seg"],
    ["-seg", "a.seg", "-chunks", "100"],
    ["-maxgap", "150000"],
    ["-minseg", "2e5"],
    ["-startpos", "1e6", "-length", "5e6"],
    ["-ckpt", "3"],
    ["-nothreads"],
    ["-dephase"],
    ["-ancestral_aware"],
    ["-cap", "50000"],
    ["-xc", "0-3"],
    ["-xr", "2", "-xr", "30-32"],
    ["-xc", "5", "-xr", "1-2"],
    ["-no_infer_recomb"],
    ["-no_m_step"],
    ["-record_ess"],
    ["-segs", "a.seg", "b.seg", "-chunks", "4", "-Np", "10000", "-EM", "1",
     "-N0", "10000", "-mu", "1e-8", "-rho", "1e-9", "-P", "133", "133016",
     "31*1", "-record_ess", "-ckpt", "1", "-seed", "7"],
    ["-bias_heights", "0", "0.05"],
    ["-bias_heights", "0.01", "0.1", "-bias_strengths", "4", "2", "1"],
    ["-delay", "0.3"],
    ["-lag_fraction", "1.5"],
    ["-calibrate_lag", "2"],
    ["-delay_coal"],
    ["-delay_migr", "-delay", "0.7", "-calibrate_lag", "3"],
    ["-seg", "a.seg", "-bias_heights", "0", "0.05", "-calibrate_lag", "2",
     "-Np", "200"],
    ["-guide", "g.recomb_guide.gz"],
    ["-alpha", "0.5"],
    ["-alpha", "-1"],
    ["-seg", "a.seg", "-alpha", "0.5", "-EM", "1", "-bias_heights", "0",
     "0.01", "-bias_strengths", "2", "1", "-guide", "g.recomb_guide.gz",
     "-vb", "-apf", "2"],
], ids=lambda argv: " ".join(argv)[:40])
def test_flags_parse_as_in_the_jax_cli(argv):
    tcfg, tio = tcli.parse_args(argv)
    jcfg, demo_args, jio = jcli.parse_smc2_args(argv)
    assert demo_args == []
    for name in PORT_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
        assert type(getattr(tcfg, name)) is type(getattr(jcfg, name)), name
    for key in IO_KEYS:
        assert tio[key] == jio[key], key
    assert tcfg.device == "cuda"  # the entry point runs on the card


TWOPOP = twopop_flags()


@pytest.mark.parametrize("argv", [
    ["-seg", "a.seg", "-length", "2e6", *TWOPOP],
    ["-seg", "a.seg", "-length", "2e6", *TWOPOP, "-migbuf", "24"],
    ["-seg", "a.seg", "-length", "1e6", "-N0", "10000", "-I", "2", "2", "2",
     "-eM", "0", "1.5", "-en", "0.1", "2", "0.5", "-ej", "0.5", "2", "1"],
    ["-seg", "a.seg", "-length", "1e6", "-N0", "20000", "-I", "3", "2", "1",
     "1", "-em", "0", "1", "2", "1", "-em", "0", "3", "1", "0.5", "-ema",
     "0.2", "0", "1", "0", "2", "0", "1", "0", "1", "0", "-P", "133",
     "133016", "7*1"],
], ids=lambda argv: " ".join(argv[4:])[:40])
def test_structured_flags_give_the_jax_demography(argv):
    """-I -eN -en -em -eM -ema -ej -migbuf: the same EMConfig, demography
    flags, Demography and migration buffer capacity as smcsmc_tpu.cli."""
    from smcsmc_tpu import em as jem

    tcfg, tio = tcli.parse_args(argv)
    jcfg, demo_args, jio = jcli.parse_smc2_args(argv)
    assert tio["demo_args"] == demo_args
    for name in PORT_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    td = tcli.build_demography(tcfg, tio["demo_args"], tio)
    jd = jcli.build_demography(jcfg, demo_args, jio)
    assert td.num_populations > 1
    for k in ("change_times", "pop_sizes", "mig_rates", "sample_pops",
              "sample_times", "mutation_rate", "recombination_rate",
              "sequence_length"):
        assert np.array_equal(getattr(td, k), getattr(jd, k)), k
    assert np.array_equal(td.pop_map_at_epoch(), jd.pop_map_at_epoch())
    t_mig = tcfg.mig_buffer or tem._auto_mig_buffer(td)
    assert t_mig == (jcfg.mig_buffer or jem._auto_mig_buffer(jd))
    if argv[4:] == TWOPOP:
        # bench.py's twopop model, with 56 events per branch buffer
        ref, _ = twopop_data(L=1e4)
        assert t_mig == 56
        assert np.allclose(td.change_times, ref.change_times, rtol=1e-12)
        assert np.array_equal(td.mig_rates, ref.mig_rates)
        assert np.array_equal(td.pop_sizes, ref.pop_sizes)


@pytest.mark.parametrize("extra,flag", [
    (["-eI", "0.1", "1"], "-eI"),
])
def test_out_of_scope_with_migration_is_refused_by_name(tmp_path, extra,
                                                        flag):
    seg = str(tmp_path / "t.seg")
    demo, data = twopop_data(L=2e4)
    write_seg(seg, data)
    with pytest.raises(SystemExit, match=re.escape(repr(flag))):
        tcli.smcsmc_main(["-seg", seg, "-o", str(tmp_path / "out"), "-Np",
                          "8", *TWOPOP, *extra, "-device", "cpu"])


def test_arg_with_migration_is_accepted(tmp_path):
    """``-arg`` with bench.py's twopop model runs and writes the sampled
    ARG of iteration 0, with M rows for the walks' migrations."""
    seg = str(tmp_path / "t.seg")
    write_seg(seg, twopop_data(L=2e4)[1])
    out = tmp_path / "out"
    assert tcli.smcsmc_main(["-seg", seg, "-o", str(out), "-Np", "8",
                             "-EM", "0", *TWOPOP, "-arg", "-seed", "3",
                             "-device", "cpu"]) == 0
    with gzip.open(out / "emiter0" / "chunk0.trees.gz", "rt") as fh:
        codes = [ln.split()[0] for ln in fh]
    assert codes[:3] == ["C"] * 3 and "R" in codes


def test_structured_refusals_cite_item_15(tmp_path, caplog, monkeypatch):
    """The production proposal and the guide with several populations are
    in the port (ROADMAP item 15): with bench.py's twopop model on the CPU
    ``-bias_heights 0 0.05 -calibrate_lag 2 -delay_migr`` (its survival
    calibration cut to 32 genealogies over 20 kb), ``-guide FILE`` and
    ``-alpha 0.5`` each run to ``result.out`` and no message cites item
    15; on the card ``-arg`` with height bias on such a model is refused
    by name, citing item 16, before anything is swept."""
    from smcsmc_tpu_torch import calibrate as tcal
    from smcsmc_tpu_torch.sweep_profile import write_constant_guide

    caplog.set_level(logging.INFO, logger="smcsmc_tpu_torch")
    monkeypatch.setattr(tcal, "calibrate_survival", functools.partial(
        tcal.calibrate_survival, num_particles=32, distance=2e4,
        num_windows=4))
    demo, data = twopop_data(L=2e4)
    seg = str(tmp_path / "t.seg")
    write_seg(seg, data)
    guide = write_constant_guide(str(tmp_path / "g.recomb_guide.gz"), demo)
    for i, extra in enumerate((
            ["-bias_heights", "0", "0.05", "-calibrate_lag", "2",
             "-delay_migr"], ["-guide", guide], ["-alpha", "0.5"])):
        out = str(tmp_path / f"out{i}")
        assert tcli.smcsmc_main(["-seg", seg, "-o", out, "-Np", "8", "-EM",
                                 "0", *TWOPOP, *extra, "-seed", "3",
                                 "-device", "cpu"]) == 0
        assert os.path.exists(os.path.join(out, "result.out"))
    msgs = [r.getMessage() for r in caplog.records]
    assert not any("item 15" in m for m in msgs)
    assert any("migration pass launches" in m for m in msgs)

    def reached(*args, **kwargs):
        raise AssertionError("the run started")

    monkeypatch.setattr(tcli, "resolve_device", torch.device)
    monkeypatch.setattr(tcli, "run_em", reached)
    with pytest.raises(SystemExit, match=r"-arg with -bias_heights with "
                       r"several populations.*item 16"):
        tcli.smcsmc_main(["-seg", seg, "-o", str(tmp_path / "card"), "-Np",
                          "8", *TWOPOP, "-bias_heights", "0", "0.05", "-arg",
                          "-device", "cuda"])


def test_card_caps_are_refused_before_the_sweep(tmp_path, monkeypatch):
    """``smc2-torch -device cuda`` with a buffer above the migration
    kernel's cap exits naming it, right after the demography is built and
    before anything is swept (the device is taken as given here)."""
    def reached(*args, **kwargs):
        raise AssertionError("the run started")

    monkeypatch.setattr(tcli, "resolve_device", torch.device)
    monkeypatch.setattr(tcli, "run_em", reached)
    seg = str(tmp_path / "t.seg")
    write_seg(seg, twopop_data(L=2e4)[1])
    with pytest.raises(SystemExit, match=r"smc2-torch: 97 -migbuf.*MAX_MIG"):
        tcli.smcsmc_main(["-seg", seg, "-o", str(tmp_path / "out"), "-Np",
                          "8", *TWOPOP, "-migbuf", "97", "-device", "cuda"])


def test_twopop_command_runs_on_the_cpu(tmp_path):
    seg = str(tmp_path / "t.seg")
    write_seg(seg, twopop_data(L=5e4)[1])
    out = str(tmp_path / "out")
    assert tcli.smcsmc_main(["-seg", seg, "-o", out, "-Np", "16", "-EM",
                             "1", *TWOPOP, "-seed", "3",
                             "-device", "cpu"]) == 0
    with open(os.path.join(out, "result.out")) as fh:
        rows = [ln.split() for ln in fh.read().strip().split("\n")[1:]]
    kinds = {r[4] for r in rows}  # Iter Epoch Start End Type ...
    assert {"Coal", "Migr", "Recomb", "LogL"} <= kinds
    logl = [float(r[8]) for r in rows if r[4] == "LogL"]
    assert all(np.isfinite(x) and x < 0 for x in logl)


def test_biased_command_runs_on_the_cpu(tmp_path, caplog, monkeypatch):
    """``-bias_heights 0 0.05 -calibrate_lag 2`` on the CPU: the heights
    reach the sweep in generations (0.05 x 4 N0), the strengths are
    calibrated from the model, the lags from the survival pre-pass."""
    caplog.set_level(logging.INFO, logger="smcsmc_tpu_torch")
    seg = str(tmp_path / "t.seg")
    write_seg(seg, simulate_seg(Demography(
        change_times=np.array([0.0]), pop_sizes=np.array([[10000.0]]),
        mig_rates=np.zeros((1, 1, 1)), sample_pops=np.zeros(4, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=1e5),
        seed=3))
    out = str(tmp_path / "out")
    seen = []

    def spy(demo, data, cfg):
        seen.append(cfg)
        return tem.run_em(demo, data, cfg)

    monkeypatch.setattr(tcli, "run_em", spy)
    assert tcli.smcsmc_main([
        "-seg", seg, "-o", out, "-Np", "24", "-EM", "0", "-N0", "10000",
        "-mu", "1e-8", "-rho", "1e-9", "-P", "133", "133016", "3*1",
        "-bias_heights", "0", "0.05", "-calibrate_lag", "2", "-seed", "7",
        "-device", "cpu"]) == 0
    assert seen[0].bias_heights == (2000.0,) and seen[0].calibrate_lag
    assert os.path.exists(os.path.join(out, "result.out"))
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Calibrated lag = 2.0 x survival") for m in msgs)
    assert any(m.startswith("auto-calibrated bias_strengths for heights "
                            "(2000.0,): ") for m in msgs)
    assert any(m.startswith("calibrated lags (bp) by epoch: ") for m in msgs)


def test_every_config_field_of_the_port_exists_in_the_jax_package():
    jax_fields = {f.name: f.default for f in dataclasses.fields(jcli_config())}
    for f in dataclasses.fields(tem.EMConfig):
        if f.name != "device":
            assert f.name in jax_fields and jax_fields[f.name] == f.default, (
                f.name)


def jcli_config():
    from smcsmc_tpu.em import EMConfig

    return EMConfig


def _write_genome(tmp_path):
    """Two small chromosomes as an unphased VCF with gaps would give them."""
    truth = Demography(
        change_times=np.array([0.0]), pop_sizes=np.array([[10000.0]]),
        mig_rates=np.zeros((1, 1, 1)), sample_pops=np.zeros(4, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=2.5e5,
    )
    paths = []
    for i, (seed, gaps, part, sample) in enumerate((
            (1, [(100_000, 140_000)], (30_000, 60_000), 0),
            (2, [(60_000, 100_000)], (180_000, 220_000), 1))):
        seg = unphase_and_blank(simulate_seg(truth, seed=seed), gaps, part,
                                sample)
        paths.append(str(tmp_path / f"chr{i}.seg"))
        write_seg(paths[-1], seg)
    return paths


def test_whole_genome_command_runs_and_resumes(tmp_path, monkeypatch, caplog):
    caplog.set_level(logging.INFO, logger="smcsmc_tpu_torch")
    paths = _write_genome(tmp_path)
    out = str(tmp_path / "out")
    argv = ["-segs", *paths, "-chunks", "4", "-maxgap", "20000", "-minseg",
            "40000", "-o", out, "-Np", "24", "-EM", "1", "-N0", "10000",
            "-mu", "1e-8", "-rho", "1e-9", "-P", "133", "133016", "3*1",
            "-record_ess", "-ckpt", "1", "-seed", "7", "-device", "cpu"]
    assert tcli.smcsmc_main(argv) == 0
    with open(os.path.join(out, "result.out")) as fh:
        first = fh.read()
    lines = first.strip().split("\n")
    assert lines[0].split()[-1] == "Clump"
    assert {ln.split()[-1] for ln in lines[1:]} == {"-1"}
    assert {ln.split()[0] for ln in lines[1:]} == {"0", "1"}
    for it in (0, 1):
        d = os.path.join(out, f"emiter{it}")
        with open(os.path.join(d, "chunkfinal.out")) as fh:
            clumps = {ln.split()[-1] for ln in fh.read().strip().split("\n")[1:]}
        assert clumps == {"-1", "0", "1", "2", "3"}
        assert os.path.getsize(os.path.join(d, "chunkfinal.resample")) > 0
    assert not os.path.exists(os.path.join(out, "ckpt"))
    steps = [r for r in caplog.records if r.msg.startswith("EM iteration")]
    assert [r.args[0] for r in steps] == [0, 1]
    for r in steps:
        n_segments, n_chunks, by_status, unphased = (
            r.args[2], r.args[6], r.args[7], r.args[8])
        assert n_chunks == 4 and sum(by_status.values()) == n_segments
        assert min(by_status.values()) > 0 and unphased > 10

    def no_sweep(*a, **k):
        raise AssertionError("the second run swept a finished iteration")

    monkeypatch.setattr(tem, "run_chunk", no_sweep)
    assert tcli.smcsmc_main(argv) == 0
    with open(os.path.join(out, "result.out")) as fh:
        assert fh.read() == first
