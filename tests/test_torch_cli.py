"""``smc2-torch`` takes the flags of the whole-genome path and of the
biased proposal as ``smc2`` does: every flag parses to the same ``EMConfig``
fields and io values as ``smcsmc_tpu.cli.parse_smc2_args`` gives, and the
command runs end to end on unphased data with missing stretches in several
files and chunks, twice (the second run sweeps nothing), and with
``-bias_heights 0 0.05 -calibrate_lag 2`` on the CPU.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from smcsmc_tpu import cli as jcli
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu_torch import cli as tcli
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.segio import write_seg
from smcsmc_tpu_torch.sweep_profile import unphase_and_blank

torch.set_num_threads(1)

PORT_FIELDS = [f.name for f in dataclasses.fields(tem.EMConfig)
               if f.name != "device"]
IO_KEYS = ("segs", "out", "pattern", "maxgap", "minseg", "startpos", "length",
           "mu", "rho", "N0", "nsam", "logfile", "bias_heights")


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
