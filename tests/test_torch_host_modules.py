"""The port's host-side modules are copies of the JAX package's numpy-only
modules (demography, pattern, segio, simulate, outfmt, lookahead, and the
demography helpers of cli; the C scan of the lookahead too).  Each copy must behave exactly like its original: the same
inputs go through both, and the results are compared for exact equality.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import smcsmc_tpu.cli as ref_cli
import smcsmc_tpu.demography as ref_demography
import smcsmc_tpu.outfmt as ref_outfmt
import smcsmc_tpu.pattern as ref_pattern
import smcsmc_tpu.segio as ref_segio
import smcsmc_tpu.simulate as ref_simulate
import smcsmc_tpu_torch.cli as port_cli
import smcsmc_tpu_torch.demography as port_demography
import smcsmc_tpu_torch.outfmt as port_outfmt
import smcsmc_tpu_torch.pattern as port_pattern
import smcsmc_tpu_torch.segio as port_segio
import smcsmc_tpu_torch.simulate as port_simulate
from smcsmc_tpu_torch.smc import SuffStats

REPO = Path(__file__).resolve().parent.parent


def assert_same_fields(a, b):
    """Two dataclass instances (of the two packages' twin classes) hold
    exactly equal fields."""
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            assert np.array_equal(x, y), name
        else:
            assert x == y, name


SCRM_ARGS = {
    "plain": "-nsam 4 -t 800 -r 320 2000000",
    "eN ladder": ("-nsam 6 -t 1000 -r 400 1000000 -eN 0.01 0.5 -eN 0.05 2.0 "
                  "-eN 0.3 1.5 -eN 1.2 1.0"),
    "two populations": ("-t 1000 -r 400 1000000 -I 2 4 4 -eM 0 1.0 "
                        "-eN 0.1 0.7 -ej 0.5 2 1"),
}


@pytest.mark.parametrize("name", SCRM_ARGS)
def test_parse_scrm_args_equals_the_original(name):
    args = SCRM_ARGS[name].split()
    ref = ref_demography.parse_scrm_args(list(args), n0=10000.0)
    got = port_demography.parse_scrm_args(list(args), n0=10000.0)
    assert_same_fields(got, ref)
    assert got.core_command_line() == ref.core_command_line()
    assert np.array_equal(got.pop_map_at_epoch(), ref.pop_map_at_epoch())


def _demo(module, n=4, L=2e5):
    return module.Demography(
        change_times=np.array([0.0, 1000.0, 20000.0]),
        pop_sizes=np.array([[8000.0], [12000.0], [10000.0]]),
        mig_rates=np.zeros((3, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L)


@pytest.mark.parametrize("seed", [3, 42])
def test_simulate_seg_equals_the_original(seed):
    ref = ref_simulate.simulate_seg(_demo(ref_demography), seed=seed)
    got = port_simulate.simulate_seg(_demo(port_demography), seed=seed)
    assert ref.num_segments > 10
    assert_same_fields(got, ref)


def test_seg_round_trip_and_splitters_equal_the_original(tmp_path):
    ref = ref_simulate.simulate_seg(_demo(ref_demography), seed=5)
    got = port_simulate.simulate_seg(_demo(port_demography), seed=5)
    ref_segio.write_seg(str(tmp_path / "ref.seg"), ref)
    port_segio.write_seg(str(tmp_path / "port.seg"), got)
    assert ((tmp_path / "ref.seg").read_bytes()
            == (tmp_path / "port.seg").read_bytes())
    ref_back = ref_segio.read_seg(str(tmp_path / "ref.seg"))
    got_back = port_segio.read_seg(str(tmp_path / "ref.seg"))
    assert_same_fields(got_back, ref_back)
    assert_same_fields(got_back, got)

    assert_same_fields(port_segio.split_long_segments(got, 5000.0),
                       ref_segio.split_long_segments(ref, 5000.0))
    start, end = int(ref.positions[3]) + 7, int(ref.end) // 2
    assert_same_fields(port_segio.slice_seg(got, start, end),
                       ref_segio.slice_seg(ref, start, end))
    for kw in (dict(length=1e5), dict()):
        ref_chunks = ref_segio.define_chunks(ref, 3, **kw)
        got_chunks = port_segio.define_chunks(got, 3, **kw)
        assert len(got_chunks) == len(ref_chunks)
        for a, b in zip(got_chunks, ref_chunks):
            assert_same_fields(a, b)
    assert (port_segio.watterson_estimate(got)
            == ref_segio.watterson_estimate(ref))


def test_port_has_no_native_scanner_of_its_own():
    """The optional native scanner is looked for beside the port's own
    module; none is built there, so the Python parser runs."""
    assert not (REPO / "smcsmc_tpu_torch" / "_segscan.so").exists()
    assert port_segio._native_scanner() is None


def test_outfmt_text_equals_the_original():
    rng = np.random.default_rng(17)
    E = 5

    def stats():
        return SuffStats(
            coal_opp=rng.uniform(1.0, 1e7, (E, 1)),
            coal_cnt=rng.uniform(0.0, 300.0, (E, 1)),
            mig_opp=rng.uniform(1.0, 1e6, (E, 1)),
            mig_cnt=np.zeros((E, 1, 1)),
            recomb_opp=rng.uniform(1.0, 1e10, E),
            recomb_cnt=rng.uniform(0.0, 40.0, E))

    st, wt = stats(), stats()
    change = np.array([0.0, 133.0, 1500.0, 20000.0, 133016.0])
    kw = dict(num_resamples=11, sequence_len=2e6)
    ref = ref_outfmt.stats_to_out(2, change, st, wt, -13446.13, 10000, **kw)
    got = port_outfmt.stats_to_out(2, change, st, wt, -13446.13, 10000, **kw)
    assert got == ref
    assert len(ref.split("\n")) > E + 4
    assert port_outfmt.parse_outfile(got, from_text=True) \
        == ref_outfmt.parse_outfile(ref, from_text=True)
    for d in (0.0, 0.05, 1.0, 123456.789, 1e-12):
        assert port_outfmt.format_double(d) == ref_outfmt.format_double(d)


def test_pattern_times_equal_the_original():
    assert (port_pattern.smc2_pattern_times(133.0, 133016.0, "7*1", n0=1e4)
            == ref_pattern.smc2_pattern_times(133.0, 133016.0, "7*1", n0=1e4))
    assert (port_pattern.epoch_times_from_pattern("1*3+4*2+1*5", 2.0)
            == ref_pattern.epoch_times_from_pattern("1*3+4*2+1*5", 2.0))


def _io(**kw):
    io = {"segs": [], "out": "o", "pattern": None, "p_pattern": None,
          "tmax": 2.0, "startpos": 1, "length": None, "mu": 1e-8,
          "rho": 1e-9, "N0": 10000.0, "nsam": None, "logfile": None}
    io.update(kw)
    return io


@pytest.mark.parametrize("kw,demo_args", [
    (dict(pattern=["133", "133016", "7*1"]), []),
    (dict(pattern=["133", "133016", "7*1"]),
     ["-eN", "0.02", "0.5", "-eN", "0.4", "2.0"]),
    (dict(p_pattern="1*3+4*2", tmax=3.0, nsam=6, length=1e6), []),
    (dict(N0=None), []),  # N0 from Watterson's estimate on the data
])
def test_build_demography_equals_the_original(kw, demo_args):
    ref_seg = ref_simulate.simulate_seg(_demo(ref_demography), seed=9)
    got_seg = port_simulate.simulate_seg(_demo(port_demography), seed=9)
    ref = ref_cli.build_demography(None, list(demo_args), _io(**kw),
                                   seg=ref_seg)
    got = port_cli.build_demography(None, list(demo_args), _io(**kw),
                                    seg=got_seg)
    assert_same_fields(got, ref)
    if kw.get("pattern"):
        assert got.num_epochs == 9


def test_load_option_file_equals_the_original(tmp_path):
    opt = tmp_path / "opts.txt"
    opt.write_text("-Np 100  # particles\n\n-EM 2\n")
    argv = ["-seg", "a.seg", "-@", str(opt), "-seed", "4"]
    assert port_cli.load_option_file(argv) == ref_cli.load_option_file(argv)
    assert port_cli.load_option_file(argv)[2:6] == ["-Np", "100", "-EM", "2"]


def test_copies_are_the_originals_letter_for_letter():
    """Each copied module is its original plus one first line naming it;
    only the prefix of the reference tree's location is dropped from the
    paths that two docstrings cite."""
    for name in ("demography", "pattern", "segio", "simulate", "outfmt",
                 "lookahead", "argout"):
        ref = (REPO / "smcsmc_tpu" / f"{name}.py").read_text()
        got = (REPO / "smcsmc_tpu_torch" / f"{name}.py").read_text()
        first, rest = got.split("\n", 1)
        assert first.startswith(f"# Copied from smcsmc_tpu/{name}.py"), name
        assert rest == ref.replace("/" + "root/reference/", ""), name


def test_lookahead_scan_source_is_the_original_letter_for_letter():
    """csrc/lookahead.c is native/lookahead.c plus one first line naming
    it."""
    ref = (REPO / "native" / "lookahead.c").read_text()
    got = (REPO / "smcsmc_tpu_torch" / "csrc" / "lookahead.c").read_text()
    first, rest = got.split("\n", 1)
    assert first.startswith("/* Copied from native/lookahead.c")
    assert rest == ref
