"""The narrow passes with local recording of ``csrc/trip.cu`` (the local
plain pass and the local biased pass, each with and without VB) built as
host C++ and held to their plain versions, on the CPU.

``tools/rehearse/rehearse.py`` compiles ``trip.cu`` with g++ against the
stand-in ``tools/rehearse/cuda_runtime.h``: every lane of a block is a
host thread, so the kernels' ballots, shuffles and warp syncs (the leaves
below the cut branch from the leaves' path masks, the lag's epoch and the
ring's free slots by ballots, the event's words stored by four lanes) run
as written.  Each case goes through ``rehearse.check_guide`` (the
``--guide`` check) with the two local variants: trees equal, every float
within ``kernels.trip.float_tolerances`` (rtol 1e-4), the local ring's
positions, due positions, heights and the segment's opportunity within
their tolerances, its bitmasks, slots in use and drop count equal.  The
cases: one trip at 20 kb; 64 trips at 50 kb; every ring full (events
dropped and counted); a ring with one free slot (one event pushed, the
rest dropped); the caps (8 leaves, 64 epochs, 8 sections); leaf status 0
and -1; a block of one particle (P = 17 against the block of 16), and P
ragged against the block in every case.  Each case's data comes from its
index (``rehearse.guide_case``).  Skipped where g++ is absent.
"""

import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools" / "rehearse"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import rehearse  # noqa: E402

torch.set_num_threads(1)

LONG = dict(T=64, L=cs.MAX_SEG, nr_scale=0.1, delay_type=0)
# (label, rehearse.case arguments, ring: "30%", "full" or "one free")
CASES = [
    ("one trip at 20 kb", dict(P=150, n=4, E=9, S=2, ls=1, T=1, L=20000.0,
                               nr_scale=1.5, delay_type=0), "30%"),
    ("64 trips at 50 kb", dict(P=203, n=8, E=33, S=2, ls=1, **LONG), "30%"),
    ("every ring full", dict(P=203, n=8, E=33, S=2, ls=1, full=True, **LONG),
     "full"),
    ("one free slot", dict(P=150, n=4, E=9, S=2, ls=1, **LONG), "one free"),
    ("the caps", dict(P=161, n=8, E=64, S=8, ls=1, **LONG), "30%"),
    ("leaf status 0", dict(P=203, n=8, E=33, S=2, ls=0, **dict(
        LONG, delay_type=1)), "30%"),
    ("leaf status -1", dict(P=150, n=4, E=9, S=2, ls=-1, **LONG), "30%"),
    ("a block of one particle", dict(P=17, n=8, E=9, S=2, ls=1, **LONG),
     "30%"),
]
LOCAL = ((True, False, True), (False, False, True))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/trip.cu as host C++")
    return rehearse.build((ROOT / rehearse.SOURCE).read_text(), "local_host",
                          tmp_path_factory.mktemp("local_host"))


def _one_free(st, seed):
    """Every slot of every particle's local ring in use but one, at a
    place drawn from ``seed``."""
    P, R = st["lr_pos"].shape
    g = torch.Generator().manual_seed(seed)
    free = torch.randint(0, R, (P,), generator=g)
    used = st["lr_pos"] < rehearse.INF
    pos = cs.BIAS_FRONT - 2e4 * torch.rand((P, R), generator=g)
    st["lr_pos"] = torch.where(used, st["lr_pos"], pos)
    st["lr_due"] = torch.where(used, st["lr_due"], pos + 2e4)
    st["lr_time"] = torch.where(used, st["lr_time"],
                                5e4 * torch.rand((P, R), generator=g))
    st["lr_desc"] = torch.where(used, st["lr_desc"], 1)
    rows = torch.arange(P)
    st["lr_pos"][rows, free] = rehearse.INF
    st["lr_due"][rows, free] = rehearse.INF
    st["lr_time"][rows, free] = 0.0
    st["lr_desc"][rows, free] = 0


@pytest.mark.parametrize("vb", [False, True])
@pytest.mark.parametrize("label,c,ring", CASES, ids=[x[0] for x in CASES])
def test_local_passes_match_plain(lib, label, c, ring, vb):
    j = 40 + [x[0] for x in CASES].index(label)
    st, f, gt, table = rehearse.guide_case(c, j, vb=vb)
    if ring == "one free":
        _one_free(st, 900 + j)
    assert f["P"] % 16 != 0  # a ragged last block
    for biased, _, local in LOCAL:
        got = rehearse.run(lib, st, f, biased, table, None, local)
        pushed = int((got["lr_pos"] != st["lr_pos"]).sum())
        dropped = int(got["lr_dropped"] - st["lr_dropped"])
        assert pushed > 0 or ring == "full", "no event pushed"
        if ring != "30%":
            assert dropped > 0, "no event dropped on a full ring"
        if ring == "one free":
            assert int((got["lr_pos"] >= rehearse.INF).sum()) == 0
    results = rehearse.check_guide(lib, st, f, gt, table, variants=LOCAL,
                                   label=f" ({label})")
    assert [name for name, _, _ in results] == (
        ["biased local vb", "plain local vb"] if vb
        else ["biased local", "plain local"])
    bad = [name for name, good, _ in results if not good]
    assert not bad, f"{label}: {bad} apart from the plain version"
