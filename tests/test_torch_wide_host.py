"""The wide kernels of ``csrc/trip.cu`` (9 to 64 leaves) built as host C++
and held to their plain versions run in float64, on the CPU.

``tools/rehearse/rehearse.py`` compiles ``trip.cu`` with g++ against the
stand-in ``tools/rehearse/cuda_runtime.h``: every lane of a block is a
host thread, so the kernels' shuffles, ballots and warp syncs run as
written.  Each case below goes through ``rehearse.check_wide`` (the
``--wide`` check): the wide plain and biased passes and ``trip`` on the
same inputs as ``segment_pass_plain`` / ``trip_plain`` in float64; trees
equal and every float within ``kernels.trip.float_tolerances`` (rtol
1e-4).  The cases straddle the group sizes (8 lanes a particle up to 16
leaves, 16 particles a block; 16 lanes and 8 particles above): n of 9, 16,
17 and 64, P one particle past a whole block, one trip at 20 kb and 64
trips at 50 kb, each leaf status, VB on one case.  Skipped where g++ is
absent.
"""

import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools" / "rehearse"))
sys.path.insert(0, str(ROOT))

import rehearse  # noqa: E402

torch.set_num_threads(1)

ONE = dict(T=1, L=20000.0, nr_scale=1.5)
CHAIN = dict(T=64, L=rehearse.cs.MAX_SEG, nr_scale=0.1)
# (P, n, leaf status, trips, VB)
CASES = [(17, 9, 1, ONE, True), (17, 16, 0, CHAIN, False),
         (9, 17, 0, ONE, False), (9, 17, 1, CHAIN, False),
         (9, 64, -1, CHAIN, False), (9, 64, 1, ONE, False)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/trip.cu as host C++")
    return rehearse.build((ROOT / rehearse.SOURCE).read_text(), "wide_host",
                          tmp_path_factory.mktemp("wide_host"))


@pytest.mark.parametrize("P,n,ls,trips,vb", CASES)
def test_wide_kernels_match_plain_in_double(lib, P, n, ls, trips, vb):
    c = dict(P=P, n=n, E=9, S=2, ls=ls, delay_type=0, **trips)
    results = rehearse.check_wide(lib, c, 1000 + n + ls, 7 if vb else None)
    assert [name for name, _, _ in results] == (
        ["plain vb", "biased vb", "trip"] if vb
        else ["plain", "biased", "trip"])
    bad = [(name, worst) for name, good, worst in results if not good]
    assert not bad, f"{c}: {bad} apart from the plain version in float64"
