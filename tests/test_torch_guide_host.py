"""The guided passes of ``csrc/trip.cu`` (the biased pass with a
recombination guide, with and without local recording, each with and
without VB) built as host C++ and held to their plain versions, on the CPU.

``tools/rehearse/rehearse.py`` compiles ``trip.cu`` with g++ against the
stand-in ``tools/rehearse/cuda_runtime.h``: every lane of a block is a
host thread, so the kernels' shuffles, ballots, warp syncs and block
barriers (the search's first pivots staged in shared memory, the branch
rates merged by lane 0) run as written.  Each case goes through
``rehearse.check_guide`` (the ``--guide`` check) on a guide that is not
constant: trees equal,
every float within ``kernels.trip.float_tolerances`` (rtol 1e-4), the
local ring's positions, due positions, heights and the segment's
opportunity within their tolerances, its bitmasks, slots in use and drop
count equal.  The cases: one trip at 20 kb; 64 trips at 50 kb; a table of
20,000 windows (a 2 Mb guide, the segment at its middle) so that the
search takes its full depth beyond its staged first steps; a table that
ends a segment after the front, so that gaps run past its last window;
trees whose first internal node is tied in
time with its parent, the parent of lower index, so that the stable order
of the times takes the parent first; the caps (8 leaves, 64 epochs, 8
sections); P ragged against the block of 16 particles throughout.  The
cases and their data are the ``--guide`` check's own
(``rehearse.guide_cases``, each made from its index).  Skipped where g++
is absent.  Beside them, on any host: the search pivots of
``guide.guide_tables`` walked as the kernels walk them find the window
that ``searchsorted`` finds, at 1 to 20,000 windows.
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

# (label, index j into rehearse.guide_cases(), the --guide check's own
# cases and data)
CASES = [("one trip at 20 kb", 3), ("64 trips at 50 kb", 10),
         ("a 2 Mb table", 13), ("a table ending past the segment", 15),
         ("tied internal times", 17), ("the caps", 7)]
GUIDED = ((True, True, False), (True, True, True))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/trip.cu as host C++")
    return rehearse.build((ROOT / rehearse.SOURCE).read_text(), "guide_host",
                          tmp_path_factory.mktemp("guide_host"))


@pytest.mark.parametrize("vb", [False, True])
@pytest.mark.parametrize("label,j", CASES, ids=[x[0] for x in CASES])
def test_guided_passes_match_plain(lib, label, j, vb):
    c, opts = rehearse.guide_cases()[j]
    st, f, gt, table = rehearse.guide_case(c, j, vb=vb, **opts)
    if opts.get("tied"):
        n = f["n"]
        child = st["parent"] == n
        child[:, :n] = False  # internal children of node n
        tied = (child & (st["time"] == st["time"][:, n:n + 1])).any(1)
        assert int(tied.sum()) > f["P"] // 2, "too few ties"
    if opts.get("windows"):
        assert gt.g_rel.shape[0] == 20000
    assert f["P"] % 16 != 0  # a ragged last block
    results = rehearse.check_guide(lib, st, f, gt, table, variants=GUIDED,
                                   label=f" ({label})")
    assert [name for name, _ in results] == (
        ["biased guide vb", "biased guide local vb"] if vb
        else ["biased guide", "biased guide local"])
    bad = [name for name, good in results if not good]
    assert not bad, f"{label}: {bad} apart from the plain version"


def _kernel_search(pivots, cum, m):
    """The guided kernels' search (csrc/trip.cu::guide_inv_mass) in
    Python: the staged pivots by node for the first steps, then the table;
    returns the window index j."""
    lo, hi, h = 0, len(cum), 1
    while h < len(pivots) and lo < hi:
        mid, right = (lo + hi) >> 1, int(pivots[h] <= m)
        lo, hi = (mid + 1, hi) if right else (lo, mid)
        h = 2 * h + right
    while lo < hi:
        mid = (lo + hi) >> 1
        lo, hi = (mid + 1, hi) if cum[mid] <= m else (lo, mid)
    return min(max(lo - 1, 0), len(cum) - 2)


@pytest.mark.parametrize("W", [1, 130, 1100, 20000])
def test_search_pivots_give_the_tables_search(W):
    import numpy as np

    from smcsmc_tpu_torch.kernels.guide import guide_tables

    rng = np.random.default_rng(W)
    g = guide_tables(1e-9 * rng.uniform(0.2, 3.0, W), np.ones((W, 4)),
                     1e-9, 100.0, "cpu")
    cum, piv = g.cum_mass.numpy(), g.pivots.numpy()
    ms = np.concatenate([rng.uniform(-10.0, cum[-1] + 1e3, 2000), cum,
                         [np.nextafter(c, np.inf) for c in cum[:50]]])
    want = np.clip(np.searchsorted(cum, ms, side="right") - 1, 0, W - 1)
    got = np.array([_kernel_search(piv, cum, m) for m in ms])
    assert (got == want).all()
