"""The ARG variants of the narrow and migration passes of ``csrc/trip.cu``
(the plain, the biased and the migration pass with ARG recording, each
with and without VB) built as host C++ and held to their plain versions,
on the CPU.

``tools/rehearse/rehearse.py`` compiles ``trip.cu`` with g++ against the
stand-in ``tools/rehearse/cuda_runtime.h``: every lane of a block is a
host thread, so the kernels' ballots, shuffles and warp syncs (the leaves'
paths to the root, each row written by a lane of its own) run as written.
Each case goes through ``chip_smoke.compare_arg``'s own check
(``arg_narrow`` / ``arg_migration``, ``--arg``'s cases) on CPU tensors:
trees equal and every float within ``kernels.trip.float_tolerances``
(rtol 1e-4) of the plain version, the ring's codes, populations, leaves
and ``arg_n`` equal, its positions and heights within tolerance (the
migration pass's heights too: the host's ``log1pf`` is not the card's),
every output but the ring bit for bit the same kernel's without ARG.  The
ring is ``chip_smoke.arg_ring``'s: 16 particles one row short of wrapping,
the others anywhere up to twice its 512 slots (about half of them
wrapped); and rings of 1 and 3 slots, fewer than a trip's rows, so that
later rows take earlier rows' slots.  The cases: one trip at 20 kb and 64
trips at 50 kb; leaf status 1, 0 and -1; the main shape (4 leaves, 9
epochs), the genome shape (8, 33) and the migration pass's twopop shape
(4 leaves, 8 epochs, 2 populations, 56 events a buffer) and its caps
corner (8, 64, 4, 96); P ragged against the block (16 particles a block
of the narrow passes, 2 of the migration pass).  Skipped where g++ is
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

cs = rehearse.cs
torch.set_num_threads(1)

# (label, keyword arguments of chip_smoke.arg_narrow)
NARROW = [
    ("plain n=4 one trip", dict(P=49, n=4, E=9, ls=1, T=1, biased=False)),
    ("plain n=4 64 trips", dict(P=49, n=4, E=9, ls=0, T=64, biased=False)),
    ("plain n=8 64 trips", dict(P=49, n=8, E=33, ls=-1, T=64,
                                biased=False)),
    ("plain one slot", dict(P=49, n=4, E=9, ls=1, T=64, biased=False, A=1)),
    ("biased n=8 one trip", dict(P=49, n=8, E=33, ls=0, T=1, biased=True)),
    ("biased n=8 64 trips", dict(P=49, n=8, E=33, ls=1, T=64, biased=True)),
    ("biased n=4 64 trips", dict(P=49, n=4, E=9, ls=-1, T=64, biased=True)),
    ("biased three slots", dict(P=49, n=8, E=33, ls=1, T=64, biased=True,
                                A=3)),
]
# (label, keyword arguments of chip_smoke.arg_migration)
MIGRATION = [
    ("one trip", dict(P=33, ls=1, T=1)),
    ("64 trips", dict(P=33, ls=0, T=64)),
    ("64 trips, no data", dict(P=33, ls=-1, T=64)),
    ("caps corner", dict(P=9, ls=1, T=64, caps=True)),
    ("three slots", dict(P=33, ls=1, T=64, A=3)),
    ("one slot", dict(P=33, ls=1, T=1, A=1)),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/trip.cu as host C++")
    return rehearse.build((ROOT / rehearse.SOURCE).read_text(), "arg_host",
                          tmp_path_factory.mktemp("arg_host"))


@pytest.mark.parametrize("vb", [False, True])
@pytest.mark.parametrize("label,kw", NARROW, ids=[x[0] for x in NARROW])
def test_narrow_arg_passes_match_plain(lib, monkeypatch, label, kw, vb):
    from smcsmc_tpu_torch.kernels.trip import segment_pass_plain

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    assert kw["P"] % 16 != 0  # a ragged last block
    assert cs.arg_narrow(rehearse.host_pass(lib), segment_pass_plain, {},
                         vb=vb, **kw), f"{label}: apart from the plain version"


@pytest.mark.parametrize("vb", [False, True])
@pytest.mark.parametrize("label,kw", MIGRATION, ids=[x[0] for x in MIGRATION])
def test_migration_arg_pass_matches_plain(lib, monkeypatch, label, kw, vb):
    from smcsmc_tpu_torch.kernels.trip import segment_pass_plain

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    assert kw["P"] % 2 != 0  # a ragged last block
    m_rows = []
    assert cs.arg_migration(rehearse.host_pass(lib), segment_pass_plain, {},
                            vb=vb, mig_exact=False, m_rows=m_rows, **kw), \
        f"{label}: apart from the plain version"
    if kw["T"] > 1:
        assert m_rows[0] > 0, "no M rows pushed"
