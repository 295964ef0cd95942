"""The migration pass's proposal variants of ``csrc/trip.cu`` (biased,
guided and biased, local, biased local and guided local, each with and
without VB) built as host C++ and held to their plain versions, on the
CPU.

``tools/rehearse/rehearse.py`` compiles ``trip.cu`` with g++ against the
stand-in ``tools/rehearse/cuda_runtime.h``: every lane of a block is a
host thread, so the warp's ballots, shuffles and syncs (the slot of each
ring a lane of its own, the biased point's running sums kept by lane
q % 32 and searched by lanes) run as written.  Each case is one of
``chip_smoke.MIG_PROPOSAL_CASES`` through ``chip_smoke.mig_proposal_one``
on CPU tensors (twopop at each leaf status, one trip at 20 kb and 64 at 50
kb, the caps corner with 8 sections at one trip, the delay keyed by the
recombination point, the coalescence and ``-delay_migr``, a ring of
delayed factors and a ring of local events each 30% in use, a guide that
is not constant),
at P=49 and 23 at the caps corner (ragged against the block of 2
particles): trees, populations and buffers' destinations equal, every
float within ``kernels.trip.float_tolerances`` (rtol 1e-4), the walk
diagnostics equal, the local ring's slots, leaves and drops equal.  Node
and event times are held to tolerance, not bit for bit, as the host's
``log1pf`` is not the card's (they came out bit for bit on this host all
the same).  Then the corners the proposal's scratch-held state
reaches (``CORNERS``: every slot of the ring of delayed factors in use,
eight slots due with applications left, 8 sections at the caps corner,
every slot of the local ring in use, the caps corner's forests
recombining), four trips each, for the biased, biased local and guided
local passes with and without VB.  Skipped where g++ is absent.
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

# phase 3's cases, the caps corner's at one trip (its 64-trip chains take
# the plain version minutes on one core; rehearse.py --mig-proposal runs
# them)
CASES = [(name, label, kw, ls, 1 if kw.get("caps") else T, delay)
         for name, label, kw, ls, T, delay in cs.MIG_PROPOSAL_CASES]


# the corners the scratch-held state reaches (chip_smoke.MIG_CORNERS, and
# 8 sections at the caps corner over several trips), each for the biased,
# biased local and guided local passes where it applies, with and without
# VB: (corner, MigCase options, leaf status, delay type)
CORNERS = (("full ring", {}, 1, "migr"), ("due many", {}, 0, "coal"),
           ("8 sections", cs.MIG_CAPS, 1, "coal"),
           ("local full", {}, -1, "recomb"),
           ("forest", cs.MIG_CAPS, 1, "migr"))
CORNER_PASSES = (cs.MIG_BIASED_PASS, cs.MIG_BIASED_LOCAL_PASS,
                 cs.MIG_GUIDE_LOCAL_PASS)
CORNER_CASES = [
    (name, corner, kw, ls, delay)
    for base in CORNER_PASSES for name in (base, cs.vb_name(base))
    for corner, kw, ls, delay in CORNERS
    if (corner != "local full" or cs.MIG_PROPOSAL_PASSES[base][2])
    and (corner != "forest" or cs.MIG_PROPOSAL_PASSES[base][1])]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/trip.cu as host C++")
    return rehearse.build((ROOT / rehearse.SOURCE).read_text(),
                          "mig_proposal_host",
                          tmp_path_factory.mktemp("mig_proposal_host"))


@pytest.mark.parametrize(
    "name,label,kw,ls,T,delay", CASES,
    ids=[f"{n[14:-1].replace(', ', '-')}{lab.replace(' ', '-')}-ls{ls}"
         f"-T{T}-{d}" for n, lab, _, ls, T, d in CASES])
def test_mig_proposal_variant_matches_plain(lib, monkeypatch, name, label,
                                            kw, ls, T, delay):
    from smcsmc_tpu_torch.kernels.trip import segment_pass_plain

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    assert cs.mig_proposal_one(rehearse.host_pass(lib), segment_pass_plain,
                               {}, name, label, kw, ls, T, delay, P=49,
                               caps_P=23, exact=False), \
        f"{name}{label}: apart from the plain version"


@pytest.mark.parametrize(
    "name,corner,kw,ls,delay", CORNER_CASES,
    ids=[f"{n[14:-1].replace(', ', '-')}-{c.replace(' ', '-')}"
         for n, c, _, _, _ in CORNER_CASES])
def test_mig_proposal_corner_matches_plain(lib, monkeypatch, name, corner,
                                           kw, ls, delay):
    """Four trips on a 50 kb segment at a corner (``CORNERS``) of the
    proposal variant ``name``, held to the plain version as
    :func:`test_mig_proposal_variant_matches_plain` holds it."""
    from smcsmc_tpu_torch.kernels.trip import segment_pass_plain

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    assert cs.mig_proposal_one(
        rehearse.host_pass(lib), segment_pass_plain, {}, name,
        f" {corner}" if corner == "8 sections" else "", kw, ls, 4, delay,
        P=49, caps_P=23, exact=False,
        corner=None if corner == "8 sections" else corner), \
        f"{name} {corner}: apart from the plain version"
