"""Mid-sweep checkpoints of the torch port (``smcsmc_tpu_torch/checkpoint.py``
takes ``torch.save`` where ``smcsmc_tpu/checkpoint.py`` takes orbax): the
round trip is exact for every field of the state and for the generator, and
a sweep that is interrupted after a checkpoint and run again gives, bit for
bit, what the uninterrupted sweep gives.
"""

import os

import numpy as np
import pytest
import torch

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu_torch import em as tem
from smcsmc_tpu_torch.checkpoint import load_state, remove_state, save_state
from smcsmc_tpu_torch.sweep_profile import unphase_and_blank

torch.set_num_threads(1)


def _demo(E=5, n=4, L=1.5e5):
    change = (np.array([0.0]) if E == 1
              else np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]))
    return Demography(
        change_times=change, pop_sizes=np.full((E, 1), 10000.0),
        mig_rates=np.zeros((E, 1, 1)), sample_pops=np.zeros(n, np.int32),
        mutation_rate=1e-8, recombination_rate=1e-9, sequence_length=L,
    )


def _data():
    seg = simulate_seg(_demo(E=1), seed=4)
    return unphase_and_blank(seg, [(60_000, 70_000)], (90_000, 120_000), 1)


def _cfg(**kw):
    return tem.EMConfig(num_particles=32, device="cpu", **kw)


def _assert_states_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "trees":
            for f in x._fields:
                assert torch.equal(getattr(x, f), getattr(y, f)), f
                assert getattr(x, f).dtype == getattr(y, f).dtype, f
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y) and x.dtype == y.dtype, name
            assert x.shape == y.shape, name
        else:
            assert type(x) is type(y), name
            assert np.array_equal(x, y), name
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, name


def test_save_load_round_trip_is_exact(tmp_path):
    sweep = tem.start_sweep(_demo(), _data(), _cfg(), seed=3)
    state = sweep.state
    s = 0
    while float(state.stats.abs().sum()) == 0:  # until the first commit
        state, _ = sweep.step(state, sweep.segs[s])
        s += 1
    assert state.num_resamples > 0 and float(state.fifo.abs().sum()) > 0
    path = str(tmp_path / "ckpt" / "seed3_start1")
    progress = {"segments": 40, "ess": [1.5, 2.25], "resample_rows": [[7.0, 3.5]]}
    save_state(path, state, sweep.generator, progress)
    assert os.listdir(tmp_path / "ckpt") == ["seed3_start1"]  # no temp file

    other = torch.Generator().manual_seed(99)
    got, done = load_state(path, other, "cpu")
    _assert_states_equal(got, state)
    assert done == progress
    assert torch.equal(other.get_state(), sweep.generator.get_state())
    # the restored generator continues the saved one's stream
    assert torch.equal(torch.rand(5, generator=other),
                       torch.rand(5, generator=sweep.generator))
    remove_state(path)
    assert not (tmp_path / "ckpt").exists()
    remove_state(path)  # nothing there: no error


def test_interrupted_sweep_resumes_bit_for_bit(tmp_path, monkeypatch):
    """-ckpt 1 with blocks of 16 segments: the sweep dies at segment 41, the
    same call again continues from the checkpoint after segment 32 and ends
    where the uninterrupted sweep ends, and the checkpoint is gone."""
    monkeypatch.setattr(tem, "CHECK_EVERY", 16)
    demo, seg = _demo(), _data()
    ref = tem.run_chunk(demo, seg, _cfg(), seed=11)
    assert ref[3]["num_segments"] > 60
    assert min(ref[3]["leaf_status_counts"].values()) > 0

    cfg = _cfg(checkpoint_blocks=1, outdir=str(tmp_path))
    real = tem.make_segment_step
    stepped = []

    def dying(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, segment):
            if len(stepped) == 41:
                raise KeyboardInterrupt("power cut")
            stepped.append(1)
            return step(state, segment)
        return wrapped

    monkeypatch.setattr(tem, "make_segment_step", dying)
    with pytest.raises(KeyboardInterrupt):
        tem.run_chunk(demo, seg, cfg, seed=11)
    ckpt = tmp_path / "ckpt"
    assert [p.name for p in ckpt.iterdir()] == [
        f"seed11_start{int(seg.positions[0])}"]

    monkeypatch.setattr(tem, "make_segment_step", real)
    counted = []

    def counting(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, segment):
            counted.append(1)
            return step(state, segment)
        return wrapped

    monkeypatch.setattr(tem, "make_segment_step", counting)
    got = tem.run_chunk(demo, seg, cfg, seed=11)
    assert len(counted) == ref[3]["num_segments"] - 32
    assert not ckpt.exists()
    assert got[2] == ref[2]
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(a, b)
    for key in ("num_resamples", "resample_rows", "final_front"):
        assert got[3][key] == ref[3][key], key
    np.testing.assert_array_equal(got[3]["ess"], ref[3]["ess"])

    # another seed or chunk start never picks up this checkpoint's name
    other = tem.run_chunk(demo, seg, cfg, seed=12)
    assert other[2] != ref[2]


def test_biased_sweep_resumes_bit_for_bit(tmp_path):
    """Under bias the pilot weights and the ring of delayed factors ride in
    the checkpoint: a biased sweep saved half way and loaded into a sweep
    set up from another seed ends bit for bit where the uninterrupted sweep
    of the saved seed ends."""
    from smcsmc_tpu_torch.kernels.tree import INF
    from smcsmc_tpu_torch.smc import flush_pending

    demo, seg = _demo(), _data()
    cfg = _cfg(bias_heights=(1000.0,), bias_strengths=(3.0, 1.0))

    def sweep_from(sweep, state, first):
        for s in range(first, len(sweep.segs)):
            state, _ = sweep.step(state, sweep.segs[s])
        return state

    straight = tem.start_sweep(demo, seg, cfg, seed=11)
    ref = flush_pending(sweep_from(straight, straight.state, 0))

    first = tem.start_sweep(demo, seg, cfg, seed=11)
    half = len(first.segs) // 2
    state = first.state
    for s in range(half):
        state, _ = first.step(state, first.segs[s])
    assert (state.df_pos < INF).any()  # delayed factors pending
    assert not torch.equal(state.log_pilot, state.log_w)
    path = str(tmp_path / "biased")
    save_state(path, state, first.generator, {"segments": half})
    second = tem.start_sweep(demo, seg, cfg, seed=12)
    state, done = load_state(path, second.generator, "cpu")
    got = flush_pending(sweep_from(second, state, done["segments"]))
    _assert_states_equal(got, ref)


def test_checkpoint_of_another_generator_kind_is_refused(tmp_path):
    sweep = tem.start_sweep(_demo(), _data(), _cfg(), seed=3)
    path = str(tmp_path / "state")
    save_state(path, sweep.state, sweep.generator)
    payload = torch.load(path, weights_only=True)
    payload["generator"] = payload["generator"][:16]  # a CUDA generator's size
    torch.save(payload, path)
    with pytest.raises(RuntimeError, match="another kind of generator"):
        load_state(path, torch.Generator(), "cpu")
