"""Checkpoint/resume (counterpart of ``smcsmc_tpu/checkpoint.py``).

Two layers:
- iteration-level idempotent resume (reference: model.py:949-959
  ``have_outfile`` + :1105-1115 skip-if-done): a finished EM iteration is
  detected by a parseable ``emiterN/chunkfinal.out`` containing a LogL row,
  and is skipped on re-run.  ``have_outfile`` and ``load_iteration`` are
  copied from ``smcsmc_tpu/checkpoint.py``;
- mid-sweep state checkpointing with ``torch.save``: every tensor of the
  ``PFState`` (the trees' populations and migration buffers, the
  migration diagnostics, the window accumulators and ring of pending
  local events, and the ARG ring among them), its host fields, the state
  of the sweep's ``torch.Generator`` and the caller's progress record, in
  one file, so that a resumed sweep continues exactly where the saved one
  stood.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .kernels.tree import Trees
from .smc import PFState


def have_outfile(outdir: str, iteration: int) -> bool:
    """True iff the iteration's merged .out exists and contains LogL."""
    path = os.path.join(outdir, f"emiter{iteration}", "chunkfinal.out")
    if not os.path.exists(path):
        return False
    try:
        with open(path) as fh:
            return any(" LogL " in line or "\tLogL\t" in line for line in fh)
    except OSError:
        return False


def load_iteration(outdir: str, iteration: int):
    """Parse a finished iteration's .out back into aggregation form."""
    from .outfmt import parse_outfile

    return parse_outfile(os.path.join(outdir, f"emiter{iteration}", "chunkfinal.out"))


def save_state(path: str, state: PFState, generator: torch.Generator,
               progress: dict | None = None) -> None:
    """Save a sweep in mid-course: ``state``, the state of ``generator``
    and ``progress`` (plain numbers, lists and dicts: what the caller needs
    to pick up its loop).  The file appears under ``path`` only when it is
    complete (written beside it, then renamed)."""
    payload = {}
    for name, v in state._asdict().items():
        if v is None:  # a feature the sweep does not run
            continue
        if name == "trees":
            payload[name] = dict(v._asdict())
        elif isinstance(v, torch.Tensor):
            payload[name] = v
        elif name == "num_resamples":
            payload[name] = int(v)
        else:  # slot_open [E] f32, front f32: host numpy, kept bit for bit
            payload[name] = torch.from_numpy(
                np.array(v, dtype=np.float32, ndmin=1))
    payload = {"state": payload, "generator": generator.get_state(),
               "progress": progress or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_state(path: str, generator: torch.Generator, device
               ) -> tuple[PFState, dict]:
    """Restore what :func:`save_state` wrote: returns the ``PFState`` with
    its tensors on ``device`` and the progress record, and sets
    ``generator`` (which must be of the kind that was saved: a CUDA
    generator's state does not fit a CPU generator) to the saved state."""
    payload = torch.load(path, map_location=device, weights_only=True)
    saved = payload["state"]
    try:
        generator.set_state(payload["generator"].cpu())
    except RuntimeError as exc:
        raise RuntimeError(
            f"checkpoint {path} holds the state of another kind of "
            f"generator than {generator.device}: {exc}") from exc
    fields = {}
    for name in PFState._fields:
        v = saved.get(name)
        if name == "diag" and v is None:  # saved before the field existed
            v = torch.zeros(2, dtype=torch.float64, device=device)
        if name == "trees":
            fields[name] = Trees(**v)
        elif name == "slot_open":
            fields[name] = v.cpu().numpy().astype(np.float32)
        elif name == "front":
            fields[name] = np.float32(v.cpu().numpy()[0])
        else:
            fields[name] = v
    return PFState(**fields), payload["progress"]


def remove_state(path: str) -> None:
    """Drop a mid-sweep checkpoint (and the ``ckpt`` directory with the
    last one)."""
    if os.path.exists(path):
        os.remove(path)
    try:
        os.rmdir(os.path.dirname(os.path.abspath(path)))
    except OSError:
        pass  # other chunks' checkpoints are still there, or none was made
