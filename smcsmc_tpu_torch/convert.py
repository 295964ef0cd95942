"""Carry particle state between numpy and the port's tensors.

The tests start both packages from the same trees, weights, FIFO and
statistics: a JAX ``PFState`` with every leaf passed through ``np.asarray``
goes in through :func:`state_from_numpy`, and :func:`state_to_numpy` gives
the port's state back as numpy arrays under the same field names.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .kernels.tree import Trees
from .smc import PFState


def _get(d, name):
    return d[name] if isinstance(d, Mapping) else getattr(d, name)


def trees_from_numpy(d, device) -> Trees:
    """Trees from any object (or mapping) with parent/time/child0/child1."""
    return Trees(
        parent=torch.as_tensor(np.array(_get(d, "parent"), np.int32),
                               device=device),
        time=torch.as_tensor(np.array(_get(d, "time"), np.float32),
                             device=device),
        child0=torch.as_tensor(np.array(_get(d, "child0"), np.int32),
                               device=device),
        child1=torch.as_tensor(np.array(_get(d, "child1"), np.int32),
                               device=device),
    )


def trees_to_numpy(trees: Trees) -> dict:
    """parent/time/child0/child1 as numpy, plus ``pop`` (all population 0)
    so the dict fills the JAX ``Trees`` fields."""
    out = {k: v.detach().cpu().numpy() for k, v in trees._asdict().items()}
    out["pop"] = np.zeros_like(out["parent"])
    return out


def state_from_numpy(d, device) -> PFState:
    """PFState from a JAX ``PFState`` (or mapping) with numpy leaves."""
    f32 = lambda x: torch.as_tensor(np.array(x, np.float32),  # noqa: E731
                                    device=device)
    return PFState(
        trees=trees_from_numpy(_get(d, "trees"), device),
        log_w=f32(_get(d, "log_w")),
        next_rec=f32(_get(d, "next_rec")),
        fifo=f32(_get(d, "fifo")),
        slot_open=np.array(_get(d, "slot_open"), np.float32),
        stats=f32(_get(d, "stats")),
        stats_wt=f32(_get(d, "stats_wt")),
        ln_norm=f32(_get(d, "ln_norm")),
        ln_norm_c=f32(_get(d, "ln_norm_c")),
        front=np.float32(_get(d, "front")),
        num_resamples=int(_get(d, "num_resamples")),
    )


def state_to_numpy(state: PFState) -> dict:
    """The port's state as numpy arrays under the JAX field names."""
    out = {}
    for name, v in state._asdict().items():
        if name == "trees":
            out[name] = trees_to_numpy(v)
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out
