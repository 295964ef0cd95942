"""Carry particle state and segments between numpy and the port's tensors.

The tests start both packages from the same trees, weights (posterior and
pilot), FIFO, statistics and ring of delayed factors: a JAX ``PFState``
with every leaf passed through ``np.asarray`` goes in through
:func:`state_from_numpy`, and :func:`state_to_numpy` gives the port's state
back as numpy arrays under the same field names.
:func:`segment_from_numpy` turns the tuple that the JAX segment step
consumes into the port's ``Segment``, so that both take the same step.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .kernels.tree import Trees
from .smc import PFState, Segment, fifo_gate_masks


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
        log_pilot=f32(_get(d, "log_pilot")),
        next_rec=f32(_get(d, "next_rec")),
        fifo=f32(_get(d, "fifo")),
        slot_open=np.array(_get(d, "slot_open"), np.float32),
        stats=f32(_get(d, "stats")),
        stats_wt=f32(_get(d, "stats_wt")),
        ln_norm=f32(_get(d, "ln_norm")),
        ln_norm_c=f32(_get(d, "ln_norm_c")),
        front=np.float32(_get(d, "front")),
        num_resamples=int(_get(d, "num_resamples")),
        df_pos=f32(_get(d, "df_pos")),
        df_logf=f32(_get(d, "df_logf")),
        df_delta=f32(_get(d, "df_delta")),
        df_k=torch.as_tensor(np.array(_get(d, "df_k"), np.int32),
                             device=device),
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


def segment_from_numpy(seg, lags, device, xc_epochs=(), xr_epochs=()
                       ) -> Segment:
    """The port's ``Segment`` from the JAX step's segment ``(length,
    configs [C, n], n_configs, state, leaf_status, dist_mut)`` with numpy
    leaves: the first ``n_configs`` phase configurations, ``has_data`` from
    the first of them, and the recording gate that the JAX step computes
    from ``dist_mut``, ``lags`` and its ``-xc``/``-xr`` masks."""
    length, configs, n_configs, state, leaf_status, dist_mut = (
        np.asarray(x) for x in seg)
    cf = torch.as_tensor(configs[:int(n_configs)].astype(np.int8),
                         device=device)
    gate = fifo_gate_masks(dist_mut.reshape(1), lags, xc_epochs, xr_epochs)[0]
    return Segment(int(length), int(state), int(leaf_status), cf, cf[0] >= 0,
                   torch.as_tensor(gate, device=device))
