"""Carry particle state and segments between numpy and the port's tensors.

The tests start both packages from the same trees (with their populations
and migration buffers), weights (posterior and pilot), FIFO, statistics,
ring of delayed factors, diagnostics and, with local recording, the window
accumulators and the ring of pending local events, with ARG recording the
ARG ring: a JAX ``PFState``
with every leaf passed through ``np.asarray`` goes in through
:func:`state_from_numpy`, and :func:`state_to_numpy` gives the port's state
back as numpy arrays under the same field names (the port's one window
tensor ``win_cnt`` as JAX's ``win_leaf_cnt``, ``win_time_cnt`` and
``win_logtime_cnt``; descendant bitmasks, JAX's u32 words, as one int64).
:func:`segment_from_numpy` turns the tuple that the JAX segment step
consumes into the port's ``Segment``, so that both take the same step.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .kernels.local import split_windows
from .kernels.tree import Trees
from .smc import PFState, Segment, fifo_gate_masks


def _get(d, name):
    return d[name] if isinstance(d, Mapping) else getattr(d, name)


def _opt(d, name):
    """``_get``, or None where ``d`` lacks the field."""
    return d.get(name) if isinstance(d, Mapping) else getattr(d, name, None)


def trees_from_numpy(d, device, max_mig: int = 0) -> Trees:
    """Trees from any object (or mapping) with parent/time/child0/child1.
    Where it has migration buffers (``mig_time`` not None) they come too,
    with ``pop``; ``max_mig`` > 0 gives a tree without buffers empty ones
    of that capacity (a JAX tree of a -ej split without migration, for the
    port's migration pass)."""
    mt = _opt(d, "mig_time")
    extra = {}
    if mt is not None or max_mig:
        pop = np.array(_get(d, "pop"), np.int32)
        if mt is None:
            mt = np.full(pop.shape + (max_mig,), 3e38, np.float32)
            md = np.zeros(pop.shape + (max_mig,), np.int32)
        else:
            md = _get(d, "mig_dest")
        extra = dict(
            pop=torch.as_tensor(pop, device=device),
            mig_time=torch.as_tensor(np.array(mt, np.float32), device=device),
            mig_dest=torch.as_tensor(np.array(md, np.int32), device=device))
    return Trees(
        parent=torch.as_tensor(np.array(_get(d, "parent"), np.int32),
                               device=device),
        time=torch.as_tensor(np.array(_get(d, "time"), np.float32),
                             device=device),
        child0=torch.as_tensor(np.array(_get(d, "child0"), np.int32),
                               device=device),
        child1=torch.as_tensor(np.array(_get(d, "child1"), np.int32),
                               device=device),
        **extra,
    )


def trees_to_numpy(trees: Trees) -> dict:
    """The tree arrays as numpy under the JAX ``Trees`` field names; a tree
    of one population gets ``pop`` all 0 and no buffers."""
    out = {k: (None if v is None else v.detach().cpu().numpy())
           for k, v in trees._asdict().items()}
    if out["pop"] is None:
        out["pop"] = np.zeros_like(out["parent"])
    return out


def desc_words_to_int64(words) -> np.ndarray:
    """[..., dw] u32 bitmask words (JAX's ``lr_desc`` / ``arg_desc``) ->
    [...] int64, word k holding bits 32k..32k+31."""
    words = np.asarray(words, np.uint64)
    out = np.zeros(words.shape[:-1], np.uint64)
    for k in range(words.shape[-1]):
        out |= words[..., k] << np.uint64(32 * k)
    return out.view(np.int64)


def _local_from_numpy(d, device) -> dict:
    """The port's window accumulators and ring of pending local events
    from a JAX state's ``win_*`` and ``lr_*`` (none where it has none)."""
    if _opt(d, "lr_pos") is None:
        return {}
    leaf = np.asarray(_get(d, "win_leaf_cnt"), np.float32)
    W, n = leaf.shape
    cnt = np.zeros((W, n + 2), np.float32)
    cnt[:, :n] = leaf
    cnt[:, n] = _get(d, "win_time_cnt")
    cnt[:, n + 1] = _get(d, "win_logtime_cnt")
    f32 = lambda x: torch.as_tensor(np.array(x, np.float32),  # noqa: E731
                                    device=device)
    return dict(
        win_opp_diff=f32(_get(d, "win_opp_diff")),
        win_cnt=torch.as_tensor(cnt, device=device),
        lr_pos=f32(_get(d, "lr_pos")), lr_due=f32(_get(d, "lr_due")),
        lr_time=f32(_get(d, "lr_time")),
        lr_desc=torch.as_tensor(desc_words_to_int64(_get(d, "lr_desc")),
                                device=device),
        lr_dropped=torch.as_tensor(np.array(_get(d, "lr_dropped"),
                                            np.int32), device=device))


def _arg_from_numpy(d, device) -> dict:
    """The port's ARG ring from a JAX state's ``arg_*`` (none where it has
    none); the leaves' u32 words as one int64."""
    if _opt(d, "arg_pos") is None:
        return {}
    t = lambda x, dt: torch.as_tensor(np.array(x, dt),  # noqa: E731
                                      device=device)
    return dict(
        arg_pos=t(_get(d, "arg_pos"), np.float32),
        arg_code=t(_get(d, "arg_code"), np.int8),
        arg_time=t(_get(d, "arg_time"), np.float32),
        arg_from=t(_get(d, "arg_from"), np.int8),
        arg_to=t(_get(d, "arg_to"), np.int8),
        arg_desc=torch.as_tensor(desc_words_to_int64(_get(d, "arg_desc")),
                                 device=device),
        arg_n=t(_get(d, "arg_n"), np.int32))


def state_from_numpy(d, device, max_mig: int = 0) -> PFState:
    """PFState from a JAX ``PFState`` (or mapping) with numpy leaves
    (``max_mig`` as in :func:`trees_from_numpy`)."""
    f32 = lambda x: torch.as_tensor(np.array(x, np.float32),  # noqa: E731
                                    device=device)
    diag = _opt(d, "diag")
    return PFState(
        trees=trees_from_numpy(_get(d, "trees"), device, max_mig),
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
        diag=torch.as_tensor(np.zeros(2) if diag is None
                             else np.array(diag, np.float64), device=device),
        **_local_from_numpy(d, device),
        **_arg_from_numpy(d, device),
    )


def state_to_numpy(state: PFState) -> dict:
    """The port's state as numpy arrays under the JAX field names."""
    out = {}
    for name, v in state._asdict().items():
        if name == "trees":
            out[name] = trees_to_numpy(v)
        elif name == "win_cnt" and v is not None:
            for k, x in zip(("win_leaf_cnt", "win_time_cnt",
                             "win_logtime_cnt"), split_windows(v)):
                out[k] = x.detach().cpu().numpy()
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def segment_from_numpy(seg, lags, device, xc_epochs=(), xr_epochs=(),
                       Pp: int = 1) -> Segment:
    """The port's ``Segment`` from the JAX step's segment ``(length,
    configs [C, n], n_configs, state, leaf_status, dist_mut)`` with numpy
    leaves: the first ``n_configs`` phase configurations, ``has_data`` from
    the first of them, and the recording gate that the JAX step computes
    from ``dist_mut``, ``lags`` and its ``-xc``/``-xr`` masks.  A segment
    of the APF step carries the twelve lookahead columns after those six
    (``em.lookahead_columns``' order); they become ``Segment.lookahead``,
    the split's distance and count as host numbers."""
    (length, configs, n_configs, state, leaf_status, dist_mut,
     *la) = (np.asarray(x) for x in seg)
    cf = torch.as_tensor(configs[:int(n_configs)].astype(np.int8),
                         device=device)
    gate = fifo_gate_masks(dist_mut.reshape(1), lags, xc_epochs, xr_epochs,
                           Pp)[0]
    lookahead = None
    if la:
        lookahead = tuple(
            x[()] if k in (9, 11)
            else torch.as_tensor(np.array(x), device=device)
            for k, x in enumerate(la))
    return Segment(int(length), int(state), int(leaf_status), cf, cf[0] >= 0,
                   torch.as_tensor(gate, device=device), lookahead)
