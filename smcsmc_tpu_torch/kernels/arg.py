"""ARG recording (``-arg``): each particle's ring of genealogy events, the
record behind ``.trees.gz``.

Counterparts: ``smcsmc_tpu/smc.py::_init_arg_ring`` (:351),
``_push_arg_event`` (:513) and the pushes of the trip loop (:1021-1052)
(the reference's RECORD_TREE_EVENT chain, particleContainer.cpp:515-555).
The ring starts with the initial tree at position 0: one C row per internal
node (its height, population and leaves) and, for a structured model, M
rows for the first 4 migration events of each branch's buffer.  Each
recombination trip then pushes an R row (the point's height and the leaves
below the cut branch before the SPR), a C row (the coalescence height and
population, the union of the leaves below the cut branch and below the
branch it joins) and, with migration, an M row for each of the first 4
hops of the new branch's walk (its source and destination population, the
leaves below the cut branch).  A push takes slot ``arg_n % A`` and counts
``arg_n`` up: the ring keeps the newest ``A`` rows.  A row's leaves are one
int64 word, bit l for leaf l (the reference's u64 Descendants_t, at most
64 leaves).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tree import INF, Trees, descendant_bitmask

# row codes (the .trees.gz event types)
ARG_RECOMB, ARG_COAL, ARG_MIG = 0, 1, 2
# migration hops recorded per transition (and per branch of the initial
# tree): smc.py:1044 of the JAX package
ARG_MIG_ROWS = 4
# the ring's slots per particle (PFConfig.arg_slots)
ARG_SLOTS = 512
ARG_FIELDS = ("arg_pos", "arg_code", "arg_time", "arg_from", "arg_to",
              "arg_desc", "arg_n")


class ArgPass(NamedTuple):
    """What a segment pass with ARG recording updates beyond its variant's
    own tensors, IN PLACE."""

    arg_pos: torch.Tensor  # [P, A] f32 event position (chunk relative)
    arg_code: torch.Tensor  # [P, A] i8 0 R, 1 C, 2 M
    arg_time: torch.Tensor  # [P, A] f32 event height
    arg_from: torch.Tensor  # [P, A] i8 population (R: -1)
    arg_to: torch.Tensor  # [P, A] i8 destination (M), else -1
    arg_desc: torch.Tensor  # [P, A] i64 leaves below
    arg_n: torch.Tensor  # [P] i32 rows pushed so far
    front: float  # the segment's start, chunk relative (host float32)

    @property
    def ring(self) -> tuple:
        return tuple(self[:7])


def push_arg_event(ring: tuple, mask, pos, code: int, time, from_pop, to_pop,
                   desc) -> tuple:
    """One row per masked particle into slot ``arg_n % A`` of its ring
    (``ring`` in :data:`ARG_FIELDS` order); returns the new ring.
    ``from_pop``/``to_pop`` are [P] tensors or ints."""
    pos_, code_, time_, from_, to_, desc_, n_ = ring
    P, A = pos_.shape
    slot = (n_ % A).long()
    hit = (torch.arange(A, device=pos_.device)[None, :] == slot[:, None]) \
        & mask[:, None]

    def put(a, v):
        v = torch.as_tensor(v, device=a.device).to(a.dtype)
        return torch.where(hit, v[:, None] if v.dim() else v, a)

    return (put(pos_, pos), put(code_, code), put(time_, time),
            put(from_, from_pop), put(to_, to_pop), put(desc_, desc),
            n_ + mask.to(torch.int32))


def init_arg_ring(trees: Trees, slots: int = ARG_SLOTS) -> dict:
    """The ring of the initial trees (``_init_arg_ring``): one C row per
    internal node at position 0 (``arg_n`` = n - 1), then with migration
    buffers the first :data:`ARG_MIG_ROWS` events of each branch's buffer
    as M rows, branch by branch, each from the population the branch was
    in before it."""
    P, N = trees.parent.shape
    n = (N + 1) // 2
    dev = trees.parent.device
    k = n - 1
    desc = descendant_bitmask(trees.parent)
    pop = (trees.pop if trees.pop is not None
           else torch.zeros_like(trees.parent))
    pos = torch.zeros((P, slots), device=dev)
    code = torch.zeros((P, slots), dtype=torch.int8, device=dev)
    code[:, :k] = ARG_COAL
    time = torch.zeros((P, slots), device=dev)
    time[:, :k] = trees.time[:, n:]
    frm = torch.full((P, slots), -1, dtype=torch.int8, device=dev)
    frm[:, :k] = pop[:, n:].to(torch.int8)
    to = torch.full((P, slots), -1, dtype=torch.int8, device=dev)
    dsc = torch.zeros((P, slots), dtype=torch.int64, device=dev)
    dsc[:, :k] = desc[:, n:]
    ring = (pos, code, time, frm, to, dsc,
            torch.full((P,), k, dtype=torch.int32, device=dev))
    if trees.mig_time is not None:
        Mw = trees.mig_time.shape[2]
        for b in range(N):
            src = pop[:, b]
            for j in range(min(ARG_MIG_ROWS, Mw)):
                t_ev = trees.mig_time[:, b, j]
                have = t_ev < 0.5 * INF
                dst = trees.mig_dest[:, b, j]
                ring = push_arg_event(ring, have, 0.0, ARG_MIG, t_ev, src,
                                      dst, desc[:, b])
                src = torch.where(have, dst, src)
    return dict(zip(ARG_FIELDS, ring))


def push_trip_rows(ring: tuple, active, pos, h_r, t_c, coal_pop, desc_c,
                   desc_d, mig=None) -> tuple:
    """A trip's rows for each active particle: R (``h_r``, the leaves
    ``desc_c`` below the cut branch), C (``t_c``, ``coal_pop``, the union
    with ``desc_d``, the leaves below the branch it joins) and, with
    ``mig`` = (ev_t, from, to) [P, 2 Mw], an M row for each of the first
    :data:`ARG_MIG_ROWS` hops (smc.py:1021-1052 of the JAX package)."""
    ring = push_arg_event(ring, active, pos, ARG_RECOMB, h_r, -1, -1, desc_c)
    ring = push_arg_event(ring, active, pos, ARG_COAL, t_c, coal_pop, -1,
                          desc_c | desc_d)
    if mig is not None:
        ev_t, ev_from, ev_to = mig
        for j in range(min(ARG_MIG_ROWS, ev_t.shape[1])):
            ring = push_arg_event(ring, active & (ev_t[:, j] < 0.5 * INF),
                                  pos, ARG_MIG, ev_t[:, j], ev_from[:, j],
                                  ev_to[:, j], desc_c)
    return ring


def pick_desc(desc, node):
    """[P] the word of ``desc`` [P, N] at ``node`` [P] (0 where node < 0,
    as the JAX package's one-hot pick)."""
    got = desc.gather(1, node.clamp(min=0).long()[:, None])[:, 0]
    return torch.where(node >= 0, got, torch.zeros_like(got))


def store_ring(arg: ArgPass | None, ring: tuple) -> None:
    """Copy ``ring`` into ``arg``'s tensors (a plain pass's result)."""
    if arg is not None:
        for dst, src in zip(arg.ring, ring):
            if dst is not src:
                dst.copy_(src)
