# Copied from smcsmc_tpu/argout.py at commit 6997021; keep it letter for letter.
""".trees ARG output and tskit-style postprocessing.

Reference: ``-arg`` dumps the sampled particle's event chain to ``.trees.gz``
(particleContainer.cpp:515-555): rows ``{R|C|M}  pos  time  from  to
descendants-bitstring``; smcsmc/trees2tskit.py parses them back into tables
and `utils.find_segments` extracts migrated tracts.  tskit is not available
in this environment, so the conversion surface returns plain numpy tables
(and raises with a clear message where a tskit TableCollection is required).
"""

from __future__ import annotations

import gzip

import numpy as np


def _desc_string(mask: int) -> str:
    """0/1 bitstring up to the highest set bit (descendants.hpp:50-64)."""
    if mask == 0:
        return "0"
    out = []
    while mask:
        out.append("1" if mask & 1 else "0")
        mask >>= 1
    return "".join(out)


def write_trees(
    path: str,
    arg_pos: np.ndarray,
    arg_code: np.ndarray,
    arg_time: np.ndarray,
    arg_from: np.ndarray,
    arg_to: np.ndarray,
    arg_desc: np.ndarray,
    arg_n: int,
    start_position: int = 1,
) -> None:
    """Write one particle's event ring to .trees.gz, oldest first."""
    A = len(arg_pos)
    n = int(arg_n)
    if n <= A:
        order = range(n)
    else:
        first = n % A
        order = list(range(first, A)) + list(range(first))
    codes = {0: "R", 1: "C", 2: "M"}
    with gzip.open(path, "wt") as fh:
        for i in order:
            fh.write(
                f"{codes[int(arg_code[i])]}\t"
                f"{float(arg_pos[i]) + start_position - 1:.1f}\t"
                f"{float(arg_time[i]):.1f}\t{int(arg_from[i])}\t"
                f"{int(arg_to[i])}\t{_desc_string(int(arg_desc[i]))}\n"
            )


def read_trees(path: str) -> np.ndarray:
    """Parse a .trees.gz into a structured array (trees2tskit.py front end)."""
    rows = []
    with gzip.open(path, "rt") as fh:
        for line in fh:
            code, pos, time, frm, to, desc = line.split()
            rows.append(
                (code, float(pos), float(time), int(frm), int(to),
                 int(desc[::-1], 2) if desc != "0" else 0)
            )
    return np.array(
        rows,
        dtype=[("code", "U1"), ("pos", "f8"), ("time", "f8"), ("from", "i4"),
               ("to", "i4"), ("desc", "u8")],
    )


def find_segments(
    trees_path: str,
    source: int,
    dest: int,
    tmin: float = 0.0,
    tmax: float = np.inf,
    sequence_length: float | None = None,
):
    """Migrated-haplotype tracts from the sampled ARG's M rows (reference:
    utils.find_segments -> trees2tskit migrationlist, utils.py:345-417).

    A migration hop recorded at genome position x on the branch with
    descendant set D and event time t persists along the genome until the
    first later recombination that cuts the SAME branch BELOW the event
    (R row with desc == D and recombination height < t) — that SPR replaces
    the branch section carrying the hop.  Returns a structured array with
    (left, right, time, source, dest, desc) bed-like tract rows filtered by
    direction and time window."""
    ev = read_trees(trees_path)
    end = float(sequence_length) if sequence_length else (
        float(ev["pos"].max()) if len(ev) else 0.0
    )
    m = ev[
        (ev["code"] == "M")
        & (ev["from"] == source)
        & (ev["to"] == dest)
        & (ev["time"] >= tmin)
        & (ev["time"] < tmax)
    ]
    r = ev[ev["code"] == "R"]
    tracts = []
    for row in m:
        cut = r[
            (r["pos"] > row["pos"])
            & (r["desc"] == row["desc"])
            & (r["time"] < row["time"])
        ]
        right = float(cut["pos"].min()) if len(cut) else end
        tracts.append(
            (float(row["pos"]), right, float(row["time"]),
             int(row["from"]), int(row["to"]), int(row["desc"]))
        )
    return np.array(
        tracts,
        dtype=[("left", "f8"), ("right", "f8"), ("time", "f8"),
               ("source", "i4"), ("dest", "i4"), ("desc", "u8")],
    )


def tract_fraction(tracts: np.ndarray, sequence_length: float, n: int) -> float:
    """Fraction of total haplotype-bp covered by migrated tracts.

    Per-haplotype interval-union coverage: a tract covers each of its
    descendant leaves over [left, right), and overlapping tracts on the
    same haplotype are merged before measuring — so the result is a true
    coverage fraction <= 1 (the reference's downstream bed_to_marey,
    utils.py:420, expects disjoint per-haplotype tracts)."""
    if len(tracts) == 0:
        return 0.0
    covered = 0.0
    for leaf in range(n):
        bit = np.uint64(1) << np.uint64(leaf)
        rows = tracts[(tracts["desc"].astype(np.uint64) & bit) != 0]
        if len(rows) == 0:
            continue
        order = np.argsort(rows["left"])
        cur_l = cur_r = None
        for left, right in zip(rows["left"][order], rows["right"][order]):
            if cur_l is None:
                cur_l, cur_r = left, right
            elif left <= cur_r:
                cur_r = max(cur_r, right)
            else:
                covered += cur_r - cur_l
                cur_l, cur_r = left, right
        covered += cur_r - cur_l
    return float(covered / (sequence_length * n))


def _num_leaves(events: np.ndarray) -> int:
    hi = int(np.max(events["desc"])) if len(events) else 1
    return max(hi.bit_length(), 1)


def build_tables(events: np.ndarray, sequence_length: float,
                 num_leaves: int | None = None):
    """Reconstruct node/edge/migration tables from a ``.trees`` event stream
    (the numpy core of the reference's trees2tskit.py:361-521, re-derived
    for this framework's stream: initial-tree C rows at position 0, then
    per-recombination R + C(+M) rows where the C row's descendant set is
    the UNION of the cut lineage and the coalesced-with subtree).

    The current local tree is tracked as a set of (tskit_node_id, height,
    leaf-cluster) records; each SPR updates clusters (remove the cut
    lineage above the cut, add it above the re-coalescence), retires nodes
    whose cluster collapses onto a child's, and diffs the implied edge set
    to emit closed edges.  Migration rows open tract segments that close
    when a later recombination cuts the carrying branch below the event.

    Returns dict with arrays:
      nodes:      time [K], population [K], is_sample [K]
      edges:      left, right, parent, child
      migrations: left, right, node, source, dest, time
    """
    n = num_leaves or _num_leaves(events)
    full = (1 << n) - 1

    nodes_time = [0.0] * n
    nodes_pop = [-1] * n
    nodes_sample = [1] * n

    # active internal nodes: id -> (height, cluster); leaves always active
    active: dict[int, tuple[float, int]] = {}
    open_edges: dict[tuple[int, int], float] = {}  # (parent, child) -> left
    edges = []
    migrations = []
    open_migs = []  # (start_pos, node_id, source, dest, time, cluster)

    def new_node(t, pop=-1):
        nodes_time.append(float(t))
        nodes_pop.append(int(pop))
        nodes_sample.append(0)
        return len(nodes_time) - 1

    def cluster_of(nid):
        return (1 << nid) if nid < n else active[nid][1]

    def height_of(nid):
        return 0.0 if nid < n else active[nid][0]

    def current_edges():
        """Implied (parent, child) pairs: parent = lowest active node with a
        proper-superset cluster."""
        out = {}
        ids = list(active.keys()) + list(range(n))
        for cid in ids:
            cc = cluster_of(cid)
            ch = height_of(cid)
            best = None
            for pid, (ph, pc) in active.items():
                if pid == cid:
                    continue
                if (pc & cc) == cc and (pc != cc or ph > ch):
                    if ph >= ch and (best is None or ph < active[best][0]):
                        best = pid
            if best is not None:
                out[(best, cid)] = True
        return out

    def diff_edges(pos):
        now = current_edges()
        for key in list(open_edges):
            if key not in now:
                left = open_edges.pop(key)
                if pos > left:
                    edges.append((left, pos, key[0], key[1]))
        for key in now:
            if key not in open_edges:
                open_edges[key] = pos

    ev_sorted = events  # stream order: pos-0 rows first, then by position
    i = 0
    # --- initial tree: C rows at the first position, sorted by height -----
    first_pos = ev_sorted["pos"][0] if len(ev_sorted) else 0.0
    init_rows = []
    while i < len(ev_sorted) and ev_sorted["pos"][i] == first_pos and (
        ev_sorted["code"][i] != "R"
    ):
        init_rows.append(ev_sorted[i])
        i += 1
    for row in sorted(init_rows, key=lambda r: float(r["time"])):
        if row["code"] == "C":
            nid = new_node(row["time"], row["from"])
            active[nid] = (float(row["time"]), int(row["desc"]))
        elif row["code"] == "M":
            open_migs.append(
                (float(row["pos"]), None, int(row["from"]), int(row["to"]),
                 float(row["time"]), int(row["desc"]))
            )
    diff_edges(float(first_pos))

    # --- recombination blocks --------------------------------------------
    while i < len(ev_sorted):
        row = ev_sorted[i]
        pos = float(row["pos"])
        if row["code"] == "M":
            open_migs.append(
                (pos, None, int(row["from"]), int(row["to"]),
                 float(row["time"]), int(row["desc"]))
            )
            i += 1
            continue
        if row["code"] != "R":
            i += 1  # stray C (ring overflow lost its R partner): skip
            continue
        h = float(row["time"])
        D = int(row["desc"])
        # find the C partner (next C row at the same position)
        j = i + 1
        crow = None
        while j < len(ev_sorted) and float(ev_sorted["pos"][j]) == pos:
            if ev_sorted["code"][j] == "C":
                crow = ev_sorted[j]
                break
            j += 1
        if crow is None:
            i += 1
            continue
        t_c = float(crow["time"])
        U = int(crow["desc"])
        T = U & ~D
        # close migration tracts whose carrying branch is cut below the event
        still = []
        for mig in open_migs:
            m_pos, _, src, dst, m_t, m_d = mig
            if m_d == D and h < m_t:
                migrations.append((m_pos, pos, m_d, src, dst, m_t))
            else:
                still.append(mig)
        open_migs = still
        i = j + 1
        if T == 0:
            continue  # self-coalescence: tree unchanged
        # update clusters: strict ancestors of the cut lose D ...
        for pid in list(active):
            ph, pc = active[pid]
            if (pc & D) == D and pc != D and ph > h:
                active[pid] = (ph, pc & ~D)
        # ... ancestors of the target (incl. target's old ancestors) gain D
        for pid in list(active):
            ph, pc = active[pid]
            if (pc & T) == T and ph > t_c:
                active[pid] = (ph, pc | D)
        # the new coalescence node
        nid = new_node(t_c, crow["from"])
        active[nid] = (t_c, U)
        # retire nodes whose cluster now equals a lower node's cluster
        # (the cut lineage's old parent went unary)
        changed = True
        while changed:
            changed = False
            for pid in list(active):
                ph, pc = active[pid]
                dup = any(
                    (cluster_of(o) == pc and height_of(o) < ph)
                    for o in (list(active) + list(range(n)))
                    if o != pid
                )
                if dup or pc == 0:
                    del active[pid]
                    changed = True
        diff_edges(pos)

    # --- close everything at the sequence end ----------------------------
    end = float(sequence_length)
    for key, left in open_edges.items():
        if end > left:
            edges.append((left, end, key[0], key[1]))
    for m_pos, _, src, dst, m_t, m_d in open_migs:
        migrations.append((m_pos, end, m_d, src, dst, m_t))

    return {
        "nodes": {
            "time": np.array(nodes_time),
            "population": np.array(nodes_pop),
            "is_sample": np.array(nodes_sample),
        },
        "edges": np.array(
            edges, dtype=[("left", "f8"), ("right", "f8"),
                          ("parent", "i4"), ("child", "i4")]
        ),
        "migrations": np.array(
            migrations, dtype=[("left", "f8"), ("right", "f8"),
                               ("desc", "u8"), ("source", "i4"),
                               ("dest", "i4"), ("time", "f8")]
        ),
        "num_leaves": n,
    }


def migration_attach_node(desc: int) -> int:
    """The node a migration row attaches to: tskit migrations reference a
    single node, while the event stream carries the whole migrating leaf
    cluster as a bitmask — attach to the LOWEST sample leaf of the cluster
    (reference trees2tskit.py keys migrations by descendant set; the lowest
    member is the deterministic representative)."""
    d = int(desc)
    return (d & -d).bit_length() - 1  # lowest set bit


def assemble_tables(tb: dict, sequence_length: float, tskit_mod,
                    num_populations: int | None = None):
    """Fill a tskit TableCollection from :func:`build_tables` output.

    ``tskit_mod`` is the tskit module (or an API-compatible stand-in with
    ``TableCollection``, ``NODE_IS_SAMPLE``, ``NULL``) — injected so the
    assembly logic is testable in environments without tskit installed."""
    tables = tskit_mod.TableCollection(
        sequence_length=float(sequence_length)
    )
    pops = num_populations or max(
        1, int(tb["nodes"]["population"].max()) + 1
    )
    for _ in range(pops):
        tables.populations.add_row()
    for t, p, s in zip(tb["nodes"]["time"], tb["nodes"]["population"],
                       tb["nodes"]["is_sample"]):
        tables.nodes.add_row(
            flags=tskit_mod.NODE_IS_SAMPLE if s else 0,
            time=float(t),
            population=int(p) if p >= 0 else tskit_mod.NULL,
        )
    for e in tb["edges"]:
        tables.edges.add_row(
            left=float(e["left"]), right=float(e["right"]),
            parent=int(e["parent"]), child=int(e["child"]),
        )
    for m in tb["migrations"]:
        tables.migrations.add_row(
            left=float(m["left"]), right=float(m["right"]),
            node=migration_attach_node(m["desc"]),
            source=int(m["source"]), dest=int(m["dest"]),
            time=float(m["time"]),
        )
    tables.sort()
    return tables


def trees_to_tskit(trees_path: str, sequence_length: float,
                   num_populations: int | None = None):
    """Convert a .trees.gz event stream into a tskit TableCollection
    (reference: trees2tskit.py:361-521).  The numpy tables are always
    built (see :func:`build_tables`); tskit is only needed for the final
    TableCollection assembly."""
    try:
        import tskit
    except ImportError as e:
        raise ImportError(
            "tskit is not installed in this environment; use build_tables() "
            "for the plain-numpy node/edge/migration tables"
        ) from e
    ev = read_trees(trees_path)
    tb = build_tables(ev, sequence_length)
    return assemble_tables(tb, sequence_length, tskit, num_populations)
