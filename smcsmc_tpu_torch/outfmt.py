# Copied from smcsmc_tpu/outfmt.py at commit dfc2fad; keep it letter for letter.
""".out file reading/writing — the reference's primary inter-layer contract.

Format (reference: pfparam.cpp:459-527 ``appendToOutFile``/``outFileHeader``;
merged format model.py:913-947 ``write_outfile``):

    Iter Epoch Start End Type From To Opp Count Rate Ne ESS [Clump]

Types: Coal | Recomb | Migr | Delay | Resamp | LogL.  Derived columns:
Rate = Count/Opp; Ne = Opp/(2*Count) for Coal rows; ESS = 1/(Wt/Opp)
(post-lag effective sample size).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def format_double(d: float, scientific_bound: float = 0.1, precision: int = 2) -> str:
    """Reproduce the reference's FormatDouble (pfparam.cpp:482-496)."""
    field_length = 14
    maxdouble = 10.0 ** (field_length - precision - 1)
    if d < maxdouble and (d > scientific_bound or d == 0.0):
        return f"{d:>{field_length}.{precision}f}"
    return f"{d:>{field_length}.{field_length - 7}e}"


HEADER = (
    f"{'Iter':>6} {'Epoch':>6} {'Start':>14} {'End':>14} {'Type':>6} "
    f"{'From':>6} {'To':>6} {'Opp':>14} {'Count':>14} {'Rate':>14} "
    f"{'Ne':>14} {'ESS':>14}"
)
HEADER_CLUMP = HEADER + f" {'Clump':>6}"


def append_rows(
    lines: list[str],
    em_iter: int,
    epoch: int,
    start: float,
    end: float,
    etype: str,
    from_pop: int,
    to_pop: int,
    opp: float,
    count: float,
    weight: float,
    clump: int | None = None,
) -> None:
    """One .out row (pfparam.cpp:500-527).  ``clump`` appends the merged
    format's chunk-index column (model.py:917: -1 = aggregate row)."""
    rate = count / (opp + 1e-10)
    ne = (opp + 1e-10) / (2.0 * count) if etype == "Coal" else 0.0
    ess = 1.0 / (weight / opp + 1e-10) if opp > 0 else 1.0
    lines.append(
        f"{em_iter:>6} {epoch:>6} {format_double(start)} {format_double(end)} "
        f"{etype:>6} {from_pop:>6} {to_pop:>6} {format_double(opp)} "
        f"{format_double(count)} {format_double(rate)} {format_double(ne)} "
        f"{format_double(ess, 1.0, 3)}"
        + ("" if clump is None else f" {clump:>6}")
    )


def stats_to_out(
    em_iter: int,
    change_times: np.ndarray,
    stats,
    stats_wt,
    log_likelihood: float,
    num_particles: int,
    num_resamples: int = 0,
    sequence_len: float = 0.0,
    clump: int | None = None,
    header: bool = True,
) -> str:
    """Render a committed SuffStats pair into .out text (count.cpp:66-158,
    ``log_counts``).  ``stats``/``stats_wt`` are host numpy SuffStats.

    ``clump`` adds the merged format's chunk-index column to every row
    (model.py:913-947: -1 marks aggregate rows, >=0 per-chunk rows);
    ``header=False`` omits the header line so per-chunk row groups can be
    appended to an aggregate file."""
    E = len(change_times)
    ends = np.append(change_times[1:], 1e99)
    Pp = np.asarray(stats.coal_opp).shape[1]
    if header:
        lines = [HEADER if clump is None else HEADER_CLUMP]
    else:
        lines = []
    coal_opp = np.asarray(stats.coal_opp, dtype=np.float64)
    coal_cnt = np.asarray(stats.coal_cnt, dtype=np.float64)
    coal_wt = np.asarray(stats_wt.coal_opp, dtype=np.float64)
    for e in range(E):
        for p in range(Pp):
            append_rows(
                lines, em_iter, e, change_times[e], ends[e], "Coal", p, -1,
                coal_opp[e, p], coal_cnt[e, p], coal_wt[e, p], clump=clump,
            )
    # recombination: single aggregate row (count.cpp:104-113)
    r_opp = float(np.sum(np.asarray(stats.recomb_opp, dtype=np.float64)))
    r_cnt = float(np.sum(np.asarray(stats.recomb_cnt, dtype=np.float64)))
    r_wt = float(np.sum(np.asarray(stats_wt.recomb_opp, dtype=np.float64)))
    append_rows(lines, em_iter, -1, 0.0, 1e99, "Recomb", -1, -1, r_opp, r_cnt, r_wt, clump=clump)
    # migration rows
    mig_opp = np.asarray(stats.mig_opp, dtype=np.float64)
    mig_cnt = np.asarray(stats.mig_cnt, dtype=np.float64)
    mig_wt = np.asarray(stats_wt.mig_opp, dtype=np.float64)
    if Pp > 1:
        for e in range(E):
            for i in range(Pp):
                for j in range(Pp):
                    if i != j:
                        append_rows(
                            lines, em_iter, e, change_times[e], ends[e], "Migr",
                            i, j, mig_opp[e, i], mig_cnt[e, i, j], mig_wt[e, i],
                            clump=clump,
                        )
    # Delay / Resamp bookkeeping rows (count.cpp:135-157)
    append_rows(
        lines, em_iter, -1, 0.0, 1e99, "Delay", -1, -1,
        max(sequence_len, 1e-10), 0.0, max(sequence_len, 1e-10), clump=clump,
    )
    append_rows(
        lines, em_iter, -1, 0.0, 1e99, "Resamp", -1, -1,
        max(sequence_len, 1e-10), float(num_resamples),
        max(sequence_len, 1e-10), clump=clump,
    )
    # LogL row (smcsmc.cpp:391)
    append_rows(
        lines, em_iter, -1, 0.0, 1e99, "LogL", -1, -1, 1.0, log_likelihood,
        1.0, clump=clump,
    )
    return "\n".join(lines) + "\n"


def parse_outfile(path_or_text: str, data=None, from_text: bool = False):
    """Parse a .out file into the reference's aggregation dict
    (model.py:865-911 ``parse_outfile``): keys ``((Type, Epoch, From, To,
    Clump), column)`` summing Opp/Count/Wt across chunks."""
    if from_text:
        content = path_or_text
    else:
        with open(path_or_text) as fh:
            content = fh.read()
    if data is None:
        data = defaultdict(float)
    lines = content.strip().split("\n")
    header = lines[0].split()
    for line in lines[1:]:
        elts = dict(zip(header, line.split()))
        typ = elts["Type"]
        epoch = int(elts["Epoch"])
        frm = int(elts["From"])
        to = int(elts["To"])
        opp = float(elts["Opp"])
        count = float(elts["Count"])
        ess = float(elts["ESS"])
        clump = int(elts.get("Clump", -1))
        key = (typ, epoch, frm, to, clump)
        # per-chunk rows accumulate only under their own clump key — unlike
        # the reference (model.py:896-905), which also re-adds them to the
        # aggregate key and relies on the M-step using only Opp/Count ratios;
        # keeping the aggregate clean preserves absolute magnitudes for the
        # resume path (_stats_from_outdata)
        data[(key, "Opp")] += opp
        data[(key, "Count")] += count
        data[(key, "Wt")] += max(0.0, (1.0 / ess - 1e-10)) * opp
        data[(key, "Start")] = float(elts["Start"])
        data[(key, "End")] = float(elts["End"])
    return data


def write_merged_outfile(path: str, data, iteration: int) -> None:
    """Write the merged per-iteration .out (model.py:913-947)."""
    lines = [
        "  Iter  Epoch       Start         End   Type   From     To"
        "            Opp          Count           Rate             Ne"
        "         ESS  Clump"
    ]
    for key in sorted(
        (k for k in data if k[1] == "Count"),
        key=lambda elt: (elt[0][-1] >= 0, elt),
    ):
        k0 = key[0]
        typ, epoch, frm, to, clump = k0
        start = data[(k0, "Start")]
        end = data[(k0, "End")]
        opp = data[(k0, "Opp")]
        count = data[(k0, "Count")]
        wt = data[(k0, "Wt")]
        if typ == "LogL":
            opp, wt = 1.0, 1.0
        rate = count / (opp + 1e-30)
        ne = (opp + 1e-10) / (2.0 * count + 1e-30) if typ == "Coal" else 0.0
        ess = 1.0 / (wt / (opp + 1e-30))
        lines.append(
            "{:6d} {:>6d} {:11.5g} {:11.5g} {:>6s}  {:>5d}  {:>5d} {:14.8g}"
            " {:14.8g} {:14.8g} {:14.8g} {:11.5g} {:>6d}".format(
                iteration, epoch, start, end, typ, frm, to, opp, count, rate,
                ne, ess, clump,
            )
        )
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
