# Copied from smcsmc_tpu/demography.py at commit dfc2fad; keep the code letter for letter (the docstrings name the reference's files by their path inside the reference tree).
"""Demographic model container: piecewise-constant structured coalescent.

Feature parity target: the scrm ``Model``/``Param`` surface actually consumed
by the reference (SURVEY.md §2.3; reference usage at
src/pfparam.cpp:287-318 and
smcsmc/populationmodels.py:73-182) — epochs, per-population
sizes, migration matrices, population splits (``-ej``), sample configuration
(``-I``/``-eI``), plus mutation/recombination rates.

Everything is stored in **natural units**: times in generations, sizes as
diploid Ne, rates per generation.  The scrm-style flag parser converts from
ms units (times in 4N0 generations, sizes relative to N0, migration as
4N0*m).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np


class DemographyError(ValueError):
    """Invalid demographic model or flags (reference: src/exception.hpp)."""


@dataclass
class Demography:
    """Piecewise-constant demography over epochs.

    Attributes
    ----------
    change_times : (E,) float64
        Epoch start times in generations; ``change_times[0] == 0``.
    pop_sizes : (E, P) float64
        Diploid effective population size per epoch per population.
    mig_rates : (E, P, P) float64
        Backwards-in-time per-lineage migration rate per generation;
        ``mig_rates[e, i, j]`` moves a lineage from pop i to pop j.
        Diagonal is zero.
    splits : list of (time, source, sink)
        ``-ej t i j``: backwards in time, at generation ``t`` all lineages in
        ``source`` move to ``sink`` (0-based pops).  ``time`` must coincide
        with a change time.
    sample_pops : (n,) int32 — population of each sampled haplotype (0-based).
    sample_times : (n,) float64 — sampling time (generations) of each leaf.
    mutation_rate, recombination_rate : per site per generation.
    sequence_length : in bp.
    n0 : scaling N0 used for unit conversion (scrm ``-N0``).
    """

    change_times: np.ndarray
    pop_sizes: np.ndarray
    mig_rates: np.ndarray
    splits: list[tuple[float, int, int]] = field(default_factory=list)
    sample_pops: np.ndarray = None
    sample_times: np.ndarray = None
    mutation_rate: float = 1e-8
    recombination_rate: float = 1e-9
    sequence_length: float = 2e7
    n0: float = 10000.0

    def __post_init__(self):
        self.change_times = np.asarray(self.change_times, dtype=np.float64)
        self.pop_sizes = np.asarray(self.pop_sizes, dtype=np.float64)
        self.mig_rates = np.asarray(self.mig_rates, dtype=np.float64)
        E = len(self.change_times)
        if self.pop_sizes.ndim == 1:
            self.pop_sizes = self.pop_sizes[:, None]
        P = self.pop_sizes.shape[1]
        if self.mig_rates.size == 0:
            self.mig_rates = np.zeros((E, P, P))
        if self.change_times[0] != 0.0:
            raise DemographyError("first change time must be 0")
        if np.any(np.diff(self.change_times) <= 0):
            raise DemographyError("change times must be strictly increasing")
        if self.pop_sizes.shape != (E, P):
            raise DemographyError("pop_sizes must be (E, P)")
        if self.mig_rates.shape != (E, P, P):
            raise DemographyError("mig_rates must be (E, P, P)")
        if np.any(self.pop_sizes <= 0):
            raise DemographyError("population sizes must be positive")
        for i in range(P):
            self.mig_rates[:, i, i] = 0.0
        if self.sample_pops is None:
            self.sample_pops = np.zeros(2, dtype=np.int32)
        self.sample_pops = np.asarray(self.sample_pops, dtype=np.int32)
        if self.sample_times is None:
            self.sample_times = np.zeros(len(self.sample_pops))
        self.sample_times = np.asarray(self.sample_times, dtype=np.float64)
        for t, src, snk in self.splits:
            if not np.any(np.isclose(self.change_times, t)):
                raise DemographyError(f"-ej time {t} is not an epoch boundary")
            if not (0 <= src < P and 0 <= snk < P):
                raise DemographyError("-ej population out of range")

    # -- basic queries ----------------------------------------------------

    @property
    def num_epochs(self) -> int:
        return len(self.change_times)

    @property
    def num_populations(self) -> int:
        return self.pop_sizes.shape[1]

    @property
    def num_samples(self) -> int:
        return len(self.sample_pops)

    def epoch_of(self, t: float) -> int:
        """Epoch index containing generation ``t``."""
        return int(np.searchsorted(self.change_times, t, side="right") - 1)

    def epoch_end_times(self) -> np.ndarray:
        """End of each epoch; the final epoch is open (1e99, matching the
        reference .out convention, count.cpp:73)."""
        return np.append(self.change_times[1:], 1e99)

    def pop_map_at_epoch(self) -> np.ndarray:
        """(E, P) int32: population relabeling in force during each epoch,
        folding in ``-ej`` splits.  ``pop_map[e, p]`` is the population a
        lineage labelled ``p`` actually occupies during epoch ``e``."""
        E, P = self.num_epochs, self.num_populations
        pm = np.tile(np.arange(P, dtype=np.int32), (E, 1))
        for t, src, snk in self.splits:
            e0 = self.epoch_of(t)
            for e in range(e0, E):
                pm[e][pm[e] == src] = snk
        return pm

    def with_updated_rates(
        self,
        pop_sizes: np.ndarray | None = None,
        mig_rates: np.ndarray | None = None,
        recombination_rate: float | None = None,
    ) -> "Demography":
        """Functional update used by the M-step (reference: count.cpp:44-63)."""
        new = replace(self)
        if pop_sizes is not None:
            new.pop_sizes = np.asarray(pop_sizes, dtype=np.float64)
        if mig_rates is not None:
            new.mig_rates = np.asarray(mig_rates, dtype=np.float64)
        if recombination_rate is not None:
            new.recombination_rate = float(recombination_rate)
        new.__post_init__()
        return new

    # -- scrm-style command line ------------------------------------------

    def core_command_line(self) -> str:
        """Emit an ms/scrm-style flag string for this model (reference:
        populationmodels.py:406-437, ``core_command_line``)."""
        parts = []
        four_n0 = 4 * self.n0
        theta = 4 * self.n0 * self.mutation_rate * self.sequence_length
        rho = 4 * self.n0 * self.recombination_rate * self.sequence_length
        parts.append(f"-N0 {self.n0:g}")
        parts.append(f"-t {theta:g}")
        parts.append(f"-r {rho:g} {self.sequence_length:g}")
        P = self.num_populations
        if P > 1:
            counts = [int(np.sum(self.sample_pops == p)) for p in range(P)]
            parts.append("-I " + str(P) + " " + " ".join(map(str, counts)))
        for e in range(self.num_epochs):
            t = self.change_times[e] / four_n0
            sizes = self.pop_sizes[e] / self.n0
            if P == 1:
                if e > 0 or sizes[0] != 1.0:
                    parts.append(f"-eN {t:g} {sizes[0]:g}")
            else:
                for p in range(P):
                    parts.append(f"-en {t:g} {p + 1:d} {sizes[p]:g}")
                for i in range(P):
                    for j in range(P):
                        if i != j and (
                            e == 0 or self.mig_rates[e, i, j] != self.mig_rates[e - 1, i, j]
                        ):
                            m = self.mig_rates[e, i, j] * four_n0
                            parts.append(f"-em {t:g} {i + 1:d} {j + 1:d} {m:g}")
        for t, src, snk in self.splits:
            parts.append(f"-ej {t / four_n0:g} {src + 1:d} {snk + 1:d}")
        return " ".join(parts)


def parse_scrm_args(args: list[str] | str, n0: float = 10000.0) -> Demography:
    """Parse ms/scrm-style demography flags into a :class:`Demography`.

    Supported (reference: populationmodels.py:73-182 and scrm Param surface,
    SURVEY.md §2.3): ``-N0 -nsam -t -r -I -eI -ej -eM -ema -em -eN -en
    -seed`` (seed is parsed and exposed; unknown flags raise).

    Times on the command line are in units of 4*N0 generations; sizes
    relative to N0; migration rates are 4*N0*m (per ms convention).
    """
    if isinstance(args, str):
        args = args.split()
    opts = list(args)

    # scrm accepts timed options in any order (it sorts model events by
    # time); reproduce that by stable-sorting the timed flag groups while
    # keeping non-timed groups (incl. -I, which must precede them) first
    _TIMED = {"-eI", "-ej", "-eM", "-ema", "-em", "-eN", "-en"}

    def _is_flag(tok: str) -> bool:
        # a token is a flag iff it starts with '-' and is NOT numeric —
        # float-parse rather than isdigit so negative scientific-notation
        # arguments ('-1e-5', '-.5') stay arguments
        if not tok.startswith("-"):
            return False
        try:
            float(tok)
            return False
        except ValueError:
            return True

    groups: list[tuple[float | None, list[str]]] = []
    i = 0
    while i < len(opts):
        o = opts[i]
        grp = [o]
        i += 1
        while i < len(opts) and not _is_flag(opts[i]):
            grp.append(opts[i])
            i += 1
        if o in _TIMED and len(grp) > 1:
            try:
                groups.append((float(grp[1]), grp))
            except ValueError as exc:
                raise DemographyError(
                    f"malformed time argument for {' '.join(grp)}"
                ) from exc
        else:
            groups.append((None, grp))
    untimed = [tok for t, g in groups if t is None for tok in g]
    timed = sorted(
        ((t, g) for t, g in groups if t is not None), key=lambda x: x[0]
    )
    opts = untimed + [tok for _, g in timed for tok in g]

    # first pass: find -N0 (affects all unit conversions)
    nsam = None
    seed = None
    theta = None
    rho = None
    seqlen = None
    i = 0
    while i < len(opts):
        if opts[i] == "-N0":
            n0 = float(opts[i + 1])
            i += 2
        else:
            i += 1

    num_pops = 1
    change_points: list[float] = []  # in 4N0 units
    pop_sizes: list[list[float]] = []  # relative to N0
    mig: list[list[list[float]]] = []  # in 4N0*m units
    splits: list[tuple[float, int, int]] = []
    sample_pops: list[int] = []
    sample_times: list[float] = []

    def ensure_time(t: float):
        if not change_points:
            if t != 0.0:
                ensure_time(0.0)
                ensure_time(t)
                return
            change_points.append(0.0)
            pop_sizes.append([1.0] * num_pops)
            mig.append([[0.0] * num_pops for _ in range(num_pops)])
        elif change_points[-1] != t:
            if t < change_points[-1]:
                raise DemographyError("time arguments must be nondecreasing")
            change_points.append(t)
            pop_sizes.append(list(pop_sizes[-1]))
            mig.append([row[:] for row in mig[-1]])

    i = 0
    while i < len(opts):
        o = opts[i]
        if o == "-N0":
            i += 2
        elif o == "-nsam":
            nsam = int(opts[i + 1])
            i += 2
        elif o == "-t":
            theta = float(opts[i + 1])
            i += 2
        elif o == "-r":
            rho = float(opts[i + 1])
            seqlen = float(opts[i + 2])
            i += 3
        elif o == "-seed":
            # scrm takes 1-3 seed ints; take the first
            seed = int(opts[i + 1])
            i += 2
            while i < len(opts) and not opts[i].startswith("-"):
                i += 1
        elif o == "-I":
            num_pops = int(opts[i + 1])
            if change_points:
                raise DemographyError("-I must precede -eN/-en/-eM/-em/-ema")
            ensure_time(0.0)
            for p in range(num_pops):
                cnt = int(opts[i + 2 + p])
                sample_pops += [p] * cnt
                sample_times += [0.0] * cnt
            i += 2 + num_pops
            # optional symmetric migration rate argument
            if i < len(opts) and not opts[i].startswith("-"):
                m = float(opts[i]) / max(num_pops - 1, 1)
                for a in range(num_pops):
                    for b in range(num_pops):
                        if a != b:
                            mig[-1][a][b] = m
                i += 1
        elif o == "-eI":
            t = float(opts[i + 1])
            ensure_time(t)
            for p in range(num_pops):
                cnt = int(opts[i + 2 + p])
                sample_pops += [p] * cnt
                sample_times += [t] * cnt
            i += 2 + num_pops
        elif o == "-ej":
            t = float(opts[i + 1])
            ensure_time(t)
            src, snk = int(opts[i + 2]) - 1, int(opts[i + 3]) - 1
            splits.append((t, src, snk))
            i += 4
        elif o == "-eM":
            t = float(opts[i + 1])
            ensure_time(t)
            m = float(opts[i + 2]) / max(num_pops - 1, 1)
            for a in range(num_pops):
                for b in range(num_pops):
                    if a != b:
                        mig[-1][a][b] = m
            i += 3
        elif o == "-ema":
            t = float(opts[i + 1])
            ensure_time(t)
            k = i + 2
            for a in range(num_pops):
                for b in range(num_pops):
                    mig[-1][a][b] = float(opts[k]) if a != b else 0.0
                    k += 1
            i = k
        elif o == "-em":
            t = float(opts[i + 1])
            ensure_time(t)
            a, b = int(opts[i + 2]) - 1, int(opts[i + 3]) - 1
            mig[-1][a][b] = float(opts[i + 4])
            i += 5
        elif o == "-eN":
            t = float(opts[i + 1])
            ensure_time(t)
            for p in range(num_pops):
                pop_sizes[-1][p] = float(opts[i + 2])
            i += 3
        elif o == "-en":
            t = float(opts[i + 1])
            ensure_time(t)
            pop_sizes[-1][int(opts[i + 2]) - 1] = float(opts[i + 3])
            i += 4
        elif o == "-M":
            m = float(opts[i + 1]) / max(num_pops - 1, 1)
            ensure_time(0.0)
            for a in range(num_pops):
                for b in range(num_pops):
                    if a != b:
                        mig[-1][a][b] = m
            i += 2
        else:
            raise DemographyError(f"unrecognized demography flag {o!r}")

    if not change_points:
        ensure_time(0.0)

    four_n0 = 4 * n0
    if not sample_pops:
        sample_pops = [0] * (nsam if nsam else 2)
        sample_times = [0.0] * len(sample_pops)
    if nsam is not None and len(sample_pops) != nsam and num_pops > 1:
        raise DemographyError("-nsam disagrees with -I/-eI sample counts")
    if nsam is not None and num_pops == 1:
        sample_pops = [0] * nsam
        sample_times = [0.0] * nsam

    seqlen = seqlen if seqlen is not None else 2e7
    mutation_rate = (theta / (four_n0 * seqlen)) if theta is not None else 1e-8
    recomb_rate = (rho / (four_n0 * seqlen)) if rho is not None else 1e-9

    demo = Demography(
        change_times=np.array(change_points) * four_n0,
        pop_sizes=np.array(pop_sizes) * n0,
        mig_rates=np.array(mig) / four_n0,
        splits=[(t * four_n0, s, k) for t, s, k in splits],
        sample_pops=np.array(sample_pops, dtype=np.int32),
        sample_times=np.array(sample_times) * four_n0,
        mutation_rate=mutation_rate,
        recombination_rate=recomb_rate,
        sequence_length=seqlen,
        n0=n0,
    )
    demo.seed = seed
    return demo


def watterson_theta(num_samples: int, num_seg_sites: int, seqlen: float) -> float:
    """Watterson's estimator of theta per site (reference: model.py:563-662
    uses it for the default N0 when chunking)."""
    harmonic = sum(1.0 / i for i in range(1, num_samples))
    return num_seg_sites / (harmonic * seqlen)
