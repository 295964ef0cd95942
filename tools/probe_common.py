"""What the kernel probes of ``tools/`` share: the card's line, builds of
``csrc/trip.cu``'s units with every nvcc process started together, a
build loaded behind this tree's wrappers and launched through them,
timing in turns, and a library's SASS.

``tools/arg_probe.py``, ``tools/mig_proposal_probe.py`` and
``tools/local_probe.py`` import it.  A build of trip.cu is five units
(``-DSMC_PART=0..4``, as ``smcsmc_tpu_torch/kernels/_build.py`` builds
it; a source of four units compiles an empty fifth); the narrow kernels
(``trip``, the plain, biased and guided passes and their local, VB and
ARG variants) are unit 0, the migration pass without VB, and its
proposal variants, unit 2."""

from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import time
from pathlib import Path

import chip_smoke as cs
import torch
from smcsmc_tpu_torch.kernels import _build
from smcsmc_tpu_torch.kernels.trip import segment_pass_launch_args

UNITS = _build.TRIP_PARTS
NARROW_UNIT = 0
MIG_UNIT = 2


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# ---- builds ----------------------------------------------------------------

def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _unit(src: Path, part: int):
    """An nvcc process compiling unit ``part`` of ``src`` beside it;
    (process, object path)."""
    obj = src.with_name(f"part{part}.o")
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    cmd = [_build._nvcc(), *flags, f"-DSMC_PART={part}", "-c", "-o",
           str(obj), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), obj


def _source(where: Path, text: str) -> Path:
    where.mkdir(parents=True, exist_ok=True)
    (where / "trip.cu").write_text(text)
    return where / "trip.cu"


def build(out: Path, wholes: dict[str, str],
          variants: dict[str, str] | None = None,
          base: str | None = None,
          unit: int = MIG_UNIT) -> dict[str, tuple[Path, str]]:
    """{name: (library, ptxas log)} under ``out``: each text of ``wholes``
    built whole (its units), each of ``variants`` as unit ``unit``
    (the migration unit unless given) linked with the other units of
    ``base`` (a text of ``wholes``); every nvcc process started together,
    libraries that exist (by hash) not built again."""
    t0 = time.monotonic()
    variants = variants or {}
    jobs, libs = [], {}
    for name, text in wholes.items():
        where = out / f"whole_{_sha(text)}"
        if not (where / "libsmctrip.so").exists():
            src = _source(where, text)
            jobs += [(name, where, k, _unit(src, k)) for k in range(UNITS)]
    for name, text in variants.items():
        where = out / f"variant_{unit}_{_sha(base + text)}"
        if not (where / "libsmctrip.so").exists():
            jobs.append((name, where, unit, _unit(_source(where, text),
                                                  unit)))
    logs = {}
    for name, where, k, (proc, obj) in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name} unit {k}:\n{log}")
        logs.setdefault(where, []).append(log)
    for where, parts in logs.items():
        (where / "ptxas.log").write_text("".join(parts))
    for name, text in {**wholes, **variants}.items():
        if name in variants:
            where = out / f"variant_{unit}_{_sha(base + text)}"
            objs = [where / f"part{k}.o" if k == unit
                    else out / f"whole_{_sha(base)}" / f"part{k}.o"
                    for k in range(UNITS)]
        else:
            where = out / f"whole_{_sha(text)}"
            objs = [where / f"part{k}.o" for k in range(UNITS)]
        lib = where / "libsmctrip.so"
        if not lib.exists():
            subprocess.run([_build._nvcc(), "-shared", "-o", str(lib),
                            *map(str, objs)], check=True)
        libs[name] = (lib, (where / "ptxas.log").read_text())
    print(f"built {len(jobs)} units for {len(libs)} libraries in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return libs


def load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with the argument types of the tree's."""
    real = _build.build_trip_library
    _build.build_trip_library = lambda force=False: _build.BuildInfo(
        path, False, 0.0, "")
    try:
        return _build.load_trip_library.__wrapped__()
    finally:
        _build.build_trip_library = real


def ptxas(log: str, pick: str) -> list[str]:
    """ptxas's lines of the kernels whose name holds ``pick``: name,
    registers, stack, spills."""
    out, lines = [], log.splitlines()
    for j, ln in enumerate(lines):
        if "Compiling entry function" in ln and pick in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            out.append(name + ": " + " | ".join(
                x.strip() for x in lines[j + 1:j + 4]
                if "Function properties" not in x))
    return out


# ---- launches and timing in turns -------------------------------------------

def via(lib):
    """``segment_pass``'s interface launching ``lib``'s kernel (another
    build of trip.cu) on the current stream."""
    def fn(*args, **kw):
        _, packed = segment_pass_launch_args(*args, **kw)
        err = lib.smc_segment_pass_launch(
            *packed, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"smc_segment_pass_launch returned {err}")
    return fn


def bits(st):
    """A state's tensors with every float's bits as an int."""
    return {k: v.view(torch.int32) if v.dtype == torch.float32 else v
            for k, v in st.items()}


def same(libs: dict, names, fresh, run) -> dict:
    """{name: whether lib ``name``'s outputs are the first name's bit for
    bit}, one fresh state each; ``run(fn, state)`` launches through
    ``fn`` and returns the state."""
    want = bits(run(via(libs[names[0]]), fresh()))
    return {n: all(torch.equal(v, want[k]) for k, v in bits(run(
        via(libs[n]), fresh())).items()) for n in names[1:]}


def turns(libs: dict, names, fresh, run, filler) -> dict:
    """{name: best ms}, ``names`` of ``libs`` timed in turns (the order
    given, then back), each as ``chip_smoke`` times a kernel."""
    ms = {}
    for n in list(names) + list(names)[::-1]:
        t = cs._best_device_ms(lambda st, fn=via(libs[n]): run(fn, st),
                               fresh, filler)
        ms[n] = min(ms.get(n, t), t)
    return ms


def checkouts(out: Path, dirs, pick: str):
    """Each checkout's trip.cu built whole and loaded: ({dir: library},
    {dir: label}); prints ptxas's lines of its kernels holding
    ``pick``."""
    texts = {d: (Path(d).resolve() / "smcsmc_tpu_torch" / "csrc"
                 / "trip.cu").read_text() for d in dict.fromkeys(dirs)}
    built = build(out, texts)
    label_of = {d: Path(d).resolve().name or d for d in texts}
    for d, (_, log) in built.items():
        for ln in ptxas(log, pick):
            print(f"ptxas {label_of[d]}: {ln}", flush=True)
    return {d: load(p) for d, (p, _) in built.items()}, label_of


def times(libs: dict, label_of: dict, dirs, cases, filler):
    """For each (label, {pass: (fresh, run)}) of ``cases``, every pass
    timed with the libraries of ``dirs`` in the order given (a checkout
    given twice is timed twice); each checkout's outputs held to the
    first's bit for bit."""
    uniq = list(dict.fromkeys(dirs))
    for label, passes in cases:
        for pname, (fresh, run) in passes.items():
            ok = same(libs, uniq, fresh, run)
            ms = {}
            for d in dirs:
                t = cs._best_device_ms(
                    lambda st, fn=via(libs[d]): run(fn, st), fresh, filler)
                ms.setdefault(d, []).append(t * 1e3)
            print(f"times {pname} {label}: " + ", ".join(
                f"{label_of[d]} " + " / ".join(f"{x:.2f}" for x in ms[d])
                + f" us (best {min(ms[d]):.2f})" for d in uniq)
                + f"; bit for bit the first's: {ok}", flush=True)


# ---- SASS ------------------------------------------------------------------

def sass(lib: Path) -> dict[str, str]:
    """{kernel's mangled name: its SASS} of a library."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    # the anonymous namespace's name carries a hash of the unit
    text = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_trip_cu_[0-9a-f]{8}",
                  "_GLOBAL__N_", text)
    out, name = {}, None
    for ln in text.splitlines():
        if ln.strip().startswith("Function : "):
            name = ln.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(ln.rstrip())
    return {k: "\n".join(v) for k, v in out.items()}


def spills(code: str) -> tuple[int, int]:
    """(local loads, local stores) of a kernel's SASS: LDL and STL."""
    return tuple(len(re.findall(rf"\b{op}(\.\w+)*\b", code))
                 for op in ("LDL", "STL"))
