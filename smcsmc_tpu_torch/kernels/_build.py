"""Build and load the CUDA trip kernels (``csrc/trip.cu``) and the host
scan of the APF lookahead (``csrc/lookahead.c``).

``nvcc`` compiles the kernels, and ``gcc`` the scan, into shared libraries
with a plain C interface, loaded with ``ctypes``.  Each library is built at
first use into ``build/smcsmc_tpu_torch/`` beside the package and rebuilt
whenever a hash of its source and flags changes; a failed build raises.
``trip.cu`` is compiled as five units side by side (``-DSMC_PART=0``: the
narrow kernels and the C interface; ``-DSMC_PART=1``: the wide kernels;
``-DSMC_PART=2`` and ``3``: the migration pass's kernels without and with
VB; ``-DSMC_PART=4``: the wide guided and local kernels), then linked.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "trip.cu"
LOOKAHEAD_SOURCE = _PKG / "csrc" / "lookahead.c"
BUILD_DIR = _PKG.parent / "build" / "smcsmc_tpu_torch"
GCC_FLAGS = ("-O3", "-shared", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false",  # round each product and sum as the plain version does
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
TRIP_PARTS = 5  # units of trip.cu compiled in parallel (SMC_PART)


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    built: bool  # False when an up-to-date library was already there
    seconds: float
    log: str  # nvcc/ptxas output (registers, spills) when built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the trip kernel")


def _build(compiler: str, flags, source: Path, stem: str,
           force: bool) -> BuildInfo:
    """Compile ``source`` with ``compiler`` and ``flags`` into
    ``BUILD_DIR/<stem>_<hash>.so`` unless that library exists; raise with
    the compiler's output on failure."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    out = BUILD_DIR / f"{stem}_{digest[:16]}.so"
    if out.exists() and not force:
        return BuildInfo(out, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *flags, "-o", str(tmp), str(source)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return BuildInfo(out, True, seconds, proc.stdout + proc.stderr)


def build_trip_library(force: bool = False) -> BuildInfo:
    """Compile ``csrc/trip.cu`` unless a library for the same source and
    flags exists: its :data:`TRIP_PARTS` units by as many nvcc processes
    started together, then one link; raise with the compiler's output on
    failure.  ``seconds`` is the wall time of the whole build."""
    flags = tuple(f for f in NVCC_FLAGS if f != "-shared")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        NVCC_FLAGS).encode() + b"parts%d" % TRIP_PARTS).hexdigest()
    out = BUILD_DIR / f"libsmctrip_{digest[:16]}.so"
    if out.exists() and not force:
        return BuildInfo(out, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.stem}.{os.getpid()}.part{k}.o")
            for k in range(TRIP_PARTS)]
    t0 = time.monotonic()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *flags, f"-DSMC_PART={k}", "-c", "-o",
                          str(obj), str(SOURCE)]
                         for k, obj in enumerate(objs))]
    logs = []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return BuildInfo(out, True, time.monotonic() - t0, "".join(logs))


@functools.cache
def load_trip_library() -> ctypes.CDLL:
    """Build (if needed) and load the library; argument types declared."""
    lib = ctypes.CDLL(str(build_trip_library().path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.smc_trip_launch.argtypes = [
        vp, ci, ci, ci, ci, ci,  # uniforms, trips, P, n, E, leaf_status
        vp, vp, vp, vp,  # time, parent, child0, child1
        vp, vp, vp, vp, vp,  # next_rec, upd, log_w, tl, B
        vp, vp,  # tl_e, pending
        cf, cf, cf,  # L, mu, rho
        vp, vp, vp,  # epoch_start, inv2ne, has_data
        vp,  # stream
    ]
    lib.smc_trip_launch.restype = ci
    lib.smc_segment_pass_launch.argtypes = [
        vp, ci, ci, ci, ci, ci, ci,  # uniforms, trips, P, n, E, F, leaf_status
        vp, vp, vp, vp,  # time, parent, child0, child1
        vp, vp,  # next_rec, log_w
        vp, vp, vp,  # fifo, fifo_mask, tl_out
        cf, cf, cf,  # L, mu, rho
        vp, vp, vp,  # epoch_start, inv2ne, has_data
        # the biased pass (all 0 for the plain one): log_pilot, the ring
        # (df_pos, df_logf, df_delta, df_k), heights, strengths, delays;
        # slots K, sections S, front, delay type, delay k
        vp, vp, vp, vp, vp, vp, vp, vp,
        ci, ci, cf, ci, ci,
        # the migration pass (all 0 otherwise): pop, mig_time, mig_dest,
        # diag, key, ne, mig, tot_mig, pop_map; populations Pp, buffer
        # capacity Mw, walk event bound
        vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ci, ci, ci,
        vp, vp,  # the VB tables vb_coal, vb_mig (0: VB off)
        # the guide (0: off): g_rel, cum_mass, g_leaf, the search's first
        # pivots; windows Wg, size ws
        vp, vp, vp, vp, ci, cf,
        # local recording (0: off): lr_pos, lr_due, lr_time, lr_desc,
        # lr_dropped, lags, ropp; ring slots R
        vp, vp, vp, vp, vp, vp, vp, ci,
        # ARG recording (0: off): arg_pos, arg_code, arg_time, arg_from,
        # arg_to, arg_desc, arg_n; ring slots A
        vp, vp, vp, vp, vp, vp, vp, ci,
        vp,  # stream
    ]
    lib.smc_segment_pass_launch.restype = ci
    # kind, n, E, S, Pp, Mw, vb, guide, local, arg, out
    lib.smc_kernel_resources.argtypes = [ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                         ci, vp]
    lib.smc_kernel_resources.restype = ci
    lib.smc_noop_launch.argtypes = [vp]
    lib.smc_noop_launch.restype = ci
    lib.smc_cuda_error_string.argtypes = [ci]
    lib.smc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_lookahead_library(force: bool = False) -> BuildInfo:
    """Compile ``csrc/lookahead.c`` with gcc unless a library for the same
    source and flags exists; raise with the compiler's output on failure."""
    return _build(shutil.which("gcc") or "gcc", GCC_FLAGS, LOOKAHEAD_SOURCE,
                  "liblookahead", force)


@functools.cache
def load_lookahead_library() -> ctypes.CDLL:
    """Build (if needed) and load the lookahead scan, with the argument
    types of ``lookahead._native_lookahead``."""
    lib = ctypes.CDLL(str(build_lookahead_library().path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.lookahead_scan.restype = None
    lib.lookahead_scan.argtypes = [
        ctypes.c_long, ctypes.c_int, ctypes.c_int,
        f64p, f64p, i8p, u8p,
        f32p, f32p, u8p, i32p, i32p, f32p, f32p, u8p, u8p,
        f32p, i8p, i32p,
    ]
    return lib
