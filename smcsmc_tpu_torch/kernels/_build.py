"""Build and load the CUDA trip kernels (``csrc/trip.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface, loaded with ``ctypes``.  The library is built at first use into
``build/smcsmc_tpu_torch/`` beside the package and rebuilt whenever a hash
of the source and the flags changes.
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

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "trip.cu"
BUILD_DIR = _PKG.parent / "build" / "smcsmc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false",  # round each product and sum as the plain version does
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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


def build_trip_library(force: bool = False) -> BuildInfo:
    """Compile ``csrc/trip.cu`` unless a library for the same source and
    flags exists; raise with the compiler's output on failure."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libsmctrip_{digest[:16]}.so"
    if out.exists() and not force:
        return BuildInfo(out, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return BuildInfo(out, True, seconds, proc.stdout + proc.stderr)


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
        vp,  # stream
    ]
    lib.smc_segment_pass_launch.restype = ci
    lib.smc_noop_launch.argtypes = [vp]
    lib.smc_noop_launch.restype = ci
    lib.smc_cuda_error_string.argtypes = [ci]
    lib.smc_cuda_error_string.restype = ctypes.c_char_p
    return lib
