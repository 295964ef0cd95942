"""The torch port never imports jax nor anything of ``smcsmc_tpu``, and its
CLI refuses what it does not support with a message naming the flag."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import smcsmc_tpu_torch
from smcsmc_tpu_torch import cli
from smcsmc_tpu_torch.device import resolve_device

torch.set_num_threads(1)

PKG = Path(smcsmc_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def test_port_runs_without_importing_jax(tmp_path):
    """Import every port module and run the CLI on a tiny .seg on the CPU
    in a fresh interpreter; neither jax nor smcsmc_tpu may be in
    sys.modules afterwards."""
    modules = sorted(
        "smcsmc_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = textwrap.dedent(f"""
        import importlib, sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        for m in {modules!r}:
            importlib.import_module(m)
        from smcsmc_tpu_torch.demography import Demography
        from smcsmc_tpu_torch.segio import write_seg
        from smcsmc_tpu_torch.simulate import simulate_seg
        demo = Demography(change_times=np.array([0.0]),
                          pop_sizes=np.array([[10000.0]]),
                          mig_rates=np.zeros((1, 1, 1)),
                          sample_pops=np.zeros(4, dtype=np.int32),
                          mutation_rate=1e-8, recombination_rate=1e-9,
                          sequence_length=5e4)
        write_seg({str(tmp_path / 't.seg')!r}, simulate_seg(demo, seed=3))
        from smcsmc_tpu_torch.cli import smcsmc_main
        rc = smcsmc_main(["-seg", {str(tmp_path / 't.seg')!r}, "-o",
                          {str(tmp_path / 'out')!r}, "-Np", "16", "-EM", "1",
                          "-N0", "10000", "-mu", "1e-8", "-rho", "1e-9",
                          "-seed", "3", "-device", "cpu"])
        assert rc == 0
        print("JAX_LOADED", "jax" in sys.modules)
        print("JAX_PACKAGE_LOADED", "smcsmc_tpu" in sys.modules)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "JAX_LOADED False" in out.stdout
    assert "JAX_PACKAGE_LOADED False" in out.stdout
    assert (tmp_path / "out" / "result.out").exists()
    assert (tmp_path / "out" / "emiter1" / "chunkfinal.out").exists()


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert not hits, hits


_IMPORTS_JAX_PACKAGE = re.compile(
    r"^\s*(import|from)\s+smcsmc_tpu\b|import_module\(\s*['\"]smcsmc_tpu\b",
    re.M)


def test_port_imports_nothing_of_the_jax_package():
    """No file of the port, and not ``chip_smoke.py``, names ``smcsmc_tpu``
    in an import: the port keeps its own copies of the jax-free modules,
    and the module ``shared.py`` that once re-exported them is gone."""
    hits = [str(p.relative_to(REPO))
            for p in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
            if _IMPORTS_JAX_PACKAGE.search(p.read_text())]
    assert hits == [], hits
    assert not (PKG / "shared.py").exists()
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", smoke, re.M)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_trip_wrapper_rejects_other_devices():
    from smcsmc_tpu_torch.kernels.trip import trip

    meta = torch.empty((2, 7), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trip(torch.empty((1, 2, 4), device="meta"), 1, meta, meta, meta, meta,
             *([torch.empty(2, device="meta")] * 5),
             torch.empty((2, 1), device="meta"),
             torch.empty((2, 6), device="meta"), 1.0, 1e-8, 1e-9,
             torch.empty(1, device="meta"), torch.empty(1, device="meta"),
             torch.empty(4, device="meta"))


@pytest.mark.parametrize("argv,flag", [
    (["-apf", "1"], "-apf"),
    (["-vb"], "-vb"),
    (["-guide", "g.recomb.gz"], "-guide"),
    (["-alpha", "0.5"], "-alpha"),
    (["-arg"], "-arg"),
    (["-online"], "-online"),
    (["-c"], "-c"),
])
def test_cli_refuses_what_is_not_ported(argv, flag):
    with pytest.raises(SystemExit, match=re.escape(repr(flag))):
        cli.parse_args(["-seg", "a.seg", *argv])
