"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc/``.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, bound with ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries go to ``build/kernels/`` at
the repository root (git-ignored), named by a hash of source and flags, so
an edited source rebuilds and an unchanged one is reused. Nothing is built
when a module is imported: the first launch builds what it needs, and
:func:`build_all` builds every source at once, one ``nvcc`` process per
source, all started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gqsa_gemv", "kv_decode_attention", "paged_attention",
           "w4_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # registers, shared memory and spills of every kernel
              "-Xptxas", "-v")


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the "
                           "CUDA kernels are built on the machine with the "
                           "card")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library that is not built yet, in parallel. Returns
    ``{name: nvcc output}`` (the ``-Xptxas -v`` report) for every source
    in ``names``: nvcc's output is kept beside each library, so a library
    built earlier still has its report. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(names)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():   # wait for every process
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    for name in names:
        if name not in logs:
            report = library_path(name).with_suffix(".log")
            logs[name] = report.read_text() if report.exists() else ""
    return logs


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index`` (the launchers size
    their grids from it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
