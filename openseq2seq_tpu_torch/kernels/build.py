"""Build the hand-written CUDA kernels and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point,
which may include the shared headers ``csrc/*.cuh``.
At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/openseq2seq_tpu_torch/`` at the root of the
checkout, or under ``$OPENSEQ2SEQ_TPU_TORCH_BUILD_DIR`` where that is set
(an installed package should set it: its default would lie beside the
installed package); the library's file name carries a hash of the source,
the headers and the flags, so an edited source is rebuilt and an unchanged one is
reused. A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = Path(os.environ.get(
    "OPENSEQ2SEQ_TPU_TORCH_BUILD_DIR",
    PACKAGE_DIR.parent / "build" / "openseq2seq_tpu_torch"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in {} and on PATH)".format(candidate))
    return found


def library_path(name: str) -> Path:
    source = (CSRC_DIR / (name + ".cu")).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / "lib{}-{}.so".format(name, digest.hexdigest()[:16])


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash is
    already built. The compiler's output (with ``-Xptxas -v``: registers,
    shared memory and spills per kernel) goes to ``<library>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".so.tmp{}".format(os.getpid()))
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / (name + ".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError("nvcc failed for {} (exit {}):\n{}".format(
            name, proc.returncode, proc.stdout + proc.stderr))
    os.replace(tmp, out)     # atomic: a concurrent build never sees half
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if
    needed; loaded once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
