"""Build the package's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher (raw
pointers, sizes, the stream; returns ``cudaGetLastError()``), so a build is
one ``nvcc`` call with no PyTorch headers. Libraries land
in ``fedml_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded.
"""

from __future__ import annotations

import dataclasses
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class CudaLibrary:
    name: str
    path: str
    lib: ctypes.CDLL
    #: nvcc's output when this process built the library ("-Xptxas -v"
    #: register/shared-memory/spill lines); empty when it was already built
    build_log: str


def find_nvcc() -> str:
    """``$NVCC``, then ``nvcc`` on PATH, then ``$CUDA_HOME/bin/nvcc``
    (default ``/usr/local/cuda``)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found ($NVCC, PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "fedml_tpu_torch are built from csrc/ at first use and need the "
        "CUDA toolkit")


def build(name: str) -> tuple:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns
    ``(path, nvcc output or "")``."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return str(out), ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name, then an atomic rename: two processes that
    # build at once never load a half-written library
    tmp = BUILD_DIR / f".lib{name}_{digest}.{os.getpid()}.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return str(out), log


@functools.cache
def load_library(name: str) -> CudaLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    path, log = build(name)
    return CudaLibrary(name, path, ctypes.CDLL(path), log)
