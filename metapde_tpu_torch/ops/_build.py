"""Build the port's CUDA kernels with plain nvcc and load them with ctypes.

Each source under ``metapde_tpu_torch/csrc/`` has a plain C interface (no
PyTorch headers), so one nvcc call builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>_<hash>.so \
         metapde_tpu_torch/csrc/<name>.cu

The library lands in ``build/torch_kernels/`` at the repository root, named
by a hash of the source and the flags, so a rebuild happens only when either
changes. nvcc writes to a temporary name that is then renamed into place:
there is no lock file for a killed run to leave behind. The build happens at
first use, never at import.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 120


class BuildResult(NamedTuple):
    path: Path
    cached: bool     # True when the library for this source already existed
    seconds: float   # nvcc wall time (0 when cached)
    log: str         # nvcc's stderr: -Xptxas -v register/shared-memory report


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> BuildResult:
    """Compile csrc/<name>.cu into its hashed shared library if missing."""
    out = library_path(name)
    if out.exists():
        return BuildResult(out, True, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return BuildResult(out, False, time.perf_counter() - t0, proc.stderr)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per process."""
    return ctypes.CDLL(str(build(name).path))
