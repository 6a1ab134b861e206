"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside the
package (a directory git ignores), keyed by a hash of the source and the
flags, and loaded with ``ctypes``.  The host route does the same for a
``csrc/<name>.cpp`` with the host's C++ compiler (``$CXX`` or ``g++``):
the HEALPix pixelization (:mod:`nifty_tpu_torch.ops.healpix`) is host
precompute.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIBS: dict = {}
#: name -> (seconds, the compiler's output, for nvcc with ptxas'
#: register/spill report);
#: only for libraries compiled in this process.
BUILD_LOG: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built with the CUDA "
            "toolkit on the machine that holds the card"
        )
    return path


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _load(name: str, suffix: str, compiler, flags) -> ctypes.CDLL:
    """Compile ``csrc/<name><suffix>`` with ``compiler()`` and ``flags`` if
    no library of this source and these flags is built yet, and load it."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC_DIR / f"{name}{suffix}"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [compiler(), *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
        BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with ``nvcc`` if needed and return the
    loaded library."""
    return _load(name, ".cu", _nvcc, NVCC_FLAGS)


def load_host_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cpp`` with the host's C++ compiler if needed
    and return the loaded library."""
    return _load(name, ".cpp", _cxx, CXX_FLAGS)
