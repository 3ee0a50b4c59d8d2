"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

The kernels have a plain C interface (``csrc/fused_recon.cu``), so they
compile in seconds without PyTorch's headers.  The library goes to
``build/fdoct_tpu_torch/`` beside the package, under a file name that carries
a hash of the source and flags, so an edited source rebuilds.  Nothing is
built at import: :func:`load` builds at first use and raises if ``nvcc`` is
missing or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_ROOT / "csrc" / "fused_recon.cu"
BUILD_DIR = PACKAGE_ROOT.parent / "build" / "fdoct_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
#: C signature of each entry point (all return cudaError_t as int)
SIGNATURES = {
    "fdoct_recon_raw_u8_f32": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    "fdoct_recon_raw_u8_bf16": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    "fdoct_recon_yr_f32_f32": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    "fdoct_recon_yr_f32_bf16": [_PTR] * 4 + [_INT] * 4 + [_PTR],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, PATH, or /usr/local/cuda; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the fdoct_tpu_torch CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfdoct_fused_recon-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns the library.

    nvcc's output (with ``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside it as ``<library>.log``.  The library is
    written under a temporary name and renamed, so a concurrent loader never
    sees a partial file.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
