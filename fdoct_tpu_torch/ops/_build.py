"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every source under ``csrc/`` (``fused_recon.cu``, ``int8_bscan.cu``) has a
plain C interface, so each compiles in seconds without PyTorch's headers;
both include ``hopper_mma.cuh``, the inline-PTX wrappers (``cp.async``,
``ldmatrix``, ``mma.sync``, ``wgmma``, ``mbarrier``, TMA tensor loads) and
the block schedule their tensor-core kernels share, which need the
``sm_90a`` target and no extra flag or library.  The resident kernel's TMA
tensor maps are encoded on the host with
``cuTensorMapEncodeTiled``, which ``fused_recon.cu`` obtains at run time
through the runtime's ``cudaGetDriverEntryPoint`` (``...ByVersion`` from
CUDA 12.5): the library links no ``-lcuda``.  One ``nvcc -c`` per source
runs in parallel; the objects are linked into one library in
``build/fdoct_tpu_torch/`` beside the package, under a file name that
carries a hash of every source, header and flag, so an edited file
rebuilds.  Nothing is built at import: :func:`load` builds at first use and
raises if ``nvcc`` is missing or a build fails.
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
SOURCES = tuple(sorted((PACKAGE_ROOT / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((PACKAGE_ROOT / "csrc").glob("*.cuh")))
BUILD_DIR = PACKAGE_ROOT.parent / "build" / "fdoct_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
#: C signature of each entry point (all return cudaError_t as int)
SIGNATURES = {
    "fdoct_recon_raw_u8_f32": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    "fdoct_recon_raw_u8_bf16": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    "fdoct_recon_yr_f32_f32": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    "fdoct_recon_yr_f32_bf16": [_PTR] * 4 + [_INT] * 4 + [_PTR],
    "fdoct_recon_resident_u8_bf16": [_PTR] * 6 + [_INT] * 4 + [_PTR],
    "fdoct_int8_bscan": [_PTR] * 7 + [_FLOAT] * 4 + [_PTR] * 4 + [_INT] * 5 + [_PTR],
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
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libfdoct_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless their library exists; returns the library.

    nvcc's output (with ``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside it as ``<library>.log``.  Objects and the
    library are written under temporary names and the library is renamed,
    so a concurrent loader never sees a partial file.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = [f"{' '.join(cmd)}\n{out}" for cmd, out in zip(cmds, outs)]
    failed = [(cmd[-1], p.returncode, out) for cmd, p, out in zip(cmds, procs, outs)
              if p.returncode != 0]
    tmp = lib.with_name(f"{tag}.tmp")
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(("link", proc.returncode, proc.stdout + proc.stderr))
    lib.with_suffix(".log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        what, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed on {what} ({rc}):\n{out[-4000:]}")
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
