"""Build, load and launch the CUDA kernels of ``csrc/rdf_kernels.cu``.

The source is compiled on first use by ``nvcc`` into a shared library with
a plain C interface under ``<repo>/build/`` and loaded with ``ctypes``.
The file name carries a hash of the source and flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing here runs when the
module is imported: the CPU tests import every module of the package.

Each launch goes through :func:`launch`, which raises on a non-zero CUDA
status and adds one to that kernel's launch count — the count a run reads
to show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "rdf_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    # name: argtypes (pointers, sizes, pattern ints, ..., stream)
    "rdf_triple_scan": [_P, _L, _I, _I, _I, _P, _P],
    "rdf_triple_scan_many": [_P, _L, _P, _I, _P, _P],
    "rdf_probe_sorted_many": [_P, _I, _P, _L, _P, _P, _P],
    "rdf_scan_probe": [_P, _L, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_log = ""
_launches: Counter = Counter()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librdf_kernels_{digest[:16]}.so"


def build() -> Path:
    """Compile the source unless a library of this exact source exists.

    Writes to a temporary name and renames, so a concurrent or interrupted
    build never leaves a half-written library under the final name.
    """
    global _build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    _build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{_build_log}")
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """nvcc's output from the last build in this process (``-Xptxas=-v``
    register and shared-memory report), empty when the library was found."""
    return _build_log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rdf_error_string.argtypes = [ctypes.c_int]
            lib.rdf_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(kernel: str, device: torch.device, *args) -> None:
    """Launch ``rdf_<kernel>`` on ``device``'s current stream; raise on a
    non-zero CUDA status, else count the launch."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"rdf_{kernel}")(*args, stream)
    if rc != 0:
        msg = lib.rdf_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")
    with _lock:
        _launches[kernel] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        _launches.clear()


def check_int32(name: str, t: torch.Tensor, ndim: int,
                device: torch.device | None = None) -> None:
    """Validate one kernel argument before its pointer is handed over."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
