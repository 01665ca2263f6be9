"""Build, load and launch the CUDA kernels of ``csrc/*.cu``.

Each source is compiled on first use by ``nvcc`` into its own shared
library with a plain C interface under ``<repo>/build/`` and loaded with
``ctypes``: ``rdf_kernels.cu`` (the SPARQL query kernels),
``attention_kernels.cu`` (the float32 LM attention kernels: decode, and
the SIMT prefill kernel that no route takes any more, timed by
``chip_smoke.simt_flash``), ``flash_tc.cu`` (bfloat16 prefill attention on the tensor
cores), ``decode_tc.cu`` (bfloat16 decode attention: a TMA ring, scores on
the tensor cores), ``flash_bwd.cu`` (the SIMT attention backward,
float32 on the CUDA cores, on no route: timed by ``chip_smoke.simt_bwd``),
``flash_bwd_tc.cu`` (library ``"bwd_tc"``: the bfloat16 attention
backward at d = 16 to 256 on the tensor cores), ``flash_f32_tc.cu`` and
``flash_bwd_f32_tc.cu`` (libraries ``"flash32"`` and ``"bwd32"``: float32
prefill attention and its backward at every head dim on the tensor cores,
as bf16 products of three-piece splits, and the split pre-pass),
``sparse_kernels.cu``
(the recsys and GNN kernels, and the bag's backward) and
``qad_kernels.cu`` (the R-QAD solve behind B&B) and ``norm_kernels.cu``
(RMSNorm, and qk-norm with RoPE, on the LM's no-grad path).
A file name carries a hash of its source and flags, so an edited source
is rebuilt and a stale library is never loaded. Nothing here runs when
the module is imported: the CPU tests import every module of the
package.

Each launch goes through :func:`launch`, which raises on a non-zero CUDA
status and adds one to that kernel's launch count — the count a run reads
to show that its main path went through the kernels. On the ``meta``
device (the dry run) a wrapper launches nothing: it returns meta tensors
of its outputs and workspaces and reports the kernel's operation count to
:func:`tally`, which the dry run reads with :func:`meta_ops`.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# library: (source, {kernel: argtypes without the trailing stream})
LIBRARIES = {
    "rdf": ("rdf_kernels.cu", {
        # pointers, sizes, pattern ints, ...
        "triple_scan": [_P, _L, _I, _I, _I, _P],
        "triple_scan_many": [_P, _L, _P, _I, _P],
        # keys, K, probes, n, stride, n_samples, vec, blocks, sample, lo,
        # hi
        "probe_sorted_many": [_P, _I, _P, _L, _I, _I, _I, _I, _P, _P, _P],
        # triples, T, s, p, o, keys, K, col, stride, n_samples, vec,
        # blocks, sample, mask, lo, hi
        "scan_probe": [_P, _L, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                       _P, _P, _P],
    }),
    "attn": ("attention_kernels.cu", {
        # q, k, v, o, lse, strides, dtype, B, H, Hkv, S, D, window,
        # softcap, scale
        "flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _F, _F],
        # q, k, v, lengths, o, part_o, part_ml, lse, strides, dtype, B, H,
        # Hkv, S, D, chunk, window, softcap, scale
        "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F],
    }),
    "flash": ("flash_tc.cu", {
        # q, k, v, o, lse, strides, B, H, Hkv, S, D, window, softcap,
        # scale
        "flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _F],
    }),
    "flash32": ("flash_f32_tc.cu", {
        # q3, k3, v3 (the split pieces), o, lse, o strides, B, H, Hkv, S,
        # D, window, softcap, scale
        "flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _F],
        # desc (pointer, four strides and heads of each source), n, dst,
        # B, S, D
        "split": [_P, _I, _P, _I, _I, _I],
    }),
    "bwd32": ("flash_bwd_f32_tc.cu", {
        # q3, k3, v3, do3 (the split pieces), o, dout, lse, rows, dq, dk,
        # dv, strides (o, dout, dq, dk, dv), B, H, Hkv, S, Sp, D, window,
        # softcap, scale
        "flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _I, _I, _I, _I, _I, _F, _F],
    }),
    "bwd": ("flash_bwd.cu", {
        # q, k, v, o, dout, lse, delta, dq, dk, dv, strides, dtype, B, H,
        # Hkv, S, D, window, softcap, scale
        "flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _F, _F],
    }),
    "bwd_tc": ("flash_bwd_tc.cu", {
        # q, k, v, o, dout, lse, rows, dq, dk, dv, strides, B, H, Hkv, S,
        # Sp, D, window, softcap, scale
        "flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _F, _F],
    }),
    "decode": ("decode_tc.cu", {
        # q, k, v, lengths, o, part, tickets, lse, o_f32, strides, B, H,
        # Hkv, S, D, chunk, window, softcap, scale
        "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F],
    }),
    "sparse": ("sparse_kernels.cu", {
        # table, ids, mask, out, dtype, n_bags, nnz, D, mean, then the
        # plan: vec, lanes, chunk, blocks, ring
        "embedding_bag": [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I,
                          _I, _I],
        # msg, dst, out, scratch, dtype, E, D, n_nodes, then the plan:
        # per, chunk, sub, n_sub, cols, stages, ring, blocks
        "segment_sum_sorted": [_P, _P, _P, _P, _I, _L, _I, _I, _L, _I, _I,
                               _I, _I, _I, _I, _I],
        # g, ids, mask, grad, scratch, dtype, n_bags, nnz, D, n_rows, mean
        "embedding_bag_bwd": [_P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _I],
    }),
    "qad": ("qad_kernels.cu", {
        # A, b, F, e, fixed_mask, fixed_Ds, out, B, N, K, iters, then the
        # plan: route, kmax, threads, smem bytes
        "qad_solve": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I],
    }),
    "norm": ("norm_kernels.cu", {
        # q, k, q_scale, k_scale, cos, sin, q_out, k_out, tokens, S, Hq,
        # Hk, d, dtype, scale dtype, cos strides (batch, position,
        # column), sin strides, qk_norm, eps
        "norm_rope": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                      _I, _I, _L, _L, _L, _L, _L, _L, _I, _F],
        # x, scale, out, rows, d, dtype, scale dtype, warps a row, eps,
        # offset
        "rms_norm_rows": [_P, _P, _P, _L, _I, _I, _I, _I, _F, _F],
    }),
}
# a kernel's default library: the first that has it (the attention kernels
# have a float32 route in "attn" and a bf16 one in "flash" or "decode"; the
# wrapper names the library)
_LIBRARY_OF: dict[str, str] = {}
for _lib, (_src, _sigs) in LIBRARIES.items():
    for _kernel in _sigs:
        _LIBRARY_OF.setdefault(_kernel, _lib)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_logs: dict[str, str] = {}
_launches: Counter = Counter()
_meta_ops: Counter = Counter()


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


def library_path(lib: str) -> Path:
    source = CSRC / LIBRARIES[lib][0]
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def build(*libs: str) -> dict[str, Path]:
    """Compile each named library (all by default) unless a library of
    that exact source exists; the ``nvcc`` runs start together.

    Each writes to a temporary name and renames, so a concurrent or
    interrupted build never leaves a half-written library under the final
    name. Raises if any build fails.
    """
    paths = {lib: library_path(lib) for lib in (libs or LIBRARIES)}
    todo = {lib: out for lib, out in paths.items() if not out.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for lib, out in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / LIBRARIES[lib][0])]
        procs[lib] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for lib, (cmd, tmp, proc) in procs.items():
        _build_logs[lib] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed with code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{_build_logs[lib]}")
        else:
            os.replace(tmp, todo[lib])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(*libs: str) -> str:
    """nvcc's output from the builds in this process (``-Xptxas=-v``
    register, spill and shared-memory report) of the named libraries (all
    by default), empty when the libraries were found."""
    return "\n".join(log for lib, log in _build_logs.items()
                     if not libs or lib in libs)


def library(lib: str) -> ctypes.CDLL:
    """The loaded library ``lib`` (a key of ``LIBRARIES``), built first if
    needed."""
    with _lock:
        if lib not in _libs:
            handle = ctypes.CDLL(str(build(lib)[lib]))
            for kernel, argtypes in LIBRARIES[lib][1].items():
                fn = getattr(handle, f"{lib}_{kernel}")
                fn.argtypes = [*argtypes, _P]
                fn.restype = ctypes.c_int
            err = getattr(handle, f"{lib}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[lib] = handle
        return _libs[lib]


def launch(kernel: str, device: torch.device, *args,
           lib: str | None = None, route: str | None = None,
           counted: str | None = None) -> None:
    """Launch ``kernel`` (of library ``lib``, by default the first that has
    it) on ``device``'s current stream; raise on a non-zero CUDA status,
    else count the launch under the kernel's name and, for a kernel with
    routes, under ``kernel/route`` too; or under ``counted`` alone, for a
    pre-pass counted beside the kernel it feeds."""
    lib = lib or _LIBRARY_OF[kernel]
    handle = library(lib)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(handle, f"{lib}_{kernel}")(*args, stream)
    if rc != 0:
        msg = getattr(handle, f"{lib}_error_string")(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")
    with _lock:
        if counted:
            _launches[counted] += 1
            return
        _launches[kernel] += 1
        if route:
            _launches[f"{kernel}/{route}"] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        _launches.clear()


def tally(kernel: str, ops: int) -> None:
    """A meta call of ``kernel`` (no launch): add the operations the
    kernel would do, the count its bound uses, to the dry run's tally."""
    with _lock:
        _meta_ops[kernel] += int(ops)


def meta_ops() -> dict[str, int]:
    """Operations of the kernels' meta calls since the last
    :func:`reset_meta_ops`, by kernel."""
    with _lock:
        return dict(_meta_ops)


def reset_meta_ops() -> None:
    with _lock:
        _meta_ops.clear()


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
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
