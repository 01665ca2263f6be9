"""Causal prefill attention: the ``flash_attention`` CUDA kernels.

Wrapper of two kernels (ports of ``repro/kernels/flash_attention.py``)
with the Pallas signature: q [B, H, S, d], k/v [B, Hkv, S, d] with H a
multiple of Hkv, an optional sliding window and logit softcap, any S (the
ragged last tile is masked).

- bfloat16 runs on the tensor cores (``csrc/flash_tc.cu``: TMA-fed K/V
  ring, ``wgmma`` products, P split into two bf16 parts). TMA reads q, k
  and v through tensor maps, so each needs d stride 1, its other strides
  multiples of 8 elements (16 bytes) and a 16-byte aligned base; a caller
  holding [B, S, H, d] passes ``x.transpose(1, 2)`` with no copy. An
  operand that misses one of these is copied into a new contiguous tensor
  first, and ``flash_attention.copies`` counts those copies.
- float32 runs on the CUDA cores (``csrc/attention_kernels.cu``), in full
  float32, with any element strides.

``out`` takes any strides on both routes. A tensor on the CPU takes the
plain torch version in :mod:`.ref`; a tensor on the card launches a kernel
or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import launch

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_attention(name: str, t: torch.Tensor, ndim: int,
                    like: torch.Tensor | None = None) -> None:
    """Validate one float input before its pointer is handed over."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if like is not None:
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{like.device}")
        if t.dtype != like.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {like.dtype}")
    if t.device.type == "cuda":
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: the kernels take float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"{name}: head dim {t.shape[-1]} not compiled "
                             f"(one of {HEAD_DIMS})")


def strides(*tensors: torch.Tensor) -> ctypes.Array:
    """The tensors' element strides, concatenated, as a host int64 array."""
    vals = [s for t in tensors for s in t.stride()]
    return (ctypes.c_int64 * len(vals))(*vals)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, H, S, d]; k/v [B, Hkv, S, d] -> [B, H, S, d] in q's dtype.

    ``window > 0`` keeps keys ``k > q - window`` on top of causal;
    ``softcap > 0`` caps the scaled scores at ``tanh(s / c) * c``. ``out``
    (any strides, q's shape and dtype) receives the result in place."""
    if not causal:
        raise NotImplementedError("decoder-only framework: causal attention")
    check_attention("q", q, 4)
    check_attention("k", k, 4, like=q)
    check_attention("v", v, 4, like=q)
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} must be [B,H,S,d] and "
                         f"[B,Hkv,S,d] with H a multiple of Hkv")
    if out is None:
        out = torch.empty_like(q)
    else:
        check_attention("out", out, 4, like=q)
        if out.shape != q.shape:
            raise ValueError(f"out {tuple(out.shape)} must be "
                             f"{tuple(q.shape)}")
    window, softcap = max(int(window), 0), float(softcap)
    if q.device.type == "cpu":
        return out.copy_(ref.mha_reference(q, k, v, True, window, softcap))
    if not out.numel():
        return out
    if q.dtype == torch.bfloat16:
        q, k, v = (tma_operand(t, flash_attention) for t in (q, k, v))
        launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), strides(q, k, v, out), B, H,
               Hkv, S, d, window, softcap, d ** -0.5, lib="flash")
    else:
        launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), strides(q, k, v, out),
               DTYPES[q.dtype], B, H, Hkv, S, d, window, softcap,
               d ** -0.5)
    return out


def tma_operand(t: torch.Tensor, counted) -> torch.Tensor:
    """``t`` itself when a TMA tensor map can describe it (d stride 1,
    every other stride of a dimension longer than 1 a positive multiple of
    8 elements, a 16-byte aligned base), else a contiguous copy in a new
    (aligned) allocation, counted in ``counted.copies`` (the wrapper)."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st % 8 == 0
                    for n, st in zip(t.shape[:-1], t.stride()[:-1])
                    if n > 1)):
        return t
    counted.copies += 1
    return t.clone(memory_format=torch.contiguous_format)


flash_attention.copies = 0
