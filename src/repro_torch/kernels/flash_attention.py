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

Training (:class:`FlashAttention`): the forward runs the same kernels
and also writes each row's log-sum-exp (``lse=``, float32 [B, H, S]);
the backward is ``flash_attention_bwd`` (``csrc/flash_bwd.cu``, no Pallas
counterpart: the reference differentiates its XLA attention), which
recomputes the probabilities from q, k and the lse and gives dq, dk and
dv in the inputs' dtype, any strides, float32 sums, no atomics.
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
                    out: torch.Tensor | None = None,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, H, S, d]; k/v [B, Hkv, S, d] -> [B, H, S, d] in q's dtype.

    ``window > 0`` keeps keys ``k > q - window`` on top of causal;
    ``softcap > 0`` caps the scaled scores at ``tanh(s / c) * c``. ``out``
    (any strides, q's shape and dtype) receives the result in place;
    ``lse`` (float32 [B, H, S], contiguous), when given, each row's
    log-sum-exp of its scaled, capped scores in natural log."""
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
    if lse is not None:
        check_lse(lse, q)
    window, softcap = max(int(window), 0), float(softcap)
    if q.device.type == "cpu":
        if lse is not None:
            lse.copy_(ref.mha_lse_reference(q, k, window, softcap))
        return out.copy_(ref.mha_reference(q, k, v, True, window, softcap))
    if not out.numel():
        return out
    lse_ptr = None if lse is None else lse.data_ptr()
    if q.dtype == torch.bfloat16:
        q, k, v = (tma_operand(t, flash_attention) for t in (q, k, v))
        launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), lse_ptr, strides(q, k, v, out),
               B, H, Hkv, S, d, window, softcap, d ** -0.5, lib="flash")
    else:
        launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), lse_ptr, strides(q, k, v, out),
               DTYPES[q.dtype], B, H, Hkv, S, d, window, softcap,
               d ** -0.5)
    return out


def check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    """The row log-sum-exp buffer of q [B, H, S, d]: float32 [B, H, S],
    contiguous, on q's device."""
    if (not isinstance(lse, torch.Tensor) or lse.dtype != torch.float32
            or lse.shape != q.shape[:3] or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 tensor of shape "
                         f"{tuple(q.shape[:3])} on {q.device}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, window: int = 0,
                        softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of causal :func:`flash_attention` for the output
    gradient ``dout``: q, o, dout [B, H, S, d] and k, v [B, Hkv, S, d] of
    one dtype (any strides), ``o`` and ``lse`` the forward's. Each gradient
    has its input's shape, dtype and strides. The CPU takes the plain
    version (autograd through ``mha_reference``; o and lse unused); the
    card launches ``flash_attention_bwd`` or raises."""
    check_attention("q", q, 4)
    for name, t in (("k", k), ("v", v), ("o", o), ("dout", dout)):
        check_attention(name, t, 4, like=q)
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if (k.shape != (B, Hkv, S, d) or v.shape != k.shape or H % Hkv
            or o.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"q/o/dout {tuple(q.shape)}/{tuple(o.shape)}/"
                         f"{tuple(dout.shape)} and k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} must be [B,H,S,d] and "
                         f"[B,Hkv,S,d] with H a multiple of Hkv")
    check_lse(lse, q)
    window, softcap = max(int(window), 0), float(softcap)
    if q.device.type == "cpu":
        return ref.flash_attention_backward_reference(q, k, v, dout, window,
                                                      softcap)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not dq.numel():
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    launch("flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           strides(q, k, v, o, dout, dq, dk, dv), DTYPES[q.dtype], B, H,
           Hkv, S, d, window, softcap, d ** -0.5)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal attention with a gradient: the forward kernel (writing each
    row's lse into a buffer of its own, the output into a new tensor), the
    backward kernel for dq, dk and dv. Saves q, k, v, o and lse (the
    model's layer checkpoints free them). ``FlashAttention.apply(q, k, v,
    window, softcap)`` returns a new [B, H, S, d] output in q's dtype and
    layout. On the CPU both directions take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, window: int = 0, softcap: float = 0.0):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        o = flash_attention(q, k, v, True, window, softcap, lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.softcap = window, softcap
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, dout, lse, ctx.window,
                                         ctx.softcap)
        return dq, dk, dv, None, None



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
