"""Causal prefill attention: the ``flash_attention`` CUDA kernels.

Wrapper of the kernels that port ``repro/kernels/flash_attention.py``,
with the Pallas signature: q [B, H, S, d], k/v [B, Hkv, S, d] with H a
multiple of Hkv, an optional sliding window and logit softcap, any S (the
ragged last tile is masked). The route is chosen by (dtype, d)
(:func:`flash_route`) and each launch is counted as
``flash_attention/<route>``:

- ``"tc"``, bfloat16, on the tensor cores (``csrc/flash_tc.cu``: TMA-fed
  K/V ring, ``wgmma`` products, P split into two bf16 parts). TMA reads q,
  k and v through tensor maps, so each needs d stride 1, its other strides
  multiples of 8 elements (16 bytes) and a 16-byte aligned base; a caller
  holding [B, S, H, d] passes ``x.transpose(1, 2)`` with no copy. An
  operand that misses one of these is copied into a new contiguous tensor
  first, and ``flash_attention.copies`` counts those copies.
- ``"tc32"``, float32 at every head dim, on the tensor cores
  (``csrc/flash_f32_tc.cu``, library ``"flash32"``): a pre-pass
  (``flash_attention/split``, :func:`split_pieces`) writes q, k and v, of
  any strides, as three bf16 pieces each (:func:`.ref.split3`, exact), and
  each product is the sum of six bf16 ``wgmma`` products of the pieces,
  within a float32 rounding of the float32 product (P split in three too).

The SIMT kernels that float32 took before (``csrc/attention_kernels.cu``
and ``csrc/flash_bwd.cu``, float32 on the CUDA cores) are on no route:
``chip_smoke.simt_flash`` and ``simt_bwd`` call their libraries directly
to time them beside the tensor-core routes.

``out`` takes any strides on every route. A tensor on the CPU takes the
plain torch version in :mod:`.ref`; a tensor on the card launches a kernel
or raises — it never falls back. A meta tensor (the dry run) gets meta
outputs, and the kernel's operations (:func:`attention_ops`) go to the
dry run's tally.

Training (:class:`FlashAttention`): the forward runs the same kernels
and also writes each row's log-sum-exp (``lse=``, float32 [B, H, S]);
the backward is ``flash_attention_bwd`` (no Pallas counterpart: the
reference differentiates its XLA attention), which recomputes the
probabilities from q, k and the lse and gives dq, dk and dv in the
inputs' dtype, any strides, float32 sums, no atomics. Its route is chosen
by (dtype, d) (:func:`bwd_route`):

- ``"tc"``, bfloat16 at every head dim, on the tensor cores
  (``csrc/flash_bwd_tc.cu``, library ``"bwd_tc"``: TMA-fed tiles,
  ``wgmma`` products, P and dS split into two bf16 parts; at d = 256 a
  block's two warpgroups share 64 keys or rows and split the gradients'
  columns), with the TMA operand rules above for q, k, v and dout (copies
  counted in ``flash_attention_bwd.copies``);
- ``"tc32"``, float32 at every head dim, on the tensor cores
  (``csrc/flash_bwd_f32_tc.cu``, library ``"bwd32"``): q, k, v and dout
  split in three by the same pre-pass, every product six bf16 products,
  P and dS split in three; at d = 256 a key or row tile is a cluster of
  two blocks, each over half of d, that swap their partial score tiles.

No route falls back to another: a failed build or launch raises. The
tensor-core routes' arithmetic is emulated on the CPU by
``tests/test_torch_flash_split.py``, ``tests/test_torch_flash_bwd_split.py``
and (float32, with :func:`.ref.mha_split_reference`)
``tests/test_torch_flash_f32_split.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import launch, tally

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bfloat16 head dims whose backward runs on the tensor cores: all
TC_BWD_HEAD_DIMS = HEAD_DIMS
# the float32 head dims that run on the tensor cores (route "tc32"): all;
# and the forward's key tile at each (flash_f32_tc.cu's Plan<D>::BK)
TC32_HEAD_DIMS = HEAD_DIMS
TC32_KEY_TILE = {16: 128, 32: 128, 64: 64, 128: 32, 256: 32}
ROW_PAD = 128   # the tensor-core backward's lse/Delta rows: S rounded up
BWD_OPS = 5     # the backward's operations, in halves of the forward's:
                # five products of a pair (s, dP, dV, dQ, dK) to its two


def check_attention(name: str, t: torch.Tensor, ndim: int,
                    like: torch.Tensor | None = None) -> None:
    """Validate one float input before its pointer is handed over."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda", "meta"):
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


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs a causal pass over S positions visits: row i
    sees min(i + 1, window) keys (all i + 1 without a window)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_ops(B: int, H: int, S: int, d: int, window: int = 0) -> int:
    """Operations of the causal forward, the count its bound uses: two
    products of d multiply-adds each a visited pair, 4 d a pair."""
    return 4 * d * B * H * causal_pairs(S, window)


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
    if q.device.type == "meta":
        tally("flash_attention", attention_ops(B, H, S, d, window))
        return out
    if not out.numel():
        return out
    lse_ptr = None if lse is None else lse.data_ptr()
    route = flash_route(q.dtype, d)
    if route == "tc":
        q, k, v = (tma_operand(t, flash_attention) for t in (q, k, v))
        launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), lse_ptr, strides(q, k, v, out),
               B, H, Hkv, S, d, window, softcap, d ** -0.5, lib="flash",
               route=route)
    else:
        q3, k3, v3 = split_pieces(q, k, v)
        launch("flash_attention", q.device, q3.data_ptr(), k3.data_ptr(),
               v3.data_ptr(), out.data_ptr(), lse_ptr, strides(out), B, H,
               Hkv, S, d, window, softcap, d ** -0.5, lib="flash32",
               route=route)
    return out


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The route of :func:`flash_attention` on the card, by dtype (every
    head dim of ``HEAD_DIMS`` alike): ``"tc"`` (``csrc/flash_tc.cu``) for
    bfloat16, ``"tc32"`` (``csrc/flash_f32_tc.cu``, three-piece splits on
    the tensor cores) for float32."""
    return "tc" if dtype == torch.bfloat16 else "tc32"


def split_pieces(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """Each float32 [B, heads, S, d] tensor (any strides; one B, S and d)
    as its three bf16 pieces (:func:`.ref.split3`): [3, B, heads, S, d],
    contiguous, all in one new buffer written by one launch of the split
    kernel (``csrc/flash_f32_tc.cu``), counted as
    ``flash_attention/split``; on the CPU the plain :func:`.ref.split3`.
    The float32 tensor-core routes read the pieces through TMA tensor maps
    as [3 B, heads, S, d]."""
    B, _, S, d = tensors[0].shape
    sizes = [t.numel() for t in tensors]
    buf = torch.empty(3 * sum(sizes), dtype=torch.bfloat16,
                      device=tensors[0].device)
    outs, at = [], 0
    for t, n in zip(tensors, sizes):
        outs.append(buf[at:at + 3 * n].view(3, *t.shape))
        at += 3 * n
    if buf.device.type == "cpu":
        for t, pieces in zip(tensors, outs):
            for piece, want in zip(pieces, ref.split3(t)):
                piece.copy_(want)
    elif buf.device.type == "cuda" and buf.numel():
        desc = [x for t in tensors
                for x in (t.data_ptr(), *t.stride(), t.shape[1])]
        launch("split", buf.device, (ctypes.c_int64 * len(desc))(*desc),
               len(tensors), buf.data_ptr(), B, S, d, lib="flash32",
               counted="flash_attention/split")
    return outs


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
    card launches ``flash_attention_bwd`` on the route :func:`bwd_route`
    names (counted as ``flash_attention_bwd/tc`` or ``/tc32``) or raises. The bf16 tensor-core route reads q, k, v and dout through
    TMA tensor maps, so an operand without d stride 1, 16-byte strides and
    base is copied first (counted in ``flash_attention_bwd.copies``); the
    float32 one reads their split pieces (:func:`split_pieces`); o and the
    gradients take any strides."""
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
    route = bwd_route(q.dtype, d)
    if route == "tc":
        q, k, v, dout = (tma_operand(t, flash_attention_bwd)
                         for t in (q, k, v, dout))
    Sp = -(-S // ROW_PAD) * ROW_PAD
    rows = torch.empty((2, B, H, Sp), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return _bwd_tallied(dq, dk, dv, window)
    if route == "tc32":
        q3, k3, v3, do3 = split_pieces(q, k, v, dout)
        launch("flash_attention_bwd", q.device, q3.data_ptr(),
               k3.data_ptr(), v3.data_ptr(), do3.data_ptr(), o.data_ptr(),
               dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               strides(o, dout, dq, dk, dv), B, H, Hkv, S, Sp, d, window,
               softcap, d ** -0.5, lib="bwd32", route=route)
    else:
        launch("flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
               rows.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               strides(q, k, v, o, dout, dq, dk, dv), B, H, Hkv, S, Sp, d,
               window, softcap, d ** -0.5, lib="bwd_tc", route=route)
    return dq, dk, dv


def _bwd_tallied(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                 window: int) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """A meta call's end, after the route's workspace: its operations to
    the dry run's tally, the gradients returned."""
    B, H, S, d = dq.shape
    tally("flash_attention_bwd", BWD_OPS * attention_ops(B, H, S, d,
                                                         window) // 2)
    return dq, dk, dv


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The route of :func:`flash_attention_bwd` on the card, by dtype
    (every head dim of ``HEAD_DIMS`` alike): ``"tc"``
    (``csrc/flash_bwd_tc.cu``, the tensor cores) for bfloat16, ``"tc32"``
    (``csrc/flash_bwd_f32_tc.cu``, three-piece splits on the tensor cores)
    for float32."""
    return "tc" if dtype == torch.bfloat16 else "tc32"


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
flash_attention_bwd.copies = 0
