"""RMSNorm, and RMSNorm with rotary embeddings: the ``norm_rope`` and
``rms_norm_rows`` CUDA kernels, and their plain torch versions.

Wrappers of the kernels in ``csrc/norm_kernels.cu``. They replace no
``pl.pallas_call``: the reference leaves its norms and RoPE to XLA, which
fuses each into one pass. As eager torch (:func:`rms_norm_reference`,
:func:`apply_rope_reference`) they are some nine float32 passes a norm and
seven a rotation, so on the card the model step's no-grad path takes one
launch for the qk-norm and RoPE of a layer's q and k (:func:`norm_rope`)
and one for each other RMSNorm (:func:`rms_norm_rows`), with the plain
versions' rounding points (the source's note).

The model decides from what the operands show (:func:`takes_norm_rope`,
:func:`takes_rows`): a CUDA tensor, no operand that needs a gradient (the
kernels have no backward), a dtype, width and layout the kernel takes.
Everything else (the CPU, the meta device of the dry run, the training
route under autograd) keeps the plain versions. A wrapper refuses what
its kernel does not take (``ValueError``, with the reason those functions
give) on any device; off the card it then runs the plain version, on the
card it launches the kernel, and it never falls back. Each launch counts
under the kernel's name.
"""

from __future__ import annotations

import torch

from ._build import launch
from .flash_attention import DTYPES

NORM_ROPE_HEAD_DIMS = (64, 128, 256)   # norm_rope_kernel<T, S, D>
ROW_CHUNKS = 4                          # csrc's kRowChunks: 8-element
                                        # chunks a lane holds of a row
ROW_WARPS = (1, 2, 4, 8)                # warps a row, of a 256-thread block
ROW_WIDTH_MAX = 8 * 32 * ROW_CHUNKS * ROW_WARPS[-1]   # 8,192
ALIGN = 16                              # bytes of a lane's vector access


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-6, offset: float = 0.0
                       ) -> torch.Tensor:
    """RMSNorm in float32, cast back to the input dtype. Gemma uses
    (1 + scale)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    scale = scale.float()
    return (y * (scale + offset if offset else scale)).to(dtype)


def apply_rope_reference(x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D_head] rotated by the tables of
    :func:`repro_torch.models.common.rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def norm_rope_reference(q: torch.Tensor, k: torch.Tensor,
                        q_scale: torch.Tensor | None,
                        k_scale: torch.Tensor | None, cos: torch.Tensor,
                        sin: torch.Tensor, qk_norm: bool, eps: float = 1e-6
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q and k each RMSNormed by its scale (with ``qk_norm``), then
    rotated."""
    if qk_norm:
        q = rms_norm_reference(q, q_scale, eps)
        k = rms_norm_reference(k, k_scale, eps)
    return apply_rope_reference(q, cos, sin), apply_rope_reference(k, cos,
                                                                   sin)


def row_warps(d: int) -> int:
    """Warps of a row of width ``d`` in ``rms_norm_rows_kernel``: the
    fewest whose lanes hold the row, ROW_CHUNKS chunks of 8 each."""
    return next(w for w in ROW_WARPS if d <= 8 * 32 * ROW_CHUNKS * w)


def _broadcasts(shape: tuple, target: tuple) -> bool:
    """Whether ``shape`` broadcasts to ``target`` (``torch.broadcast_shapes``
    takes seconds on its first call: it imports torch's reference ops)."""
    return len(shape) <= len(target) and all(
        a in (1, b) for a, b in zip(reversed(shape), reversed(target)))


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _refused(t: torch.Tensor, name: str, device: torch.device
             ) -> str | None:
    """Why the kernels do not take ``t``, an operand of a call on
    ``device``, or None."""
    if t.device != device:
        return f"{name} is on {t.device}, expected {device}"
    if t.dtype not in DTYPES:
        return f"{name} is {t.dtype}, not float32 or bfloat16"
    if not t.is_contiguous():
        return f"{name} is not contiguous"
    return None


def rows_refusal(x: torch.Tensor, scale: torch.Tensor) -> str | None:
    """Why ``rms_norm_rows`` does not take (x, scale) on the card, or
    None."""
    if _needs_grad(x, scale):
        return "an operand needs a gradient: the kernel has no backward"
    d = x.shape[-1] if x.dim() else 0
    why = (_refused(x, "x", x.device)
           or _refused(scale, "scale", x.device))
    if why:
        return why
    if d % 8 or not 0 < d <= ROW_WIDTH_MAX:
        return (f"row width {d} is not a multiple of 8 up to "
                f"{ROW_WIDTH_MAX}")
    if tuple(scale.shape) != (d,):
        return f"scale is {tuple(scale.shape)}, expected ({d},)"
    if x.data_ptr() % ALIGN:
        return f"x is not {ALIGN}-byte aligned"
    return None


def takes_rows(x: torch.Tensor, scale: torch.Tensor) -> bool:
    """Whether the model's RMSNorm of x goes to ``rms_norm_rows``."""
    return x.device.type == "cuda" and rows_refusal(x, scale) is None


def rms_norm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                  offset: float = 0.0) -> torch.Tensor:
    """RMSNorm of x over its last dim (a multiple of 8, up to 8,192) by
    ``scale`` [d] (plus ``offset``): a new tensor of x's dtype and layout,
    as :func:`rms_norm_reference`."""
    why = rows_refusal(x, scale)
    if why:
        raise ValueError(f"rms_norm_rows: {why}")
    if x.device.type != "cuda":
        return rms_norm_reference(x, scale, eps, offset)
    d = x.shape[-1]
    out = torch.empty_like(x)
    launch("rms_norm_rows", x.device, x.data_ptr(), scale.data_ptr(),
           out.data_ptr(), x.numel() // d, d, DTYPES[x.dtype],
           DTYPES[scale.dtype], row_warps(d), eps, offset)
    return out


def norm_rope_refusal(q: torch.Tensor, k: torch.Tensor,
                      q_scale: torch.Tensor | None,
                      k_scale: torch.Tensor | None, cos: torch.Tensor,
                      sin: torch.Tensor) -> str | None:
    """Why ``norm_rope`` does not take these operands on the card, or
    None. ``q_scale`` and ``k_scale`` are None without qk-norm."""
    if _needs_grad(q, k, q_scale, k_scale):
        return "an operand needs a gradient: the kernel has no backward"
    if q.dim() != 4 or k.dim() != 4:
        return (f"q {tuple(q.shape)} and k {tuple(k.shape)} are not "
                "[B, S, heads, d]")
    B, S, _, d = q.shape
    if k.shape[:2] != q.shape[:2] or k.shape[-1] != d:
        return f"k {tuple(k.shape)} does not match q {tuple(q.shape)}"
    if d not in NORM_ROPE_HEAD_DIMS:
        return f"head dim {d} not compiled (one of {NORM_ROPE_HEAD_DIMS})"
    why = _refused(q, "q", q.device) or _refused(k, "k", q.device)
    if why:
        return why
    if k.dtype != q.dtype:
        return f"k is {k.dtype}, q {q.dtype}"
    if q.data_ptr() % ALIGN or k.data_ptr() % ALIGN:
        return f"q or k is not {ALIGN}-byte aligned"
    if (q_scale is None) != (k_scale is None):
        return "q_scale and k_scale are given together or not at all"
    for name, t in (("q_scale", q_scale), ("k_scale", k_scale)):
        if t is not None:
            why = _refused(t, name, q.device)
            if why:
                return why
            if tuple(t.shape) != (d,):
                return f"{name} is {tuple(t.shape)}, expected ({d},)"
    if q_scale is not None and q_scale.dtype != k_scale.dtype:
        return f"q_scale is {q_scale.dtype}, k_scale {k_scale.dtype}"
    table = (B, S, 1, d // 2)
    for name, t in (("cos", cos), ("sin", sin)):
        if t.device != q.device or t.dtype != torch.float32:
            return f"{name} must be float32 on {q.device}"
        if not _broadcasts(tuple(t.shape), table):
            return f"{name} {tuple(t.shape)} does not broadcast to {table}"
    return None


def takes_norm_rope(q: torch.Tensor, k: torch.Tensor,
                    q_scale: torch.Tensor | None,
                    k_scale: torch.Tensor | None, cos: torch.Tensor,
                    sin: torch.Tensor) -> bool:
    """Whether the model's qk-norm and RoPE of q and k go to
    ``norm_rope``."""
    return q.device.type == "cuda" and norm_rope_refusal(
        q, k, q_scale, k_scale, cos, sin) is None


def norm_rope(q: torch.Tensor, k: torch.Tensor,
              q_scale: torch.Tensor | None, k_scale: torch.Tensor | None,
              cos: torch.Tensor, sin: torch.Tensor, qk_norm: bool,
              eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, Hq, d] and k [B, S, Hk, d] (d 64, 128 or 256), each row
    RMSNormed by its scale [d] with ``qk_norm`` and rotated by the tables
    ``cos``, ``sin`` (float32, broadcast to [B, S, 1, d/2], any strides):
    new tensors of q's and k's dtype and layout, in one launch, as
    :func:`norm_rope_reference`."""
    if not qk_norm:
        q_scale = k_scale = None
    elif q_scale is None or k_scale is None:
        raise ValueError("norm_rope: qk_norm needs q_scale and k_scale")
    why = norm_rope_refusal(q, k, q_scale, k_scale, cos, sin)
    if why:
        raise ValueError(f"norm_rope: {why}")
    if q.device.type != "cuda":
        return norm_rope_reference(q, k, q_scale, k_scale, cos, sin,
                                   qk_norm, eps)
    B, S, Hq, d = q.shape
    table = (B, S, 1, d // 2)
    c, s = cos.expand(table), sin.expand(table)
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    launch("norm_rope", q.device, q.data_ptr(), k.data_ptr(),
           q_scale.data_ptr() if qk_norm else None,
           k_scale.data_ptr() if qk_norm else None, c.data_ptr(),
           s.data_ptr(), q_out.data_ptr(), k_out.data_ptr(), B * S, S, Hq,
           k.shape[2], d, DTYPES[q.dtype],
           DTYPES[q_scale.dtype] if qk_norm else DTYPES[torch.float32],
           c.stride(0), c.stride(1), c.stride(3), s.stride(0), s.stride(1),
           s.stride(3), int(qk_norm), eps)
    return q_out, k_out
