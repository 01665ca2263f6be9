"""One-token attention against a KV cache: the ``decode_attention`` CUDA
kernel.

Wrapper of the kernel in ``csrc/attention_kernels.cu`` (port of
``repro/kernels/decode_attention.py``), with the Pallas signature: q
[B, H, d], caches [B, Hkv, S, d], valid lengths [B] int32, an optional
sliding window and logit softcap. The caches may be any strided view, so
a model holding [B, S, Hkv, d] passes ``cache.transpose(1, 2)`` with no
copy. The kernel reads only the valid rows (those before ``length`` and,
with a window, from ``length - window``) in 512-key chunks, and merges the
chunks in a second pass; the wrapper allocates the chunks' partials. A
tensor on the CPU takes the plain torch version in :mod:`.ref`; a tensor
on the card launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import torch

from . import ref
from ._build import check_int32, launch
from .flash_attention import DTYPES, check_attention, strides

CHUNK = 512            # keys per block; a multiple of the kernel's tile
MAX_GROUP = 16         # query heads per kv head the kernel takes


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q [B, H, d]; caches [B, Hkv, S, d]; lengths [B] int32 -> [B, H, d]
    in q's dtype. A length of 0 gives zeros."""
    check_attention("q", q, 3)
    check_attention("k_cache", k_cache, 4, like=q)
    check_attention("v_cache", v_cache, 4, like=q)
    check_int32("lengths", lengths, 1, device=q.device)
    B, H, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (B, Hkv, S, d) or v_cache.shape != k_cache.shape
            or H % Hkv or lengths.shape[0] != B):
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)}"
                         f"/{tuple(v_cache.shape)}, lengths "
                         f"{tuple(lengths.shape)} must be [B,H,d], "
                         f"[B,Hkv,S,d] and [B] with H a multiple of Hkv")
    window, softcap = max(int(window), 0), float(softcap)
    if q.device.type == "cpu":
        return ref.decode_reference(q, k_cache, v_cache, lengths, window,
                                    softcap)
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"{H // Hkv} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    out = torch.empty_like(q)
    if out.numel() and S:
        n_split = -(-S // CHUNK)
        part_o = torch.empty((B, H, n_split, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32,
                              device=q.device)
        launch("decode_attention", q.device, q.data_ptr(),
               k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
               out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
               strides(q, k_cache, v_cache, out), DTYPES[q.dtype], B, H,
               Hkv, S, d, CHUNK, window, softcap, d ** -0.5)
    elif out.numel():
        out.zero_()                     # an empty cache: no visible key
    return out
