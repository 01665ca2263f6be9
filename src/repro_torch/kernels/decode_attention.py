"""One-token attention against a KV cache: the ``decode_attention`` CUDA
kernels.

Wrapper of two kernels (ports of ``repro/kernels/decode_attention.py``)
with the Pallas signature: q [B, H, d], caches [B, Hkv, S, d], valid
lengths [B] int32 read on the device, an optional sliding window and logit
softcap. Keys ``[max(0, length - window), length)`` are visible; a length
of 0 gives zeros. Both split the cache into chunks of keys, one block per
chunk of a (sequence, kv head), and read only the visible rows.

- bfloat16 runs ``csrc/decode_tc.cu``: a TMA-fed ring of bf16 K/V tiles,
  scores on the tensor cores (``mma.sync``), softmax and P V in float32,
  the chunks merged by the last block of each (sequence, kv head). TMA
  reads the caches through tensor maps, so each needs d stride 1, its
  other strides multiples of 8 elements and a 16-byte aligned base; the
  model's [B, S, Hkv, d] cache passes ``cache.transpose(1, 2)`` with no
  copy. A cache that misses one of these is copied into a new contiguous
  tensor first, and ``decode_attention.copies`` counts those copies. The
  chunk comes from :func:`split_plan`, on the host, from the shapes alone.
- float32 runs the SIMT kernel of ``csrc/attention_kernels.cu`` (512-key
  chunks and a merge pass, any element strides).

With ``lse`` (float32 [B, H]) both routes also write, at their merge,
the natural log of the sum of exponentials of the scaled, softcapped
logits over the visible keys, and -inf where no key is visible: the
weight with which a sequence-sharded decode combines the slices of a
cache (``models.transformer.lse_combine``). ``out_dtype=torch.float32``
has the bf16 route store its merged output unrounded, so that combine
rounds once.

q and ``out`` take any strides on both routes. A tensor on the CPU takes
the plain torch version in :mod:`.ref`; a tensor on the card launches a
kernel or raises — it never falls back. A meta tensor (the dry run) gets
a meta output and the route's partial-result workspace, and
:func:`decode_ops` at the whole cache (the lengths are data) goes to the
dry run's tally.
"""

from __future__ import annotations

import torch

from . import ref
from ._build import check_int32, launch, tally
from .flash_attention import DTYPES, check_attention, strides, tma_operand

MAX_GROUP = 16         # query heads per kv head the kernels take
F32_CHUNK = 512        # keys per block of the float32 route
# The bf16 route's plan: keys per ring stage by head dim, and the grid the
# split aims at on an H100 SXM (132 SMs, two blocks an SM, at most about
# four waves), with chunks of at least MIN_TILES tiles.
TILE = {16: 64, 32: 64, 64: 64, 128: 64, 256: 32}
SMS = 132
BLOCKS_PER_SM = 2
WAVES = 4
MIN_TILES = 4

_tickets: dict[tuple[int, int], torch.Tensor] = {}


def split_plan(B: int, Hkv: int, S: int, d: int) -> tuple[int, int]:
    """(chunk, n_split) of the bf16 route for B sequences of Hkv kv heads
    over an S-position cache: chunks of whole tiles, at least MIN_TILES
    long, as many as the largest power of two that keeps the B * Hkv *
    n_split blocks within WAVES waves of BLOCKS_PER_SM blocks on each of
    SMS SMs. A power-of-two cache then splits into equal chunks, and the
    grid ends just short of a whole wave (at the serving shape 16 chunks of
    2,048 keys, 1,024 blocks). Depends on the shapes alone, never on the
    lengths on the device."""
    tile = TILE[d]
    want = max(1, SMS * BLOCKS_PER_SM * WAVES // max(1, B * Hkv))
    n = 1 << (want.bit_length() - 1)
    chunk = max(MIN_TILES, -(-S // (n * tile))) * tile
    return chunk, max(1, -(-S // chunk))


def decode_ops(B: int, H: int, keys: int, d: int) -> int:
    """Operations of one call, the count its bound uses: two products of
    d multiply-adds for each of B * H query heads and each visible key."""
    return 4 * B * H * d * keys


def _ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros, kept per (device, current stream): the
    bf16 kernel takes a ticket per (sequence, kv head) and sets it back to
    0 before it ends, so the buffer needs no clearing between launches."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(),
           torch.cuda.current_stream(device).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: int = 0, softcap: float = 0.0,
                     lse: torch.Tensor | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """q [B, H, d]; caches [B, Hkv, S, d]; lengths [B] int32 -> [B, H, d]
    in ``out_dtype``: q's (the default) or float32. A length of 0 gives
    zeros. ``lse``: None, or a contiguous float32 [B, H] tensor on q's
    device that receives each row's log-sum-exp (-inf for a length of
    0)."""
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
    if lse is not None and (lse.shape != (B, H) or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [B, H] = "
                         f"{[B, H]} tensor on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"out_dtype must be q's {q.dtype} or float32, got "
                         f"{out_dtype}")
    window, softcap = max(int(window), 0), float(softcap)
    if q.device.type == "cpu":
        return ref.decode_reference(q, k_cache, v_cache, lengths, window,
                                    softcap, lse=lse, out_dtype=out_dtype)
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"{H // Hkv} query heads per kv head; the kernels "
                         f"take at most {MAX_GROUP}")
    out = torch.empty_like(q, dtype=out_dtype)
    if not out.numel():
        return out
    if not S:                           # an empty cache: no visible key
        if lse is not None:
            lse.fill_(float("-inf"))
        return out.zero_()
    lse_ptr = 0 if lse is None else lse.data_ptr()
    if q.dtype == torch.bfloat16:
        k_cache = tma_operand(k_cache, decode_attention)
        v_cache = tma_operand(v_cache, decode_attention)
        chunk, n_split = split_plan(B, Hkv, S, d)
        part = torch.empty(B * H * n_split * (d + 2), dtype=torch.float32,
                           device=q.device)
        if q.device.type == "meta":
            return _tallied(out, B, H, S, d, window)
        launch("decode_attention", q.device, q.data_ptr(),
               k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
               out.data_ptr(), part.data_ptr(),
               _ticket_counters(q.device, B * Hkv).data_ptr(), lse_ptr,
               int(out.dtype == torch.float32),
               strides(q, k_cache, v_cache, out), B, H, Hkv, S, d, chunk,
               window, softcap, d ** -0.5, lib="decode")
    else:
        n_split = -(-S // F32_CHUNK)
        part_o = torch.empty((B, H, n_split, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32,
                              device=q.device)
        if q.device.type == "meta":
            return _tallied(out, B, H, S, d, window)
        launch("decode_attention", q.device, q.data_ptr(),
               k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
               out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
               lse_ptr, strides(q, k_cache, v_cache, out), DTYPES[q.dtype],
               B, H,
               Hkv, S, d, F32_CHUNK, window, softcap, d ** -0.5)
    return out


def _tallied(out: torch.Tensor, B: int, H: int, S: int, d: int,
             window: int) -> torch.Tensor:
    """A meta call's end, after the route's workspace: its operations to
    the dry run's tally, ``out`` returned."""
    tally("decode_attention", decode_ops(B, H, min(S, window) if window
                                         else S, d))
    return out


decode_attention.copies = 0
