"""Dispatching wrappers (port of ``repro/kernels/ops.py``): one API over
the port's kernels and their plain versions.

The reference picks among its TPU backends (``pallas``, ``interpret``,
``xla``). The port's ``impl``:

- ``"auto"``: the input's device decides, as in every wrapper of the port:
  a CUDA tensor launches the kernel, a CPU tensor runs the plain version;
- ``"cuda"``: the hand-written kernel; raises ``ValueError`` for a tensor
  that is not on a CUDA device;
- ``"torch"``: the plain version in :mod:`.ref`, on any device;
- ``"interpret"``: the reference's Pallas interpret mode has no
  counterpart (a CUDA kernel cannot run on the CPU); raises
  ``ValueError``.

As in the reference, nothing on the serving paths imports this module:
the models and the engine call the kernels' wrappers directly. Its
caller to come is the port's kernel benchmark (``benchmarks/
bench_torch.py``, not yet written), which is to time each kernel
(``impl="cuda"``) against its plain version (``impl="torch"``) on the
same inputs through this one API.
"""

from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_kernel
from .embedding_bag import embedding_bag as _bag_kernel
from .flash_attention import flash_attention as _flash_kernel
from .segment_mp import segment_sum_sorted as _segment_kernel
from .triple_scan import triple_scan as _scan_kernel

IMPLS = ("auto", "cuda", "torch")


def _backend(impl: str, t: torch.Tensor) -> str:
    """"kernel" (the wrapper: the kernel on a card, the plain version on
    the CPU) or "torch" (the plain version)."""
    if impl == "interpret":
        raise ValueError("impl='interpret' is the reference's Pallas "
                         "interpret mode, which has no counterpart in the "
                         "port; impl='torch' runs the plain version")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and t.device.type != "cuda":
        raise ValueError(f"impl='cuda' launches the kernel and needs a "
                         f"CUDA tensor, got one on {t.device}")
    return "torch" if impl == "torch" else "kernel"


def attention(q, k, v, *, causal=True, window=0, softcap=0.0,
              impl: str = "auto"):
    if _backend(impl, q) == "torch":
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    return _flash_kernel(q, k, v, causal=causal, window=window,
                         softcap=softcap)


def decode_attention(q, k_cache, v_cache, lengths, *, window=0, softcap=0.0,
                     impl: str = "auto"):
    if _backend(impl, q) == "torch":
        return ref.decode_reference(q, k_cache, v_cache, lengths,
                                    window=window, softcap=softcap)
    return _decode_kernel(q, k_cache, v_cache, lengths, window=window,
                          softcap=softcap)


def segment_sum_sorted(msg, dst, n_nodes: int, *, impl: str = "auto"):
    if _backend(impl, msg) == "torch":
        return ref.segment_sum_sorted_reference(msg, dst, n_nodes)
    return _segment_kernel(msg, dst, n_nodes)


def embedding_bag(table, ids, mask, *, combiner="mean", impl: str = "auto"):
    if _backend(impl, table) == "torch":
        return ref.embedding_bag_reference(table, ids, mask,
                                           combiner=combiner)
    return _bag_kernel(table, ids, mask, combiner=combiner)


def triple_scan(triples, pattern, *, impl: str = "auto"):
    if _backend(impl, triples) == "torch":
        return ref.triple_scan_reference(triples, int(pattern[0]),
                                         int(pattern[1]), int(pattern[2]))
    return _scan_kernel(triples, pattern)
