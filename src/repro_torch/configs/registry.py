"""Architecture lookup and serving shapes (port of the LM part of
``repro/configs/registry.py``).

Each arch module exposes ``spec() -> ArchSpec``. The port serves the dense
LMs; the JAX registry's MoE, GNN and recsys archs and its cell builders
(abstract inputs and shardings for the TPU dry run) are not ported.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

ARCH_IDS = ["qwen3-0.6b", "qwen3-1.7b", "gemma2-2b"]

_MODULE_OF = {
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma2-2b": "gemma2_2b",
}

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, seq_shard=True),
}


@dataclass
class ArchSpec:
    arch_id: str
    family: str                      # lm
    config: object
    skip_shapes: dict[str, str] = field(default_factory=dict)
    source: str = ""

    @property
    def shapes(self) -> dict:
        return {k: v for k, v in LM_SHAPES.items()
                if k not in self.skip_shapes}


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULE_OF:
        raise KeyError(f"unknown or unported arch {arch_id!r}; the port "
                       f"serves {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULE_OF[arch_id]}")
    return mod.spec()
