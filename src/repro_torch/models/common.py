"""Shared model building blocks (port of ``repro/models/common.py``).

Parameters are plain dicts of tensors. :class:`AxisRules` maps the
logical axes (batch, fsdp, tp) onto the dimensions of a mesh
(:mod:`repro_torch.launch.mesh`), as the reference's does. The
reference's ``constrain`` (GSPMD's ``with_sharding_constraint``) has no
counterpart: the port runs each rank's piece eagerly and states every
layout itself, with the collectives of
:mod:`repro_torch.launch.collectives` where the reference's ``shard_map``
routes call ``jax.lax`` ones. Random initialisation takes an explicit
``torch.Generator``: the same seed gives other numbers than
``jax.random``, so tests carry weights over with :mod:`repro_torch.convert`
instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kernels import norm
from ..kernels.norm import apply_rope_reference as apply_rope


@dataclass(frozen=True)
class AxisRules:
    """Logical -> mesh axis mapping.

    batch: axes that shard the batch (data parallel, incl. the pod axis)
    fsdp:  axis that shards parameter rows (fully-sharded data parallel)
    tp:    tensor-parallel axis (heads / ffn / vocab / experts)
    mesh:  a ``DeviceMesh`` or None; the mesh routes (``mp_aggregate``'s
           sharded sum and max, NequIP's sharded chunk scan, the
           expert-parallel MoE) run only where it is set.
    """

    batch: tuple[str, ...] = ("data",)
    fsdp: str | None = "data"
    tp: str | None = "model"
    mesh: object = None

    @classmethod
    def for_mesh_axes(cls, axis_names: tuple[str, ...],
                      mesh=None) -> "AxisRules":
        if "pod" in axis_names:
            return cls(batch=("pod", "data"), fsdp="data", tp="model",
                       mesh=mesh)
        return cls(batch=("data",), fsdp="data", tp="model", mesh=mesh)

    @classmethod
    def for_mesh(cls, mesh) -> "AxisRules":
        return cls.for_mesh_axes(tuple(mesh.mesh_dim_names), mesh=mesh)


def on_mesh(rules) -> bool:
    """Whether ``rules`` (or None) carry a mesh: the mesh routes run."""
    return rules is not None and rules.mesh is not None


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in float32, cast back to the input dtype. Gemma uses
    (1 + scale). On the card with no gradient to carry, one launch of
    :func:`repro_torch.kernels.norm.rms_norm_rows`; else the plain
    version."""
    if norm.takes_rows(x, scale):
        return norm.rms_norm_rows(x, scale, eps, offset)
    return norm.rms_norm_reference(x, scale, eps, offset)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def rope_tables(positions: torch.Tensor, d: int, theta: float = 10000.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [..., S, 1, d/2] of the rotary angles at ``positions``
    [..., S]; every layer of one pass shares them."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[..., :, None].float() * freqs      # [..., S, half]
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings. x: [..., S, H, D_head], positions: [..., S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def _trunc_normal(shape: tuple[int, ...], std: float,
                  generator: torch.Generator, dtype: torch.dtype,
                  device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def dense_init(generator: torch.Generator, shape: tuple[int, ...],
               in_axis: int = -2, dtype: torch.dtype = torch.bfloat16,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-ish), bf16 storage."""
    return _trunc_normal(shape, math.sqrt(1.0 / shape[in_axis]), generator,
                         dtype, device)


def embed_init(generator: torch.Generator, shape: tuple[int, ...],
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> torch.Tensor:
    """1/sqrt(d) embeddings: tied-logit variance O(1); pairs with the
    sqrt(d) embedding rescale Gemma-style models apply in forward."""
    return _trunc_normal(shape, shape[-1] ** -0.5, generator, dtype, device)


def normal_init(generator: torch.Generator, shape: tuple[int, ...],
                std: float, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """Plain normal draws times ``std`` (the recsys tables: embeddings,
    wide weights, candidates), scaled in place so a multi-GB table is
    allocated once."""
    t = torch.randn(shape, dtype=torch.float32, device=device,
                    generator=generator)
    return t.mul_(std).to(dtype)
