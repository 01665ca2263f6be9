"""AdamW and its schedule (port of ``repro/optim/adamw.py``).

Moments are float32 whatever the parameter dtype; bf16 parameters get
float32 updates cast back. Global-norm clipping, decoupled weight decay,
linear warmup then cosine decay. State is a tree ``{"m", "v", "step"}``
with ``step`` a 0-dim int32 tensor on the parameters' device, so the
schedule and the update never read a value back to the host.

Where the port differs, by design: :func:`adamw_update` writes the new
parameters and moments **in place** (under ``torch.no_grad``) and returns
the same tensors, where the reference returns new trees: Wide&Deep's
40M x 32 table and its moments are 15 GB, and a second copy of each would
not fit beside the gradients. Large leaves are updated in chunks of
``CHUNK`` elements, so the float32 temporaries stay small. The arithmetic
is the reference's, operation for operation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import tree
from ..launch import collectives as col

CHUNK = 1 << 24          # elements of a leaf updated at once


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to end_lr_frac * peak (float32)."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.peak_lr * (cfg.end_lr_frac
                         + (1 - cfg.end_lr_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _device(params) -> torch.device:
    found = tree.leaves(params)
    return found[0].device if found else torch.device("cpu")


def adamw_init(params) -> dict:
    """Zero float32 moments shaped like ``params`` and step 0."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                    device=p.device)
    return {"m": tree.tree_map(zeros32, params),
            "v": tree.tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(grads, specs: dict | None = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of their float32 squares (0-dim). On a
    mesh (``specs``, the leaves' layouts as ``convert.local_shard`` takes
    them, and ``mesh``) each sharded leaf's squares are ``psum``med over
    the axes that shard it, each replicated leaf counted once: the norm
    of the whole gradient, the same on every rank (its gradient already
    summed over the ranks by ``make_train_step(..., rules=)``)."""
    sums: dict[tuple, torch.Tensor] = {}
    for path, leaf in tree.flatten(grads):
        axes = ()
        if mesh is not None:
            named = spec_axes((specs or {}).get(tree.path_key(path)))
            axes = tuple(a for a in mesh.mesh_dim_names if a in named)
        s = sum(c.float().square().sum() for c in _chunks(leaf.contiguous()))
        sums[axes] = s if axes not in sums else sums[axes] + s
    if not sums:
        return torch.zeros(())
    total = None
    for axes, s in sums.items():
        if axes:
            s = col.all_reduce_(s.clone(), mesh, axes)
        total = s if total is None else total + s
    return torch.sqrt(total)


def spec_axes(spec) -> set:
    """The mesh axes a layout (``convert.local_shard``'s tuple) names."""
    out = set()
    for axes in spec or ():
        if axes:
            out.update((axes,) if isinstance(axes, str) else axes)
    return out


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: dict, params,
                 specs: dict | None = None, mesh=None
                 ) -> tuple[dict, dict, dict]:
    """Returns (params, new_state, info): ``params`` and the moments
    updated in place, ``info`` = {"grad_norm", "lr"} (0-dim tensors). On
    a mesh the clipping norm is :func:`global_norm`'s over ``specs``."""
    step = state["step"] + 1
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()

    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(state["m"]), tree.leaves(state["v"])):
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("adamw_update updates contiguous leaves in "
                             "place")
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g.contiguous()),
                                  _chunks(m), _chunks(v)):
            g32 = gc.float() * scale
            m_new = cfg.b1 * mc + (1 - cfg.b1) * g32
            v_new = cfg.b2 * vc + (1 - cfg.b2) * g32 * g32
            mhat = m_new / bc1
            vhat = v_new / bc2
            p32 = pc.float()
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * p32
            pc.copy_(p32 - lr * delta)
            mc.copy_(m_new)
            vc.copy_(v_new)
    info = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, info
