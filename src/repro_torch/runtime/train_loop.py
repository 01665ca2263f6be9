"""Generic training loop: microbatching, checkpoints, straggler monitor
(port of ``repro/runtime/train_loop.py``).

Family-agnostic: anything exposing ``loss_fn(params, batch) -> (loss,
aux)`` over a tree of tensors trains through here (the LM and Wide&Deep
losses). A step takes the gradient of every floating leaf by autograd,
accumulates float32 gradients over microbatches, and runs the AdamW
update; its metrics stay on the device. The only host sync of a step is
the one that reads its loss (on a logging step, every metric in that one
read).

Where the port differs: there is no ``jit`` and so no ``jit_kwargs``
(PyTorch runs eagerly); the AdamW update writes the parameters and
moments in place (:mod:`repro_torch.optim.adamw`), so ``params`` passed
in are the ones trained. The reference retries a whole step, which is
safe there because its training state is functional. Here a step that
failed part-way through the update would have changed some leaves
already, and a retry would take its gradients at those and update them a
second time. So ``make_train_step(..., retries=n)`` retries only the
gradient (the forward and backward, which change no state), and an error
in the update propagates.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from .. import tree
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .fault_tolerance import StragglerMonitor, with_retries


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    microbatches: int = 1          # grad accumulation factor
    log_every: int = 10
    ckpt_every: int = 0            # 0 == disabled
    ckpt_dir: str = ""
    keep_last: int = 2
    straggler_factor: float = 5.0
    retries: int = 1


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, aux, grads): the gradient of ``loss_fn(params, batch)[0]``
    with respect to every floating leaf of ``params`` (zeros for a leaf
    the loss does not use, as ``jax.value_and_grad`` gives), detached."""
    flat = tree.leaves(params)
    with torch.enable_grad():
        tracked = [p.detach().requires_grad_() if p.is_floating_point()
                   else p for p in flat]
        loss, aux = loss_fn(tree.unflatten(params, tracked), batch)
        wrt = [t for t in tracked if t.requires_grad]
        grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                         materialize_grads=True))
    out = [next(grads) if t.requires_grad else torch.zeros_like(t)
           for t in tracked]
    aux = tree.tree_map(lambda a: a.detach()
                        if isinstance(a, torch.Tensor) else a, aux)
    return loss.detach(), aux, tree.unflatten(params, out)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    microbatches: int = 1, retries: int = 0):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    With microbatches > 1, ``batch`` leaves must lead with that axis:
    [microbatches, per_micro, ...]; float32 grads are summed over the
    microbatches and divided by their count, the loss likewise, and aux
    comes from the last microbatch. The gradient is retried up to
    ``retries`` times on an exception; the in-place update is not.
    """

    def gradient(params, batch):
        if microbatches == 1:
            loss, aux, grads = value_and_grad(loss_fn, params, batch)
        else:
            loss_sum, gsum = None, None
            for i in range(microbatches):
                micro = tree.tree_map(lambda x: x[i], batch)
                loss_i, aux, g = value_and_grad(loss_fn, params, micro)
                g = tree.leaves(g)
                if gsum is None:
                    loss_sum = loss_i.float()
                    gsum = [x.to(torch.float32, copy=True) for x in g]
                else:
                    loss_sum = loss_sum + loss_i
                    for acc, x in zip(gsum, g):
                        acc.add_(x.float())
            loss = loss_sum / microbatches
            grads = tree.unflatten(params,
                                   [x.div_(microbatches) for x in gsum])
        return loss, aux, grads

    gradient = with_retries(gradient, retries)

    def step(params, opt_state, batch):
        loss, aux, grads = gradient(params, batch)
        params, opt_state, info = adamw_update(opt_cfg, grads, opt_state,
                                               params)
        metrics = {"loss": loss, **info}
        if isinstance(aux, dict):
            metrics.update(aux)
        return params, opt_state, metrics

    return step


@dataclass
class TrainResult:
    params: object
    opt_state: object
    history: list = field(default_factory=list)
    resumed_from: int | None = None
    straggler_steps: list = field(default_factory=list)


def _read(metrics: dict, everything: bool) -> dict:
    """Metric values on the host in one transfer: all of them, or the
    loss alone."""
    names = list(metrics) if everything else ["loss"]
    dev = metrics["loss"].device
    vals = torch.stack([torch.as_tensor(metrics[k], device=dev)
                        .float().reshape(()) for k in names]).tolist()
    return dict(zip(names, vals))


def train(loss_fn: Callable, params, batch_iter, opt_cfg: AdamWConfig,
          loop_cfg: TrainLoopConfig, log=print) -> TrainResult:
    """Run the loop; resumes from loop_cfg.ckpt_dir if checkpoints
    exist."""
    step_fn = make_train_step(loss_fn, opt_cfg, loop_cfg.microbatches,
                              loop_cfg.retries)
    opt_state = adamw_init(params)

    start = 0
    resumed = None
    if loop_cfg.ckpt_dir and latest_step(loop_cfg.ckpt_dir) is not None:
        start, state = restore_checkpoint(
            loop_cfg.ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        resumed = start
        log(f"[train] resumed from step {start}")

    monitor = StragglerMonitor(factor=loop_cfg.straggler_factor)
    history = []
    for step in range(start, loop_cfg.total_steps):
        batch = next(batch_iter)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        logged = bool(loop_cfg.log_every) and step % loop_cfg.log_every == 0
        vals = _read(metrics, logged)        # the step's one host sync
        dt = time.perf_counter() - t0
        if monitor.observe(step, dt):
            log(f"[train] straggler at step {step}: {dt:.3f}s")
        if logged:
            history.append({"step": step, "seconds": dt, **vals})
            log(f"[train] step {step} loss {vals['loss']:.4f} "
                f"({dt * 1e3:.1f} ms)")
        if (loop_cfg.ckpt_every and loop_cfg.ckpt_dir
                and (step + 1) % loop_cfg.ckpt_every == 0):
            save_checkpoint(loop_cfg.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            keep_last=loop_cfg.keep_last)
    return TrainResult(params=params, opt_state=opt_state, history=history,
                       resumed_from=resumed,
                       straggler_steps=list(monitor.flagged_steps))
