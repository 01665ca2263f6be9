"""Training driver (port of ``repro/launch/train.py``): config -> model ->
data -> AdamW -> train loop with checkpointing, resume and straggler
monitoring, on ``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --preset smoke --steps 50 --ckpt-dir /tmp/ck [--device cpu]

The LM and recsys families train; a GNN arch raises
``NotImplementedError`` (its loss needs a ``segment_sum_sorted``
backward: ROADMAP Queue 1 item 10). Weights come from ``--seed`` (a
``torch.Generator``, not JAX's PRNG); the batches are the reference's
numpy stream, so a seed gives the reference's tokens and recsys batches.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import tree
from ..configs.registry import get_spec
from ..data.recsys import recsys_batch
from ..device import resolve_device
from ..models.recsys import init_recsys_params, recsys_loss
from ..models.transformer import init_lm_params, lm_loss
from ..optim.adamw import AdamWConfig
from ..runtime.train_loop import TrainLoopConfig, train

GNN_TODO = ("GNN training is not ported yet: gnn_loss needs a backward of "
            "segment_sum_sorted (ROADMAP Queue 1 item 10)")


def reduce_config(spec):
    """Shrink a full config to smoke scale (same family/topology)."""
    cfg = spec.config
    if spec.family == "lm":
        return dataclasses.replace(
            cfg, n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=min(4, cfg.n_kv_heads), d_head=16,
            d_ff=128 if not cfg.moe else 32, vocab=503,
            n_experts=min(cfg.n_experts, 4),
            top_k=min(cfg.top_k, 2), window=8, q_chunk=64)
    if spec.family == "gnn":
        return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, 2),
                                   d_hidden=16, d_feat=32, n_classes=5)
    return dataclasses.replace(cfg, n_sparse=6, vocab_per_field=1000,
                               embed_dim=8, n_dense=4, mlp_dims=(32, 16),
                               n_candidates=500, retrieval_dim=16)


def make_batch_iter(spec, cfg, batch_size: int, seed: int = 0,
                    device=None):
    """The reference's batches as tensors on ``device`` (``cuda`` by
    default): LM tokens int32 [batch_size, 128] from
    ``np.random.default_rng(seed)``, recsys batches from ``recsys_batch``
    with seeds ``seed``, ``seed + 1``, ..."""
    dev = resolve_device(device)
    if spec.family == "gnn":
        raise NotImplementedError(GNN_TODO)
    rng = np.random.default_rng(seed)
    if spec.family == "lm":
        def it():
            while True:
                yield torch.from_numpy(rng.integers(
                    0, cfg.vocab, (batch_size, 128)).astype(np.int32)
                ).to(dev)
        return it()

    def it():
        i = 0
        while True:
            b = recsys_batch(batch_size, n_sparse=cfg.n_sparse,
                             vocab=cfg.vocab_per_field, n_dense=cfg.n_dense,
                             seed=seed + i)
            i += 1
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    return it()


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    spec = get_spec(args.arch)
    if spec.family == "gnn":
        raise NotImplementedError(GNN_TODO)
    cfg = spec.config if args.preset == "full" else reduce_config(spec)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    if spec.family == "lm":
        params = init_lm_params(cfg, gen, device=dev)
        loss_fn = lambda p, b: lm_loss(cfg, p, b)             # noqa: E731
    else:
        params = init_recsys_params(cfg, gen, device=dev)
        loss_fn = lambda p, b: recsys_loss(cfg, p, b)         # noqa: E731

    n_params = sum(int(np.prod(x.shape)) for x in tree.leaves(params))
    print(f"[train] arch={args.arch} preset={args.preset} "
          f"params={n_params:,} device={dev}")
    result = train(
        loss_fn, params,
        make_batch_iter(spec, cfg, args.batch, args.seed, dev),
        AdamWConfig(peak_lr=args.lr, warmup_steps=5,
                    total_steps=args.steps),
        TrainLoopConfig(total_steps=args.steps, log_every=10,
                        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir))
    first = result.history[0]["loss"] if result.history else float("nan")
    last = result.history[-1]["loss"] if result.history else float("nan")
    print(f"[train] done: loss {first:.4f} -> {last:.4f}")
    return result


if __name__ == "__main__":
    main()
