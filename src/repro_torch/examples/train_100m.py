"""End-to-end example: train a ~100M-parameter transformer with Tol-FL.

The port's twin of ``examples/train_100m.py``: the same
``make_train_step`` the launcher runs, on the host mesh, with the Tol-FL
ring schedule (an all-reduce per cluster + the sequential send/recv
chain), failure injection, checkpointing and the synthetic non-IID token
pipeline.

Run (full, ~hundreds of steps):
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
Quick sanity: ``--steps 20 --layers 4``; on the CPU add ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict

import torch

from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      OptimizerConfig, TolFLConfig)
from repro_torch.core import distributed as D
from repro_torch.core.failure import NO_FAILURE, FailureSpec, alive_mask
from repro_torch.core.topology import Topology
from repro_torch.data.pipeline import TokenPipeline, shard_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.training.checkpoint import CheckpointManager


def build_config(layers: int, d_model: int) -> ModelConfig:
    return ModelConfig(
        name=f"tolfl-{d_model}x{layers}",
        num_layers=layers,
        d_model=d_model,
        d_ff=4 * d_model,
        vocab_size=32000,
        attention=AttentionConfig(num_heads=d_model // 64,
                                  num_kv_heads=max(1, d_model // 128),
                                  head_dim=64),
        remat="none",
        dtype="float32",
        tie_embeddings=True,
    )


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fail-epoch", type=int, default=-1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "tolfl_100m"))
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    cfg = build_config(args.layers, args.d_model)
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M")

    mesh = make_host_mesh(data=1, model=1, device=args.device)
    G = D.num_groups(mesh)
    tolfl = TolFLConfig(num_clusters=min(args.clusters, G),
                        schedule="tolfl_ring")
    ocfg = OptimizerConfig(name="adam", lr=args.lr, warmup_steps=20,
                           total_steps=args.steps, schedule="cosine")
    topo = Topology(G, tolfl.num_clusters)
    failure = (NO_FAILURE if args.fail_epoch < 0
               else FailureSpec(epoch=args.fail_epoch, kind="server"))

    step_fn = D.make_train_step(cfg, tolfl, ocfg, mesh)
    state = D.init_state(torch.Generator(device=mesh.device).manual_seed(0),
                         cfg, ocfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, num_groups=G)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    losses = []
    t0 = time.time()
    for step, host_batch in enumerate(pipe.batches(args.steps)):
        alive = alive_mask(failure, topo, step, device=mesh.device)
        state, metrics = step_fn(state, shard_batch(host_batch, mesh), alive)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = (step + 1) * args.batch * args.seq / dt
            print(f"step {step:4d}  loss {losses[-1]:7.4f}  "
                  f"{tok_s:7.0f} tok/s  ({dt:5.1f}s)")
        if (step + 1) % 100 == 0 or step == args.steps - 1:
            ckpt.save({"params": state["params"], "step": state["step"]},
                      step + 1)

    print(f"\nfinal loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"{'LEARNED' if losses[-1] < losses[0] else 'NO PROGRESS'}")
    return {"losses": losses, "ckpt_dir": args.ckpt_dir,
            "latest_step": ckpt.latest_step()}


if __name__ == "__main__":
    main()
