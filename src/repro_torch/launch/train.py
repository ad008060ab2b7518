"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

Port of ``repro.launch.train``: real steps of the Tol-FL train step
(:func:`repro_torch.core.distributed.make_train_step`, ring or psum
schedule) on the host mesh, failure injection via the alive mask, the
non-IID token pipeline, a checkpoint every 10 steps, and ``repro``'s
printout (``mesh=... groups=... clusters=...``, then ``step N loss L
[n_eff=...] (t s)`` a step), so a parser of ``repro``'s output reads
this one's.

One process is a world of one rank (one group); under ``torchrun
--nproc-per-node 4`` the four ranks are four groups (gloo on the CPU,
NCCL on cards, one card a rank).  Runs on the card (``--device cuda``,
the default; it raises without one) or on the CPU (``--device cpu``).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, OptimizerConfig, TolFLConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as D
from repro_torch.core.failure import NO_FAILURE, FailureSpec, alive_mask
from repro_torch.core.topology import Topology
from repro_torch.data.pipeline import TokenPipeline, shard_batch
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_axis_sizes)
from repro_torch.training.checkpoint import CheckpointManager


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced config (CPU-runnable); --no-reduced for "
                         "full")
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--schedule", default="tolfl_ring",
                    choices=["tolfl_ring", "tolfl_psum", "fedavg",
                             "sbt_ring"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fail-epoch", type=int, default=-1,
                    help="inject a failure at this step (-1: none)")
    ap.add_argument("--fail-kind", default="server",
                    choices=["server", "client"])
    ap.add_argument("--data-axis", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (dry-run scale)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the params and the token pipeline")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, log=print,
        cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """The launcher's loop; returns the per-step losses and n_eff, the
    final state, the mesh and the wall time of each step (to its end on
    the device).  ``cfg`` replaces ``--arch``'s config (reduced or not):
    a ``param_dtype`` has no flag, as in ``repro``, so a caller sets it
    on the config."""
    if cfg is None:
        cfg = ARCHS[args.arch]
        if args.reduced:
            cfg = cfg.reduced()
    mesh = (make_production_mesh(device=args.device) if args.production_mesh
            else make_host_mesh(data=args.data_axis, model=1,
                                device=args.device))
    sizes = mesh_axis_sizes(mesh)
    G = D.num_groups(mesh)
    clusters = min(args.clusters, G)
    if args.schedule == "sbt_ring":
        clusters = G
    lead = mesh.rank == 0
    if lead:
        log(f"mesh={sizes} groups={G} clusters={clusters} arch={cfg.name} "
            f"params={cfg.param_count()/1e6:.1f}M schedule={args.schedule}")

    tolfl = TolFLConfig(num_clusters=clusters, schedule=args.schedule)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=5,
                           total_steps=args.steps)
    topo = Topology(G, clusters)
    failure = (NO_FAILURE if args.fail_epoch < 0 else
               FailureSpec(epoch=args.fail_epoch, kind=args.fail_kind))

    step_fn = D.make_train_step(cfg, tolfl, ocfg, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(args.seed)
    state = D.init_state(gen, cfg, ocfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed,
                         num_groups=G)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir and lead \
        else None
    losses, n_eff, step_s = [], [], []
    t0 = time.time()
    for step, host_batch in enumerate(pipe.batches(args.steps)):
        ts = time.time()
        alive = alive_mask(failure, topo, step, device=mesh.device)
        batch = shard_batch(host_batch, mesh)
        state, metrics = step_fn(state, batch, alive)
        loss = float(metrics["loss"])           # waits for the step
        step_s.append(time.time() - ts)
        losses.append(loss)
        extras = ""
        if "n_effective" in metrics:
            n_eff.append(float(metrics["n_effective"]))
            extras = f" n_eff={n_eff[-1]:.0f}"
        if lead:
            log(f"step {step:4d} loss {loss:8.4f}{extras} "
                f"({time.time()-t0:5.1f}s)")
        if ckpt and (step + 1) % 10 == 0:
            ckpt.save({"params": state["params"], "step": state["step"]},
                      step + 1)
    if lead:
        log(f"done: {args.steps} steps in {time.time()-t0:.1f}s")
    return {"losses": losses, "n_eff": n_eff, "state": state, "mesh": mesh,
            "step_s": step_s, "config": cfg}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
