"""Production-mesh dry-run.

Port of ``repro.launch.dryrun``.  For every (architecture x input shape)
combination it runs the port's own step (the train step with its
backward, optimizer and Tol-FL collectives for train_4k, prefill for
prefill_32k, one decode step for decode_32k and long_500k) on ``meta``
tensors laid out as DTensors over the production mesh: 16x16
single-pod and 2x16x16 multi-pod.  The world is a fake process group of
256 or 512 ranks in this process (collectives return at once, nothing
is allocated); this process plays rank 0 (data 0, model 0: the head of
the ring's first cluster).

Each JSON record keeps ``repro``'s keys where they mean the same thing:
``roofline`` is the analytic model (``analysis.costmodel``) with the H100
datasheet's constants; ``roofline_trace`` reads the step's dispatch
trace: global flops from ``FlopCounterMode`` (a DTensor op counts at its
global shapes: in the train step those of the rank's model column,
which computes its group's rows, times the groups; the hand-written
kernels' own work is opaque there and not counted), this rank's collective bytes by kind
(``analysis.roofline.CollectiveCounter``), and its bytes of state
(``state_bytes``: params and optimizer state, or params and cache) and
batch held as local shards.  ``repro``'s ``memory_analysis`` and raw-HLO
fields have no twin: ``t_trace``, ``trace_flops``, ``coll_calls``,
``state_bytes`` and ``batch_bytes`` stand in their place.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch qwen3-8b] [--shape train_4k] [--mesh single|multi|both] \\
        [--schedule ring|psum|auto] [--out results/dryrun] [--reduced]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import costmodel as CM
from repro_torch.analysis.roofline import (CollectiveCounter, Roofline,
                                           build_roofline, model_flops_for)
from repro_torch.configs import (ARCHS, ASSIGNED, INPUT_SHAPES,
                                 OptimizerConfig, TolFLConfig)
from repro_torch.core import distributed as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.serving.decode import decode_step, prefill
from repro_torch.sharding import logical as L

# archs that must store params FSDP-sharded over the data axis (100B+ or
# >16GB/chip replicated) -> weighted-psum schedule
FSDP_ARCHS = {"llama4-maverick-400b-a17b", "llama4-scout-17b-a16e",
              "internvl2-26b"}
# optimizer-moment dtype override for the giants (memory budget)
BF16_STATE_ARCHS = {"llama4-maverick-400b-a17b", "llama4-scout-17b-a16e"}

# long_500k is skipped for pure full-attention archs: whisper (enc-dec
# full attention) and internvl2 (full-attention VLM).
LONG_SKIP = {"whisper-large-v3", "internvl2-26b"}

MESHES = {"pod16x16": False, "2pod16x16": True}


def pick_schedule(arch: str, requested: str) -> str:
    if requested == "ring":
        return "tolfl_ring"
    if requested == "psum":
        return "tolfl_psum"
    return "tolfl_psum" if arch in FSDP_ARCHS else "tolfl_ring"


def rules_for_arch(arch: str) -> dict:
    return L.rules_for("fsdp" if arch in FSDP_ARCHS else "replicated_data")


def _local_bytes(tree) -> int:
    """Bytes of a tree's local shards (a plain tensor's own)."""
    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            total += t.numel() * t.element_size()
        return x
    D.map_state(add, tree)
    return total


def fake_world(world_size: int, rank: int = 0) -> None:
    """This process as ``rank`` of a fake process group of
    ``world_size`` ranks (replacing any world it was in)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def dryrun_one(arch: str, shape_name: str, mesh, mesh_name: str,
               schedule: str = "auto", verbose: bool = True,
               clusters: int = 4, grad_sync_dtype: Optional[str] = None,
               microbatches: int = 1,
               param_cast_dtype: Optional[str] = None,
               reduced: bool = False) -> dict:
    cfg = ARCHS[arch].reduced() if reduced else ARCHS[arch]
    shape = INPUT_SHAPES[shape_name]
    rules = rules_for_arch(arch)
    chips = mesh.size
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": chips, "mode": shape.mode}

    if shape_name == "long_500k" and arch in LONG_SKIP:
        rec["status"] = "skipped"
        rec["reason"] = "pure full-attention arch"
        return rec

    t0 = time.time()
    coll, flops = CollectiveCounter(), FlopCounterMode(display=False)
    with L.activate_mesh(mesh, rules):
        if shape.mode == "train":
            sched = pick_schedule(arch, schedule)
            rec["schedule"] = sched
            rec["perf_knobs"] = {"clusters": clusters,
                                 "grad_sync_dtype": grad_sync_dtype,
                                 "microbatches": microbatches,
                                 "param_cast_dtype": param_cast_dtype}
            tolfl = TolFLConfig(num_clusters=clusters, schedule=sched,
                                grad_sync_dtype=grad_sync_dtype,
                                microbatches=microbatches,
                                param_cast_dtype=param_cast_dtype)
            ocfg = OptimizerConfig()
            sdt = "bfloat16" if arch in BF16_STATE_ARCHS else None
            step = D.make_train_step(cfg, tolfl, ocfg, mesh,
                                     state_dtype=sdt)
            state = SP.state_specs(cfg, ocfg, mesh, rules)
            batch = SP.train_batch_specs(cfg, shape, mesh, rules)
            with coll, flops:
                step(state, batch, SP.alive_spec(mesh))
        elif shape.mode == "prefill":
            batch = SP.prefill_specs(cfg, shape, mesh, rules)
            state = SP.params_specs(cfg, mesh, rules)
            with coll, flops, implicit_replication(), torch.no_grad():
                prefill(state, cfg, batch)
        else:  # decode
            long_ctx = shape_name == "long_500k"
            dspec = SP.decode_specs(cfg, shape, mesh, rules,
                                    long_context=long_ctx)
            params = SP.params_specs(cfg, mesh, rules)
            state = {"params": params, "cache": dspec["cache"]}
            batch = {"tokens": dspec["tokens"]}
            with coll, flops, implicit_replication(), torch.no_grad():
                decode_step(params, cfg, dspec["tokens"], dspec["cache"],
                            shape.seq_len - 1)
    t_trace = time.time() - t0
    state_bytes, batch_bytes = _local_bytes(state), _local_bytes(batch)
    mflops = model_flops_for(cfg, shape, shape.mode)
    # the train step's DTensors span a model column: its group's rows
    glob = flops.get_total_flops() * (mesh.num_groups
                                      if shape.mode == "train" else 1)
    rl_trace = build_roofline(arch, shape_name, mesh_name, chips,
                              glob, coll.bytes, mflops,
                              memory_per_device=state_bytes + batch_bytes)
    # analytic roofline (the table's)
    sizes = L.mesh_axis_sizes(mesh)
    cb = CM.step_costs(
        cfg, shape, chips, model_shards=sizes.get("model", 1),
        data_shards=sizes.get("data", 1),
        schedule=rec.get("schedule", "tolfl_ring"),
        num_clusters=clusters, pods=sizes.get("pod", 1),
        long_ctx=(shape_name == "long_500k"), fsdp=arch in FSDP_ARCHS,
        grad_sync_dtype=grad_sync_dtype, microbatches=microbatches,
        param_cast_dtype=param_cast_dtype)
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_chip=cb.flops, bytes_per_chip=cb.hbm_bytes,
        coll_bytes_per_chip=cb.coll_bytes,
        coll_breakdown=dict(coll.bytes), model_flops=mflops,
        memory_per_device=state_bytes + batch_bytes)
    rec.update(status="ok", t_trace=round(t_trace, 1), roofline=rl.to_dict(),
               roofline_trace=rl_trace.to_dict(),
               trace_flops=glob,
               coll_calls=dict(coll.calls), state_bytes=state_bytes,
               batch_bytes=batch_bytes)
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] OK "
              f"trace={t_trace:.1f}s")
        print(f"  trace: flops(global)={rec['trace_flops']:.3e} "
              f"state_bytes/rank={state_bytes:.3e} "
              f"batch_bytes/rank={batch_bytes:.3e}")
        print(f"  trace collectives/rank: "
              f"{ {k: v for k, v in coll.bytes.items() if v} }")
        print(f"  roofline(analytic, H100 datasheet): "
              f"comp={rl.t_compute:.3e}s mem={rl.t_memory:.3e}s "
              f"coll={rl.t_collective:.3e}s -> {rl.bottleneck}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED),
                    help="default: all assigned archs")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--schedule", default="auto",
                    choices=["auto", "ring", "psum"])
    ap.add_argument("--out", default="results/dryrun")
    # perf-iteration knobs
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--grad-dtype", default=None,
                    choices=[None, "bfloat16"], dest="grad_dtype")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--param-cast", default=None,
                    choices=[None, "bfloat16"], dest="param_cast")
    ap.add_argument("--tag", default="",
                    help="suffix for the output JSON (perf variants)")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced() variant (the CPU smoke "
                         "size) instead of its published width")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [name for name, multi in MESHES.items()
              if args.mesh == "both" or (args.mesh == "multi") == multi]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mesh_name in meshes:
        multi = MESHES[mesh_name]
        fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{mesh_name}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = dryrun_one(arch, shape, mesh, mesh_name,
                                     args.schedule,
                                     clusters=args.clusters,
                                     grad_sync_dtype=args.grad_dtype,
                                     microbatches=args.microbatches,
                                     param_cast_dtype=args.param_cast,
                                     reduced=args.reduced)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e)}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"dry-run complete; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
