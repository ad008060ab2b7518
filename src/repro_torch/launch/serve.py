"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``.

Port of ``repro.launch.serve``: random params from ``--seed``, a
synthetic prompt batch (with whisper's frames or InternVL2's patch
prefix), one batched prefill, then greedy decode of ``--tokens``
tokens; decode positions count a vision prefix.  Reports prefill latency and per-token decode
latency with the device's name.  Runs on the card (``--device cuda``,
the default; it raises without one) or on the CPU (``--device cpu``).
No mesh: one device.  The greedy tokens stay on the device during the
decode loop, which never waits on the card; the loop's time is taken
from the host clock around work that ends in a synchronise.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.serving.decode import decode_step, pad_cache, prefill
from repro_torch.serving.inputs import synthetic_batch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b",
                    choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the params and the synthetic prompt "
                         "batch (equal seeds reproduce both exactly)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = T.init_params(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, dev)
    batch = synthetic_batch(
        cfg, args.batch, args.prompt,
        torch.Generator(device=dev).manual_seed(args.seed + 1), dev)
    print(f"arch={cfg.name} params={P.param_count(params) / 1e6:.1f}M "
          f"batch={args.batch} prompt={args.prompt} gen={args.tokens} "
          f"device={device_name(dev)}")

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, batch)
    _sync(dev)
    print(f"prefill: {(time.perf_counter() - t0) * 1000:.1f} ms "
          f"({args.batch * args.prompt} tokens)")

    # a vision prefix's patches take the first positions
    base = args.prompt + (batch["prefix"].shape[1] if "prefix" in batch
                          else 0)
    cache = pad_cache(cache, cfg, prompt_len=base,
                      target_len=base + args.tokens)
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.tokens - 1):
        logits, cache = decode_step(params, cfg, tok, cache, base + i)
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"decode: {dt / max(args.tokens - 1, 1) * 1000:.1f} ms/token "
          f"({args.tokens - 1} steps)")
    gen = torch.cat(out, dim=1)
    print(f"sample[0]: {gen[0, :12].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
