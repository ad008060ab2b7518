"""Serving example: batched prefill + decode against a KV cache.

The port's twin of ``examples/serve_batch.py``: prefill a batch of
prompts, extend the cache, then stream tokens with one-token
``decode_step`` calls — for a dense, an SSM, a hybrid and an
encoder-decoder architecture (reduced configs, so it runs in seconds),
on the card (``--device cpu`` for the CPU).  ``--arch`` serves one id of
the registry instead; a vision prefix's patches count in the decode
positions.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batch [--tokens 16]
      PYTHONPATH=src python -m repro_torch.examples.serve_batch --arch granite-3-2b
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS
from repro_torch.models import transformer as T
from repro_torch.serving.decode import decode_step, pad_cache, prefill
from repro_torch.serving.inputs import synthetic_batch

#: the archs ``repro``'s example serves
DEFAULT_ARCHS = ("qwen3-8b", "rwkv6-7b", "recurrentgemma-9b",
                 "whisper-large-v3")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch_size: int, prompt_len: int, gen_tokens: int,
          seed: int = 0, device="cuda") -> torch.Tensor:
    """Greedy tokens (batch_size, gen_tokens) of the reduced ``arch``
    from params drawn with seed 0 and a prompt batch drawn with
    ``seed``."""
    dev = resolve_device(device)
    cfg = ARCHS[arch].reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, dev)

    # --- prefill: process the whole prompt batch in one shot ---
    _sync(dev)
    t0 = time.time()
    batch = synthetic_batch(cfg, batch_size, prompt_len,
                            torch.Generator().manual_seed(seed), dev)
    logits, cache = prefill(params, cfg, batch)
    base = prompt_len + (batch["prefix"].shape[1] if "prefix" in batch
                         else 0)
    cache = pad_cache(cache, cfg, prompt_len=base,
                      target_len=base + gen_tokens)
    _sync(dev)
    t_prefill = time.time() - t0

    # --- decode: greedy, one token per step, O(1) cache update ---
    tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
    out = [tok]
    t0 = time.time()
    for i in range(gen_tokens - 1):
        logits, cache = decode_step(params, cfg, tok, cache, base + i)
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.time() - t0

    gen = torch.cat(out, dim=1)
    per_tok = t_decode / max(gen_tokens - 1, 1) * 1000
    print(f"{arch:<28} prefill {t_prefill * 1000:7.1f} ms   "
          f"decode {per_tok:6.1f} ms/tok   sample: {gen[0, :8].tolist()}")
    return gen


def main(argv=None):
    """Serve each arch; returns {arch: greedy tokens}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic prompt batch "
                         "(equal seeds reproduce latency inputs exactly)")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None,
                    help="serve this arch only (default: "
                         + ", ".join(DEFAULT_ARCHS) + ")")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale: batch 2, 16-token prompts, 4 "
                         "tokens")
    args = ap.parse_args(argv)
    if args.smoke:
        args.batch, args.prompt, args.tokens = 2, 16, 4

    print(f"batched serving: batch={args.batch} prompt={args.prompt} "
          f"generate={args.tokens} seed={args.seed}\n")
    archs = (args.arch,) if args.arch else DEFAULT_ARCHS
    out = {arch: serve(arch, args.batch, args.prompt, args.tokens,
                       seed=args.seed, device=args.device) for arch in archs}
    print("\n(reduced configs; the full-size path is chip_smoke.py's "
          "[serve] phases)")
    return out


if __name__ == "__main__":
    main()
