"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc`` into
``build/repro_torch/``, then:

1. prints the card's name and power limit and the build's compiler log;
2. holds every kernel against its plain PyTorch version on the card at
   the main paths' shapes: the combine, the fused round aggregation (its
   cases shared with tests/test_torch_cuda.py, 64 scenarios among them)
   and the RG-LRU scan bit for bit,
   flash attention within 2e-4 in float32 (the split-TF32 kernel) and
   2e-2 in bfloat16 (the tensor-core kernel; at the four dense decoders'
   and slice 13's prefill shapes each row's largest |diff| within
   ``ATTN_ROW_TOL`` of its RMS), the RWKV6 WKV scan within 1e-4, and the
   score path's row-stable product within its two-order error bound, each
   row alone bit for bit as in the batch;
3. drives slice 1's main path, the Tol-FL simulator (``run_simulation``), at
   the paper's full width and data scale: Comms-ML (12,000 x 112), 10
   devices in 5 clusters, the paper autoencoder (P = 49,680), 100 rounds
   with dropout; Tol-FL without failure, Tol-FL with a head failure and
   FL with a server failure.  Each kernel's launch counter is set to 0
   just before and read just after; every run must launch the fused
   round kernel once per round and the standalone combine never.  A
   dropout-free Tol-FL pair at lr 1e-4 (a monotone descent),
   ``combine="streaming"`` and ``"direct"``,
   must give the same loss curve (rtol 1e-4), the direct one without
   launching either kernel.  The round loop also runs under PyTorch's
   sync debug mode, which raises on any host sync; 10-round runs under
   torch.profiler give the device's busy share and kernels a round, with
   the fused aggregation and with the unfused eager sequence in its place;
   small dropout-free runs on the card must agree with the same runs on
   the CPU (FL at lr 1e-3 up to the round where both diverge);
   then Monte-Carlo campaigns over the same data (``core/campaign.py``):
   16 sampled failure traces x 4 seeds in one round loop of 64 scenarios,
   the same grid in chunks of 16, a fused (scheme x k) sweep of 128
   scenarios and the grid at 1 and 8 scenarios, each launching the fused
   kernel once a round per chunk ([campaign]: scenarios/s, ms/round); the
   batched loop under the sync debug mode ([campaign-no-sync]); 10 rounds
   at 64 scenarios under torch.profiler ([campaign-profile]); and
   dropout-free campaigns against ``run_simulation`` on the card and a
   small campaign on the card against the CPU ([campaign-reference]);
   then the clustered-FL baselines' multi-model campaigns
   (``core/baselines.py``) over the same data and traces: a fused
   ``sweep_grid`` of (fedgroup, 3), (ifca, 3), (fesem, 3) and (ifca, 2)
   x seeds 0-1, three round loops (FedGroup at S = 32, IFCA at S = 64
   with its M = 2 cell padded to M = 3, FeSEM at S = 32; scenarios/s and
   ms/round per loop, every ported kernel's launch counter 0, every curve
   finite: [multi-campaign]); each scheme's loop at S = 8 under the sync
   debug mode ([multi-no-sync]); IFCA at S = 64 for 10 rounds under
   torch.profiler ([multi-profile]); and a small dropout-free grid on
   the card against the CPU (curves within 1e-5 relative, assignments
   equal) and fused against per-cell on the card ([multi-reference]);
   then the anomaly-scoring service (``serving/anomaly``) over the same
   data: a model bank trained at the paper's scale (the global model and
   the 10 isolated ones, 100 rounds each with dropout), which must launch
   the fused round kernel 200 times and whose rows must equal the two
   exports bit for bit ([anomaly-bank]); the service with 32-row windows
   of the test set, buckets 1/8/64 (one CUDA graph each), 64 windows a
   tick for 24 ticks, clean and under an iid, a Markov-churn and a
   cluster-cascade failure process: windows/s, p50/p99, batches a
   bucket, failovers and failbacks, 0 dropped, the cascade failing over
   with every isolated-served window bit for bit its isolated model
   scored directly at the same bucket shape, beside ``direct_bs64`` (one
   graph replay of a full bucket), and every window alone, at the head of
   a padded 8-bucket and inside a full 64-bucket, rows 0 and 1, bit for
   bit ([anomaly-serve]); ``direct_bs64`` and the clean run with cuBLAS's
   products in the score path, then the row-stable kernel's, in one call
   ([anomaly-turns]); a warm service that
   captures nothing, allocates nothing and never syncs while it
   dispatches, and a second service resolving every bucket from memory
   ([anomaly-warm]); 8 ticks of each run under torch.profiler, the
   products' launches a tick counted from the kernel events, and a
   host-clock split of a tick ([anomaly-profile]); a small bank and
   service on the card against the CPU ([anomaly-reference]); the same
   bank, serve and profile phases over a SeqDetector bank at lr 1e-4,
   each bucket's graph holding the scan kernel and replaying the eager
   core bit for bit, the scan's launches a tick ([seq-anomaly-*]);
   then the sequence detector and the experiment pipeline (slice 10): the
   RG-LRU scan at SeqDetector's campaign shape (720,000, 7, 16) and its
   backward kernel there and at the serving shape, bit for bit against
   their plain versions ([kernel]); ``run_simulation`` with SeqDetector
   (P = 1,888) at the paper's scale, tolfl k = 5, 100 rounds at lr 1e-4,
   which must launch the scan forward twice, its backward once and the
   fused round kernel once a round ([seq-slice]), and 5 rounds of tolfl
   and fl under the sync debug mode ([seq-no-sync]); the spec of tolfl
   k = 5, fl and IFCA M = 3 under no failure, a server death at round 20
   and sampled rates 0.1 and 0.3, seeds enough for 64 scenarios in the
   fused tolfl bucket, through ``plan`` (its ``describe()`` printed) and
   ``execute``, with SeqDetector at lr 1e-4 and then with the paper
   autoencoder at the paper's lr 1e-3, where a few of its single-model
   scenarios diverge (listed by cell, trace, seed and round):
   scenarios/s and ms/round a bucket, peak device memory, each bucket's
   launches, and the tolfl bucket's device busy share and device time
   by operator under torch.profiler ([experiment]); and small SeqDetector
   and autoencoder experiments on the card against the CPU, the latter at
   lr 1e-3 through its divergences ([experiment-reference]); the same
   spec at 10 rounds with ``ExecPlan(aot=True)`` in two fresh processes
   sharing a new ``REPRO_CACHE_DIR``: the first must build every
   ``csrc/*.cu`` with nvcc (every bucket "compiled"), the second none
   (every bucket "disk"), a repeat reads "memory", and the curves and
   AUROCs must be the same bits with ``aot`` on and off in both
   processes ([aot]: nvcc and load seconds, warm-up and execute seconds
   a bucket); ``plan(spec, check=True)`` on the full spec, one round a
   bucket on the meta device, with zero findings and each bucket's aten
   ops against its budget ([plancheck]); the port's
   four example scripts with ``--smoke`` on the card ([examples]);
4. drives slice 2's main path, RecurrentGemma-9B serving
   (``prefill``, ``pad_cache``, greedy ``decode_step``), at full width
   and depth: random params on the card, 4 prompts of 4,096 tokens (past
   the 2,048 window), 32 greedy tokens.  A prefill must launch the
   attention kernel 12 times and the scan 26 times, a decode step
   neither; the decode loop runs under the sync debug mode.  Then, with
   the same params in float32 at batch 1, a decode step at position S
   must match a prefill of S + 1 tokens; one prefill and 8 decode steps
   run under torch.profiler; and the reduced config on the card must
   agree with the same calls on the CPU;
5. frees those params and drives slice 3's main path, RWKV6-7B serving,
   the same way ([rwkv-serve] and the phases after it): 32 RWKV6 layers,
   d 4,096, 64 heads of 64, untied head, 4 prompts of 4,096 tokens, 32
   greedy tokens.  A prefill and every decode step must launch the WKV
   kernel once per layer and no other kernel; then slice 11's four dense
   GQA decoders the same way ([granite-serve], [internlm2-serve],
   [qwen1.5-serve], [qwen3-serve] and their phases): a prefill launches
   the tensor-core attention once a layer (40, 24, 24, 36), each on its
   warp-specialized kernel (D 64 and 128; ``WS_LAUNCHES``), a decode step
   no kernel; then slice 13's whisper-large-v3 at full width and depth
   ([whisper-serve]: 32 encoder layers over 4 x 1,500 frames, 32 decoder
   layers over 416-token prompts, 96 tensor-core attention launches a
   prefill: encoder, self and cross), Llama-4 Scout at full width cut to
   4 layers ([scout-serve]: 16 experts top-1 at capacity 1.25 and a
   shared expert; [scout-serve-consistency] at capacity 16, in float32
   and in bf16), InternVL2-26B at full width cut to 24 layers
   ([internvl2-serve]: 256 patches before each 4,096-token prompt) and
   Llama-4 Maverick at full width cut to 2 layers in bf16 params
   ([maverick-serve]: 128 experts, 37.1 GB; its consistency in bf16
   activations at capacity 128), each with its phases, the reduced
   Maverick card vs CPU in float32 and in bf16 params; then
   [bf16-params]: Scout at full width, 2 layers, its float32 params cast
   to bf16 against float32 params holding the same rounded values, a
   4 x 4,096 prefill, pad_cache and 4 decode steps on each, the logits,
   every cache leaf and the launches equal;
6. drives slice 14's main path, training: the attention's and the WKV
   scan's backward kernels against their plain backwards
   ([kernel] flash_attention_bwd over masks, GQA groups 1-6, D 32-256,
   Sq != Sk, ragged tiles, rows with no key, float32 and bf16 at D = 32
   on the split-TF32 route, bf16 at D 64, 128 and 256 on the tensor-core
   one, each twice bit for bit, reading the lse of the forward's lse
   entry point (the split-TF32 or the tensor-core one), which must match
   the serving one and the plain lse;
   [kernel] rwkv6_scan_bwd with a state0, a final-state gradient and S off
   the sub-chunk and the checkpoint stride, at every head size and
   [train-families]' shape, twice bit for bit); ``launch/train``'s loop
   at qwen1.5-0.5b full width and depth, 10 Adam steps of the ring
   schedule on 8 x 1,024
   tokens, the loss falling and every kernel's launches as the config
   says (forward twice a step under remat, backward once, on the tensor
   cores), then a server
   failure at step 5 ([train]); the same at bf16 params, its step-1 loss
   bit for bit that of float32 params holding the same values, a step
   under the failure exactly Adam's update of zeros in bf16 and one step
   under the sync debug mode ([train-bf16], [train-bf16-no-sync]); two
   steps of RWKV6-7B cut to 2 layers and RecurrentGemma-9B cut to one
   unit at full width, its local attention's backward on the tensor
   cores at D = 256, the second step timed warm (with --parent the same
   two RecurrentGemma steps again on the parent's tensor-core backward:
   the step-1 loss bit for bit, the step-2 loss within 0.1%)
   ([train-families]); two
   steps of Qwen3-8B at published width, cut to 8 of 36 layers, at bf16
   params with Adam, every layer's attention and MLP moved
   ([train-bf16-8b]);
   two steps under the sync debug mode ([train-no-sync]); one step, and
   the WKV backward's two kernels at RWKV6-7B's shape, under
   torch.profiler ([train-profile]); every arch's reduced config card vs
   CPU over 2 SGD steps in float32, the attention's backward on the
   split-TF32 route ([train-reference]); a checkpoint at step 5
   resumed to step 10 bit for bit ([train-ckpt]); ``train_100m`` at
   12 x 768 for 5 steps ([examples]);
7. times each kernel, its plain version and one library call with CUDA
   events, beside the least time the card could take; attention's two
   kernels, its plain version and SDPA in turns in one run; the WKV scan
   also at a decode step's shape; the fused round at S = 1 in turns with
   the unfused eager sequence (16 launches), beside an empty kernel's device
   time, and at the campaign's shapes (S = 64; S = 96 at k = 10) against
   its bound; the RG-LRU scan and its backward at SeqDetector's shape
   and at RecurrentGemma-9B's training shape (bit for bit there, -0
   included);
   the row-stable product at the service's products beside ``addmm``
   and an empty kernel's launch floor;
   the tensor-core attention at each dense decoder's prefill shape and at
   whisper's (encoder, cross, self), Scout's and InternVL2's beside SDPA
   (``enable_gqa``); the float32 route, the split-TF32 attention
   forward, at [serve-consistency]'s shape and, through its lse entry
   point, at [train]'s heads in float32, beside SDPA on float32 inputs; the
   backward kernels at their training shapes
   beside the plain backwards and SDPA's backward: the tensor-core
   attention backward at [train]'s and internlm2's head shapes, at
   RecurrentGemma's local attention (D = 256, each of its four kernels'
   device time under torch.profiler) and at Qwen3-8B's
   (1, 2,048, 32, 8, 128), with the serving forward
   beside the lse entry point, the split-TF32
   backward on float32 inputs at RecurrentGemma's and [train]'s shapes
   beside SDPA's float32 backward (its kernels named under
   torch.profiler), and the WKV
   backward at RWKV6-7B's training shape with each of its two kernels'
   device time under torch.profiler.

    python3 chip_smoke.py --parent DIR

also builds the row-stable product, combine, RG-LRU, WKV, both attention
forward and both attention backward kernels of another commit's
checkout in DIR (e.g. ``git archive`` of the parent, unpacked under the
ignored ``build/``) whose source or included headers differ from the
current ones and whose C entry points are declared as the current ones,
and times them in turns with the current ones; the eager sequence then
runs the parent's combine.  The row-stable product must give the
parent's bits at every service product and the ragged shapes of
[kernel] row_dense, and beat the parent at both its [times] shapes; the
float32 attention forward must lie within 2e-4 of the parent's output
and beat it at both its [times] shapes.  The tensor-core attention
forward must beat the parent's at the six 4,096-token prefills, and may lose to it at
whisper's and RecurrentGemma's shapes and, through its lse entry point,
at the training shapes of [times]' backward rows by no more than the
spread of the turns' medians; RecurrentGemma's output is compared with
the parent's bit for bit (logged).  The tensor-core attention backward
must beat the parent's at RecurrentGemma's shape (D = 256, each tree's
kernels named with their device times under torch.profiler); at [train]'s,
internlm2's and Qwen3-8B's shapes (D 64 / 128) its dq, dk and dv must be
the parent's bit for bit and it may not lose to the parent by more than
the turns' spread.  The float32 attention backward must
beat the parent's at both its [times] shapes, or, where its dq, dk and
dv are bitwise the parent's, not lose to it by more than the turns'
spread.  The RG-LRU backward must beat the parent's at RecurrentGemma's
training shape (the few-chains kernel), and neither RG-LRU direction
may lose to the parent's by more than that spread at the serving,
SeqDetector and training shapes.  A WKV kernel
must beat the parent's where its own source changed, and where only a
shared header did, not lose to it by more than that spread.  The build's
compiler log gives the registers and spill bytes of the attention
kernels (the tensor-core forward at D = 256 and its warp-specialized one
at D 64 and 128, the split-TF32 forward, both backwards), of the
row-stable product and of the
scans; any spill fails the run.

The mesh engine's model axis (``repro_torch.sharding``): [mesh1-train]
takes three [train] steps under ``activate_mesh`` of a (1, 1) mesh (the
batch a DTensor, every constraint the identity) and holds their losses
bitwise to the same steps without a mesh, the kernels' launches to the
config's count in both, steps 2 and 3 under the sync debug mode; one card
cannot host two NCCL ranks, so a model axis > 1 runs over gloo in the CPU
tests.  [dryrun] runs ``python -m repro_torch.launch.dryrun`` at full
width on the 16x16 mesh (a fake process group of 256 ranks, meta
tensors) for qwen3-8b and Llama-4 Scout train_4k, RWKV6-7B decode_32k
and RecurrentGemma-9B long_500k, one process each, and prints each
record's analytic roofline terms, traced collective bytes and per-rank
state bytes; a record that is not ok fails the run.

Scenario sharding (``ExecPlan(shard=True)``, ``scenario_shard_map``):
[shard-campaign] points the shard devices' one source
(``campaign._local_devices``) at two shards on the one card and runs, at
the paper's width for ``SHARD_ROUNDS`` rounds, a Tol-FL campaign of 64
scenarios, an FL one of 32, the fused (scheme x k) sweep, a FedGroup grid
with an M = 2 cell padded to 3 and a SeqDetector campaign, each with
``chunk_size=32`` and held bit for bit (dropout on) against the unsharded
run at chunk 16; each shard's fused-round and scan launches are counted
by its thread, the round loops run under the sync debug mode, and both
wall times are logged.  ``ExecPlan(shard=True)`` with the real device
count must warn once and give the unsharded bits on one card; with
several cards the Tol-FL campaign runs over them, bit for bit too.

A [clock] line near the end lists each phase's wall seconds, largest
first (each served arch's phases together).  It imports nothing of JAX
or of the JAX package.  It exits non-zero without a CUDA device, outside
a checkout, or if any phase fails; on success its last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
#: float32 (non-tensor-core) flop/s
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12     # dense, tensor cores
H100_TF32_FLOPS = 495e12     # dense, tensor cores
COMBINE_SHAPES = [(5, 49_680), (1, 49_680), (10, 49_680), (5, 1_000_003)]
ROUNDS = 100
PAIR_LR = 1e-4         # the streaming / direct pair's lr: a monotone descent
FAIL_EPOCH = 5         # head / server failure round of the failure runs
SAMPLES = 200          # CUDA-event timings per function
#: the campaign phases' grid: 16 traces sampled at failure rate 0.3 for the
#: paper's topology x 4 seeds = 64 scenarios in one chunk, chunks of 16 for
#: the chunked run, and a fused (scheme x k) sweep over the same traces x 2
#: seeds (96 sbt/tolfl scenarios at k_pad 10, 32 fl scenarios)
CAMPAIGN_TRACES, CAMPAIGN_RATE, CAMPAIGN_EVENTS = 16, 0.3, 8
CAMPAIGN_SEEDS = (0, 1, 2, 3)
CAMPAIGN_CHUNK = 16
SWEEP_CELLS = (("tolfl", 5), ("tolfl", 2), ("fl", 1), ("sbt", 10))
SWEEP_SEEDS = (0, 1)
#: the multi-model phases: the Tables III-V baseline columns at M =
#: min(clusters, 3) and an IFCA cell of M = 2 padded into the M = 3 loop,
#: over the campaign's traces x 2 seeds
MULTI_CELLS = (("fedgroup", 3), ("ifca", 3), ("fesem", 3), ("ifca", 2))
MULTI_SEEDS = (0, 1)
SPIN_CYCLES = 5_000_000   # ~2.5 ms of the card's clock: covers the host's
#                           dispatch of the slowest timed call (~1 ms)
DEV = "cuda"               # the serving phases' device
#: the serving archs, each with the prefix of its phases' log tags
SERVE_ARCHS = (("recurrentgemma-9b", ""), ("rwkv6-7b", "rwkv-"),
               ("granite-3-2b", "granite-"), ("internlm2-1.8b", "internlm2-"),
               ("qwen1.5-0.5b", "qwen1.5-"), ("qwen3-8b", "qwen3-"),
               ("whisper-large-v3", "whisper-"),
               ("llama4-scout-17b-a16e", "scout-"),
               ("internvl2-26b", "internvl2-"),
               ("llama4-maverick-400b-a17b", "maverick-"))
#: depth cuts of served archs whose params do not fit the card at full
#: depth (Scout: 8.28 GB of float32 embedding and head + 8.81 GB a layer,
#: 48 layers; InternVL2: 4.56 GB + 1.57 GB a layer, 48 layers; Maverick in
#: bf16: 4.14 GB + 32.5 GB an (MoE, dense) unit, 24 units); full width
SERVE_DEPTH = {"llama4-scout-17b-a16e": 4, "internvl2-26b": 24,
               "llama4-maverick-400b-a17b": 2}
#: the param dtypes of served archs whose params are not float32
#: (``ModelConfig.param_dtype``): Maverick's 128 experts take 64.4 GB a
#: MoE layer in float32, so no full-width layer of float32 params fits
SERVE_PARAM_DTYPE = {"llama4-maverick-400b-a17b": "bfloat16"}
#: prompt lengths other than SERVE_PROMPT: whisper's text context is 448
#: tokens, 416 of prompt and SERVE_TOKENS generated
SERVE_PROMPTS = {"whisper-large-v3": 416}
#: MoE archs whose [*serve-consistency] also runs in bf16 activations
#: (Maverick's only: in float32 activations its experts would be cast to a
#: 64.4 GB copy), the largest |diff| within CONSISTENCY_BF16_TOL of the
#: largest |logit|; Scout is the yardstick.  bf16 logits of |x| in [4, 8)
#: are 2^-5 apart, 0.4-0.8% of x: both read one such ulp, 0.0068 and
#: 0.0070 of max |logit| (4.59 and 4.47) on an H100; 0.03 is ~4 ulps, a
#: 4.3x margin
CONSISTENCY_BF16 = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b")
CONSISTENCY_BF16_TOL = 0.03
#: [bf16-params]: the arch, its depth (Scout: 25.9 GB of float32 params
#: beside their 13.0 GB bf16 cast) and the decode steps
BF16_PARAMS = ("llama4-scout-17b-a16e", 2, 4)
#: the dense GQA decoders, whose prefills put the tensor-core attention at
#: D = 64 and 128 (causal, no window)
DECODERS = ("granite-3-2b", "internlm2-1.8b", "qwen1.5-0.5b", "qwen3-8b")
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 4096, 32
SERVE_KERNELS = ("flash_attention", "rglru_scan", "rwkv6_scan")
#: (B, S, H, KVH, D, causal, window): the serving prefill's attention
#: (recurrentgemma-9b: 16 query heads on one kv head of 256, window 2048)
ATTN_CASES = [(4, 4096, 16, 1, 256, True, 2048),
              (1, 4097, 16, 1, 256, True, 2048),   # [serve-consistency]
              (4, 4096, 16, 1, 256, True, 1),
              (4, 4096, 16, 1, 256, False, None)]
#: (B, S, W, h0): the prefill's recurrence (lru_width 4096) and a ragged one
SCAN_CASES = [(4, 4096, 4096, False), (4, 4096, 4096, True),
              (3, 4097, 4000, True), (2, 3, 4096, True),
              (4, 4096, 4097, True)]
#: (B, S, W): SeqDetector's scan in a 64-scenario campaign of the paper's
#: split, (64 * 10 * 1,125, 7, 16)
SEQ_SCAN = (720_000, 7, 16)
#: (B, S, W): the scan backward in [train-families]' RecurrentGemma-9B step
#: (batch 1 x 2,048 tokens, lru_width 4,096)
RG_TRAIN_SCAN = (1, 2048, 4096)
#: the backward's cases: the serving shape and SeqDetector's
SCAN_BWD_CASES = [(4, 4096, 4096, False), (4, 4096, 4096, True),
                  (720_000, 7, 16, False), (5, 33, 40, True)]
#: the experiment phases: [experiment]'s spec (cells, explicit traces, the
#: sampled rates) and the least scenarios of its fused single-model bucket
EXP_CELLS = (("tolfl", 5), ("fl", 1), ("ifca", 3))
EXP_RATES = (0.1, 0.3)
EXP_MIN_SCENARIOS = 64
#: the WKV scan's cases are ``rwkv6_scan.CARD_CASES``, shared with
#: tests/test_torch_cuda.py
WKV_TOL = 1e-4     # rtol = atol: FMA contraction and another order over n
#: the bf16 attention at the dense decoders' shapes: every (b, s, h) row's
#: largest |kernel - plain| over the row's RMS.  A row that sees n keys has
#: an output of RMS ~ sqrt(e / n) (0.026 at n = 4,096), so an absolute
#: slack cannot serve every row; one bf16 ulp of a row's largest element
#: is 2^-7 of it, ~0.03 of the row's RMS
ATTN_ROW_TOL = 0.05
#: a RWKV6-7B decode step's WKV scan, timed beside the prefill's
WKV_DECODE = (4, 1, 64, 64, True, 1)


def log(msg: str) -> None:
    print(msg, flush=True)


#: wall seconds by phase for the [clock] line; a phase run inside another
#: (or inside a ``_clock`` block) counts in the outermost one alone
CLOCK = {}
_CLOCK_DEPTH = [0]


@contextlib.contextmanager
def _clock(name):
    _CLOCK_DEPTH[0] += 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _CLOCK_DEPTH[0] -= 1
        if not _CLOCK_DEPTH[0]:
            CLOCK[name] = CLOCK.get(name, 0.0) + time.perf_counter() - t0


def _clocked(fn):
    """``fn`` (a ``phase_*``) timed into CLOCK under its name."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with _clock(fn.__name__[len("phase_"):]):
            return fn(*args, **kw)
    return run


def log_clock(total_s):
    """The [clock] line: each phase's seconds, largest first, and the rest
    of the run (main's own work between phases)."""
    rest = total_s - sum(CLOCK.values())
    log(f"[clock] {total_s:.1f} s in all; by phase, largest first: "
        + ", ".join(f"{name} {s:.1f}" for name, s in
                    sorted(CLOCK.items(), key=lambda kv: -kv[1]))
        + f"; outside any phase {rest:.1f}")


def _decoder_attn(arch):
    """(B, S, H, KVH, D, causal, window) of a dense decoder's prefill
    attention at the served shape."""
    from repro_torch.configs.registry import get_arch
    a = get_arch(arch).attention
    return (SERVE_BATCH, SERVE_PROMPT, a.num_heads, a.num_kv_heads,
            a.head_dim, True, None)


def _zoo_attn():
    """[(label, archs, (B, Sq, Sk, H, KVH, D, causal))]: the attention
    shapes of the whisper, Scout, InternVL2 and Maverick prefills as
    served, with the archs whose prefills launch each: whisper's encoder
    over its frames, cross-attention (prompt on frames) and causal
    self-attention; Scout's causal self-attention, which Maverick's
    shares, and InternVL2's (over its patches and the prompt)."""
    from repro_torch.configs.registry import get_arch
    out = []
    w = get_arch("whisper-large-v3")
    a, F = w.attention, w.encoder_seq
    S = SERVE_PROMPTS["whisper-large-v3"]
    heads = (a.num_heads, a.num_kv_heads, a.head_dim)
    out += [("whisper-large-v3 encoder", (w.name,),
             (SERVE_BATCH, F, F, *heads, False)),
            ("whisper-large-v3 cross", (w.name,),
             (SERVE_BATCH, S, F, *heads, False)),
            ("whisper-large-v3 self", (w.name,),
             (SERVE_BATCH, S, S, *heads, True))]
    for archs in (("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"),
                  ("internvl2-26b",)):
        shapes = set()
        for arch in archs:
            cfg = get_arch(arch)
            a = cfg.attention
            S = SERVE_PROMPT + cfg.frontend.frontend_seq
            shapes.add((SERVE_BATCH, S, S, a.num_heads, a.num_kv_heads,
                        a.head_dim, True))
        if len(shapes) != 1:
            raise AssertionError(f"{archs} prefill at {shapes}")
        out.append((archs[0], archs, shapes.pop()))
    return out


def _plain_attn(torch, q, k, v, causal, window=None):
    """The attention's plain version on q, k, v, in slices of the batch
    where the whole batch's float32 scores would pass 9 GB (the plain
    version holds a few tensors of them; InternVL2's prefill shape has
    14.5 GB of scores)."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, _ = q.shape
    if B * H * Sq * k.shape[1] * 4 <= 9e9:
        return fa.flash_attention_plain(q, k, v, causal, window)
    return torch.cat([fa.flash_attention_plain(q[b:b + 1], k[b:b + 1],
                                               v[b:b + 1], causal, window)
                      for b in range(B)])


def _clocks():
    """The card's SM clock, power draw and temperature right now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def phase_device(torch, parent=None):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    old = _start_parent_build(parent) if parent else None
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s: {sorted(libs)}")
    for lib in sorted(libs):
        log(f"[build] {lib}: " + " | ".join(
            ln.strip() for ln in _build.build_log(lib).splitlines()
            if ln.strip()))
    for lib, what in (("flash_attention_wgmma", "tensor-core attention"),
                      ("flash_attention", "split-TF32 attention forward"),
                      ("rwkv6_scan", "WKV scan"),
                      ("rglru_scan", "RG-LRU scan"),
                      ("tolfl_combine", "Tol-FL aggregation"),
                      ("row_dense", "row-stable product"),
                      ("flash_attention_bwd", "split-TF32 attention backward"),
                      ("flash_attention_bwd_wgmma",
                       "tensor-core attention backward"),
                      ("rwkv6_scan_bwd", "WKV backward")):
        for fn, regs, spills, warned in _ptxas_summary(_build.build_log(lib)):
            log(f"[build] {what} {fn}: {regs} registers, spill stores/loads "
                f"{spills}" + (f"; {warned}" if warned else ""))
            # the fused kernel's chunked loop (above 16 devices, its second
            # template flag 0) is off the main path; no other instance may
            # spill
            if spills != "0/0" and not re.fullmatch(
                    r"round_update_kernel<[01], 0>", fn):
                raise AssertionError(f"{what} {fn} spills: {spills}")
    if old is not None:
        old = _finish_parent_build(old)
        log(f"[build] the parent's kernels from {parent}: {sorted(old)}")
    return name, smi, old


#: the parent's kernels that --parent builds, with their C entry points'
#: arguments: the symbol, its pointers, its integers and, optionally, how
#: many of those integers at the end are ``long long``; the stream comes
#: last.  A parent whose entry point is declared otherwise than the
#: current one is not built.
PARENT_KERNELS = {"row_dense": ("row_dense_f32", 4, 3),
                  "flash_attention": ("flash_attention_f32", 4, 8),
                  "rglru_scan": ("rglru_scan_f32", 4, 3),
                  "rwkv6_scan": ("rwkv6_scan_f32", 8, 4),
                  "tolfl_combine": ("tolfl_combine_f32", 3, 2, 1),
                  "flash_attention_bwd": ("flash_attention_bwd_f32", 10, 8),
                  "flash_attention_bwd_wgmma": (
                      "flash_attention_bwd_wgmma_bf16", 11, 9),
                  "flash_attention_wgmma": ("flash_attention_wgmma_bf16", 4, 8)}
#: further C entry points of a parent's library, each bound under a key of
#: its own: {kernel: ((key, symbol, pointers, integers), ...)}
PARENT_EXTRA = {"flash_attention_wgmma": (
    ("flash_attention_wgmma_lse", "flash_attention_wgmma_lse_bf16", 5, 8),),
                "flash_attention": (
    ("flash_attention_lse", "flash_attention_lse_f32", 5, 8),),
                "rglru_scan": (("rglru_scan_bwd", "rglru_scan_bwd_f32", 7, 3),)}
#: the parent's kernels whose own source is the current one's (only the
#: shared headers differ): timed against the parent, they need not beat it
PARENT_SAME_SOURCE = set()


def _entry_decl(source: bytes, symbol: str) -> str:
    """The declaration of ``symbol``'s extern "C" entry point in a source,
    whitespace folded ("" if there is none)."""
    m = re.search(rb"extern \"C\" int " + symbol.encode() + rb"\s*\([^)]*\)",
                  source)
    return " ".join(m.group(0).decode().split()) if m else ""


def _included(csrc, path, seen=None):
    """``path`` and the headers of ``csrc`` it includes (``#include
    "name"``), those headers' own included ones too, in order."""
    seen = [] if seen is None else seen
    seen.append(path)
    for name in re.findall(rb'#include "([^"]+)"', path.read_bytes()):
        header = csrc / name.decode()
        if header.is_file() and header not in seen:
            _included(csrc, header, seen)
    return seen


def _start_parent_build(parent):
    """Start one nvcc for each of the parent's kernels (``parent`` holds a
    checkout, e.g. a git archive, of another commit), beside the build of
    the current ones, into ``build/parent/``.  A kernel whose source and
    the headers it includes are the same in both is not built: it has
    nothing to compare; one whose own source is the same but an included
    header differs is built and noted in ``PARENT_SAME_SOURCE``."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    old_csrc = Path(parent) / "src" / "repro_torch" / "csrc"

    def text(csrc, name):
        return b"".join(p.name.encode() + p.read_bytes()
                        for p in _included(csrc, csrc / f"{name}.cu"))
    procs = {}
    for name in PARENT_KERNELS:
        if text(old_csrc, name) == text(_build.CSRC, name):
            log(f"[build] the parent's {name} is the current one: not timed "
                f"against it")
            continue
        symbols = [PARENT_KERNELS[name][0]] + [
            extra[1] for extra in PARENT_EXTRA.get(name, ())]
        src = old_csrc / f"{name}.cu"
        odd = [symbol for symbol in symbols
               if _entry_decl(src.read_bytes(), symbol) != _entry_decl(
                   (_build.CSRC / f"{name}.cu").read_bytes(), symbol)]
        if odd:
            log(f"[build] the parent's {odd} declared otherwise: {name} not "
                f"timed against it")
            continue
        if src.read_bytes() == (_build.CSRC / f"{name}.cu").read_bytes():
            PARENT_SAME_SOURCE.add(name)
            log(f"[build] the parent's {name} has the current source (a "
                f"shared header differs): timed against it, need not beat it")
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _finish_parent_build(procs):
    """{name: C entry point} of the parent's kernels once built."""
    import ctypes
    entries = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{text}")
        dll = ctypes.CDLL(str(lib))
        for key, symbol, n_ptr, n_int, n_long in [
                (name, *(PARENT_KERNELS[name] + (0,))[:4])] + [
                (*extra, 0) for extra in PARENT_EXTRA.get(name, ())]:
            fn = getattr(dll, symbol)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * (n_int - n_long)
                           + [ctypes.c_longlong] * n_long + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            entries[key] = fn
    return entries


def _ptxas_summary(text):
    """(kernel, registers, "stores/loads" spill bytes, warning) per kernel
    entry in an ``nvcc -Xptxas -v`` log; the kernel is named by its
    template arguments (``ILi256E`` -> ``<256>``), or by its name and
    flags (``19round_update_kernelILb1ELb0EE`` -> ``round_update_kernel<1,
    0>``)."""
    out, warned, fn = [], {}, None
    for ln in text.splitlines():
        m = re.search(r"Potential Performance Loss: (.*) for the function "
                      r"'(\S+)'", ln)
        if m:
            warned[m.group(2)] = m.group(1)
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            spills = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            args = re.search(r"(\d+[A-Za-z_]+)I((?:Li\d+E)+)E", fn)
            flags = re.search(r"([A-Za-z_]+)I((?:Lb[01]E)+)E", fn)
            plain = re.search(r"\d([a-z][a-z_]*_kernel)E", fn)
            name = (re.sub(r"^\d+", "", args.group(1)) + "<"
                    + ", ".join(re.findall(r"Li(\d+)E", args.group(2)))
                    + ">" if args else
                    f"{flags.group(1)}<"
                    + ", ".join(re.findall(r"Lb([01])E", flags.group(2)))
                    + ">" if flags else plain.group(1) if plain else fn)
            out.append((name, int(m.group(1)), spills, warned.get(fn, "")))
            fn = None
    return out


def phase_kernels(torch):
    """The two Tol-FL kernels against their plain versions on the card, bit
    for bit; returns each one's max |diff| (0 when they agree)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import tolfl_combine as tc
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(k, p, "random") for k, p in COMBINE_SHAPES]
    cases += [(5, 49_680, "all-zero"), (5, 49_680, "partial-zero"),
              (17, 1_003, "random"), (5, 49_680, "misaligned")]
    worst = {"tolfl_combine": 0.0, "tolfl_round_update": 0.0}
    for k, p, counts in cases:
        gs = torch.randn((k, p + 1), generator=gen, device="cuda")
        # a view one float past the allocation's start: rows not 16-byte
        # aligned, so the kernel takes its scalar loads
        gs = gs.view(-1)[1:k * p + 1].view(k, p) if counts == "misaligned" \
            else gs[:, :p].contiguous()
        ns = torch.randint(1, 2251, (k,), generator=gen,
                           device="cuda").to(torch.float32)
        if counts == "all-zero":
            ns.zero_()
        elif counts == "partial-zero":
            ns[3:] = 0.0          # the paper split's empty clusters
        got = ops.tolfl_combine(gs, ns)
        want = tc.tolfl_combine_plain(gs, ns)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = torch.equal(got, want)
        log(f"[kernel] tolfl_combine k={k} P={p} counts={counts}: "
            f"bitwise_equal={same} max_abs_err={err}")
        if not same:
            raise AssertionError(f"tolfl_combine differs from its plain "
                                 f"version at k={k} P={p} ({counts})")
        worst["tolfl_combine"] = max(worst["tolfl_combine"], err)
    for case in tc.ROUND_CARD_CASES:
        args = tc.round_inputs(case, gen)
        got, got_tot = ops.tolfl_round_update(*args, 1e-3, case.k)
        want, want_tot = tc.tolfl_round_update_plain(*args, 1e-3, case.k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = torch.equal(got, want) and torch.equal(got_tot, want_tot)
        log(f"[kernel] tolfl_round_update {case.name} (S, N, k, P) = "
            f"{(case.S, case.N, case.k, case.P)}: bitwise_equal={same} "
            f"max_abs_err={err}")
        if not same:
            raise AssertionError(f"tolfl_round_update differs from its plain "
                                 f"version on {case}")
        if case.counts == "zero" and not torch.equal(got, args[-1]):
            raise AssertionError("all-zero counts changed the params")
        worst["tolfl_round_update"] = max(worst["tolfl_round_update"], err)
    return worst


def phase_serve_kernels(torch):
    """The serving path's kernels against their plain versions on the
    card; returns the max |diff| of each, and of the attention at each
    dense decoder's prefill shape under "flash_attention <arch>"."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import rwkv6_scan as wk
    gen = torch.Generator(device=DEV).manual_seed(2)
    worst = {"flash_attention": 0.0, "flash_attention f32": 0.0,
             "rglru_scan": 0.0}
    for B, S, H, KVH, D, causal, window in ATTN_CASES:
        shapes = ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))
        base = [torch.randn(sh, generator=gen, device=DEV)
                for sh in shapes]
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (x.to(dtype) for x in base)
            kernel = fa.route(dtype, D)
            tc_before = fa.TC_LAUNCHES
            got = ops.attention(q, k, v, causal=causal, window=window)
            tc_launched = fa.TC_LAUNCHES - tc_before
            want = fa.flash_attention_plain(q, k, v, causal, window)
            torch.cuda.synchronize()
            if tc_launched != (kernel == "tensor_core"):
                raise AssertionError(f"{dtype} at D = {D} did not go to the "
                                     f"{kernel} kernel")
            err = float((got.float() - want.float()).abs().max())
            log(f"[kernel] flash_attention (B, S, H, KVH, D) = "
                f"{(B, S, H, KVH, D)} causal={causal} window={window} "
                f"{str(dtype)[6:]} ({kernel} kernel): max_abs_err={err} "
                f"(tolerance {tol})")
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            if kernel == "tensor_core":     # the kernel of the main path
                worst["flash_attention"] = max(worst["flash_attention"], err)
            else:
                worst["flash_attention f32"] = max(
                    worst["flash_attention f32"], err)
            del got, want
        del base, q, k, v
    for arch in DECODERS:
        B, S, H, KVH, D, causal, _ = _decoder_attn(arch)
        worst[f"flash_attention {arch}"] = _attn_rows_checked(
            torch, arch, (B, S, S, H, KVH, D, causal), gen)
    for label, _, shape in _zoo_attn():
        worst[f"flash_attention {label}"] = _attn_rows_checked(
            torch, label, shape, gen)
    for B, S, W, with_h0 in SCAN_CASES:
        a = torch.sigmoid(torch.randn((B, S, W), generator=gen,
                                      device=DEV))
        b = torch.randn((B, S, W), generator=gen, device=DEV)
        h0 = (torch.randn((B, W), generator=gen, device=DEV)
              if with_h0 else None)
        got = ops.rglru(a, b, h0)
        want = rs.rglru_scan_plain(a, b, h0)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = float((got - want).abs().max())
        log(f"[kernel] rglru_scan (B, S, W) = {(B, S, W)} h0={with_h0}: "
            f"bitwise_equal={same} max_abs_err={err}")
        if not same:
            raise AssertionError(f"rglru_scan differs from its plain version "
                                 f"at {(B, S, W)} h0={with_h0}")
        worst["rglru_scan"] = max(worst["rglru_scan"], err)
    worst["rwkv6_scan"] = 0.0
    for B, S, H, N, with_s0, calls in wk.CARD_CASES:
        r, k, v, w, u, s0 = wk.random_inputs(B, S, H, N, with_s0, gen)
        s0_in = s0.clone()
        y, st = wk.in_calls(ops.rwkv6, calls, r, k, v, w, u, s0)
        y_want, st_want = wk.rwkv6_scan_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        err = max(float((y - y_want).abs().max()),
                  float((st - st_want).abs().max()))
        log(f"[kernel] rwkv6_scan (B, S, H, N) = {(B, S, H, N)} "
            f"state0={with_s0} in {calls} call(s): max_abs_err={err} (y max "
            f"{float(y_want.abs().max())}; tolerance rtol = atol = "
            f"{WKV_TOL})")
        torch.testing.assert_close(y, y_want, rtol=WKV_TOL, atol=WKV_TOL)
        torch.testing.assert_close(st, st_want, rtol=WKV_TOL, atol=WKV_TOL)
        if not torch.equal(s0, s0_in):
            raise AssertionError("rwkv6_scan wrote to its input state")
        worst["rwkv6_scan"] = max(worst["rwkv6_scan"], err)
    return worst


def _attn_rows_checked(torch, label, shape, gen):
    """The tensor-core attention at a served prefill's shape (B, Sq, Sk,
    H, KVH, D, causal; no window) against its plain version: each (b, s,
    h) row's largest |diff| within ATTN_ROW_TOL of the row's RMS.
    Returns the max |diff|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    B, Sq, Sk, H, KVH, D, causal = shape
    q = torch.randn((B, Sq, H, D), generator=gen, device=DEV).bfloat16()
    k, v = (torch.randn((B, Sk, KVH, D), generator=gen,
                        device=DEV).bfloat16() for _ in range(2))
    tc_before, ws_before = fa.TC_LAUNCHES, fa.WS_LAUNCHES
    got = ops.attention(q, k, v, causal=causal, window=None)
    if (fa.TC_LAUNCHES - tc_before, fa.WS_LAUNCHES - ws_before) != (
            1, int(D in fa.WS_HEAD_DIMS)):
        raise AssertionError(f"{label}'s attention did not go to the "
                             f"tensor-core kernel's "
                             f"{'warp-specialized ' * (D in fa.WS_HEAD_DIMS)}"
                             f"kernel")
    want = _plain_attn(torch, q, k, v, causal).float()
    torch.cuda.synchronize()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    rel = diff.amax(-1) / want.pow(2).mean(-1).sqrt()
    at = [int(i) for i in torch.unravel_index(rel.argmax(), rel.shape)]
    rel = float(rel.max())
    log(f"[kernel] flash_attention (B, Sq, Sk, H, KVH, D) = "
        f"{(B, Sq, Sk, H, KVH, D)} {'causal' if causal else 'bidirectional'} "
        f"({label}) bfloat16 (tensor_core kernel): max_abs_err={err}, at "
        f"|out| up to {float(want.abs().max()):.4f}; the largest |diff| of a "
        f"row over the row's RMS {rel:.6f} at (b, s, h) = {tuple(at)} "
        f"(tolerance {ATTN_ROW_TOL})")
    if not rel <= ATTN_ROW_TOL:
        raise AssertionError(f"{label}'s attention: a row's |diff| reaches "
                             f"{rel} of its RMS")
    return err


def _paper_split():
    from repro_torch.data import commsml, federated
    X, y = commsml.generate(seed=0)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    return split, dx, counts


def phase_slice(torch, split, dx, counts):
    """The main path at full width; returns each Tol-FL kernel's launches
    over its three runs (the fused kernel once a round, the standalone
    combine never)."""
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.failure import NO_FAILURE, FailureSpec
    from repro_torch.core.simulate import SimConfig, run_simulation
    from repro_torch.kernels import tolfl_combine as tc
    from repro_torch.models.detector import AutoencoderDetector
    det = AutoencoderDetector(COMMSML)
    log(f"[slice] device data {tuple(dx.shape)} counts {counts.tolist()} "
        f"test {tuple(split.test_x.shape)}; autoencoder P = "
        f"{det.param_count()} ({det.param_bytes()} bytes); "
        f"{ROUNDS} rounds, dropout on")
    runs = [("tolfl", 5, NO_FAILURE),
            ("tolfl", 5, FailureSpec(FAIL_EPOCH, "server")),
            ("fl", 1, FailureSpec(FAIL_EPOCH, "server"))]
    # warm-up (cuBLAS handles, allocator); not part of the measured path
    run_simulation(COMMSML, dx, counts, split.test_x, split.test_y,
                   SimConfig(rounds=2))
    results, ms_round = {}, []
    tc.ROUND_LAUNCHES = tc.LAUNCHES = 0
    for scheme, k, failure in runs:
        before = tc.ROUND_LAUNCHES, tc.LAUNCHES
        cfg = SimConfig(scheme=scheme, num_devices=10, num_clusters=k,
                        rounds=ROUNDS, lr=1e-3, dropout=True, seed=0)
        t0 = time.perf_counter()
        res = run_simulation(COMMSML, dx, counts, split.test_x,
                             split.test_y, cfg, failure)
        wall = time.perf_counter() - t0   # ends in a host copy: synchronised
        added = (tc.ROUND_LAUNCHES - before[0], tc.LAUNCHES - before[1])
        if scheme == "tolfl":
            ms_round.append(wall / ROUNDS * 1e3)
        log(f"[slice] {scheme} k={k} failure={failure.kind}@"
            f"{failure.epoch if failure.kind != 'none' else '-'}: "
            f"auroc={res.final_auroc:.4f} used={res.auroc_used:.4f} "
            f"iso_active={res.iso_active} loss {res.loss_curve[0]:.3f} -> "
            f"{res.loss_curve[-1]:.3f}; {ms_round[-1]:.3f} ms/round; "
            f"tolfl_round_update launches {added[0]}, tolfl_combine "
            f"launches {added[1]}")
        if added != (ROUNDS, 0):
            raise AssertionError(f"{scheme}: {added} fused / combine "
                                 f"launches, expected ({ROUNDS}, 0)")
        # FL's isolated fallback diverges a few rounds after the server
        # dies at lr 1e-3, in the JAX reference as in the port: both turn
        # non-finite in the same round (tests/test_torch_simulate.py::
        # test_fl_isolated_fallback_diverges_like_repro), and the card
        # follows the CPU there ([reference] below).  So FL's loss curves
        # must be finite up to the failure round only
        finite_to = FAIL_EPOCH if scheme == "fl" else ROUNDS
        for f in ("loss_curve", "auroc_curve", "iso_loss_curve"):
            arr = getattr(res, f)
            head = arr if f == "auroc_curve" else arr[:finite_to]
            if arr.shape != (ROUNDS,) or not np.all(np.isfinite(head)):
                raise AssertionError(f"{scheme}: {f} not finite of shape "
                                     f"({ROUNDS},)")
        if scheme == "fl":
            bad = np.flatnonzero(~np.isfinite(res.loss_curve))
            log(f"[slice] fl isolated fallback: first non-finite loss at "
                f"round {bad[0] if bad.size else 'none'}")
        results[(scheme, failure.kind)] = res
    launches = {"tolfl_round_update": tc.ROUND_LAUNCHES,
                "tolfl_combine": tc.LAUNCHES}
    if not results[("fl", "server")].iso_active:
        raise AssertionError("fl with a dead server did not fall back to "
                             "isolated training")
    auc = results[("tolfl", "none")].final_auroc
    if not auc > 0.7:
        raise AssertionError(f"tolfl without failure: AUROC {auc} <= 0.7")

    # the paper's combine against the direct weighted mean (SimConfig's
    # combine="direct", plain PyTorch), dropout off so both see the same
    # gradients: the k-invariance of tests/test_torch_invariance.py at full
    # width, within its rtol 1e-4 / atol 1e-5.  At PAIR_LR the descent is
    # monotone; at the paper's lr 1e-3 the loss oscillates on these
    # unnormalised features and the two curves, equal to the last bits in
    # each round, part by far more than 1e-4 within 100 rounds
    pair = {}
    for combine in ("streaming", "direct"):
        cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                        rounds=ROUNDS, lr=PAIR_LR, dropout=False, seed=0,
                        combine=combine)
        tc.ROUND_LAUNCHES = tc.LAUNCHES = 0
        t0 = time.perf_counter()
        pair[combine] = run_simulation(COMMSML, dx, counts, split.test_x,
                                       split.test_y, cfg)
        wall = time.perf_counter() - t0
        added = (tc.ROUND_LAUNCHES, tc.LAUNCHES)
        want = (ROUNDS, 0) if combine == "streaming" else (0, 0)
        curve = pair[combine].loss_curve
        log(f"[slice] tolfl k=5 lr {PAIR_LR} dropout off, combine={combine}: "
            f"loss {curve[0]:.6f} -> {curve[-1]:.6f}, falling in "
            f"{int(np.sum(np.diff(curve) < 0))} of {ROUNDS - 1} rounds, auroc "
            f"{pair[combine].final_auroc:.4f}; {wall / ROUNDS * 1e3:.3f} "
            f"ms/round; fused / combine launches {added}")
        if added != want:
            raise AssertionError(f"combine={combine}: launches {added}, "
                                 f"expected {want}")
        if combine == "streaming":
            ms_round.append(wall / ROUNDS * 1e3)
    a, b = pair["streaming"].loss_curve, pair["direct"].loss_curve
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"[slice] streaming vs direct: loss curves within rtol 1e-4 / atol "
        f"1e-5, max rel diff {float(np.max(np.abs(a - b) / np.abs(b))):.3e}; "
        f"Tol-FL k=5 (dropout on: no failure, head failure; off): "
        f"{', '.join(f'{v:.3f}' for v in ms_round)} ms/round (spread "
        f"{min(ms_round):.3f}-{max(ms_round):.3f})")
    return launches


def phase_no_sync(torch, split, dx, counts):
    """The round loop never waits on the host: run it with PyTorch's sync
    debug mode set to raise on any call that synchronises the card."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core import simulate
    from repro_torch.core.failure import FailureSpec
    loop = simulate._round_loop

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    simulate._round_loop = guarded
    try:
        for scheme, k in (("tolfl", 5), ("fl", 1)):
            cfg = simulate.SimConfig(scheme=scheme, num_devices=10,
                                     num_clusters=k, rounds=5, seed=0)
            simulate.run_simulation(COMMSML, dx, counts, split.test_x,
                                    split.test_y, cfg, FailureSpec(2, "server"))
    finally:
        simulate._round_loop = loop
    log("[no-sync] tolfl and fl round loops ran 5 rounds each under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")


#: idle seconds at each end of a torch.profiler window.  The profiler
#: drops the device records whose timestamps, converted to the host's
#: clock, fall outside its window, and the card's converted clock can read
#: milliseconds early (kernels stamped before their own launch, and lost);
#: with this much idle time on either side the work's records stay inside.
PROFILE_PAD_S = 0.1


@contextlib.contextmanager
def _device_profile(torch):
    """torch.profiler over the host and the card, with ``PROFILE_PAD_S``
    of idle time before the body and, after it has been synchronised,
    after it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def _device_time(prof):
    """The device's side of a torch.profiler window: (busy µs, the union
    of the intervals of the events that ran on the card; {name: [µs,
    count]} of those events).  Only device events count: the CPU ops that
    launched them carry the same time as their ``self_device_time``, and
    summing both would count it twice."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy, by_name


def _record_spans(prof):
    """Where a profiler window's records lie, in µs on its clock: the card's
    events and the host's graph launches (first start, last end, count),
    to tell records lost at the window's edges from launches not made."""
    from torch.autograd import DeviceType
    spans = {"device events": [], "cudaGraphLaunch": []}
    for e in prof.events():
        key = ("device events" if e.device_type == DeviceType.CUDA
               else e.name if e.name == "cudaGraphLaunch" else None)
        if key:
            spans[key].append((e.time_range.start, e.time_range.end))
    return ", ".join(
        f"{key} {min(s for s, _ in v):.1f}..{max(t for _, t in v):.1f} "
        f"({len(v)})" if v else f"{key} none" for key, v in spans.items())


def _top(by_name, n, per=1.0, unit="us"):
    return "; ".join(
        f"{name[:60]} {us / per:.1f} {unit} ({count} calls)"
        for name, (us, count) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:n])


def _eager_round_update(torch, combine):
    """The unfused round aggregation, for comparison: the eager sequence of
    16 launches that ``aggregation.round_update`` replaced (``ns``,
    ``cluster_reduce``'s one-hot products, a standalone combine kernel, the
    gated step), with ``round_update``'s arguments at S = 1.  ``combine``
    maps (k, P) cluster gradients and their counts to the combined (P,)."""
    from repro_torch.core import aggregation as agg

    def round_update(gs, counts, w, scale, cluster_ids, params, lr, k):
        g_tx = gs[0] if scale is None else gs[0] * scale[0][:, None]
        cluster_gs, n_c = agg.cluster_reduce(g_tx, counts * w[0],
                                             cluster_ids[0], k)
        g = combine(cluster_gs, n_c)
        n_tot = torch.sum(n_c)
        has_update = (n_tot > 0).to(torch.float32)
        return (params[0] - lr * has_update * g)[None], n_tot[None]
    return round_update


def _profiled(torch, fn, calls=32):
    """``calls`` calls of ``fn`` under torch.profiler after a warm-up:
    (device busy µs a call, device events a call, {name: [µs, count]})."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with _device_profile(torch) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, by_name = _device_time(prof)
    events = sum(count for _, count in by_name.values())
    return busy / calls, events / calls, by_name


def _event_us(by_name, part, calls=32):
    """Mean device µs of the events whose name holds ``part``."""
    hits = [(us, n) for name, (us, n) in by_name.items() if part in name]
    if not hits:
        raise AssertionError(f"the profiler recorded no device event named "
                             f"like {part!r}")
    return sum(us for us, _ in hits) / calls


def phase_profile(torch, split, dx, counts, parent=None):
    """Where a Tol-FL round's time goes: device busy share, device kernels
    a round and the aggregation's device µs, from torch.profiler over 10
    rounds, with the fused aggregation and with the unfused eager sequence in
    its place (the parent's combine kernel with --parent, else the
    current one)."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core import aggregation as agg
    from repro_torch.core.simulate import SimConfig, run_simulation
    from repro_torch.kernels import tolfl_combine as tc
    rounds = 10
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                    rounds=rounds, lr=1e-3, dropout=True, seed=0)
    combine = (_parent_combine_fn(torch, parent)
               if parent and "tolfl_combine" in parent
               else tc.tolfl_combine_cuda)
    eager = _eager_round_update(torch, combine)
    fused = agg.round_update
    args = tc.round_inputs(tc.ROUND_CARD_CASES[0],
                           torch.Generator(device="cuda").manual_seed(5))
    per_round = {}
    for name, impl in (("fused", fused), ("eager", eager)):
        agg.round_update = impl
        try:
            with _device_profile(torch) as prof:
                t0 = time.perf_counter()
                run_simulation(COMMSML, dx, counts, split.test_x,
                               split.test_y, cfg)
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            agg.round_update = fused
        busy, by_name = _device_time(prof)
        if busy == 0:
            log("[profile] the profiler recorded no device time: not "
                "measured")
            return
        events = sum(count for _, count in by_name.values())
        agg_busy, agg_events, _ = _profiled(
            torch, lambda: impl(*args, 1e-3, 5))
        per_round[name] = events / rounds
        log(f"[profile] tolfl {rounds} rounds, {name} aggregation: wall "
            f"{wall_us / rounds / 1e3:.3f} ms/round, device busy "
            f"{busy / rounds / 1e3:.3f} ms/round ({busy / wall_us:.1%} of "
            f"wall), {events / rounds:.1f} device kernels a round; the "
            f"aggregation alone at the paper's round (N, k, P) = (10, 5, "
            f"49,680): {agg_busy:.2f} device us and {agg_events:.1f} device "
            f"kernels a call (32 calls); top device events: "
            + _top(by_name, 6, rounds, "us/round"))
    log(f"[profile] device kernels a round: fused {per_round['fused']:.1f}, "
        f"eager {per_round['eager']:.1f}, "
        f"{per_round['eager'] - per_round['fused']:.1f} fewer")


def phase_reference(torch, split, dx, counts):
    """Small dropout-free runs on the card against the same runs on the
    CPU (the plain path the CPU tests hold against the JAX package).  FL
    runs at lr 1e-3, where it diverges: the card must turn non-finite in
    the same round as the CPU and agree with it before."""
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.failure import FailureSpec
    from repro_torch.core.simulate import SimConfig, run_simulation
    from repro_torch.models.detector import AutoencoderDetector
    p0 = AutoencoderDetector(COMMSML).init_params(
        torch.Generator().manual_seed(1), device="cpu")
    small = dx[:, :64]
    small_counts = np.minimum(counts, 64)
    tx, ty = split.test_x[::25], split.test_y[::25]
    for scheme, k, lr, rounds in (("tolfl", 5, 5e-4, 6), ("fl", 1, 1e-3, 10)):
        cfg = SimConfig(scheme=scheme, num_devices=10, num_clusters=k,
                        rounds=rounds, lr=lr, dropout=False, seed=0)
        fail = FailureSpec(3, "server")
        gpu = run_simulation(COMMSML, small, small_counts, tx, ty, cfg, fail,
                             params0=p0, device="cuda")
        cpu = run_simulation(COMMSML, small, small_counts, tx, ty, cfg, fail,
                             params0=p0, device="cpu")
        firsts = [int(np.flatnonzero(~np.isfinite(np.append(r.loss_curve,
                                                            np.nan)))[0])
                  for r in (gpu, cpu)]
        if firsts[0] != firsts[1]:
            raise AssertionError(f"{scheme}: first non-finite loss at round "
                                 f"{firsts[0]} on the card, {firsts[1]} on "
                                 f"the CPU")
        n = firsts[1]
        # float32 sums in another order on the card: rtol 1e-4 / atol 1e-5
        # for the curves, 1e-3 for AUROC (near-equal scores swap ranks)
        np.testing.assert_allclose(gpu.loss_curve[:n], cpu.loss_curve[:n],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gpu.auroc_curve[:n], cpu.auroc_curve[:n],
                                   rtol=0, atol=1e-3)
        rel = float(np.max(np.abs(gpu.loss_curve[:n] - cpu.loss_curve[:n])
                           / np.abs(cpu.loss_curve[:n])))
        log(f"[reference] {scheme} k={k} lr={lr}: card vs CPU loss max rel "
            f"diff {rel:.3e} over the {n} finite rounds of {rounds}, auroc "
            f"{gpu.auroc_curve[n - 1]:.4f} vs {cpu.auroc_curve[n - 1]:.4f} "
            f"at round {n - 1}")


def _campaign_traces():
    """The campaign grid's traces: ``sample_traces`` at rate 0.3 for the
    paper's topology (10 devices, 5 clusters), 8 event slots, on the card."""
    import numpy as np
    from repro_torch.core.failure import sample_traces
    from repro_torch.core.topology import Topology
    return sample_traces(np.random.default_rng(0), Topology(10, 5),
                         CAMPAIGN_RATE, max_events=CAMPAIGN_EVENTS,
                         rounds=ROUNDS, num_traces=CAMPAIGN_TRACES)


def _campaign_cfg(**kw):
    from repro_torch.core.simulate import SimConfig
    base = dict(scheme="tolfl", num_devices=10, num_clusters=5,
                rounds=ROUNDS, lr=1e-3, dropout=True)
    base.update(kw)
    return SimConfig(**base)


def phase_campaign(torch, split, dx, counts):
    """The campaign's main path at the paper's full scale: a one-shot grid
    of 64 scenarios (S = 64), the same grid in chunks of 16, and a fused
    (scheme x k) sweep; then the same campaign at S = 1 and S = 8 for its
    ms/round.  Each run must launch the fused kernel once a round per
    chunk (one launch for all the chunk's scenarios) and the standalone
    combine never.  Returns the fused kernel's launches over the runs."""
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.campaign import (ExecPlan, mean_ci95, run_campaign,
                                           sweep_grid)
    from repro_torch.kernels import tolfl_combine as tc
    tx, ty = split.test_x, split.test_y
    traces = _campaign_traces()
    cfg = _campaign_cfg()
    # warm-up at the grid's shapes (the allocator, cuBLAS's batched plans)
    run_campaign(COMMSML, dx, counts, tx, ty, _campaign_cfg(rounds=2), traces,
                 CAMPAIGN_SEEDS)
    total = 0

    def timed(label, want_launches, fn):
        nonlocal total
        tc.ROUND_LAUNCHES = tc.LAUNCHES = 0
        t0 = time.perf_counter()
        res = fn()          # ends in the copy of its outputs to the host
        wall = time.perf_counter() - t0
        got = (tc.ROUND_LAUNCHES, tc.LAUNCHES)
        if got != (want_launches, 0):
            raise AssertionError(f"[campaign] {label}: fused / combine "
                                 f"launches {got}, expected "
                                 f"({want_launches}, 0)")
        total += got[0]
        results = res.values() if isinstance(res, dict) else [res]
        for r in results:
            if not np.all(np.isfinite(r.auroc_used)):
                raise AssertionError(f"[campaign] {label}: non-finite "
                                     f"auroc_used in {r.cfg.scheme} "
                                     f"k={r.cfg.num_clusters}")
        n = sum(r.num_scenarios for r in results)
        log(f"[campaign] {label}: {n} scenarios x {ROUNDS} rounds in "
            f"{wall:.3f} s: {n / wall:.2f} scenarios/s, "
            f"{wall / ROUNDS * 1e3:.3f} ms/round; fused kernel launches "
            f"{got[0]}, standalone combine {got[1]}")
        return res, wall

    B = CAMPAIGN_TRACES * len(CAMPAIGN_SEEDS)
    one, wall_one = timed(
        f"tolfl k=5 lr 1e-3 dropout on, {CAMPAIGN_TRACES} traces x "
        f"{len(CAMPAIGN_SEEDS)} seeds, one shot (S = {B})", ROUNDS,
        lambda: run_campaign(COMMSML, dx, counts, tx, ty, cfg, traces,
                             CAMPAIGN_SEEDS))
    chunks = -(-B // CAMPAIGN_CHUNK)
    chunked, _ = timed(
        f"the same grid, ExecPlan(chunk_size={CAMPAIGN_CHUNK}) ({chunks} "
        f"chunks)", ROUNDS * chunks,
        lambda: run_campaign(COMMSML, dx, counts, tx, ty, cfg, traces,
                             CAMPAIGN_SEEDS,
                             exec_plan=ExecPlan(chunk_size=CAMPAIGN_CHUNK)))
    sweep, _ = timed(
        f"fused sweep_grid {list(SWEEP_CELLS)} x {CAMPAIGN_TRACES} traces x "
        f"seeds {SWEEP_SEEDS} (two groups: sbt/tolfl at k_pad 10, fl)",
        2 * ROUNDS,
        lambda: sweep_grid(COMMSML, dx, counts, tx, ty, cfg, SWEEP_CELLS,
                           traces, SWEEP_SEEDS))
    per_round = {}
    for S, n_traces, seeds in ((1, 1, (0,)), (8, 2, CAMPAIGN_SEEDS)):
        _, wall = timed(f"S = {S}", ROUNDS, lambda: run_campaign(
            COMMSML, dx, counts, tx, ty, cfg, traces[:n_traces], seeds))
        per_round[S] = wall / ROUNDS * 1e3
    per_round[B] = wall_one / ROUNDS * 1e3
    mean, std, half = mean_ci95(chunked.auroc_used)
    one_mean = float(np.mean(one.auroc_used))
    log(f"[campaign] auroc_used mean: one shot {one_mean:.5f}, chunked "
        f"{mean:.5f} +- {half:.5f} (95% CI, std {std:.5f}); per sweep cell: "
        + ", ".join(f"{s} k={k} {r.summary()['auroc_used_mean']:.4f} "
                    f"(iso_active {int(r.iso_active.sum())})"
                    for (s, k), r in sweep.items()))
    if not abs(one_mean - mean) <= half:
        raise AssertionError(f"[campaign] the one-shot grid's AUROC mean "
                             f"{one_mean} lies outside the chunked run's 95% "
                             f"CI {mean} +- {half}")
    log(f"[campaign] ms/round: " + ", ".join(
        f"S = {S} {ms:.3f}" for S, ms in per_round.items())
        + f"; scenarios/s at S = {B}: {B / wall_one:.2f}, at S = 1: "
        f"{1e3 / (per_round[1] * ROUNDS):.2f}; clocks.sm, power.draw, "
        f"temperature after: {_clocks()}")
    return total


def phase_campaign_no_sync(torch, split, dx, counts):
    """The batched round loop at S = 64 never waits on the host: a few
    rounds under PyTorch's sync debug mode, Tol-FL and FL."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core import simulate
    from repro_torch.core.campaign import run_campaign
    loop = simulate._round_loop

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    traces = _campaign_traces()
    simulate._round_loop = guarded
    try:
        for scheme, k in (("tolfl", 5), ("fl", 1)):
            run_campaign(COMMSML, dx, counts, split.test_x, split.test_y,
                         _campaign_cfg(scheme=scheme, num_clusters=k,
                                       rounds=3), traces, CAMPAIGN_SEEDS)
    finally:
        simulate._round_loop = loop
    log(f"[campaign-no-sync] tolfl and fl round loops at S = "
        f"{CAMPAIGN_TRACES * len(CAMPAIGN_SEEDS)} ran 3 rounds each under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync")


def phase_campaign_profile(torch, split, dx, counts):
    """Where a campaign round's time goes at S = 64: 10 rounds under
    torch.profiler; the device's busy share, device kernels a round, the
    top device events and the fused kernel's share of the busy time."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.campaign import run_campaign
    rounds = 10
    traces = _campaign_traces()
    S = CAMPAIGN_TRACES * len(CAMPAIGN_SEEDS)
    with _device_profile(torch) as prof:
        t0 = time.perf_counter()
        run_campaign(COMMSML, dx, counts, split.test_x, split.test_y,
                     _campaign_cfg(rounds=rounds), traces, CAMPAIGN_SEEDS)
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name = _device_time(prof)
    if busy == 0:
        log("[campaign-profile] the profiler recorded no device time: not "
            "measured")
        return
    events = sum(count for _, count in by_name.values())
    fused = sum(us for name, (us, _) in by_name.items()
                if "round_update_kernel" in name)
    # the device time of the kernels each PyTorch operator launched itself
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0.0))
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])
    log(f"[campaign-profile] tolfl k=5 at S = {S}, {rounds} rounds under the "
        f"profiler: wall {wall_us / rounds / 1e3:.3f} ms/round, device busy "
        f"{busy / rounds / 1e3:.3f} ms/round ({busy / wall_us:.1%} of wall), "
        f"{events / rounds:.1f} device kernels a round (slice 1 at S = 1: "
        f"~190); the fused kernel {fused / rounds:.2f} us a round, "
        f"{fused / busy:.2%} of the busy time; top device events: "
        + _top(by_name, 8, rounds, "us/round"))
    log("[campaign-profile] device time by the operator that launched it: "
        + "; ".join(f"{key} {us / rounds:.1f} us/round ({us / busy:.1%})"
                    for key, us in ops[:12]))


def phase_campaign_reference(torch, split, dx, counts):
    """A dropout-free campaign (lr 1e-4, 100 rounds) of the 64-scenario
    grid and a dropout-free sweep against ``run_simulation`` on the card
    for four of their scenarios (no failure, a head failure, a recovery,
    an FL server death; loss curves rtol 1e-4, AUROC atol 1e-3,
    ``iso_active`` exact), and a small campaign on the card against the
    same campaign on the CPU (rtol 1e-4)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.campaign import run_campaign, sweep_grid
    from repro_torch.core.failure import FailureSpec, sample_traces
    from repro_torch.core.simulate import run_simulation
    from repro_torch.core.topology import Topology
    from repro_torch.models.detector import AutoencoderDetector
    tx, ty = split.test_x, split.test_y
    traces = _campaign_traces()
    cfg = _campaign_cfg(lr=PAIR_LR, dropout=False)
    grid = run_campaign(COMMSML, dx, counts, tx, ty, cfg, traces,
                        CAMPAIGN_SEEDS)
    sweep = sweep_grid(COMMSML, dx, counts, tx, ty, cfg, SWEEP_CELLS, traces,
                       SWEEP_SEEDS)
    host = [t.to(torch.device("cpu")) for t in traces]

    def pick(what, candidates, key):
        """The candidate scenario with the least ``key``."""
        candidates = list(candidates)
        if not candidates:
            raise AssertionError(f"[campaign-reference] no scenario of the "
                                 f"grid has {what}")
        return min(candidates, key=key)

    def deaths(t, devices=None):
        """Epochs at which a (head) device of trace ``t`` went down."""
        hit = (t.alive_after == 0) & (t.devices >= 0)
        if devices is not None:
            hit &= torch.isin(t.devices, torch.tensor(devices))
        return t.epochs[hit].tolist()

    heads = Topology(10, 5).heads
    n = len(host)
    picks = {
        "no failure": (grid, pick("no failure", (
            i for i in range(n) if not deaths(host[i])), key=int)),
        # a head dies, nothing comes back: the earliest such death
        "head failure": (grid, pick("a head failure", (
            i for i in range(n) if deaths(host[i], heads)
            and not bool((host[i].alive_after[host[i].devices >= 0]
                          == 1).any())),
            key=lambda i: min(deaths(host[i], heads)))),
        "recovery": (grid, pick("a recovery", (
            i for i in range(n)
            if bool((host[i].alive_after[host[i].devices >= 0] == 1).any())),
            key=int)),
    }
    fl = sweep[("fl", 1)]
    # the FL scenario whose server died last: the fewest isolated rounds
    b = pick("an FL server death", np.flatnonzero(fl.iso_active),
             key=lambda i: -max(deaths(host[fl.trace_index[i]], [0])))
    rows = [(name, res, int(np.flatnonzero((res.trace_index == i)
                                            & (res.seed == 0))[0]))
            for name, (res, i) in picks.items()]
    rows.append(("fl server death", fl, int(b)))
    for name, res, b in rows:
        one = run_simulation(COMMSML, dx, counts, tx, ty,
                             dataclasses.replace(res.cfg,
                                                 seed=int(res.seed[b])),
                             traces[int(res.trace_index[b])])
        if one.iso_active != bool(res.iso_active[b]):
            raise AssertionError(f"[campaign-reference] {name}: iso_active "
                                 f"{one.iso_active} vs {res.iso_active[b]}")
        np.testing.assert_allclose(res.loss_curves[b], one.loss_curve,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res.auroc_used[b], one.auroc_used, rtol=0,
                                   atol=1e-3)
        rel = float(np.max(np.abs(res.loss_curves[b] - one.loss_curve)
                           / np.abs(one.loss_curve)))
        log(f"[campaign-reference] {name} ({res.cfg.scheme} "
            f"k={res.cfg.num_clusters}, trace {int(res.trace_index[b])}, "
            f"seed {int(res.seed[b])}): campaign vs run_simulation loss max "
            f"rel diff {rel:.3e}, auroc_used {res.auroc_used[b]:.5f} vs "
            f"{one.auroc_used:.5f}, iso_active {one.iso_active}")

    # the same small campaign on the card and on the CPU: 6 rounds on 64
    # samples a device, traces sampled for 6 rounds and an FL server death
    small_traces = sample_traces(np.random.default_rng(1), Topology(10, 5),
                                 CAMPAIGN_RATE, CAMPAIGN_EVENTS, rounds=6,
                                 num_traces=7, device="cpu")
    small_traces.append(FailureSpec(2, "server"))
    p0 = [AutoencoderDetector(COMMSML).init_params(
        torch.Generator().manual_seed(s), device="cpu") for s in SWEEP_SEEDS]
    small, small_counts = dx[:, :64], np.minimum(counts, 64)
    stx, sty = tx[::25], ty[::25]
    for scheme, k in (("tolfl", 5), ("fl", 1)):
        scfg = _campaign_cfg(scheme=scheme, num_clusters=k, rounds=6,
                             lr=5e-4, dropout=False)
        runs = [run_campaign(COMMSML, small, small_counts, stx, sty, scfg,
                             small_traces, SWEEP_SEEDS, params0=p0,
                             device=dev)
                for dev in ("cuda", "cpu")]
        np.testing.assert_array_equal(runs[0].iso_active, runs[1].iso_active)
        np.testing.assert_allclose(runs[0].loss_curves, runs[1].loss_curves,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(runs[0].auroc_used, runs[1].auroc_used,
                                   rtol=0, atol=1e-3)
        rel = float(np.max(np.abs(runs[0].loss_curves - runs[1].loss_curves)
                           / np.abs(runs[1].loss_curves)))
        log(f"[campaign-reference] {scheme} k={k}, {len(small_traces)} "
            f"traces x "
            f"{len(SWEEP_SEEDS)} seeds, 6 rounds on 64 samples a device: "
            f"card vs CPU loss max rel diff {rel:.3e}, iso_active "
            f"{int(runs[0].iso_active.sum())} of {runs[0].num_scenarios}")


def _multi_cfg(scheme, **kw):
    from repro_torch.core.baselines import MultiModelConfig
    base = dict(scheme=scheme, num_devices=10, num_models=3, rounds=ROUNDS,
                lr=1e-3, dropout=True)
    base.update(kw)
    return MultiModelConfig(**base)


def phase_multi_campaign(torch, split, dx, counts):
    """The multi-model campaigns at the paper's full scale: a fused
    ``sweep_grid`` of ``MULTI_CELLS`` over the 16 traces x seeds 0-1, three
    round loops (one a scheme; IFCA's two cells padded to M = 3).  Each
    loop is timed from its draws to its copy to the host and its AUROCs;
    no ported kernel launches; every curve must be finite."""
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core import campaign
    from repro_torch.core.campaign import mean_ci95
    from repro_torch.kernels import tolfl_combine as tc
    tx, ty = split.test_x, split.test_y
    traces = _campaign_traces()
    cfg = _campaign_cfg()
    # warm-up at the grid's shapes (the allocator, cuBLAS's batched plans)
    campaign.sweep_grid(COMMSML, dx, counts, tx, ty, _campaign_cfg(rounds=2),
                        MULTI_CELLS, traces, MULTI_SEEDS)
    loops, run_group = [], campaign._run_multi_group

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        res = run_group(*args, **kwargs)     # ends in its copy to the host
        loops.append((args[3].scheme, args[4],
                      sum(r.num_scenarios for r in res),
                      time.perf_counter() - t0))
        return res

    tc.ROUND_LAUNCHES = tc.LAUNCHES = 0        # every kernel's count to 0
    _reset_launches()
    campaign._run_multi_group = timed
    try:
        t0 = time.perf_counter()
        res = campaign.sweep_grid(COMMSML, dx, counts, tx, ty, cfg,
                                  MULTI_CELLS, traces, MULTI_SEEDS)
        wall = time.perf_counter() - t0
    finally:
        campaign._run_multi_group = run_group
    counts_now = {"tolfl_round_update": tc.ROUND_LAUNCHES,
                  "tolfl_combine": tc.LAUNCHES, **_launches(),
                  "flash_attention (tensor cores)":
                  _counters()["flash_attention"].TC_LAUNCHES}
    launched = {k: v for k, v in counts_now.items() if v}
    if launched:
        raise AssertionError(f"[multi-campaign] ported kernels launched: "
                             f"{launched}, expected none")
    n = len(traces) * len(MULTI_SEEDS)
    want = [("fedgroup", 3, n), ("ifca", 3, 2 * n), ("fesem", 3, n)]
    if [loop[:3] for loop in loops] != want:
        raise AssertionError(f"[multi-campaign] loops (scheme, M, S) "
                             f"{[loop[:3] for loop in loops]}, expected "
                             f"{want}")
    for scheme, m, S, secs in loops:
        log(f"[multi-campaign] {scheme} M = {m}, S = {S}, {ROUNDS} rounds, "
            f"lr 1e-3, dropout on: {secs:.3f} s, {S / secs:.2f} "
            f"scenarios/s, {secs / ROUNDS * 1e3:.3f} ms/round")
    for (scheme, m), r in res.items():
        bad = ~np.isfinite(r.loss_curves)
        rows = np.flatnonzero(bad.any(1))
        firsts = [int(np.flatnonzero(bad[b])[0]) for b in rows]
        # FedGroup's groups of one class train alone and can diverge at lr
        # 1e-3 (unnormalised features), in repro as in the port: tests/
        # test_torch_baselines.py::test_fedgroup_diverges_like_repro, and
        # [multi-reference] holds the card to the CPU through a divergence.
        # A divergence stays non-finite; IFCA and FeSEM must stay finite
        if len(rows) and (scheme != "fedgroup" or 2 * len(rows) >= len(bad)
                          or bad[:, 0].any() or not all(
                              bad[b, f:].all() for b, f in zip(rows, firsts))):
            raise AssertionError(
                f"[multi-campaign] {scheme} M = {m}: non-finite loss in "
                f"{len(rows)} of {r.num_scenarios} scenarios, first at round "
                f"{min(firsts)}")
        ok = ~bad.any(1)
        if not (np.isfinite(r.best_auroc[ok]).all()
                and np.isfinite(r.multi_auroc[ok]).all()):
            raise AssertionError(f"[multi-campaign] {scheme} M = {m}: "
                                 f"non-finite AUROC")
        best, _, best_h = mean_ci95(r.best_auroc[ok])
        multi, _, multi_h = mean_ci95(r.multi_auroc[ok])
        diverged = (f"{len(rows)} of {r.num_scenarios} diverge (rounds "
                    f"{sorted(firsts)}; trace, seed "
                    f"{[(int(r.trace_index[b]), int(r.seed[b])) for b in rows]}"
                    f"); " if len(rows) else "")
        log(f"[multi-campaign] {scheme} M = {m}: {diverged}best "
            f"{best:.4f} +- {best_h:.4f}, multi {multi:.4f} +- "
            f"{multi_h:.4f} (95% CI over {int(ok.sum())} finite); mean loss "
            f"{r.loss_curves[ok, 0].mean():.3f} -> "
            f"{r.loss_curves[ok, -1].mean():.3f}; models used "
            f"{np.bincount(r.assignments.ravel(), minlength=m).tolist()}")
    log(f"[multi-campaign] the sweep: {wall:.3f} s for "
        f"{len(MULTI_CELLS) * n} "
        f"scenarios in 3 round loops; ported kernel launches 0; clocks.sm, "
        f"power.draw, temperature after: {_clocks()}")


def phase_multi_no_sync(torch, split, dx, counts):
    """Each scheme's multi-model round loop never waits on the host: S = 8
    (4 traces x 2 seeds) for 3 rounds under PyTorch's sync debug mode,
    dropout on."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core import baselines
    from repro_torch.core.campaign import run_multimodel_campaign
    loop = baselines._multimodel_loop

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    traces = _campaign_traces()[:4]
    baselines._multimodel_loop = guarded
    try:
        for scheme in ("fedgroup", "ifca", "fesem"):
            run_multimodel_campaign(COMMSML, dx, counts, split.test_x,
                                    split.test_y,
                                    _multi_cfg(scheme, rounds=3), traces,
                                    MULTI_SEEDS)
    finally:
        baselines._multimodel_loop = loop
    log(f"[multi-no-sync] fedgroup, ifca and fesem round loops at S = "
        f"{len(traces) * len(MULTI_SEEDS)} ran 3 rounds each under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync")


def phase_multi_profile(torch, split, dx, counts):
    """Where an IFCA round's time goes at S = 64 (16 traces x 4 seeds, M =
    3): 10 rounds under torch.profiler; the device's busy share, device
    kernels a round, the top device events and device time by the aten
    operator that launched it."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.campaign import run_multimodel_campaign
    rounds = 10
    traces = _campaign_traces()
    S = CAMPAIGN_TRACES * len(CAMPAIGN_SEEDS)
    with _device_profile(torch) as prof:
        t0 = time.perf_counter()
        run_multimodel_campaign(COMMSML, dx, counts, split.test_x,
                                split.test_y, _multi_cfg("ifca", rounds=rounds),
                                traces, CAMPAIGN_SEEDS)
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name = _device_time(prof)
    if busy == 0:
        log("[multi-profile] the profiler recorded no device time: not "
            "measured")
        return
    events = sum(count for _, count in by_name.values())
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0.0))
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])
    log(f"[multi-profile] ifca M = 3 at S = {S}, {rounds} rounds under the "
        f"profiler (draws, loop, copy and AUROCs): wall "
        f"{wall_us / rounds / 1e3:.3f} ms/round, device busy "
        f"{busy / rounds / 1e3:.3f} ms/round ({busy / wall_us:.1%} of wall), "
        f"{events / rounds:.1f} device kernels a round; top device events: "
        + _top(by_name, 8, rounds, "us/round"))
    log("[multi-profile] device time by the operator that launched it: "
        + "; ".join(f"{key} {us / rounds:.1f} us/round ({us / busy:.1%})"
                    for key, us in ops[:14]))


def phase_multi_reference(torch, split, dx, counts):
    """A small dropout-free grid of ``MULTI_CELLS`` at lr 1e-4 (6 rounds,
    64 samples a device, the paper autoencoder), the same fused sweep on
    the card and on the CPU: loss curves within 1e-5 relative, AUROCs
    within 1e-3, assignments equal; on the card, fused (IFCA padded to
    M = 3) against one unpadded loop a cell: within rtol 1e-6 / atol 1e-7,
    assignments equal; and FedGroup at full scale and lr 1e-3 on the card
    and the CPU through its divergence."""
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.baselines import run_multimodel
    from repro_torch.core.campaign import sweep_grid
    from repro_torch.core.failure import FailureSpec, sample_traces
    from repro_torch.core.topology import Topology
    traces = sample_traces(np.random.default_rng(1), Topology(10, 5),
                           CAMPAIGN_RATE, CAMPAIGN_EVENTS, rounds=6,
                           num_traces=7, device="cpu")
    traces += [FailureSpec(2, "server"), FailureSpec(1, "client", 1)]
    small, small_counts = dx[:, :64], np.minimum(counts, 64)
    tx, ty = split.test_x[::25], split.test_y[::25]
    base = _campaign_cfg(rounds=6, lr=PAIR_LR, dropout=False)

    def run(device, **kw):
        return sweep_grid(COMMSML, small, small_counts, tx, ty, base,
                          MULTI_CELLS, traces, MULTI_SEEDS, device=device,
                          **kw)
    card, cpu, per_cell = run("cuda"), run("cpu"), run("cuda", fuse=False)
    for key in MULTI_CELLS:
        g, c, p = card[key], cpu[key], per_cell[key]
        np.testing.assert_array_equal(g.assignments, c.assignments)
        np.testing.assert_allclose(g.loss_curves, c.loss_curves, rtol=1e-5,
                                   atol=0)
        for f in ("best_auroc", "multi_auroc"):
            np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=0,
                                       atol=1e-3)
        np.testing.assert_array_equal(g.assignments, p.assignments)
        np.testing.assert_allclose(g.loss_curves, p.loss_curves, rtol=1e-6,
                                   atol=1e-7)
        rel = float(np.max(np.abs(g.loss_curves - c.loss_curves)
                           / np.abs(c.loss_curves)))
        self_rel = float(np.max(np.abs(g.loss_curves - p.loss_curves)
                                / np.abs(p.loss_curves)))
        log(f"[multi-reference] {key[0]} M = {key[1]}, {len(traces)} traces "
            f"x {len(MULTI_SEEDS)} seeds, 6 rounds at lr {PAIR_LR} on 64 "
            f"samples a device: card vs CPU loss max rel diff {rel:.3e}, "
            f"best auroc max diff "
            f"{float(np.max(np.abs(g.best_auroc - c.best_auroc))):.2e}, "
            f"assignments equal; fused vs per-cell on the card max rel diff "
            f"{self_rel:.3e}")

    # FedGroup at lr 1e-3 at full scale, dropout off, seed 0 (k-means
    # leaves devices 0 and 1 alone in their groups): the card and the CPU
    # turn non-finite in the same round and agree within 1e-5 before it
    rounds = 12
    cfg = _multi_cfg("fedgroup", rounds=rounds, dropout=False)
    card, cpu = (run_multimodel(COMMSML, dx, counts, split.test_x,
                                split.test_y, cfg, device=device)
                 for device in ("cuda", "cpu"))
    np.testing.assert_array_equal(card.assignments, cpu.assignments)
    firsts = [np.flatnonzero(~np.isfinite(r.loss_curve)) for r in (card, cpu)]
    first = int(firsts[0][0]) if firsts[0].size else rounds
    if not (np.array_equal(firsts[0], firsts[1])
            and np.array_equal(firsts[0], np.arange(first, rounds))):
        raise AssertionError(f"[multi-reference] fedgroup lr 1e-3: non-finite "
                             f"rounds {firsts[0]} on the card, {firsts[1]} on "
                             f"the CPU")
    np.testing.assert_allclose(card.loss_curve[:first], cpu.loss_curve[:first],
                               rtol=1e-5, atol=0)
    rel = float(np.max(np.abs(card.loss_curve[:first] - cpu.loss_curve[:first])
                       / np.abs(cpu.loss_curve[:first])))
    log(f"[multi-reference] fedgroup M = 3, lr 1e-3, dropout off, full scale, "
        f"seed 0 (groups {card.assignments.tolist()}): card and CPU first "
        f"non-finite at round {first if firsts[0].size else 'none'} of "
        f"{rounds}, "
        f"loss max rel diff {rel:.3e} before it")


#: the anomaly-scoring service's phases: benchmarks/bench_serve.py's
#: windows (32 rows) cut from the paper split's 5,250-row test set (164
#: windows), buckets 1/8/64, 64 windows a tick spread over the 10 clients,
#: 24 ticks, and its failure injections (sample seed 3, horizon 24), over a
#: bank trained at the paper's scale (tolfl k = 5, 100 rounds, lr 1e-3,
#: dropout on, seed 0)
ANOMALY_WINDOW, ANOMALY_BUCKETS = 32, (1, 8, 64)
ANOMALY_PER_TICK, ANOMALY_TICKS, ANOMALY_SEED = 64, 24, 3
ANOMALY_REPS = 3          # each run's service stood up and streamed 3 times


def _anomaly_processes():
    """bench_serve.py's runs: clean and its three failure processes."""
    from repro_torch.core.processes import (ClusterCascadeProcess,
                                            IidRateProcess,
                                            MarkovChurnProcess)
    return {"clean": None, "iid": IidRateProcess(p=0.4),
            "markov": MarkovChurnProcess(p_fail=0.15, p_recover=0.3),
            "cascade": ClusterCascadeProcess(p_head=1.0, recover_prob=1.0,
                                             recovery_lag=6)}


def _anomaly_windows(split):
    """(n, 32, 112) float32 windows of the test set and their row labels."""
    import numpy as np
    tx = np.asarray(split.test_x, np.float32)
    ty = np.asarray(split.test_y)
    n = tx.shape[0] // ANOMALY_WINDOW
    return (tx[:n * ANOMALY_WINDOW].reshape(n, ANOMALY_WINDOW, -1),
            ty[:n * ANOMALY_WINDOW].reshape(n, ANOMALY_WINDOW))


def _anomaly_stream(svc, wins, labels, ticks, start=0):
    """bench_serve.py's load: ``ANOMALY_PER_TICK`` windows a tick, window j
    of tick t from client j % N, then one tick.  Returns each tick's
    results and the host seconds spent in ``submit``."""
    out, submit_s = [], 0.0
    n, N = len(wins), svc.bank.num_clients
    for t in range(start, start + ticks):
        t0 = time.perf_counter()
        for j in range(ANOMALY_PER_TICK):
            i = (t * ANOMALY_PER_TICK + j) % n
            svc.submit(j % N, wins[i], labels[i])
        submit_s += time.perf_counter() - t0
        out.append(svc.tick())
    return out, submit_s


def _anomaly_service(bank, failure=None, buckets=ANOMALY_BUCKETS):
    from repro_torch.serving.anomaly import AnomalyService, ServiceConfig
    return AnomalyService(bank, ServiceConfig(bucket_sizes=buckets,
                                              window=ANOMALY_WINDOW),
                          failure=failure, sample_seed=ANOMALY_SEED,
                          horizon=ANOMALY_TICKS)


def phase_anomaly_bank(torch, split, dx, counts, model=None, lr=1e-3,
                       tag="anomaly"):
    """The scoring service's model bank at the paper's scale: the global
    model and the 10 isolated ones, two 100-round runs of the round loop,
    of the paper autoencoder at lr 1e-3 (or ``model`` at ``lr``).  The
    fused round kernel must launch once a round a run (2 x 100) and the
    standalone combine never (a SeqDetector bank: the scan's backward
    once a round a run, its forward at least as often); bank rows 0 and
    1..N must equal the two exports bit for bit.  Returns the bank and
    each kernel's launches."""
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.simulate import SimConfig
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import tolfl_combine as tc
    from repro_torch.models.params import tree_items
    from repro_torch.serving.anomaly import train_model_bank
    model = COMMSML if model is None else model
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                    rounds=ROUNDS, lr=lr, dropout=True, seed=0)
    tc.ROUND_LAUNCHES = tc.LAUNCHES = 0
    rs.LAUNCHES = rs.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    bank = train_model_bank(model, dx, counts, cfg, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (tc.ROUND_LAUNCHES, tc.LAUNCHES)
    scans = (rs.LAUNCHES, rs.BWD_LAUNCHES)
    if got != (2 * ROUNDS, 0):
        raise AssertionError(f"[{tag}-bank] fused / combine launches {got}, "
                             f"expected ({2 * ROUNDS}, 0)")
    seq = bank.detector.budget_family == "seq"
    if (scans[1] != (2 * ROUNDS if seq else 0)
            or scans[0] < scans[1] or (scans[0] > 0) != seq):
        raise AssertionError(f"[{tag}-bank] scan forward / backward launches "
                             f"{scans}")
    iso = dict(tree_items(bank.iso_params))
    for path, g in tree_items(bank.global_params):
        rows = dict(tree_items(bank.row_params))[path]
        if not (torch.equal(rows[0], g) and torch.equal(rows[1:], iso[path])
                and bool(torch.isfinite(rows).all())):
            raise AssertionError(f"[{tag}-bank] bank rows of {path} are not "
                                 f"the exports, or not finite")
    P = bank.detector.param_count()
    first = iso[("enc", "w") if seq else ("fc0", "w")]
    log(f"[{tag}-bank] {type(bank.detector).__name__} tolfl k=5, {ROUNDS} "
        f"rounds, lr {lr}, dropout on, seed 0: global + {bank.num_clients} "
        f"isolated models (P = {P}; bank {(bank.num_clients + 1) * P * 4} "
        f"bytes) in {wall:.3f} s ({wall / (2 * ROUNDS) * 1e3:.3f} ms/round "
        f"over both runs); tolfl_round_update launches {got[0]}, "
        f"tolfl_combine {got[1]}, rglru_scan forward / backward {scans}; "
        f"rows 0 / 1..N equal the two exports bit for bit; isolated models' "
        f"first-layer norms "
        + ", ".join(f"{float(v):.2f}" for v in np.linalg.norm(
            first.reshape(bank.num_clients, -1).cpu().numpy(), axis=1)))
    return bank, {"tolfl_round_update": got[0], "rglru_scan": scans[0],
                  "rglru_scan_bwd": scans[1]}


def _score_products(det, rows):
    """(M, K, N) of each product a bucket of ``rows`` feature rows scores
    with: the autoencoder's layers over the rows, SeqDetector's seven over
    its (row, window) tokens."""
    if det.budget_family == "seq":
        t, d = rows * det.seq_len, det.d_model
        w = det.lru_width or d
        return [(t, det.window, d), (t, d, w), (t, d, w), (t, w, w),
                (t, w, w), (t, w, d), (t, d, det.window)]
    ae = det.cfg
    dims = ([ae.input_dim] + list(ae.hidden) + [ae.code_dim]
            + list(reversed(ae.hidden)) + [ae.input_dim])
    return [(rows, a, b) for a, b in zip(dims[:-1], dims[1:])]


def _direct_bs64(torch, bank, wins, tag):
    """``direct_bs64``: one graph replay of a 64-bucket against row 0,
    synchronised, ``ANOMALY_TICKS`` times; returns windows/s and the
    replay's card ms."""
    import numpy as np
    from repro_torch.serving.anomaly import engine
    det, D = bank.detector, bank.input_dim
    entry, _ = engine.score_entry(det, bank.row_params,
                                  (64, ANOMALY_WINDOW, D))
    entry.x.copy_(torch.from_numpy(wins[np.arange(64) % len(wins)]))
    entry.row.fill_(0)
    for _ in range(3):
        entry.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ANOMALY_TICKS):
        entry.replay()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wps = 64 * ANOMALY_TICKS / wall
    replay_ms = _median_ms(torch, entry.replay, True)
    flops = sum(2 * m * k * n for m, k, n in
                _score_products(det, 64 * ANOMALY_WINDOW))
    log(f"[{tag}-serve] direct_bs64: one graph replay of 64 x "
        f"{ANOMALY_WINDOW} rows against row 0, synchronised, x "
        f"{ANOMALY_TICKS}: {wall * 1e3:.3f} ms, {wps:.1f} windows/s; the "
        f"replay alone on the card (CUDA events, median of {SAMPLES}) "
        f"{replay_ms:.6f} ms for {flops / 1e9:.4f} GFLOP of products "
        f"({flops / replay_ms / 1e9:.2f} TFLOP/s)")
    return wps, replay_ms


def _anomaly_runs(bank, wins, labels, tag, direct_wps, names=None):
    """Each of bench_serve.py's runs (or those in ``names``) stood up and
    streamed ``ANOMALY_REPS`` times; {name: (service, ticks, report,
    windows/s, bucket replays over all its streams)}.  Every run drops
    nothing."""
    runs = {}
    for name, proc in _anomaly_processes().items():
        if names is not None and name not in names:
            continue
        walls, replays = [], 0
        for _ in range(ANOMALY_REPS):
            svc = _anomaly_service(bank, proc)
            t0 = time.perf_counter()
            ticks, submit_s = _anomaly_stream(svc, wins, labels,
                                              ANOMALY_TICKS)
            walls.append(time.perf_counter() - t0)
            rep = svc.report()
            replays += rep.batches
            if rep.dropped != 0 or rep.windows != (ANOMALY_TICKS
                                                   * ANOMALY_PER_TICK):
                raise AssertionError(f"[{tag}-serve] {name}: {rep}")
        wall = statistics.median(walls)
        wps = rep.windows / wall
        runs[name] = (svc, ticks, rep, wps, replays)
        log(f"[{tag}-serve] {name}: {rep.windows} windows in "
            f"{ANOMALY_TICKS} ticks, wall (submit included) median of "
            f"{ANOMALY_REPS} {wall * 1e3:.3f} ms (all: "
            + ", ".join(f"{w * 1e3:.3f}" for w in walls)
            + f") = {wps:.1f} windows/s, {wps / direct_wps:.4f} of "
            f"direct_bs64; the service's own (busy) {rep.windows_per_s:.1f} "
            f"windows/s; p50 {rep.p50_ms:.3f} ms, p99 {rep.p99_ms:.3f} ms; "
            f"batches a bucket {rep.bucket_batches}; failovers "
            f"{rep.failovers}, failbacks {rep.failbacks}; AUROC head "
            f"{rep.auroc_head:.4f}, isolated {rep.auroc_isolated:.4f}; "
            f"dropped {rep.dropped}")
    return runs


def _bucket_bitwise(torch, bank, wins, tag):
    """Every window's scores alone (a 1-bucket, 32 rows), at the head of a
    padded 8-bucket and inside a full 64-bucket, against rows 0 and 1:
    bit for bit, or the phase fails (``repro``'s padded-equals-exact
    contract)."""
    import numpy as np
    from repro_torch.serving.anomaly import engine
    det, D = bank.detector, bank.input_dim
    n = len(wins)
    entries = {bs: engine.score_entry(det, bank.row_params,
                                      (bs, ANOMALY_WINDOW, D))[0]
               for bs in ANOMALY_BUCKETS}
    dev_wins = torch.from_numpy(wins).to(DEV)
    for row in (0, 1):
        for e in entries.values():
            e.row.fill_(row)
        full = []
        for start in range(0, n, 64):
            entries[64].x.copy_(dev_wins[np.arange(start, start + 64) % n])
            entries[64].replay()
            full.append(entries[64].out.clone())
        full = torch.cat(full)[:n].cpu().numpy()
        alone, padded = [], []
        for i in range(n):
            entries[1].x.copy_(dev_wins[i:i + 1])
            entries[1].replay()
            alone.append(entries[1].out[0].clone())
            entries[8].x.zero_()
            entries[8].x[0].copy_(dev_wins[i])
            entries[8].replay()
            padded.append(entries[8].out[0].clone())
        alone = torch.stack(alone).cpu().numpy()
        padded = torch.stack(padded).cpu().numpy()
        for what, got in (("a padded 8-bucket", padded),
                          ("a full 64-bucket", full)):
            if not np.array_equal(got, alone):
                diff = np.abs(got - alone)
                raise AssertionError(
                    f"[{tag}-serve] row {row}: {int((diff > 0).sum())} of "
                    f"{diff.size} scores differ between a window alone and "
                    f"in {what} (max abs {float(diff.max())})")
    log(f"[{tag}-serve] every one of {n} windows alone (1-bucket, "
        f"{ANOMALY_WINDOW} rows), at the head of a padded 8-bucket and "
        f"inside a full 64-bucket ({64 * ANOMALY_WINDOW} rows), rows 0 and "
        f"1: bitwise_equal=True (np.array_equal)")


def _graph_kernels(torch, bank):
    """The row-stable product's and the scan's launches in one call of
    the score core (a 1-bucket, row 0), counted by their wrappers: what
    every bucket graph holds and launches a replay
    (:func:`phase_anomaly_profile` holds the replays to it)."""
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import row_dense as rd
    from repro_torch.serving.anomaly import engine
    before = rd.LAUNCHES, rs.LAUNCHES
    engine.score_core(bank.detector)(
        bank.row_params, torch.zeros((1,), dtype=torch.int64, device=DEV),
        torch.zeros((1, ANOMALY_WINDOW, bank.input_dim), device=DEV))
    torch.cuda.synchronize()
    return {"row_dense": rd.LAUNCHES - before[0],
            "rglru_scan": rs.LAUNCHES - before[1]}


def phase_anomaly_serve(torch, bank, split, tag="anomaly"):
    """The service at full width: ``direct_bs64`` (one graph replay of a
    64-bucket's 2,048 rows against row 0, synchronised), then the main
    path, the clean run and the three process runs, each stood up and
    streamed ``ANOMALY_REPS`` times, on graphs that its first service
    captures (one a bucket; later ones come from memory).  The
    wrappers' counts are set to 0 just before the runs and read just
    after: they count the warm-ups' and captures' launches (two warm-ups
    and a capture a bucket, each one core call), and a graph's replays
    launch the kernels it holds without them, so the runs' replays
    times :func:`_graph_kernels` give the graphs' launches.  Every run
    drops nothing; the cascade run fails over, and every isolated-served
    window equals its isolated model scoring the same padded bucket
    directly, bit for bit.  Then every window alone, in a padded
    8-bucket and in a full 64-bucket, rows 0 and 1: bit for bit.
    Returns direct_bs64's windows/s, each run's, and the main path's
    {"launches" | "graph_launches": {kernel: n}, "captures",
    "replays"}."""
    import numpy as np
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import row_dense as rd
    from repro_torch.serving.anomaly import engine
    det, D = bank.detector, bank.input_dim
    wins, labels = _anomaly_windows(split)
    n = len(wins)
    direct_wps, _ = _direct_bs64(torch, bank, wins, tag)
    engine.clear_score_cache()        # the main path captures its own
    captures = engine.CAPTURES
    rd.LAUNCHES = rs.LAUNCHES = 0
    runs = _anomaly_runs(bank, wins, labels, tag, direct_wps)
    torch.cuda.synchronize()
    eager = {"row_dense": rd.LAUNCHES, "rglru_scan": rs.LAUNCHES}
    captured = engine.CAPTURES - captures
    replays = sum(r[4] for r in runs.values())
    per_call = _graph_kernels(torch, bank)
    graph = {k: replays * c for k, c in per_call.items()}
    calls = 3 * len(ANOMALY_BUCKETS)
    if captured != len(ANOMALY_BUCKETS) or per_call["row_dense"] == 0 or \
            (per_call["rglru_scan"] > 0) != (det.budget_family == "seq") or \
            eager != {k: calls * c for k, c in per_call.items()}:
        raise AssertionError(f"[{tag}-serve] main path: {captured} captures, "
                             f"wrapper launches {eager}, a core call "
                             f"{per_call}")
    log(f"[{tag}-serve] main path (the four runs): {captured} captures (one "
        f"a bucket); the wrappers, set to 0 just before and read just "
        f"after, launched row_dense {eager['row_dense']} and rglru_scan "
        f"{eager['rglru_scan']} times ({calls} core calls: 2 warm-ups and "
        f"a capture a bucket, {per_call['row_dense']} and "
        f"{per_call['rglru_scan']} launches a call); {replays} graph "
        f"replays launched row_dense {graph['row_dense']} and rglru_scan "
        f"{graph['rglru_scan']} times without them")
    svc, ticks, rep, _, _ = runs["cascade"]
    if rep.failovers <= 0:
        raise AssertionError(f"[{tag}-serve] cascade: no failover")
    checked = 0
    for t, results in enumerate(ticks):
        groups = {}
        for j, r in enumerate(results):
            row = r.client + 1 if r.served_by == "isolated" else 0
            groups.setdefault(row, []).append(j)
        for row, js in groups.items():
            if row == 0:
                continue
            bs = svc._pick_bucket(len(js))
            x = torch.zeros((bs, ANOMALY_WINDOW, D), device=DEV)
            x[:len(js)] = torch.from_numpy(
                wins[[(t * ANOMALY_PER_TICK + j) % n for j in js]]).to(DEV)
            want = engine.score_windows(det, bank.client_iso_params(row - 1),
                                        x)[:len(js)].cpu().numpy()
            got = np.stack([results[j].scores for j in js])
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"[{tag}-serve] cascade tick {t}: row {row}'s windows "
                    f"differ from the isolated model scored directly, max "
                    f"{float(np.abs(got - want).max())}")
            checked += len(js)
    log(f"[{tag}-serve] cascade: {checked} isolated-served windows equal "
        f"their isolated model scoring the same padded bucket directly, bit "
        f"for bit; timeline (first 6) {svc.timeline[:6]}")
    _bucket_bitwise(torch, bank, wins, tag)
    main = {"launches": eager, "graph_launches": graph,
            "captures": captured, "replays": replays}
    return direct_wps, {name: r[3] for name, r in runs.items()}, main


def phase_score_path_turns(torch, bank, split, tag="anomaly"):
    """The score path's products before and after they became the
    row-stable kernel, in one call: ``direct_bs64`` and the clean run with
    cuBLAS's products (the parent's score path: ``params.dense_apply`` on
    the flattened bucket), then with the kernel's again.  Returns
    {"cublas" | "row_dense": (direct windows/s, replay ms, clean
    windows/s)}."""
    import types
    from repro_torch.models import params as P
    from repro_torch.serving.anomaly import engine
    wins, labels = _anomaly_windows(split)
    out = {}
    kernel = engine.row_dense
    for name, products in (("cublas", types.SimpleNamespace(
            dense_apply=P.dense_apply)), ("row_dense", kernel)):
        engine.clear_score_cache()
        engine.row_dense = products
        try:
            wps, replay_ms = _direct_bs64(torch, bank, wins,
                                          f"{tag}-{name}")
            runs = _anomaly_runs(bank, wins, labels, f"{tag}-{name}", wps,
                                 names=("clean",))
        finally:
            engine.row_dense = kernel
            engine.clear_score_cache()
        out[name] = (wps, replay_ms, runs["clean"][3])
    c, r = out["cublas"], out["row_dense"]
    log(f"[{tag}-turns] score products by cuBLAS (before) vs the row-stable "
        f"kernel (after), one call: direct_bs64 {c[0]:.1f} vs {r[0]:.1f} "
        f"windows/s ({r[0] / c[0]:.3f}x), replay on the card {c[1]:.6f} vs "
        f"{r[1]:.6f} ms ({r[1] / c[1]:.3f}x), clean {c[2]:.1f} vs {r[2]:.1f} "
        f"windows/s ({r[2] / c[2]:.3f}x)")
    return out


def phase_anomaly_warm(torch, bank, split):
    """A warm service captures nothing: after one tick, ticks of 1, 5, 64,
    70, 9 and 64 windows use every bucket and fail over (head 0 dies at
    tick 1) with no new capture and ``memory_allocated`` unchanged, each
    chunk's dispatch under the sync debug mode (its one copy to the host
    outside it); a second service over the same bank resolves every
    bucket from memory."""
    from repro_torch.core.processes import trace_from_rows
    from repro_torch.serving.anomaly import engine
    wins, labels = _anomaly_windows(split)
    svc = _anomaly_service(bank, trace_from_rows([(1, 0, 0.0, 2)], 4,
                                                 device="cpu"))
    svc.submit(0, wins[0])
    svc.tick()
    torch.cuda.synchronize()
    captures, mem = engine.CAPTURES, torch.cuda.memory_allocated()
    dispatch = svc._dispatch

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    svc._dispatch = guarded
    loads = (1, 5, 64, 70, 9, 64)
    for t, load in enumerate(loads):
        for j in range(load):
            i = (t * 64 + j) % len(wins)
            svc.submit(j % bank.num_clients, wins[i], labels[i])
        svc.tick()
    torch.cuda.synchronize()
    rep = svc.report()
    used = {b: c for b, c in rep.bucket_batches.items() if c}
    if (engine.CAPTURES != captures or torch.cuda.memory_allocated() != mem
            or len(used) != len(ANOMALY_BUCKETS) or rep.failovers == 0
            or rep.dropped):
        raise AssertionError(f"[anomaly-warm] captures "
                             f"{engine.CAPTURES - captures}, memory "
                             f"{torch.cuda.memory_allocated() - mem} "
                             f"bytes more, buckets {rep.bucket_batches}, "
                             f"failovers {rep.failovers}, dropped "
                             f"{rep.dropped}")
    again = _anomaly_service(bank)
    if set(again.compile_sources.values()) != {"memory"} or \
            engine.CAPTURES != captures:
        raise AssertionError(f"[anomaly-warm] a second service: "
                             f"{again.compile_sources}")
    log(f"[anomaly-warm] {len(loads)} warm ticks of {list(loads)} windows "
        f"(batches a bucket {rep.bucket_batches}, failovers "
        f"{rep.failovers}): 0 new captures, memory_allocated unchanged "
        f"({mem} bytes), every chunk dispatched under "
        f"torch.cuda.set_sync_debug_mode('error'); a second service over "
        f"the bank: compile_sources {again.compile_sources}")


def phase_anomaly_profile(torch, bank, split, tag="anomaly"):
    """Where a service tick's time goes: 8 ticks under torch.profiler,
    clean and under the three failure processes (device busy share,
    device kernels a tick, the row-stable products' and the scan's
    launches a tick counted from the kernel events, since a graph replay
    launches without the wrappers' counters; top device events), then 24
    unprofiled clean ticks split on the host's clock into submit, routing,
    padding, input copies, replays, score copies and the copy to the
    host.  Each kernel's events must equal the profiled ticks' replays
    times its launches a core call (:func:`_graph_kernels`).  Returns
    {run: {kernel: launches a tick}}."""
    from repro_torch.serving.anomaly.service import STAGES
    wins, labels = _anomaly_windows(split)
    ticks, per_tick = 8, {}
    per_call = _graph_kernels(torch, bank)
    for name, proc in _anomaly_processes().items():
        svc = _anomaly_service(bank, proc)
        _anomaly_stream(svc, wins, labels, 2)
        torch.cuda.synchronize()
        replays = svc.report().batches
        with _device_profile(torch) as prof:
            t0 = time.perf_counter()
            _anomaly_stream(svc, wins, labels, ticks, start=2)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, by_name = _device_time(prof)
        if busy == 0:
            raise AssertionError(f"[{tag}-profile] {name}: the profiler "
                                 f"recorded no device time")
        events = sum(count for _, count in by_name.values())
        counts = {k: sum(c for ev, (_, c) in by_name.items() if part in ev)
                  / ticks for k, part in (("row_dense", "row_dense_kernel"),
                                          ("rglru_scan", "rglru_scan_kernel"))}
        per_tick[name] = counts
        replays = svc.report().batches - replays
        if any(round(counts[k] * ticks) != replays * c
               for k, c in per_call.items()):
            raise AssertionError(f"[{tag}-profile] {name}: {replays} replays "
                                 f"of {per_call} launches each, but the "
                                 f"profiler saw {counts} a tick; "
                                 + _record_spans(prof))
        log(f"[{tag}-profile] {name}, {ticks} ticks of {ANOMALY_PER_TICK} "
            f"windows under the profiler: wall {wall_us / ticks / 1e3:.3f} "
            f"ms a tick, device busy {busy / ticks:.1f} us a tick "
            f"({busy / wall_us:.2%} of wall), {events / ticks:.1f} device "
            f"kernels a tick, of them row_dense {counts['row_dense']:.2f} and "
            f"rglru_scan {counts['rglru_scan']:.2f} a tick (= {replays} "
            f"bucket replays in the {ticks} ticks x {per_call['row_dense']} "
            f"and {per_call['rglru_scan']}); "
            f"top device events: " + _top(by_name, 10, ticks, "us/tick"))
    if per_tick["clean"]["row_dense"] <= 0:
        raise AssertionError(f"[{tag}-profile] no row_dense launch in a tick")
    if bank.detector.budget_family == "seq" and \
            per_tick["clean"]["rglru_scan"] <= 0:
        raise AssertionError(f"[{tag}-profile] no scan launch in a tick")
    svc = _anomaly_service(bank)
    _anomaly_stream(svc, wins, labels, 1)
    svc.stage_seconds = dict.fromkeys(STAGES, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, submit_s = _anomaly_stream(svc, wins, labels, ANOMALY_TICKS, start=1)
    wall = time.perf_counter() - t0
    split_ms = {"submit": submit_s, **svc.stage_seconds}
    split_ms["rest"] = wall - sum(split_ms.values())
    log(f"[{tag}-profile] clean, {ANOMALY_TICKS} ticks, host clock: "
        f"{wall / ANOMALY_TICKS * 1e3:.3f} ms a tick = "
        + ", ".join(f"{k} {v / ANOMALY_TICKS * 1e3:.3f} ms ({v / wall:.1%})"
                    for k, v in split_ms.items())
        + " (d2h holds the wait for the device and the reassembly; rest: "
        "per-window bookkeeping after the copy)")
    return per_tick


def _graph_equals_eager(torch, bank, tag):
    """Each bucket's graph replay against the eager core on the same
    inputs, rows 0, 1 and N: bit for bit."""
    from repro_torch.serving.anomaly import engine
    core = engine.score_core(bank.detector)
    gen = torch.Generator(device=DEV).manual_seed(11)
    for bs in ANOMALY_BUCKETS:
        entry, _ = engine.score_entry(bank.detector, bank.row_params,
                                      (bs, ANOMALY_WINDOW, bank.input_dim))
        for row in (0, 1, bank.num_clients):
            entry.x.copy_(torch.randn(entry.x.shape, generator=gen,
                                      device=DEV) * 50)
            entry.row.fill_(row)
            entry.replay()
            want = core(bank.row_params, torch.tensor([row], device=DEV),
                        entry.x)
            torch.cuda.synchronize()
            if not torch.equal(entry.out, want):
                raise AssertionError(f"[{tag}-serve] bucket {bs} row {row}: "
                                     f"the graph replay differs from the "
                                     f"eager core")
    log(f"[{tag}-serve] each bucket's graph replay equals the eager core bit "
        f"for bit (buckets {ANOMALY_BUCKETS}, rows 0, 1, {bank.num_clients})")


def phase_seq_anomaly(torch, split, dx, counts):
    """The scoring service over a SeqDetector bank: [seq-anomaly-bank]
    trains it at the paper's scale at ``SEQ_LR`` (the scan's forward and
    backward kernels each round); [seq-anomaly-serve] runs what
    [anomaly-serve] runs, each bucket's CUDA graph holding the scan
    kernel, and holds a replay to the eager core; [seq-anomaly-profile]
    counts the scan's launches a tick.  Returns the bank's launches, the
    service's main path (:func:`phase_anomaly_serve`) and the profile's
    launches a tick."""
    from repro_torch.models.detector import SeqDetector
    tag = "seq-anomaly"
    bank, launches = phase_anomaly_bank(torch, split, dx, counts,
                                        model=SeqDetector(), lr=SEQ_LR,
                                        tag=tag)
    _, _, main = phase_anomaly_serve(torch, bank, split, tag)
    _graph_equals_eager(torch, bank, tag)
    per_tick = phase_anomaly_profile(torch, bank, split, tag)
    return launches, main, per_tick


def phase_score_kernels(torch, parent=None):
    """The score path's row-stable product against its plain version at
    the 64-bucket's products of both detector bodies and at ragged
    shapes, within ``row_dense.error_bound``, and each row's bits alone
    equal to the batch's; with --parent, the output (with its bias and
    without) bit for bit the parent kernel's at every shape; returns the
    max |diff|."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.kernels import row_dense as rd
    from repro_torch.models.detector import AutoencoderDetector, SeqDetector
    gen = torch.Generator(device=DEV).manual_seed(9)
    shapes = sorted({p for det in (AutoencoderDetector(COMMSML),
                                   SeqDetector())
                     for p in _score_products(det, 64 * ANOMALY_WINDOW)})
    shapes += [(7, 5, 33), (100_003, 16, 8)]
    worst = 0.0
    for M, K, N in shapes:
        x = torch.randn((M, K), generator=gen, device=DEV) * 3
        w = torch.randn((K, N), generator=gen, device=DEV)
        b = torch.randn((N,), generator=gen, device=DEV)
        got = rd.row_dense(x, w, b)
        want = rd.row_dense_plain(x, w, b)
        err = (got.double() - want.double()).abs()
        ok = bool((err <= rd.error_bound(x, w, b)).all())
        rows = all(torch.equal(rd.row_dense(x[i:i + 1], w, b)[0], got[i])
                   for i in (0, M // 2, M - 1))
        same = None
        if parent and "row_dense" in parent:
            same = (torch.equal(got, _parent_row_dense(torch, parent, x, w, b))
                    and torch.equal(rd.row_dense(x, w),
                                    _parent_row_dense(torch, parent, x, w)))
        torch.cuda.synchronize()
        log(f"[kernel] row_dense (M, K, N) = {(M, K, N)}: max_abs_err "
            f"{float(err.max())} (within error_bound: {ok}; |y| max "
            f"{float(want.abs().max())}); rows alone bitwise_equal={rows}"
            + ("" if same is None else
               f"; bitwise the parent kernel's (bias and none): {same}"))
        if not (ok and rows and same is not False):
            raise AssertionError(f"row_dense at {(M, K, N)}: within bound "
                                 f"{ok}, rows alone equal {rows}, the "
                                 f"parent's bits {same}")
        worst = max(worst, float(err.max()))
    return worst


def _parent_row_dense(torch, parent, x, w, b=None):
    """The parent's row-stable product y = x @ w (+ b)."""
    (M, K), N = x.shape, w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = parent["row_dense"](x.data_ptr(), w.data_ptr(),
                              None if b is None else b.data_ptr(),
                              y.data_ptr(), M, K, N,
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's row_dense failed: {err}")
    return y


def phase_anomaly_reference(torch, split, dx, counts):
    """A small dropout-free bank (6 rounds at lr 5e-4 on 64 samples a
    device, the paper autoencoder, one init) on the card and on the CPU:
    every bank leaf within 1e-5 of the CPU's relative to its largest
    value; then both services under the cascade process over 8 ticks:
    routing, timeline and bucket use identical, scores within rtol 1e-4 /
    atol 1e-5."""
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.simulate import SimConfig
    from repro_torch.models.detector import AutoencoderDetector
    from repro_torch.models.params import tree_items
    from repro_torch.serving.anomaly import train_model_bank
    p0 = AutoencoderDetector(COMMSML).init_params(
        torch.Generator().manual_seed(1), device="cpu")
    small, small_counts = dx[:, :64], np.minimum(counts, 64)
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5, rounds=6,
                    lr=5e-4, dropout=False, seed=0)
    banks = [train_model_bank(COMMSML, small, small_counts, cfg, params0=p0,
                              device=device) for device in (DEV, "cpu")]
    worst = 0.0
    cpu_leaves = dict(tree_items(banks[1].row_params))
    for path, leaf in tree_items(banks[0].row_params):
        want = cpu_leaves[path]
        rel = float((leaf.cpu() - want).abs().max() / want.abs().max())
        if not rel <= 1e-5:
            raise AssertionError(f"[anomaly-reference] bank leaf {path}: "
                                 f"card vs CPU {rel:.3e} relative")
        worst = max(worst, rel)
    wins, labels = _anomaly_windows(split)
    proc = _anomaly_processes()["cascade"]
    runs = [_anomaly_stream(_anomaly_service(b, proc), wins, labels, 8)[0]
            for b in banks]
    flat = [[r for tick in run for r in tick] for run in runs]
    for g, c in zip(*flat):
        if (g.client, g.seq, g.epoch, g.served_by) != (
                c.client, c.seq, c.epoch, c.served_by):
            raise AssertionError(f"[anomaly-reference] routing differs: {g} "
                                 f"vs {c}")
        np.testing.assert_allclose(g.scores, c.scores, rtol=1e-4, atol=1e-5)
    got = np.stack([r.scores for r in flat[0]])
    want = np.stack([r.scores for r in flat[1]])
    iso = sum(r.served_by == "isolated" for r in flat[0])
    log(f"[anomaly-reference] bank (6 rounds at lr 5e-4, 64 samples a "
        f"device): card vs CPU max leaf diff {worst:.3e} of the leaf's "
        f"largest value; cascade service, 8 ticks of {ANOMALY_PER_TICK}: "
        f"routing identical ({iso} of {len(flat[0])} windows isolated), "
        f"scores max rel diff "
        f"{float(np.max(np.abs(got - want) / np.abs(want))):.3e}")


SEQ_LR = 1e-4   # SeqDetector's lr: at 1e-3 its loss turns non-finite on
#                 these unnormalised features, in repro as in the port
#                 (tests/test_torch_seq_detector.py)
AE_LR = 1e-3    # the paper autoencoder's lr (the paper's)


def _scan_counters():
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import tolfl_combine as tc
    return rs, tc


def _zero_seq_counts():
    rs, tc = _scan_counters()
    rs.LAUNCHES = rs.BWD_LAUNCHES = tc.ROUND_LAUNCHES = tc.LAUNCHES = 0


def _seq_counts():
    """(scan forward, scan backward, fused round, standalone combine)
    launches since the last :func:`_zero_seq_counts`."""
    rs, tc = _scan_counters()
    return rs.LAUNCHES, rs.BWD_LAUNCHES, tc.ROUND_LAUNCHES, tc.LAUNCHES


def phase_seq_kernels(torch):
    """The RG-LRU scan at SeqDetector's campaign shape and its backward
    kernel at that shape and the serving one, against their plain versions
    on the card, bit for bit; returns each one's max |diff|."""
    from repro_torch.kernels import rglru_scan as rs
    gen = torch.Generator(device=DEV).manual_seed(3)
    worst = {"rglru_scan": 0.0, "rglru_scan_bwd": 0.0}
    a = torch.sigmoid(torch.randn(SEQ_SCAN, generator=gen, device=DEV))
    b = torch.randn(SEQ_SCAN, generator=gen, device=DEV)
    got, want = rs.rglru_scan_cuda(a, b), rs.rglru_scan_plain(a, b)
    torch.cuda.synchronize()
    same, err = torch.equal(got, want), float((got - want).abs().max())
    log(f"[kernel] rglru_scan (B, S, W) = {SEQ_SCAN} (SeqDetector, 64 "
        f"scenarios): bitwise_equal={same} max_abs_err={err}")
    if not same:
        raise AssertionError(f"rglru_scan differs from its plain version at "
                             f"{SEQ_SCAN}")
    worst["rglru_scan"] = err
    del a, b, got, want
    for B, S, W, with_h0 in SCAN_BWD_CASES:
        a = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=DEV))
        b = torch.randn((B, S, W), generator=gen, device=DEV)
        dh = torch.randn((B, S, W), generator=gen, device=DEV)
        h0 = (torch.randn((B, W), generator=gen, device=DEV)
              if with_h0 else None)
        h = rs.rglru_scan_cuda(a, b, h0)
        got = rs.rglru_scan_bwd_cuda(a, h, h0, dh)
        want = rs.rglru_scan_backward_plain(a, h, h0, dh)
        torch.cuda.synchronize()
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        same = (got[2] is None) == (want[2] is None) and all(
            torch.equal(g, w) for g, w in pairs)
        err = max(float((g - w).abs().max()) for g, w in pairs)
        log(f"[kernel] rglru_scan_bwd (B, S, W) = {(B, S, W)} h0={with_h0}: "
            f"bitwise_equal={same} (da, db{', dh0' if with_h0 else ''}) "
            f"max_abs_err={err}")
        if not same:
            raise AssertionError(f"rglru_scan_bwd differs from its plain "
                                 f"version at {(B, S, W)} h0={with_h0}")
        worst["rglru_scan_bwd"] = max(worst["rglru_scan_bwd"], err)
        del a, b, dh, h0, h, got, want, pairs
    return worst


def phase_seq_slice(torch, split, dx, counts):
    """SeqDetector through ``run_simulation`` at the paper's scale (S = 1):
    tolfl k = 5, 100 rounds.  Every round must launch the scan forward
    twice (the training loss, the test scores), its backward once and the
    fused round kernel once; one more forward scores the final model.
    Returns the launches of the run."""
    import numpy as np
    from repro_torch.core.simulate import SimConfig, run_simulation
    from repro_torch.models.detector import SeqDetector
    det = SeqDetector()
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                    rounds=ROUNDS, lr=SEQ_LR, seed=0)
    rows = dx.shape[0] * dx.shape[1]
    log(f"[seq-slice] SeqDetector {det}: P = {det.param_count()}; the "
        f"scan's batch a round: ({rows}, {det.seq_len}, "
        f"{det.lru_width or det.d_model}) for the loss, "
        f"({len(split.test_x)}, {det.seq_len}, "
        f"{det.lru_width or det.d_model}) for the test scores; tolfl k=5, "
        f"{ROUNDS} rounds, lr {SEQ_LR}")
    run_simulation(det, dx, counts, split.test_x, split.test_y,
                   SimConfig(rounds=2, lr=SEQ_LR))          # warm-up
    _zero_seq_counts()
    t0 = time.perf_counter()
    res = run_simulation(det, dx, counts, split.test_x, split.test_y, cfg)
    wall = time.perf_counter() - t0
    got = _seq_counts()
    want = (2 * ROUNDS + 1, ROUNDS, ROUNDS, 0)
    curve = res.loss_curve
    log(f"[seq-slice] {wall / ROUNDS * 1e3:.3f} ms/round; launches: scan "
        f"forward {got[0]} ({got[0] / ROUNDS:.2f} a round), backward "
        f"{got[1]} ({got[1] / ROUNDS:.2f} a round), fused round {got[2]}, "
        f"standalone combine {got[3]}; loss {curve[0]:.4f} -> "
        f"{curve[-1]:.4f}, auroc {res.final_auroc:.4f}")
    if got != want:
        raise AssertionError(f"[seq-slice] launches {got}, expected {want}")
    if not (np.all(np.isfinite(curve)) and curve.shape == (ROUNDS,)
            and curve[-1] < curve[0]):
        raise AssertionError("[seq-slice] the loss curve is not finite and "
                             "falling")
    return {"rglru_scan": got[0], "rglru_scan_bwd": got[1],
            "tolfl_round_update": got[2]}


def phase_seq_no_sync(torch, split, dx, counts):
    """SeqDetector's round loop (the scan kernels' forward and backward
    included) never waits on the host: 5 rounds under the sync debug
    mode."""
    from repro_torch.core import simulate
    from repro_torch.models.detector import SeqDetector
    loop = simulate._round_loop

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    simulate._round_loop = guarded
    try:
        for scheme, k in (("tolfl", 5), ("fl", 1)):
            simulate.run_simulation(
                SeqDetector(), dx, counts, split.test_x, split.test_y,
                simulate.SimConfig(scheme=scheme, num_clusters=k, rounds=5,
                                   lr=SEQ_LR), simulate.NO_FAILURE)
    finally:
        simulate._round_loop = loop
    log("[seq-no-sync] SeqDetector tolfl and fl round loops ran 5 rounds "
        "each under torch.cuda.set_sync_debug_mode('error'): no host sync")


def _exp_spec(model, split, dx, counts, seeds, rounds=None, lr=1e-3,
              cells=EXP_CELLS):
    """[experiment]'s spec: tolfl k = 5, fl and IFCA M = 3 under no
    failure, a server death at round 20 and a sampled rate grid."""
    from repro_torch.core import experiment as X
    from repro_torch.core.failure import NO_FAILURE, FailureSpec
    from repro_torch.core.simulate import SimConfig
    return X.ExperimentSpec(
        data=X.DataSpec(model=model, device_x=dx, device_counts=counts,
                        test_x=split.test_x, test_y=split.test_y,
                        name="commsml"),
        base=SimConfig(num_devices=10, rounds=rounds or ROUNDS, lr=lr),
        cells=tuple(X.CellSpec(s, k) for s, k in cells),
        traces=X.TraceSpec(traces=(NO_FAILURE, FailureSpec(20, "server")),
                           p_grid=EXP_RATES),
        seeds=X.SeedSpec(tuple(range(seeds))))


def _exp_seeds(split, dx, counts):
    """(traces in the tolfl cell, seeds): seeds enough that [experiment]'s
    fused tolfl bucket holds at least ``EXP_MIN_SCENARIOS`` scenarios."""
    from repro_torch.core import experiment as X
    from repro_torch.models.detector import SeqDetector
    n_traces = len(X.plan(_exp_spec(SeqDetector(), split, dx, counts, 1))
                   .cells[0].traces)
    return n_traces, -(-EXP_MIN_SCENARIOS // n_traces)


def _bucket_launches(bucket, cfg, rounds):
    """(scan forward, scan backward, fused round) launches a bucket's
    round loop makes: per round the training gradient (a forward and a
    backward), the test scores (and, for fl, the isolated models'), IFCA's
    probe of every model; the final scores once."""
    chunks = bucket.num_chunks
    if bucket.kind == "single":
        fwd = (3 * rounds + 2) if bucket.track_iso else (2 * rounds + 1)
        return fwd * chunks, rounds * chunks, rounds * chunks
    if cfg.scheme != "ifca":
        raise AssertionError(f"no launch count for {cfg.scheme}")
    return (3 * rounds + 1) * chunks, rounds * chunks, 0


def phase_experiment(torch, split, dx, counts):
    """The declarative pipeline at the paper's scale: the spec of
    tolfl k = 5, fl and IFCA M = 3 under no failure, a server death and
    the sampled rates 0.1 and 0.3 (4 draws each), seeds enough that the
    fused tolfl bucket holds at least 64 scenarios, through ``plan`` and
    ``execute`` with SeqDetector at ``SEQ_LR``, then with the paper
    autoencoder at the paper's lr (``AE_LR``).  Each bucket's round loop
    is timed on the host clock (it ends in its copy to the host); the
    launches must be those of the buckets' loops.  SeqDetector's curves
    and AUROCs must all be finite.  The autoencoder at lr 1e-3 diverges
    in a few single-model scenarios, in repro as in the port, with or
    without failures (tests/test_torch_experiment.py::
    test_paper_autoencoder_diverges_at_lr_1e3_like_repro, and
    [experiment-reference] holds the card to the CPU through such
    divergences): a tolfl or fl cell may turn non-finite in fewer than
    half of its scenarios, never in the first round, and stays so; IFCA
    and every other scenario must stay finite, AUROCs in [0, 1].  Returns
    the launches of the two runs (the scans: SeqDetector's alone)."""
    import numpy as np
    from repro_torch.core import campaign
    from repro_torch.core import experiment as X
    n_traces, seeds = _exp_seeds(split, dx, counts)
    timings = []
    run_group, run_multi = campaign._run_group, campaign._run_multi_group

    def timed(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            timings.append(time.perf_counter() - t0)
            return out
        return run

    launches = {}
    for body in ("seq", "ae"):
        model, lr = _body(body)
        spec = _exp_spec(model, split, dx, counts, seeds, lr=lr)
        t0 = time.perf_counter()
        plan = X.plan(spec)
        plan_s = time.perf_counter() - t0
        if body == "seq":
            log(f"[experiment] {n_traces} traces in the tolfl cell -> "
                f"{seeds} seeds; plan() on the host in {plan_s:.3f} s:\n"
                + plan.describe())
        fused = plan.buckets[0]
        if not (fused.fused and fused.num_scenarios >= EXP_MIN_SCENARIOS):
            raise AssertionError(f"[experiment] the fused bucket holds "
                                 f"{fused.num_scenarios} scenarios")
        timings.clear()
        campaign._run_group = timed(run_group)
        campaign._run_multi_group = timed(run_multi)
        torch.cuda.reset_peak_memory_stats()
        _zero_seq_counts()
        try:
            t0 = time.perf_counter()
            res = X.execute(plan)
            wall = time.perf_counter() - t0
        finally:
            campaign._run_group, campaign._run_multi_group = (run_group,
                                                              run_multi)
        got = _seq_counts()
        peak = torch.cuda.max_memory_allocated()
        want = [0, 0, 0]
        for b in plan.buckets:
            for i, n in enumerate(_bucket_launches(
                    b, plan.cells[b.cell_indices[0]].cfg, ROUNDS)):
                want[i] += n
        if body == "ae":
            want[:2] = [0, 0]
        if got[:3] != tuple(want) or got[3] != 0:
            raise AssertionError(f"[experiment] {body}: launches {got}, "
                                 f"expected {tuple(want)} and 0")
        diverged, means = {}, {}
        for c, r in zip(plan.cells, res.results):
            auroc = r.auroc_used if hasattr(r, "auroc_used") else r.best_auroc
            bad = ~np.isfinite(r.loss_curves)
            rows = np.flatnonzero(bad.any(1))
            firsts = [int(np.flatnonzero(bad[b])[0]) for b in rows]
            fine = ~bad.any(1)
            ok = (r.loss_curves.shape == (c.num_scenarios, ROUNDS)
                  and np.all(np.isfinite(auroc[fine]))
                  and np.all((auroc >= 0) & (auroc <= 1)))
            # SeqDetector's lr is chosen so that it never diverges; the
            # autoencoder's single-model cells may, in a minority
            may_diverge = body == "ae" and c.kind == "single"
            bounded = may_diverge and 2 * len(rows) < len(bad) and all(
                f > 0 and bad[b, f:].all() for b, f in zip(rows, firsts))
            if not ok or (len(rows) and not bounded):
                raise AssertionError(
                    f"[experiment] {body} {c.key}: AUROCs finite and in "
                    f"[0, 1] of shape ({c.num_scenarios},): {ok}; "
                    f"{len(rows)} scenarios with a non-finite loss, first "
                    f"at rounds {firsts}")
            diverged[c.key] = [(int(r.trace_index[b]), int(r.seed[b]), f)
                               for b, f in zip(rows, firsts)]
            means[c.key] = float(auroc[fine].mean())
        per_bucket = "; ".join(
            f"bucket {b.index} ({b.kind}, {'+'.join(str(plan.cells[i].key) for i in b.cell_indices)}, "
            f"S = {b.chunk}) {t:.3f} s: {b.num_scenarios / t:.2f} "
            f"scenarios/s, {t / ROUNDS * 1e3:.3f} ms/round"
            for b, t in zip(plan.buckets, timings))
        log(f"[experiment] {body} (lr {lr}): {res.num_scenarios} scenarios "
            f"x {ROUNDS} rounds in {wall:.3f} s ({res.num_scenarios / wall:.2f}"
            f" scenarios/s); {per_bucket}; peak device memory {peak} bytes "
            f"({peak / 2**30:.2f} GiB); launches: scan forward {got[0]}, "
            f"backward {got[1]}, fused round {got[2]}; scenarios with a "
            f"non-finite loss (trace, seed, first round) {diverged}; AUROC "
            f"means over the finite scenarios: "
            + ", ".join(f"{key} {v:.4f}" for key, v in means.items()))
        if body == "seq":
            launches = {"rglru_scan": got[0], "rglru_scan_bwd": got[1],
                        "tolfl_round_update": got[2]}
            seq_spec, seq_plan = spec, plan
        else:
            launches["tolfl_round_update"] += got[2]
        del res
        torch.cuda.empty_cache()
    _experiment_profile(torch, seq_spec, seq_plan)
    return launches


def _experiment_profile(torch, spec, plan):
    """Where a round of the Seq experiment's fused tolfl bucket goes: 10
    rounds of its cell at the same S under torch.profiler; the device's
    busy share of the whole ``execute`` and of its round loop alone (the
    host clock around ``simulate._round_loop``, synchronised), and the
    device time by the aten operator that launched it."""
    import dataclasses
    from repro_torch.core import experiment as X
    from repro_torch.core import simulate
    rounds = 10
    cell = plan.cells[plan.buckets[0].cell_indices[0]]
    one = dataclasses.replace(spec, cells=(cell.spec,),
                              base=dataclasses.replace(spec.base,
                                                       rounds=rounds))
    p = X.plan(one)
    X.execute(p)                                         # warm-up
    loop, loop_s = simulate._round_loop, []

    def timed_loop(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop(*args, **kwargs)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)
        return out

    simulate._round_loop = timed_loop
    try:
        with _device_profile(torch) as prof:
            t0 = time.perf_counter()
            X.execute(p)
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        simulate._round_loop = loop
    busy, by_name = _device_time(prof)
    if busy == 0:
        log("[experiment] the profiler recorded no device time: not "
            "measured")
        return
    loop_us = loop_s[0] * 1e6
    if busy > 1.05 * loop_us:
        raise AssertionError(f"[experiment] profile: device busy {busy:.1f} "
                             f"us over a round loop of {loop_us:.1f} us: "
                             f"device spans counted twice?")
    scan = sum(us for name, (us, _) in by_name.items()
               if "rglru_scan" in name)
    ops = sorted(((e.key, getattr(e, "self_device_time_total", 0.0))
                  for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])
    log(f"[experiment] profile, seq {cell.key} at S = {p.buckets[0].chunk}, "
        f"{rounds} rounds: execute wall {wall_us / rounds / 1e3:.3f} "
        f"ms/round, its round loop {loop_us / rounds / 1e3:.3f} ms/round; "
        f"device busy {busy / rounds / 1e3:.3f} ms/round, {busy / wall_us:.1%}"
        f" of the execute's wall (inits, traces, the copy and AUROCs on the "
        f"host included), {busy / loop_us:.1%} of the loop's; "
        f"{sum(c for _, c in by_name.values()) / rounds:.1f} device kernels "
        f"a round; the scan kernels {scan / rounds:.1f} us a round "
        f"({scan / busy:.2%} of busy); top device events: "
        + _top(by_name, 8, rounds, "us/round"))
    log("[experiment] profile, device time by the operator that launched "
        "it: " + "; ".join(f"{key} {us / rounds:.1f} us/round "
                           f"({us / busy:.1%})" for key, us in ops[:12]))


def phase_experiment_reference(torch, split, dx, counts):
    """A small dropout-free SeqDetector experiment (tolfl, fl and IFCA
    cells, 6 rounds on 64 samples a device, explicit and sampled traces)
    on the card against the CPU: loss curves within rtol 1e-4 / atol
    1e-5, AUROCs within 1e-3 (float32 sums in other orders), iso_active
    and assignments equal.  Then the paper autoencoder at lr 1e-3 through
    its divergences: tolfl k = 5 and fl without failure, 8 seeds, 12
    rounds on 64 samples a device, dropout off.  Some scenarios must turn
    non-finite, on the card in the same scenarios and rounds as on the
    CPU; the curves agree within rtol 1e-4 / atol 1e-5 up to each
    scenario's first overshoot (a round whose loss exceeds the first
    round's: past it the unstable step amplifies the sums' rounding), the
    AUROCs within 1e-3 where both stay finite."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core import experiment as X
    from repro_torch.core.failure import NO_FAILURE
    from repro_torch.models.detector import SeqDetector
    small, small_counts = dx[:, :64], np.minimum(counts, 64)
    sub = dataclasses.replace(split, test_x=split.test_x[::25],
                              test_y=split.test_y[::25])
    spec = _exp_spec(SeqDetector(), sub, small, small_counts, 2, rounds=6,
                     lr=SEQ_LR, cells=(("tolfl", 2), ("fl", 1), ("ifca", 2)))
    spec = dataclasses.replace(spec, base=dataclasses.replace(
        spec.base, dropout=False))
    p = X.plan(spec)
    gpu, cpu = X.execute(p), X.execute(p, device="cpu")
    for c, g, h in zip(p.cells, gpu.results, cpu.results):
        np.testing.assert_allclose(g.loss_curves, h.loss_curves, rtol=1e-4,
                                   atol=1e-5)
        if hasattr(g, "auroc_used"):
            np.testing.assert_array_equal(g.iso_active, h.iso_active)
            pairs = (g.auroc_used, h.auroc_used)
        else:
            np.testing.assert_array_equal(g.assignments, h.assignments)
            pairs = (g.best_auroc, h.best_auroc)
        np.testing.assert_allclose(*pairs, rtol=0, atol=1e-3)
        rel = float(np.max(np.abs(g.loss_curves - h.loss_curves)
                           / np.abs(h.loss_curves)))
        log(f"[experiment-reference] seq {c.key}, {c.num_scenarios} "
            f"scenarios x 6 rounds on 64 samples a device: card vs CPU loss "
            f"max rel diff {rel:.3e}, AUROC max abs diff "
            f"{float(np.max(np.abs(pairs[0] - pairs[1]))):.3e}")

    rounds = 12
    spec = _exp_spec(COMMSML, sub, small, small_counts, 8, rounds=rounds,
                     lr=AE_LR, cells=(("tolfl", 5), ("fl", 1)))
    spec = dataclasses.replace(
        spec, base=dataclasses.replace(spec.base, dropout=False),
        traces=X.TraceSpec(traces=(NO_FAILURE,)))
    p = X.plan(spec)
    gpu, cpu = X.execute(p), X.execute(p, device="cpu")
    for c, g, h in zip(p.cells, gpu.results, cpu.results):
        firsts = [[int(np.flatnonzero(row)[0]) if row.any() else rounds
                   for row in ~np.isfinite(r.loss_curves)] for r in (g, h)]
        if firsts[0] != firsts[1] or min(firsts[1]) == rounds:
            raise AssertionError(
                f"[experiment-reference] ae {c.key} lr {AE_LR}: first "
                f"non-finite rounds {firsts[0]} on the card, {firsts[1]} on "
                f"the CPU ({rounds}: none)")
        held = []
        for b, f in enumerate(firsts[1]):
            curve = h.loss_curves[b]
            over = np.flatnonzero(~(curve[:f] <= curve[0]))
            n = int(over[0]) if over.size else f
            np.testing.assert_allclose(g.loss_curves[b, :n], curve[:n],
                                       rtol=1e-4, atol=1e-5)
            held.append(n)
        fine = np.asarray(firsts[1]) == rounds
        np.testing.assert_allclose(g.auroc_used[fine], h.auroc_used[fine],
                                   rtol=0, atol=1e-3)
        finite = np.isfinite(g.loss_curves) & np.isfinite(h.loss_curves)
        rel = (np.abs(g.loss_curves[finite] - h.loss_curves[finite])
               / np.abs(h.loss_curves[finite]))
        log(f"[experiment-reference] ae {c.key}, lr {AE_LR}, dropout off, "
            f"{c.num_scenarios} seeds x {rounds} rounds on 64 samples a "
            f"device: first non-finite round a seed {firsts[0]} on the card "
            f"and the CPU ({rounds}: none); held within 1e-4 for the first "
            f"{held} rounds, card vs CPU loss max rel diff over every "
            f"finite round {float(rel.max()):.3e}; AUROC of the "
            f"finite seeds max abs diff "
            f"{float(np.max(np.abs(g.auroc_used - h.auroc_used)[fine])):.3e}")


AOT_ROUNDS = 10   # [aot]'s depth: the [experiment] spec cut to 10 rounds
#: [aot]'s runs in each process: (body, aot), in order
AOT_RUNS = {"first": (("seq", True), ("ae", True)),
            "second": (("seq", True), ("seq", True), ("seq", False),
                       ("ae", True), ("ae", False))}


def _body(name):
    """(model, lr) of [experiment]'s two detector bodies."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.models.detector import SeqDetector
    return (SeqDetector(), SEQ_LR) if name == "seq" else (COMMSML, AE_LR)


def aot_child(torch, which, out_dir):
    """One of [aot]'s two processes (``--aot-child first|second``, with
    ``REPRO_CACHE_DIR`` set by the parent): [experiment]'s spec at
    ``AOT_ROUNDS`` rounds through ``execute``, for each run of
    ``AOT_RUNS[which]``; every run's curves and AUROCs go to
    ``<out_dir>/<which>-<i>.npz``, its compile report and launches (the
    counters set to 0 just before the run and read just after) to
    ``<out_dir>/<which>.json``."""
    import dataclasses
    import numpy as np
    from repro_torch.core import experiment as X
    from repro_torch.core.campaign import ExecPlan
    split, dx, counts = _paper_split()
    _, seeds = _exp_seeds(split, dx, counts)
    record = []
    for i, (body, aot) in enumerate(AOT_RUNS[which]):
        model, lr = _body(body)
        spec = dataclasses.replace(
            _exp_spec(model, split, dx, counts, seeds, rounds=AOT_ROUNDS,
                      lr=lr), exec_plan=ExecPlan(aot=aot))
        plan = X.plan(spec)
        _zero_seq_counts()
        t0 = time.perf_counter()
        res = X.execute(plan)
        wall = time.perf_counter() - t0
        got = _seq_counts()
        want = [0, 0, 0]
        for b in plan.buckets:
            cfg = plan.cells[b.cell_indices[0]].cfg
            for rounds in ((AOT_ROUNDS, 1) if aot else (AOT_ROUNDS,)):
                for j, n in enumerate(_bucket_launches(b, cfg, rounds)):
                    want[j] += n
        if body == "ae":
            want[:2] = [0, 0]
        arrays = {}
        for c, r in zip(plan.cells, res.results):
            arrays[f"loss{c.index}"] = r.loss_curves
            arrays[f"auroc{c.index}"] = (r.auroc_used if hasattr(
                r, "auroc_used") else r.best_auroc)
        np.savez(Path(out_dir) / f"{which}-{i}.npz", **arrays)
        rep = res.compile_report
        log(f"[aot] {which} process, run {i} ({body}, aot={aot}): "
            f"{res.num_scenarios} scenarios x {AOT_ROUNDS} rounds in "
            f"{wall:.3f} s\n" + rep.describe())
        record.append(dict(
            body=body, aot=aot, wall=wall, launches=list(got),
            want=want + [0], xla=rep.xla, cache_dir=rep.cache_dir,
            buckets=[dataclasses.asdict(b) for b in rep.buckets]))
    (Path(out_dir) / f"{which}.json").write_text(json.dumps(record))
    return 0


def phase_aot(torch, smi):
    """``ExecPlan(aot=True)`` and the kernel cache across processes:
    [experiment]'s spec (tolfl k = 5, fl, IFCA M = 3; SeqDetector and the
    paper autoencoder; 64 scenarios a bucket) at ``AOT_ROUNDS`` rounds in
    two fresh processes sharing a new, empty ``REPRO_CACHE_DIR``
    (:func:`aot_child`).  The first process's first run must build every
    ``csrc/*.cu`` (``misses`` = their count, every bucket "compiled");
    the second process's first run must build none and load them all
    (``misses`` 0, ``hits`` their count, every bucket "disk"); a repeat in
    a process reads "memory" and counts nothing.  Every bucket's
    predicted shapes must match.  Each body's curves and AUROCs must be
    the same bits (``np.array_equal``, non-finite values where they
    diverge included) in every run, with ``aot`` on or off and in either
    process; each run's launches must be its buckets' loops plus, with
    ``aot``, one warm-up round a bucket.  Returns those launches."""
    import os
    import tempfile
    import numpy as np
    from repro_torch.kernels import _build
    n_src = len(_build.sources())
    with tempfile.TemporaryDirectory(prefix="chip_smoke-aot-") as tmp:
        env = dict(os.environ, REPRO_CACHE_DIR=str(Path(tmp) / "cache"))
        walls = {}
        for which in AOT_RUNS:
            t0 = time.perf_counter()
            subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--aot-child", which, "--aot-out", tmp],
                           env=env, timeout=900, check=True)
            walls[which] = time.perf_counter() - t0
        runs = {which: json.loads((Path(tmp) / f"{which}.json").read_text())
                for which in AOT_RUNS}
        arrays = {(which, i): dict(np.load(Path(tmp) / f"{which}-{i}.npz"))
                  for which in AOT_RUNS for i in range(len(AOT_RUNS[which]))}

    def check(ok, what):
        if not ok:
            raise AssertionError(f"[aot] {what}")

    first, second = runs["first"], runs["second"]
    want = {("first", 0): ("compiled", n_src, 0),
            ("second", 0): ("disk", 0, n_src)}
    for which, rs in runs.items():
        for i, r in enumerate(rs):
            cache, misses, hits = want.get(
                (which, i), ("memory", 0, 0) if r["aot"] else ("", 0, 0))
            caches = [b["cache"] for b in r["buckets"]]
            check(caches == [cache] * len(caches),
                  f"{which} run {i}: caches {caches}, expected {cache}")
            check((r["xla"]["misses"], r["xla"]["hits"]) == (misses, hits),
                  f"{which} run {i}: xla {r['xla']}, expected misses "
                  f"{misses} and hits {hits}")
            check(all(b["aval_match"] is (True if r["aot"] else None)
                      for b in r["buckets"]),
                  f"{which} run {i}: aval_match "
                  f"{[b['aval_match'] for b in r['buckets']]}")
            check(r["launches"] == r["want"], f"{which} run {i} "
                  f"({r['body']}): launches {r['launches']}, expected "
                  f"{r['want']}")
    for body in ("seq", "ae"):
        keys = [(which, i) for which in AOT_RUNS
                for i, (b, _) in enumerate(AOT_RUNS[which]) if b == body]
        ref = arrays[keys[0]]
        for key in keys[1:]:
            got = arrays[key]
            check(sorted(got) == sorted(ref) and all(
                np.array_equal(got[name], ref[name], equal_nan=True)
                for name in ref),
                f"{body}: {key} differs from {keys[0]} (aot on/off must "
                f"give the same bits)")
    nvcc_s = first[0]["buckets"][0]["compile_s"]
    load_s = second[0]["buckets"][0]["compile_s"]
    log(f"[aot] {smi}: {n_src} kernel libraries built by nvcc in "
        f"{nvcc_s:.3f} s in the first process, loaded from the cache "
        f"directory in {load_s:.3f} s (compile_s) in the second; warm-up "
        f"rounds (lower_s) first "
        + ", ".join(f"{b['lower_s']:.3f}" for b in first[0]["buckets"])
        + " s, second "
        + ", ".join(f"{b['lower_s']:.3f}" for b in second[0]["buckets"])
        + " s; execute_s a bucket, Seq: first "
        + ", ".join(f"{b['execute_s']:.3f}" for b in first[0]["buckets"])
        + ", second (disk) "
        + ", ".join(f"{b['execute_s']:.3f}" for b in second[0]["buckets"])
        + ", second (memory) "
        + ", ".join(f"{b['execute_s']:.3f}" for b in second[1]["buckets"])
        + ", aot off "
        + ", ".join(f"{b['execute_s']:.3f}" for b in second[2]["buckets"])
        + f" s; processes {walls['first']:.1f} s and "
        f"{walls['second']:.1f} s; curves and AUROCs bitwise equal with "
        f"aot on and off, in both processes")
    totals = [sum(r["launches"][j] for rs in runs.values() for r in rs)
              for j in range(3)]
    return {"rglru_scan": totals[0], "rglru_scan_bwd": totals[1],
            "tolfl_round_update": totals[2]}


#: [shard-campaign]: shards on the one card through the shard devices' one
#: source (``campaign._local_devices``), the chunk of each sharded run and
#: the rounds of its campaigns
SHARD_DEVICES = 2
SHARD_CHUNK = 32
SHARD_ROUNDS = 50


def _same_bits(got, want):
    """Whether two lists of campaign results hold the same bytes in every
    array (NaNs included)."""
    import dataclasses
    for g, w in zip(got, want, strict=True):
        for f in dataclasses.fields(g):
            if f.name == "cfg":
                continue
            a, b = getattr(g, f.name), getattr(w, f.name)
            if a.dtype != b.dtype or a.shape != b.shape or \
                    a.tobytes() != b.tobytes():
                return False
    return True


def _shard_workloads(split, dx, counts):
    """[shard-campaign]'s campaigns at the paper's width: (label, scenarios
    of each bucket, (fused round, scan forward, scan backward) launches a
    round loop makes, run(exec_plan, rounds) -> a list of results)."""
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.campaign import run_campaign, sweep_grid
    from repro_torch.models.detector import SeqDetector
    tx, ty = split.test_x, split.test_y
    traces = _campaign_traces()
    R = SHARD_ROUNDS

    def campaign(model, seeds, **kw):
        return lambda plan, rounds: [run_campaign(
            model, dx, counts, tx, ty, _campaign_cfg(rounds=rounds, **kw),
            traces, seeds, exec_plan=plan)]

    def sweep(cells, seeds):
        return lambda plan, rounds: list(sweep_grid(
            COMMSML, dx, counts, tx, ty, _campaign_cfg(rounds=rounds), cells,
            traces, seeds, exec_plan=plan).values())

    n = len(traces)
    return [
        (f"tolfl k=5, {n} traces x {len(CAMPAIGN_SEEDS)} seeds",
         [n * len(CAMPAIGN_SEEDS)], (R, 0, 0),
         campaign(COMMSML, CAMPAIGN_SEEDS)),
        (f"fl, {n} traces x {len(SWEEP_SEEDS)} seeds",
         [n * len(SWEEP_SEEDS)], (R, 0, 0),
         campaign(COMMSML, SWEEP_SEEDS, scheme="fl", num_clusters=1)),
        (f"fused sweep_grid {list(SWEEP_CELLS)} x seeds {SWEEP_SEEDS}",
         [3 * n * len(SWEEP_SEEDS), n * len(SWEEP_SEEDS)], (R, 0, 0),
         sweep(SWEEP_CELLS, SWEEP_SEEDS)),
        (f"FedGroup grid (fedgroup, 3) + (fedgroup, 2) padded to M = 3 x "
         f"seeds {MULTI_SEEDS}", [2 * n * len(MULTI_SEEDS)], (0, 0, 0),
         sweep((("fedgroup", 3), ("fedgroup", 2)), MULTI_SEEDS)),
        (f"SeqDetector tolfl k=5 lr {SEQ_LR}, {n} traces x "
         f"{len(CAMPAIGN_SEEDS)} seeds", [n * len(CAMPAIGN_SEEDS)],
         (R, 2 * R + 1, R),
         campaign(SeqDetector(), CAMPAIGN_SEEDS, lr=SEQ_LR)),
    ]


@contextlib.contextmanager
def _sharded_watch(torch):
    """While it is open: every round loop runs under the sync debug mode
    (set while any loop runs, so a shard's loop is covered whichever
    thread started first), and the fused round kernel's and the scan
    forward's launches are tallied by the thread that made them, i.e. by
    shard.  Yields the tallies {(kernel, thread name): launches}."""
    import threading
    from collections import Counter
    from repro_torch.core import baselines, simulate
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import tolfl_combine as tc
    lock, running, tallies = threading.Lock(), [0], Counter()

    def guarded(fn):
        def run(*args, **kwargs):
            with lock:
                if running[0] == 0:
                    torch.cuda.set_sync_debug_mode("error")
                running[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    running[0] -= 1
                    if running[0] == 0:
                        torch.cuda.set_sync_debug_mode("default")
        return run

    def tallied(name, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            with lock:
                tallies[(name, threading.current_thread().name)] += 1
            return out
        return run

    saved = [(simulate, "_round_loop"), (baselines, "_multimodel_loop"),
             (tc, "tolfl_round_update_cuda"), (rs, "rglru_scan_cuda")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in saved]
    simulate._round_loop = guarded(simulate._round_loop)
    baselines._multimodel_loop = guarded(baselines._multimodel_loop)
    tc.tolfl_round_update_cuda = tallied("tolfl_round_update",
                                         tc.tolfl_round_update_cuda)
    rs.rglru_scan_cuda = tallied("rglru_scan", rs.rglru_scan_cuda)
    try:
        yield tallies
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        torch.cuda.set_sync_debug_mode("default")


def _sharded_run(torch, tag, label, buckets, per_loop, run, devices):
    """One sharded campaign over ``devices`` against the unsharded one at
    the shard's chunk: bit for bit, each shard's launches, both wall
    times.  Returns the sharded run's launches (fused round, scan
    forward, scan backward)."""
    import warnings

    import numpy as np
    from repro_torch.core import campaign
    from repro_torch.core.campaign import ExecPlan
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import tolfl_combine as tc
    ndev = len(devices)
    chunk = -(-SHARD_CHUNK // ndev) * ndev
    run(ExecPlan(chunk_size=chunk // ndev), 2)                  # warm-up
    t0 = time.perf_counter()
    want = run(ExecPlan(chunk_size=chunk // ndev), SHARD_ROUNDS)
    plain_s = time.perf_counter() - t0
    local = campaign._local_devices
    campaign._local_devices = lambda: list(devices)
    try:
        rs.LAUNCHES = rs.BWD_LAUNCHES = tc.ROUND_LAUNCHES = tc.LAUNCHES = 0
        with _sharded_watch(torch) as tallies, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            got = run(ExecPlan(shard=True, chunk_size=SHARD_CHUNK),
                      SHARD_ROUNDS)
            shard_s = time.perf_counter() - t0
        launches = (tc.ROUND_LAUNCHES, rs.LAUNCHES, rs.BWD_LAUNCHES)
        combine = tc.LAUNCHES
    finally:
        campaign._local_devices = local
    degraded = [str(w.message) for w in caught
                if "single local device" in str(w.message)]
    if degraded:
        raise AssertionError(f"[{tag}] {label}: the sharded run degraded: "
                             f"{degraded}")
    if not _same_bits(got, want):
        raise AssertionError(f"[{tag}] {label}: the sharded run over "
                             f"{[str(d) for d in devices]} differs from the "
                             f"unsharded one at chunk {chunk // ndev}")
    loops = sum(-(-b // chunk) for b in buckets)       # a shard's loops
    want_shard = {"tolfl_round_update": loops * per_loop[0],
                  "rglru_scan": loops * per_loop[1]}
    for kernel, n in want_shard.items():
        per_shard = [tallies[(kernel, f"scenario-shard-{d}")]
                     for d in range(ndev)]
        if per_shard != [n] * ndev:
            raise AssertionError(f"[{tag}] {label}: {kernel} launches by "
                                 f"shard {per_shard}, expected {n} each")
    expect = (ndev * loops * per_loop[0], ndev * loops * per_loop[1],
              ndev * loops * per_loop[2])
    if launches != expect or combine != 0:
        raise AssertionError(f"[{tag}] {label}: launches (fused, scan, "
                             f"scan backward, combine) "
                             f"{launches + (combine,)}, expected "
                             f"{expect + (0,)}")
    bad = sum(int((~np.isfinite(getattr(r, "auroc_used",
                                         getattr(r, "best_auroc", None)))
                   ).sum()) for r in got)
    total = sum(r.num_scenarios for r in got)
    if bad == total:
        raise AssertionError(f"[{tag}] {label}: no finite AUROC")
    log(f"[{tag}] {label}: {total} scenarios, {SHARD_ROUNDS} rounds, "
        f"ExecPlan(shard=True, chunk_size={SHARD_CHUNK}) over "
        f"{[str(d) for d in devices]} == ExecPlan(chunk_size="
        f"{chunk // ndev}) bit for bit; per shard: fused round "
        f"{want_shard['tolfl_round_update']}, scan forward "
        f"{want_shard['rglru_scan']} launches; all shards: {launches} "
        f"(fused, scan, scan backward); round loops under "
        f"set_sync_debug_mode('error'); wall: sharded {shard_s:.3f} s, "
        f"unsharded {plain_s:.3f} s, ratio {shard_s / plain_s:.3f} (the "
        f"shard path's cost with {ndev} shards on {len(set(devices))} "
        f"card(s), not a multi-card speed-up); non-finite AUROC in {bad} "
        f"of {total}")
    return launches


def phase_shard_campaign(torch, split, dx, counts):
    """Scenario sharding (``ExecPlan(shard=True)``): every campaign of
    :func:`_shard_workloads` over ``SHARD_DEVICES`` shards placed on the
    one card, bit for bit the unsharded run at the shard's chunk, each
    shard's kernels counted, the loops sync-free; ``shard=True`` with the
    real device count degrading on one card; and over the real cards
    where there are several.  Returns the sharded runs' launches."""
    import warnings
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.campaign import ExecPlan, run_campaign
    tag = "shard-campaign"
    card = torch.device(DEV, 0)
    total = {"tolfl_round_update": 0, "rglru_scan": 0, "rglru_scan_bwd": 0}
    work = _shard_workloads(split, dx, counts)
    for label, buckets, per_loop, run in work:
        got = _sharded_run(torch, tag, label, buckets, per_loop, run,
                           [card] * SHARD_DEVICES)
        for key, n in zip(total, got):
            total[key] += n
    # the real device count: one card warns once and runs unsharded
    n_cards = torch.cuda.device_count()
    traces = _campaign_traces()[:2]
    small = lambda plan: run_campaign(                          # noqa: E731
        COMMSML, dx, counts, split.test_x, split.test_y,
        _campaign_cfg(rounds=5), traces, CAMPAIGN_SEEDS, exec_plan=plan)
    if n_cards == 1:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = small(ExecPlan(shard=True))
        msgs = [str(w.message) for w in rec]
        if len(msgs) != 1 or "single local device" not in msgs[0]:
            raise AssertionError(f"[{tag}] ExecPlan(shard=True) on one "
                                 f"card warned {msgs}")
        if not _same_bits([got], [small(ExecPlan())]):
            raise AssertionError(f"[{tag}] ExecPlan(shard=True) on one card "
                                 f"differs from the unsharded run")
        log(f"[{tag}] ExecPlan(shard=True) with the real device count (1): "
            f"one warning, the unsharded run's bits; the run over several "
            f"real cards did not run: this machine has one card")
    else:
        label, buckets, per_loop, run = work[0]
        got = _sharded_run(torch, tag, f"{label}, real cards", buckets,
                           per_loop, run,
                           [torch.device("cuda", i) for i in range(n_cards)])
        for key, n in zip(total, got):
            total[key] += n
    return total


def phase_plancheck(torch, split, dx, counts):
    """``plan(spec, check=True)`` on [experiment]'s spec at full shapes,
    for both bodies: one round of each bucket on the meta device, which
    must give zero findings and launch no kernel; each bucket's aten ops
    a round beside its budget."""
    from repro_torch.core import experiment as X
    _, seeds = _exp_seeds(split, dx, counts)
    _zero_seq_counts()
    for body in ("seq", "ae"):
        model, lr = _body(body)
        t0 = time.perf_counter()
        plan = X.plan(_exp_spec(model, split, dx, counts, seeds, lr=lr),
                      check=True)
        rep = plan.report
        log(f"[plancheck] {body}: plan(check=True) in "
            f"{time.perf_counter() - t0:.3f} s\n" + rep.describe())
        if not rep.clean or len(rep.buckets) != len(plan.buckets):
            raise AssertionError(f"[plancheck] {body}: {rep.describe()}")
    if any(_seq_counts()):
        raise AssertionError(f"[plancheck] the meta rounds launched "
                             f"kernels: {_seq_counts()}")


def phase_examples(torch):
    """Each of the port's example scripts with ``--smoke`` on the card, in
    this process (``python -m repro_torch.examples.<name> --smoke``): the
    quickstart's AUROCs, failure_scenarios with ``--shard`` (one warning,
    the unsharded path), score_stream's service (nothing dropped, its
    failover asserted bit for bit inside) and serve_batch's default archs
    and ``--arch granite-3-2b``; their own output goes to a buffer, its
    last lines to the log."""
    import contextlib
    import io
    import warnings
    import numpy as np
    from repro_torch.examples import (failure_scenarios, quickstart,
                                      score_stream, serve_batch)
    runs = (("quickstart", quickstart, []),
            ("failure_scenarios", failure_scenarios, ["--shard"]),
            ("score_stream", score_stream, []),
            ("serve_batch", serve_batch, []),
            ("serve_batch", serve_batch, ["--arch", "granite-3-2b"]))
    for name, mod, extra in runs:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = mod.main(["--smoke"] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "quickstart":
            ok = all(0.0 <= v <= 1.0 for v in out.values())
        elif name == "failure_scenarios":
            ok = (sum("single local device" in str(w.message) for w in rec)
                  == 1 and all(np.isfinite(r.loss_curves).all()
                               for r in out.results))
        elif name == "score_stream":
            ok = out[1].dropped == 0 and out[1].failovers > 0
        else:
            ok = all(t.is_cuda and t.shape == (2, 4) for t in out.values())
        tail = " | ".join(ln for ln in buf.getvalue().splitlines()[-3:]
                          if ln.strip())
        log(f"[examples] {name} --smoke {' '.join(extra)} on the card: "
            f"{wall:.2f} s, checks {'passed' if ok else 'FAILED'}; last "
            f"lines: {tail}")
        if not ok:
            raise AssertionError(f"[examples] {name} {extra}: {out}")


def _samples_ms(torch, fn, device_only, samples):
    """``samples`` times, in ms, between CUDA events recorded before and
    after one call of ``fn``, after 10 calls of warm-up.  With
    ``device_only`` a spin kernel keeps the card busy while the host
    enqueues the events and the call, so the events time the call's work
    on the card alone; without it they also time the host's dispatch of
    the call."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def _median_ms(torch, fn, device_only, samples=SAMPLES):
    """Median of :func:`_samples_ms`."""
    return statistics.median(_samples_ms(torch, fn, device_only, samples))


def _turns_ms(torch, fns, device_only, samples, turns=4):
    """Median ms of each of ``fns`` timed in turns: ``turns`` rounds of
    ``samples / turns`` timings each, in order and then in reverse, so
    that a drift of the card's clock falls on all of them alike."""
    return _turns_spread_ms(torch, fns, device_only, samples, turns)[0]


def _turns_spread_ms(torch, fns, device_only, samples, turns=4):
    """:func:`_turns_ms`'s medians, and each function's spread: the range
    of its ``turns`` per-turn medians, in ms."""
    times = {key: [] for key in fns}
    per_turn = {key: [] for key in fns}
    for t in range(turns):
        for key in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            got = _samples_ms(torch, fns[key], device_only, samples // turns)
            times[key] += got
            per_turn[key].append(statistics.median(got))
    return ({key: statistics.median(v) for key, v in times.items()},
            {key: max(v) - min(v) for key, v in per_turn.items()})


def _round_bytes(S, N, P, faulty):
    """Bytes the fused kernel must move: the deltas and params read, the new
    params written, and the per-device operands (counts, w, ids, scale)
    and n_tot."""
    return (S * N * P + 2 * S * P + N + (3 if faulty else 2) * S * N + S) * 4


def _round_flops(S, N, k, P, faulty):
    """The fused kernel's float operations: a multiply-add per delta (and
    the faulty scale's multiply), per cluster a divide and the combine's
    two multiplies and add, and the step's multiply and subtract."""
    return S * P * (N * (3 if faulty else 2) + 4 * k + 2)


def phase_times(torch, launches, errs, parent=None):
    """The Tol-FL kernels: the standalone combine at (5, 49,680) and the
    fused round at S = 1 and S = 64, each beside its plain version, a
    library call or the unfused eager sequence, the card's bound, and (with
    --parent) the parent's combine kernel, in turns."""
    from repro_torch.kernels import tolfl_combine as tc
    rows = []
    k, p = COMBINE_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    gs = torch.randn((k, p), generator=gen, device="cuda")
    ns = torch.tensor([1125.0, 1125.0, 1125.0, 0.0, 0.0], device="cuda")
    fns = {"kernel": lambda: tc.tolfl_combine_cuda(gs, ns),
           "library (ns/ns.sum())@gs": lambda: (ns / ns.sum()) @ gs}
    if parent and "tolfl_combine" in parent:
        fns["parent kernel"] = lambda: _parent_combine_fn(torch, parent)(
            gs, ns)
        if not torch.equal(fns["kernel"](), fns["parent kernel"]()):
            raise AssertionError("tolfl_combine differs from the parent's "
                                 "kernel")
    dev_ms = _turns_ms(torch, fns, True, SAMPLES)
    call_ms = _turns_ms(torch, fns, False, SAMPLES)
    plain_ms = _median_ms(torch, lambda: tc.tolfl_combine_plain(gs, ns),
                          True)
    _, _, by_name = _profiled(torch, fns["kernel"])
    prof_us = _event_us(by_name, "combine_kernel")
    moved = (k * p + k + p) * 4          # each input read, output written
    flops = 3 * k * p + 3 * k            # 2 mul + 1 add per element per i
    bound_bytes = moved / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_F32_FLOPS * 1e3
    bound = max(bound_bytes, bound_ops)
    log(f"[times] tolfl_combine k={k} P={p}, median of {SAMPLES} CUDA-event "
        f"timings in 4 turns, card / call: " + ", ".join(
            f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms" for key in fns)
        + f"; plain {plain_ms:.6f} ms on the card alone; the kernel's device "
        f"duration under torch.profiler {prof_us:.3f} us (32 calls); bound "
        f"{bound:.6f} ms ({moved} bytes)")
    rows.append({
        "name": "tolfl_combine", "route": "cuda",
        "source": "src/repro_torch/csrc/tolfl_combine.cu",
        "replaces": "src/repro/kernels/tolfl_combine.py:44",
        "launches": launches["tolfl_combine"],
        "max_abs_err": errs["tolfl_combine"],
        "ms": dev_ms["kernel"], "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": dev_ms["library (ns/ns.sum())@gs"],
        "profiler_ms": prof_us / 1e3,
        "path": "aggregation.stacked_streaming_mean; off the round loop, "
                "which calls tolfl_round_update"})
    if "parent kernel" in fns:
        rows[-1]["parent_ms"] = dev_ms["parent kernel"]
    del gs, ns, fns

    # the fused round at the paper's shape (S = 1), against the unfused eager
    # sequence (the parent's combine kernel with --parent) and an empty
    # kernel on the same grid
    lr = 1e-3
    case = tc.ROUND_CARD_CASES[0]
    args = tc.round_inputs(case, gen)
    S, N, k, P = case.S, case.N, case.k, case.P
    combine = (_parent_combine_fn(torch, parent)
               if parent and "tolfl_combine" in parent
               else tc.tolfl_combine_cuda)
    eager = _eager_round_update(torch, combine)
    want = tc.tolfl_round_update_cuda(*args, lr, k)[0]
    got = eager(*args, lr, k)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    fns = {"fused kernel": lambda: tc.tolfl_round_update_cuda(*args, lr, k),
           "eager sequence": lambda: eager(*args, lr, k)}
    dev_ms = _turns_ms(torch, fns, True, SAMPLES)
    call_ms = _turns_ms(torch, fns, False, SAMPLES)
    plain_ms = _median_ms(torch, lambda: tc.tolfl_round_update_plain(
        *args, lr, k), True, 20)
    _, _, by_name = _profiled(torch, fns["fused kernel"])
    fused_us = _event_us(by_name, "round_update_kernel")
    _, _, by_name = _profiled(torch, lambda: tc.empty_launch(S, P))
    floor_us = _event_us(by_name, "empty_kernel")
    eager_busy, eager_events, _ = _profiled(torch, fns["eager sequence"])
    moved = _round_bytes(S, N, P, False)
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    b_ops = _round_flops(S, N, k, P, False) / H100_F32_FLOPS * 1e3
    bound = max(b_bytes, b_ops)
    fused_ms = dev_ms["fused kernel"]
    log(f"[times] tolfl_round_update (S, N, k, P) = {(S, N, k, P)}, median "
        f"of {SAMPLES} CUDA-event timings in 4 turns, card / call: "
        + ", ".join(f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms"
                    for key in fns)
        + f"; plain {plain_ms:.6f} ms (median of 20, card alone); under "
        f"torch.profiler (32 calls): fused kernel {fused_us:.3f} us, an "
        f"empty kernel on its grid {floor_us:.3f} us, the eager sequence "
        f"{eager_busy:.3f} busy us in {eager_events:.1f} device kernels a "
        f"call; bound {bound:.6f} ms ({moved} bytes at 3.35 TB/s); the fused "
        f"call takes {call_ms['fused kernel'] / call_ms['eager sequence']:.1%}"
        f" of the eager sequence's with the host's dispatch; combine in the "
        f"eager sequence: the {'parent' if combine is not tc.tolfl_combine_cuda else 'current'} "
        f"tolfl_combine kernel")
    row = {
        "name": "tolfl_round_update", "route": "cuda",
        "source": "src/repro_torch/csrc/tolfl_combine.cu",
        "replaces": "src/repro/kernels/tolfl_combine.py:44",
        "launches": launches["tolfl_round_update"],
        "max_abs_err": errs["tolfl_round_update"],
        "ms": fused_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": dev_ms["eager sequence"],
        "library": "the unfused eager sequence of 16 launches, not one call",
        "call_ms": call_ms["fused kernel"],
        "library_call_ms": call_ms["eager sequence"],
        "profiler_ms": fused_us / 1e3, "launch_floor_ms": floor_us / 1e3}
    del args, fns

    # the campaign's shapes: its 64-scenario grid (here with a faulty
    # channel) and its fused sweep's 96 scenarios with the cluster axis
    # padded to 10, where the kernel can be held to a bound the card can reach
    for name, key in (("scenarios", "s64"), ("campaign_sweep", "s96")):
        case = next(c for c in tc.ROUND_CARD_CASES if c.name == name)
        args = tc.round_inputs(case, gen)
        S, N, k, P = case.S, case.N, case.k, case.P
        ms = _median_ms(torch, lambda: tc.tolfl_round_update_cuda(
            *args, lr, k), True)
        moved = _round_bytes(S, N, P, case.faulty)
        b_bytes = moved / H100_BYTES_PER_S * 1e3
        b_ops = _round_flops(S, N, k, P, case.faulty) / H100_F32_FLOPS * 1e3
        s_bound = max(b_bytes, b_ops)
        log(f"[times] tolfl_round_update (S, N, k, P) = {(S, N, k, P)} "
            f"({case.name}{', faulty channel' if case.faulty else ''}; ids "
            f"{case.ids}), median of {SAMPLES} CUDA-event timings on the "
            f"card alone: {ms:.6f} ms, {moved / ms / 1e6:.1f} GB/s; bound "
            f"{s_bound:.6f} ms ({moved} bytes at 3.35 TB/s), "
            f"{s_bound / ms:.1%} of it; clocks.sm, power.draw, temperature "
            f"after: {_clocks()}")
        row.update({f"{key}_ms": ms, f"{key}_bound_ms": s_bound,
                    f"{key}_share_of_bound": s_bound / ms})
        del args
    rows.append(row)
    rows.append(_row_dense_times(torch, launches, errs, parent))
    return rows


def _row_dense_times(torch, launches, errs, parent=None):
    """The score path's row-stable product at the service's largest
    product (the autoencoder's first layer over a 64-bucket, (2,048, 112,
    128)) and at SeqDetector's (14,336, 16, 16): kernel, plain version
    (``x @ w + b``), ``torch.addmm`` and an empty kernel (the launch
    floor; ``tolfl_combine``'s, on a grid of 1 x 49,680), in turns with,
    under --parent, the parent's kernel, which it must beat at both,
    beside the bound."""
    from repro_torch.kernels import row_dense as rd
    from repro_torch.kernels import tolfl_combine as tc
    gen = torch.Generator(device=DEV).manual_seed(10)
    row = None
    for key, (M, K, N) in (("ae", (64 * ANOMALY_WINDOW, 112, 128)),
                           ("seq", (64 * ANOMALY_WINDOW * 7, 16, 16))):
        x = torch.randn((M, K), generator=gen, device=DEV)
        w = torch.randn((K, N), generator=gen, device=DEV)
        b = torch.randn((N,), generator=gen, device=DEV)
        fns = {"kernel": lambda: rd.row_dense_cuda(x, w, b),
               "plain": lambda: rd.row_dense_plain(x, w, b),
               "library addmm": lambda: torch.addmm(b, x, w),
               "empty kernel": lambda: tc.empty_launch(1, 49_680)}
        if parent and "row_dense" in parent:
            fns["parent kernel"] = lambda: _parent_row_dense(torch, parent,
                                                             x, w, b)
        dev_ms, spread = _turns_spread_ms(torch, fns, True, SAMPLES)
        call_ms = _turns_ms(torch, fns, False, SAMPLES)
        _, _, by_name = _profiled(torch, fns["kernel"])
        prof_us = _event_us(by_name, "row_dense_kernel")
        _, _, by_name = _profiled(torch, fns["empty kernel"])
        floor_us = _event_us(by_name, "empty_kernel")
        moved = (M * K + K * N + N + M * N) * 4
        flops = 2 * M * K * N
        b_bytes = moved / H100_BYTES_PER_S * 1e3
        b_ops = flops / H100_F32_FLOPS * 1e3
        bound = max(b_bytes, b_ops)
        ms = dev_ms["kernel"]
        log(f"[times] row_dense (M, K, N) = {(M, K, N)} ({key} score "
            f"product), median of {SAMPLES} CUDA-event timings in 4 turns, "
            f"card / call: " + ", ".join(
                f"{k} {dev_ms[k]:.6f} / {call_ms[k]:.6f} ms" for k in fns)
            + " (turns' spread: " + ", ".join(
                f"{k} {spread[k]:.6f}" for k in fns)
            + f"); {dev_ms['library addmm'] / ms:.3f}x addmm's speed"
            + (f", {dev_ms['parent kernel'] / ms:.3f}x the parent's"
               if "parent kernel" in fns else "")
            + f"; device durations under torch.profiler (32 calls): the "
            f"kernel {prof_us:.3f} us, the empty kernel {floor_us:.3f} us; "
            f"bound {bound:.6f} ms ({flops} flops at 67 TFLOP/s float32; "
            f"{moved} bytes take {b_bytes:.6f} ms), {bound / ms:.1%} of it")
        if row is None:
            row = {
                "name": "row_dense", "route": "cuda",
                "source": "src/repro_torch/csrc/row_dense.cu",
                "replaces": "src/repro/serving/anomaly/engine.py:55 (the "
                            "score core's products, left to XLA; no Pallas "
                            "kernel)",
                "launches": launches["row_dense launches"],
                "graph_launches": launches["row_dense graph_launches"],
                "max_abs_err": errs["row_dense"],
                "ms": ms, "plain_ms": dev_ms["plain"], "bound_ms": bound,
                "bound_by": "operations" if b_ops >= b_bytes else "bytes",
                "library_ms": dev_ms["library addmm"],
                "call_ms": call_ms["kernel"], "profiler_ms": prof_us / 1e3,
                "launch_floor_ms": dev_ms["empty kernel"],
                "profiler_floor_ms": floor_us / 1e3,
                "share_of_bound": bound / ms}
            if "parent kernel" in fns:
                _faster_than_parent(row, dev_ms["parent kernel"])
        else:
            row.update({f"{key}_ms": ms, f"{key}_plain_ms": dev_ms["plain"],
                        f"{key}_library_ms": dev_ms["library addmm"],
                        f"{key}_bound_ms": bound,
                        f"{key}_launch_floor_ms": dev_ms["empty kernel"],
                        f"{key}_profiler_ms": prof_us / 1e3,
                        f"{key}_profiler_floor_ms": floor_us / 1e3})
            if "parent kernel" in fns:
                seq_row = {"name": "row_dense seq", "ms": ms}
                _faster_than_parent(seq_row, dev_ms["parent kernel"])
                row[f"{key}_parent_ms"] = seq_row["parent_ms"]
        del x, w, b, fns
    return row


def _parent_combine_fn(torch, parent):
    """The parent's combine kernel as a (k, P), (k,) -> (P,) function."""
    def combine(gs, ns):
        out = torch.empty((gs.shape[1],), dtype=torch.float32,
                          device=gs.device)
        err = parent["tolfl_combine"](
            gs.data_ptr(), ns.data_ptr(), out.data_ptr(), gs.shape[0],
            gs.shape[1], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's tolfl_combine failed: {err}")
        return out
    return combine


def _full_params(torch, arch, tag):
    """The arch's config at full width (its depth cut where SERVE_DEPTH
    says, logged as ``reduced``; its ``param_dtype`` where
    SERVE_PARAM_DTYPE names one) and random params on the card."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(
        get_arch(arch), param_dtype=SERVE_PARAM_DTYPE.get(arch, "float32"))
    size = getattr(torch, cfg.param_dtype).itemsize
    if arch in SERVE_DEPTH:
        full = cfg
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTH[arch])
        log(f"[{tag}serve] reduced: depth {full.num_layers} -> "
            f"{cfg.num_layers} layers (full width); {full.param_count()} "
            f"{cfg.param_dtype} params ({full.param_count() * size / 1e9:.1f}"
            f" GB) at full depth do not fit the card's 80 GB, "
            f"{cfg.param_count()} ({cfg.param_count() * size / 1e9:.1f} GB) "
            f"do")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=DEV).manual_seed(0),
                           cfg, DEV)
    torch.cuda.synchronize()
    extra = ""
    if cfg.is_encdec:
        extra += (f", encoder {cfg.num_encoder_layers} layers over "
                  f"{cfg.encoder_seq} frames")
    if cfg.moe.num_experts:
        m = cfg.moe
        extra += (f", MoE {m.num_experts} experts top-{m.num_experts_per_tok}"
                  f" capacity {m.capacity_factor}"
                  f"{' + shared expert' if m.shared_expert else ''} every "
                  f"{m.interleave} layer(s)")
    if cfg.frontend.kind == "vision":
        extra += f", vision prefix of {cfg.frontend.frontend_seq} patches"
    log(f"[{tag}serve] {cfg.name}: {cfg.num_layers} layers "
        f"{''.join(k[0] for k in cfg.layer_pattern)}, d {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        f"{'' if cfg.tie_embeddings else ' (untied head)'}{extra}; params "
        f"{P.param_count(params)} ({P.param_bytes(params)} bytes, "
        f"{cfg.param_dtype}; analytic {cfg.param_count()}), activations "
        f"{cfg.dtype}; random init on the card in "
        f"{time.perf_counter() - t0:.2f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes after it")
    return cfg, params


def _prompt(cfg):
    """(prompt tokens, positions before the first generated one) of a
    served arch: a vision prefix's patches come first."""
    S = SERVE_PROMPTS.get(cfg.name, SERVE_PROMPT)
    return S, S + (cfg.frontend.frontend_seq
                   if cfg.frontend.kind == "vision" else 0)


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import rwkv6_scan as wk
    return {"flash_attention": fa, "rglru_scan": rs, "rwkv6_scan": wk}


def _reset_launches():
    for mod in _counters().values():
        mod.LAUNCHES = 0
    _counters()["flash_attention"].TC_LAUNCHES = 0
    _counters()["flash_attention"].WS_LAUNCHES = 0


def _launches():
    return {name: mod.LAUNCHES for name, mod in _counters().items()}


def _expected_launches(cfg):
    """Each serving kernel's launches per prefill and per decode step:
    attention once per attention layer (for an encoder-decoder also once
    per encoder layer and once per decoder layer's cross-attention) and
    the RG-LRU scan once per recurrent layer in a prefill only; the WKV
    scan once per RWKV6 layer in a prefill and in every decode step."""
    pat = cfg.layer_pattern
    n_rwkv = pat.count("rwkv")
    n_attn = pat.count("attn") + pat.count("local")
    if cfg.is_encdec:
        n_attn += cfg.num_encoder_layers + cfg.num_layers
    prefill = {"flash_attention": n_attn,
               "rglru_scan": pat.count("rec"), "rwkv6_scan": n_rwkv}
    step = {"flash_attention": 0, "rglru_scan": 0, "rwkv6_scan": n_rwkv}
    return prefill, step


def phase_serve(torch, cfg, params, tag):
    """A serving main path: prefill, pad_cache, greedy decode at full
    width and depth.  Returns each kernel's launches over the run."""
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    want_prefill, want_step = _expected_launches(cfg)
    S, base = _prompt(cfg)
    gen = torch.Generator(device=DEV).manual_seed(1)
    # warm-up (cuBLAS handles and heuristics, the allocator), off the path
    prefill(params, cfg, synthetic_batch(cfg, 1, 256, gen, DEV))
    batch = synthetic_batch(cfg, SERVE_BATCH, S, gen, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = _launches()
    if counts != want_prefill:
        raise AssertionError(f"prefill launched {counts}, expected "
                             f"{want_prefill}")
    fa = _counters()["flash_attention"]
    tc, ws = fa.TC_LAUNCHES, fa.WS_LAUNCHES
    if tc != counts["flash_attention"]:
        raise AssertionError(f"{tc} of the prefill's "
                             f"{counts['flash_attention']} attention launches "
                             f"went to the tensor-core kernel")
    # every attention of a D <= 128 model on the warp-specialized kernel
    want_ws = (tc if cfg.attention.head_dim in fa.WS_HEAD_DIMS else 0)
    if ws != want_ws:
        raise AssertionError(f"{ws} of the prefill's {tc} tensor-core "
                             f"attention launches went to the warp-specialized "
                             f"kernel, expected {want_ws}")
    cache = pad_cache(cache, cfg, prompt_len=base,
                      target_len=base + SERVE_TOKENS)
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    out = [tok]
    steps = SERVE_TOKENS - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(steps):
            logits, cache = decode_step(params, cfg, tok, cache, base + i)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
            out.append(tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    after = _launches()
    want_after = {k: counts[k] + steps * want_step[k] for k in counts}
    if after != want_after:
        raise AssertionError(f"{steps} decode steps after a prefill launched "
                             f"{after} in all, expected {want_after}")
    if not bool(finite):
        raise AssertionError("non-finite logits in prefill or decode")
    gen_toks = torch.cat(out, dim=1)
    inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    log(f"[{tag}serve] batch {SERVE_BATCH} x prompt {S} ({inputs}; the first "
        f"generated token at position {base}), "
        f"{SERVE_TOKENS} greedy tokens: prefill {prefill_ms:.3f} ms "
        f"({SERVE_BATCH * base / prefill_ms * 1e3:.1f} positions/s), "
        f"decode {decode_ms:.3f} ms/token over {steps} steps "
        f"(under sync debug mode 'error'); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes; launches per prefill "
        f"{counts} ({tc} attention launches on the tensor cores, {ws} of "
        f"them on the warp-specialized kernel), per decode "
        f"step {want_step}, over the run {after}; all "
        f"logits finite; sample[0] {gen_toks[0, :12].tolist()}; clocks.sm, "
        f"power.draw, temperature after decode: {_clocks()}")
    return after


def phase_serve_consistency(torch, cfg, params, tag, dtype="float32"):
    """Batch 1: decode_step at the prompt's end against the last logits of
    a prefill one token longer, on the same frames or patches; an MoE arch
    at capacity factor E (each expert's capacity the chunk: no token is
    dropped; repro's tests/test_serving.py sets 16, Scout's E).  In
    float32 activations within tests/test_serving.py's 2e-3; in bf16
    (CONSISTENCY_BF16) the largest |diff| within CONSISTENCY_BF16_TOL of
    the largest |logit|."""
    import dataclasses
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    cfg1 = dataclasses.replace(cfg, dtype=dtype)
    if cfg.moe.num_experts:
        cfg1 = dataclasses.replace(cfg1, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    S, base = _prompt(cfg)
    batch = synthetic_batch(cfg1, 1, S + 1,
                            torch.Generator(device=DEV).manual_seed(3), DEV)
    toks = batch["tokens"]
    want, _ = prefill(params, cfg1, batch)
    _, cache = prefill(params, cfg1, dict(batch, tokens=toks[:, :S]))
    cache = pad_cache(cache, cfg1, prompt_len=base, target_len=base + 1)
    got, _ = decode_step(params, cfg1, toks[:, S:], cache, base)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    if dtype == "float32":
        tol = "rtol = atol = 2e-3"
    else:
        margin = CONSISTENCY_BF16_TOL * top / err if err else math.inf
        tol = (f"{CONSISTENCY_BF16_TOL} of max |logit|, "
               f"{CONSISTENCY_BF16_TOL * top}; read {err / top:.6f} of it, "
               f"a {margin:.2f}x margin")
    log(f"[{tag}serve-consistency] {dtype}, params {cfg.param_dtype}, "
        f"batch 1"
        + (f", MoE capacity factor {cfg1.moe.capacity_factor}"
           if cfg.moe.num_experts else "") + f": decode_step "
        f"at position {base} vs prefill of {S + 1} tokens"
        + (f" after {base - S} patches" if base > S else "")
        + f": max_abs_diff {err} (max |logit| {top}; tolerance {tol}); "
        f"argmax equal: {bool(torch.equal(got.argmax(-1), want.argmax(-1)))}")
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    elif not err <= CONSISTENCY_BF16_TOL * top:
        raise AssertionError(f"[{tag}serve-consistency] bf16: max_abs_diff "
                             f"{err} > {CONSISTENCY_BF16_TOL} x {top}")


def phase_serve_profile(torch, cfg, params, tag):
    """One prefill and 8 decode steps, each under its own torch.profiler
    window: the device's busy share, its top kernels and each kernel's
    share."""
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    steps = 8
    S, base = _prompt(cfg)
    batch = synthetic_batch(cfg, SERVE_BATCH, S,
                            torch.Generator(device=DEV).manual_seed(4),
                            DEV)
    torch.cuda.synchronize()
    state = {}

    def run_prefill():
        state["logits"], cache = prefill(params, cfg, batch)
        state["cache"] = pad_cache(cache, cfg, base, base + steps)

    def run_decode():
        tok = torch.argmax(state["logits"][:, :cfg.vocab_size], dim=-1)
        tok = tok[:, None]
        for i in range(steps):
            logits, state["cache"] = decode_step(params, cfg, tok,
                                                 state["cache"], base + i)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]

    for what, fn, per in (("prefill", run_prefill, 1),
                          ("decode", run_decode, steps)):
        with _device_profile(torch) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        busy, by_name = _device_time(prof)
        if busy == 0:
            log(f"[{tag}serve-profile] {what}: the profiler recorded no "
                f"device time: not measured")
            continue
        shares = ", ".join(
            f"{k} {v / per / 1e3:.3f} ms ({v / busy:.2%} of busy)"
            for k, v in ((k, sum(us for name, (us, _) in by_name.items()
                                 if k in name))
                         for k in SERVE_KERNELS))
        log(f"[{tag}serve-profile] {what} ({SERVE_BATCH} x {S}"
            + (f", {steps} steps, per step" if per > 1 else "")
            + f") under the profiler: wall {wall / per / 1e3:.3f} ms, "
            f"device busy {busy / per / 1e3:.3f} ms ({busy / wall:.1%} of "
            f"wall); {shares}; top device events per "
            f"{'step' if per > 1 else 'prefill'}: "
            + _top(by_name, 10, per * 1e3, "ms"))


def phase_serve_reference(torch, arch, tag):
    """The reduced config on the card against the same calls on the CPU,
    in float32 params and, where SERVE_PARAM_DTYPE names another, in
    those too (float32 activations)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    for param_dtype in dict.fromkeys(("float32",
                                      SERVE_PARAM_DTYPE.get(arch, "float32"))):
        _serve_reference(torch, dataclasses.replace(
            get_arch(arch).reduced(), param_dtype=param_dtype), tag)


def _serve_reference(torch, cfg, tag):
    """A ragged prompt of 100 tokens (past RecurrentGemma's reduced window,
    so the ring roll runs; after InternVL2's 16 patches; on whisper's 16
    frames), pad_cache, 3 decode steps, the same params (moved to the card
    leaf by leaf, bf16 ones too) and inputs on both."""
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    cpu = T.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    gpu = P.tree_map(lambda x: x.to(DEV), cpu)
    S, steps = 100, 3
    inputs = synthetic_batch(cfg, 2, S + steps,
                             torch.Generator().manual_seed(6), "cpu")
    base = S + (inputs["prefix"].shape[1] if "prefix" in inputs else 0)
    runs = {}
    for dev, params in ((DEV, gpu), ("cpu", cpu)):
        b = {k: v.to(dev) for k, v in inputs.items()}
        t = b["tokens"]
        logits, cache = prefill(params, cfg, dict(b, tokens=t[:, :S]))
        seq = [logits]
        cache = pad_cache(cache, cfg, base, base + steps)
        for i in range(steps):
            logits, cache = decode_step(params, cfg, t[:, S + i:S + i + 1],
                                        cache, base + i)
            seq.append(logits)
        runs[dev] = [x.cpu() for x in seq] + [
            x.cpu() for _, x in P.tree_items(cache)]
    worst = max(float((a - b).abs().max())
                for a, b in zip(runs[DEV], runs["cpu"]))
    # float32 on both (TF32 off): the card sums in other orders (its
    # GEMMs, the kernels), ~1e-6 relative; 1e-4 as the CPU parity tests
    # against repro
    for a, b in zip(runs[DEV], runs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    window = ("local" in cfg.layer_pattern) and cfg.attention.sliding_window
    extra = ", ".join(f"{k} {tuple(v.shape)}" for k, v in inputs.items()
                      if k != "tokens")
    log(f"[{tag}serve-reference] {cfg.name} (float32, params "
        f"{cfg.param_dtype}), prompt {S}"
        + (f" past the window {window}" if window else "")
        + (f" ({extra})" if extra else "")
        + f", {steps} decode steps: card vs CPU max_abs_diff {worst} over "
        f"the logits and every cache leaf (tolerance rtol = atol = 1e-4)")


def phase_bf16_params(torch):
    """BF16_PARAMS' arch at full width and its depth: float32 params cast
    to bf16 (``P.cast_tree``) against float32 params that hold the same
    rounded values, each through a 4 x 4,096 prefill, pad_cache and the
    decode steps in bf16 activations.  The logits, every cache leaf and
    the kernels' launches must be equal: bf16 params change nothing but
    the bytes held."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    arch, depth, steps = BF16_PARAMS
    cfg = dataclasses.replace(get_arch(arch), num_layers=depth)
    torch.cuda.reset_peak_memory_stats()
    p16 = P.cast_tree(T.init_params(
        torch.Generator(device=DEV).manual_seed(8), cfg, DEV), torch.bfloat16)
    rounded = P.cast_tree(p16, torch.float32)
    held = (P.param_bytes(p16), P.param_bytes(rounded))
    S = SERVE_PROMPT
    batch = synthetic_batch(cfg, SERVE_BATCH, S + steps,
                            torch.Generator(device=DEV).manual_seed(9), DEV)
    toks = batch["tokens"]
    fa = _counters()["flash_attention"]
    runs = {}
    for name, params in (("bfloat16", p16), ("float32", rounded)):
        c = dataclasses.replace(cfg, param_dtype=name)
        _reset_launches()
        logits, cache = prefill(params, c, dict(batch, tokens=toks[:, :S]))
        seq = [logits]
        cache = pad_cache(cache, c, S, S + steps)
        for i in range(steps):
            logits, cache = decode_step(params, c, toks[:, S + i:S + i + 1],
                                        cache, S + i)
            seq.append(logits)
        torch.cuda.synchronize()
        runs[name] = (seq + [x for _, x in P.tree_items(cache)],
                      dict(_launches(), tc=fa.TC_LAUNCHES, ws=fa.WS_LAUNCHES))
    (a, la), (b, lb) = runs["bfloat16"], runs["float32"]
    same = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
    worst = max(float((x.float() - y.float()).abs().max())
                for x, y in zip(a, b))
    log(f"[bf16-params] {cfg.name} at full width, {depth} layers: params "
        f"{held[0]} bytes in bfloat16 beside {held[1]} in float32 holding "
        f"the same rounded values (max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes); activations "
        f"{cfg.dtype}, batch {SERVE_BATCH} x prompt {S}, pad_cache, {steps} "
        f"decode steps on each: {sum(same)} of {len(same)} outputs (logits "
        f"of each step, every cache leaf) equal under torch.equal, max_abs_"
        f"diff {worst}; launches bfloat16 {la}, float32 {lb}")
    if not all(same) or la != lb:
        raise AssertionError("[bf16-params] bf16 params and their rounded "
                             "float32 copy differ")
    if la["flash_attention"] != depth or la["ws"] != depth:
        raise AssertionError(f"[bf16-params] launched {la}, expected "
                             f"{depth} warp-specialized attention launches")


def visible_pairs(S, causal, window):
    """(query, key) pairs the mask lets through for Sq = Sk = S."""
    total = 0
    for i in range(S):
        hi = i if causal else S - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def phase_serve_times(torch, launches, errs, arch_launches, parent=None):
    """The serving kernels at their prefills' shapes: kernel, plain
    version and one library call, beside the card's bound.  "card" times
    the work on the card alone, "call" adds the host's dispatch."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import rwkv6_scan as wk
    gen = torch.Generator(device=DEV).manual_seed(7)
    rows = []
    B, S, H, KVH, D, causal, window = ATTN_CASES[0]
    q = torch.randn((B, S, H, D), generator=gen, device=DEV).bfloat16()
    k = torch.randn((B, S, KVH, D), generator=gen, device=DEV).bfloat16()
    v = torch.randn((B, S, KVH, D), generator=gen, device=DEV).bfloat16()
    band = fa.visible(S, S, causal, window, DEV)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"tensor-core kernel": lambda: fa.flash_attention_cuda(
               q, k, v, causal, window),
           "split-TF32 kernel": lambda: fa.flash_attention_cuda(
               q, k, v, causal, window, kernel="tf32x3"),
           "plain": lambda: fa.flash_attention_plain(q, k, v, causal, window),
           "library sdpa": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=band, enable_gqa=True)}
    same = None
    if parent and "flash_attention_wgmma" in parent:
        fns["parent kernel"] = lambda: _parent_attn(torch, parent, q, k, v,
                                                    causal, window)
        same = torch.equal(fns["tensor-core kernel"](), fns["parent kernel"]())
    n = 20
    dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    pairs = visible_pairs(S, causal, window)
    flops = 4 * B * H * D * pairs
    moved = (2 * B * S * H * D + 2 * B * S * KVH * D) * 2
    b_ops = flops / H100_BF16_FLOPS * 1e3
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    bound = max(b_ops, b_bytes)
    tc_ms = dev_ms["tensor-core kernel"]
    tiles = sum(count for _, count in fa.wgmma_tiles(S, S, H // KVH, causal,
                                                     window, D))
    rows_b, keys_t = fa.wgmma_plan(D)[:2]
    tile_pairs = tiles * keys_t * rows_b * B * KVH
    log(f"[times] flash_attention bf16 (B, S, H, KVH, D) = "
        f"{(B, S, H, KVH, D)} window {window}, median of {n} CUDA-event "
        f"timings in 4 turns, card / call: " + ", ".join(
            f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms"
            for key in fns)
        + f"; bound {bound:.6f} ms ({flops} flops over "
        f"{pairs} visible pairs at 989 TFLOP/s; {moved} bytes take "
        f"{b_bytes:.6f} ms); tensor-core kernel {flops / tc_ms / 1e9:.1f} "
        f"TFLOP/s, {bound / tc_ms:.1%} of the bound, "
        f"{dev_ms['split-TF32 kernel'] / tc_ms:.2f}x faster than the "
        f"split-TF32 kernel and {dev_ms['library sdpa'] / tc_ms:.2f}x than "
        f"SDPA; its "
        f"tiles hold {tile_pairs} (query, key) pairs of rows, "
        f"{tile_pairs / (B * H * pairs) - 1:.2%} more than visible"
        + (f"; {dev_ms['parent kernel'] / tc_ms:.3f}x the parent's speed "
           f"(turns' spread: kernel {spread['tensor-core kernel']:.6f}, parent "
           f"{spread['parent kernel']:.6f} ms), output bitwise equal to the "
           f"parent's: {same}" if "parent kernel" in fns else "")
        + f"; clocks.sm, power.draw, temperature after: {_clocks()}")
    if not tc_ms < min(dev_ms["library sdpa"], dev_ms["split-TF32 kernel"]):
        raise AssertionError("the tensor-core kernel is not faster than SDPA "
                             "and the split-TF32 kernel")
    rows.append({
        "name": "flash_attention", "arch": "recurrentgemma-9b",
        "route": "cuda", "shape": [B, S, H, KVH, D],
        "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:90",
        "launches": arch_launches["recurrentgemma-9b"]["flash_attention"],
        "max_abs_err": errs["flash_attention"],
        "ms": tc_ms, "plain_ms": dev_ms["plain"],
        "bound_ms": bound,
        "bound_by": "operations" if b_ops >= b_bytes else "bytes",
        "library_ms": dev_ms["library sdpa"],
        "tflops": flops / tc_ms / 1e9, "share_of_bound": bound / tc_ms})
    if "parent kernel" in fns:
        rows[-1]["parent_equal"] = same
        _no_slower_than_parent(rows[-1], dev_ms["parent kernel"], max(
            spread["tensor-core kernel"], spread["parent kernel"]))
    del q, k, v, qt, kt, vt, band, fns
    rows.append(_attn_f32_times(torch, launches, errs, gen, parent))
    for arch in DECODERS:
        B, S, H, KVH, D, causal, _ = _decoder_attn(arch)
        rows.append(_attn_times(torch, arch,
                                (B, S, S, H, KVH, D, causal),
                                arch_launches[arch], errs, gen, parent))
    for label, archs, shape in _zoo_attn():
        rows.append(_attn_times(torch, label, shape, {"flash_attention": sum(
            arch_launches[a]["flash_attention"] for a in archs)}, errs, gen,
            parent))
        rows[-1]["archs"] = list(archs)

    B, S, W, _ = SCAN_CASES[0]
    a = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=DEV))
    b = torch.randn((B, S, W), generator=gen, device=DEV)
    fns = {"kernel": lambda: rs.rglru_scan_cuda(a, b)}
    if parent and "rglru_scan" in parent:
        fns["parent kernel"] = lambda: _parent_rglru(torch, parent, a, b)
        if not torch.equal(fns["kernel"](), fns["parent kernel"]()):
            raise AssertionError("rglru_scan differs from the parent's kernel")
    n = 48
    dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    plain_ms = _median_ms(torch, lambda: rs.rglru_scan_plain(a, b), True, 3)
    moved = 3 * B * S * W * 4
    flops = 2 * B * S * W
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    b_ops = flops / H100_F32_FLOPS * 1e3
    bound = max(b_bytes, b_ops)
    log(f"[times] rglru_scan (B, S, W) = {(B, S, W)}, median of {n} "
        f"CUDA-event timings in 4 turns, card / call: " + ", ".join(
            f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms" for key in fns)
        + f"; plain {plain_ms:.6f} ms (median of 3; its {S} steps are "
        f"dispatched by the host), library none (no single PyTorch call "
        f"computes the recurrence); bound {bound:.6f} ms ({moved} bytes at "
        f"3.35 TB/s); kernel {moved / dev_ms['kernel'] / 1e6:.1f} GB/s, "
        f"{bound / dev_ms['kernel']:.1%} of the bound")
    rows.append({
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:48",
        "launches": launches["rglru_scan"],
        "graph_launches": launches["rglru_scan graph_launches"],
        "max_abs_err": errs["rglru_scan"],
        "ms": dev_ms["kernel"], "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None, "share_of_bound": bound / dev_ms["kernel"]})
    if "parent kernel" in fns:   # the streaming kernel, at a parent's shape
        _no_slower_than_parent(rows[-1], dev_ms["parent kernel"], max(
            spread["kernel"], spread["parent kernel"]))
    del a, b, fns
    rows += _seq_scan_times(torch, rows[-1], launches, errs, gen, parent)

    for B, S, H, N, _, _ in (wk.CARD_CASES[0], WKV_DECODE):
        args = wk.random_inputs(B, S, H, N, True, gen)
        fns = {"kernel": lambda: wk.rwkv6_scan_cuda(*args)}
        if parent and "rwkv6_scan" in parent:
            fns["parent kernel"] = lambda: _parent_wkv(torch, parent, *args)
            for got, want in zip(fns["kernel"](), fns["parent kernel"]()):
                torch.testing.assert_close(got, want, rtol=WKV_TOL,
                                           atol=WKV_TOL)
        n = 48 if S > 1 else 200
        dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
        call_ms = _turns_ms(torch, fns, False, n)
        plain_ms = _median_ms(torch, lambda: wk.rwkv6_scan_plain(*args),
                              True, 3)
        # r, k, v, w read and y written once, the state read and written
        # once, u read once.  The function needs 5 flops per (b, t, h, n,
        # m): y_m = sum_n r_n S[n, m] + v_m sum_n r_n u_n k_n takes a
        # multiply and an add per (n, m) (the bonus sum is one scalar per
        # (t, h)), the update w_n S[n, m] + k_n v_m two multiplies and an add
        moved = (5 * B * S * H * N + 2 * B * H * N * N + H * N) * 4
        flops = 5 * B * S * H * N * N
        b_bytes = moved / H100_BYTES_PER_S * 1e3
        b_ops = flops / H100_F32_FLOPS * 1e3
        bound = max(b_bytes, b_ops)
        log(f"[times] rwkv6_scan (B, S, H, N) = {(B, S, H, N)}, median of "
            f"{n} CUDA-event timings in 4 turns, card / call: " + ", ".join(
                f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms"
                for key in fns)
            + f"; plain {plain_ms:.6f} ms (median of 3; its {S} steps are "
            f"dispatched by the host), library none (no single PyTorch call "
            f"computes the recurrence); bound {bound:.6f} ms ({flops} flops "
            f"at 67 TFLOP/s float32; {moved} bytes take {b_bytes:.6f} ms); "
            f"kernel {bound / dev_ms['kernel']:.1%} of the bound; clocks.sm, "
            f"power.draw, temperature after: {_clocks()}")
        if S == 1:
            continue
        rows.append({
            "name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan.py:59",
            "launches": launches["rwkv6_scan"],
            "max_abs_err": errs["rwkv6_scan"],
            "ms": dev_ms["kernel"], "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None, "share_of_bound": bound / dev_ms["kernel"]})
        if "parent kernel" in fns:
            _parent_gate(rows[-1], "rwkv6_scan", dev_ms, spread)
        del args, fns
    return rows


def _attn_f32_times(torch, launches, errs, gen, parent=None):
    """The float32 route, the split-TF32 forward (csrc/flash_attention.cu),
    at ``F32_FWD_TIMES`` beside SDPA on the same float32 inputs, the plain
    version and the bound: three TF32 passes of 4 D flops per visible
    (query, head, key) triple at 495 TFLOP/s, or its float32 bytes at 3.35
    TB/s (and one float32 pass on the CUDA cores at 67 TFLOP/s beside it).
    With --parent the parent's kernel (the same entry point) runs in
    turns: the output within 2e-4 of the parent's, and faster."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for B, S, H, KVH, D, causal, window, with_lse in F32_FWD_TIMES:
        q = torch.randn((B, S, H, D), generator=gen, device=DEV)
        k, v = (torch.randn((B, S, KVH, D), generator=gen, device=DEV)
                for _ in range(2))
        band = fa.visible(S, S, causal, window, DEV)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fns = {"split-TF32 kernel": lambda: fa.flash_attention_cuda(
                   q, k, v, causal, window, return_lse=with_lse),
               "library sdpa": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=band, enable_gqa=True)}
        parent_err = None
        if parent and "flash_attention" in parent:
            fns["parent kernel"] = lambda: _parent_attn_f32(
                torch, parent, q, k, v, causal, window, with_lse)
            got, want = (fns[key]() for key in ("split-TF32 kernel",
                                                "parent kernel"))
            if with_lse:
                got, want = got[0], want[0]
            parent_err = float((got - want).abs().max())
            if not parent_err <= 2e-4:
                raise AssertionError(f"flash_attention float32 at "
                                     f"{(B, S, H, KVH, D)}: {parent_err} "
                                     f"from the parent's output")
        n = 8
        dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
        call_ms = _turns_ms(torch, fns, False, n)
        plain_ms = _median_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal, window), True, 3)
        pairs = visible_pairs(S, causal, window)
        flops = 4 * B * H * D * pairs
        moved = (2 * B * S * H * D + 2 * B * S * KVH * D) * 4 + (
            B * H * S * 4 if with_lse else 0)
        b_ops = 3 * flops / H100_TF32_FLOPS * 1e3
        b_f32 = flops / H100_F32_FLOPS * 1e3
        b_bytes = moved / H100_BYTES_PER_S * 1e3
        bound = max(b_ops, b_bytes)
        ms = dev_ms["split-TF32 kernel"]
        log(f"[times] flash_attention float32 (B, S, H, KVH, D) = "
            f"{(B, S, H, KVH, D)} causal={causal} window={window}"
            f"{' (lse entry point)' if with_lse else ''}, median of {n} "
            f"CUDA-event timings in 4 turns, card / call: " + ", ".join(
                f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms"
                for key in fns)
            + " (turns' spread: " + ", ".join(
                f"{key} {spread[key]:.6f}" for key in fns)
            + f"); plain {plain_ms:.6f} ms (median of 3); bound "
            f"{bound:.6f} ms ({flops} flops, three TF32 passes at 495 "
            f"TFLOP/s; {moved} bytes take {b_bytes:.6f} ms; one float32 "
            f"pass on the CUDA cores at 67 TFLOP/s {b_f32:.6f} ms); kernel "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of the "
            f"split-TF32 bound, {b_f32 / ms:.1%} of the CUDA-core one, "
            f"{dev_ms['library sdpa'] / ms:.3f}x SDPA's speed on float32 "
            f"inputs"
            + (f", {dev_ms['parent kernel'] / ms:.3f}x the parent's (max "
               f"|diff| {parent_err:.3e})" if "parent kernel" in fns else "")
            + f"; launches on the main path {launches['flash_attention f32']} "
            f"([serve-consistency] and [train-reference]); clocks.sm, "
            f"power.draw, temperature after: {_clocks()}")
        row = {"shape": [B, S, H, KVH, D], "causal": causal, "window": window,
               "lse": with_lse, "ms": ms,
               "call_ms": call_ms["split-TF32 kernel"], "plain_ms": plain_ms,
               "bound_ms": bound,
               "bound_by": "operations" if b_ops >= b_bytes else "bytes",
               "bound_cuda_core_ms": b_f32,
               "library_ms": dev_ms["library sdpa"],
               "share_of_bound": bound / ms, "name": "flash_attention_f32"}
        if "parent kernel" in fns:
            _faster_than_parent(row, dev_ms["parent kernel"])
            row["turns_spread_ms"] = spread["split-TF32 kernel"]
        rows.append(row)
        del q, k, v, qt, kt, vt, band, fns
    return {
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:90",
        "note": "the float32 route (and bf16 at D = 32) in split TF32 on "
                "the tensor cores; its launches are the float32 runs of "
                "[serve-consistency] and [train-reference]",
        "launches": launches["flash_attention f32"],
        "max_abs_err": errs["flash_attention f32"],
        **rows[0], "also": rows[1:]}


def _parent_attn_f32(torch, parent, q, k, v, causal, window, with_lse):
    """The parent's float32 attention forward (its serving entry point, or
    its lse entry point with ``with_lse``): o, or (o, lse)."""
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    lse = None
    if with_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        args.append(lse.data_ptr())
    err = parent["flash_attention_lse" if with_lse else "flash_attention"](
        *args, B, Sq, k.shape[1], H, k.shape[2], D, int(causal),
        -1 if window is None else window,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's float32 attention failed: {err}")
    return (out, lse) if with_lse else out


def _attn_times(torch, label, shape, launches, errs, gen, parent=None):
    """The tensor-core attention at a served prefill's shape (B, Sq, Sk, H,
    KVH, D, causal; no window) beside SDPA (``enable_gqa``; ``is_causal``
    where causal, no mask where bidirectional), the plain version and the
    bound.  A shape where the kernel loses to SDPA is logged as such: it
    stays on the kernel.  With the parent's kernel, it is timed in the same
    turns: at a 4,096-token prefill the kernel must beat it, elsewhere
    (whisper's shorter ones) not lose to it by more than the turns'
    spread."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KVH, D, causal = shape
    q = torch.randn((B, Sq, H, D), generator=gen, device=DEV).bfloat16()
    k = torch.randn((B, Sk, KVH, D), generator=gen, device=DEV).bfloat16()
    v = torch.randn((B, Sk, KVH, D), generator=gen, device=DEV).bfloat16()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"tensor-core kernel": lambda: fa.flash_attention_cuda(
               q, k, v, causal, None),
           "library sdpa": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=causal, enable_gqa=True)}
    if parent and "flash_attention_wgmma" in parent:
        fns["parent kernel"] = lambda: _parent_attn(torch, parent, q, k, v,
                                                    causal, None)
    n = 20
    dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    plain_ms = _median_ms(torch, lambda: _plain_attn(torch, q, k, v, causal),
                          True, 3)
    pairs = visible_pairs(Sq, True, None) if causal else Sq * Sk
    flops = 4 * B * H * D * pairs
    moved = (2 * B * Sq * H * D + 2 * B * Sk * KVH * D) * 2
    b_ops = flops / H100_BF16_FLOPS * 1e3
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    bound = max(b_ops, b_bytes)
    tc_ms = dev_ms["tensor-core kernel"]
    sdpa = dev_ms["library sdpa"]
    log(f"[times] flash_attention bf16 (B, Sq, Sk, H, KVH, D) = "
        f"{(B, Sq, Sk, H, KVH, D)} "
        f"{'causal' if causal else 'bidirectional'} ({label}'s prefill), "
        f"median of {n} CUDA-event timings in 4 turns, card / call: "
        + ", ".join(f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms"
                    for key in fns)
        + f"; plain {plain_ms:.6f} ms (median of 3); bound {bound:.6f} ms "
        f"({flops} flops over {pairs} visible pairs at 989 TFLOP/s; {moved} "
        f"bytes take {b_bytes:.6f} ms); tensor-core kernel "
        f"{flops / tc_ms / 1e9:.1f} TFLOP/s, {bound / tc_ms:.1%} of the "
        f"bound, {sdpa / tc_ms:.2f}x SDPA's speed"
        + ("" if tc_ms < sdpa else " (LOSES to SDPA)")
        + (f", {dev_ms['parent kernel'] / tc_ms:.3f}x the parent's speed "
           f"(turns' spread: kernel {spread['tensor-core kernel']:.6f}, parent "
           f"{spread['parent kernel']:.6f} ms)" if "parent kernel" in fns
           else "")
        + f"; clocks.sm, power.draw, temperature after: {_clocks()}")
    row = {
        "name": "flash_attention", "arch": label, "route": "cuda",
        "shape": [B, Sq, Sk, H, KVH, D], "causal": causal,
        "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:90",
        "launches": launches["flash_attention"],
        "max_abs_err": errs[f"flash_attention {label}"],
        "ms": tc_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if b_ops >= b_bytes else "bytes",
        "library_ms": sdpa, "call_ms": call_ms["tensor-core kernel"],
        "tflops": flops / tc_ms / 1e9, "share_of_bound": bound / tc_ms}
    if "parent kernel" in fns:
        if Sq >= SERVE_PROMPT:
            _faster_than_parent(row, dev_ms["parent kernel"])
        else:
            _no_slower_than_parent(row, dev_ms["parent kernel"], max(
                spread["tensor-core kernel"], spread["parent kernel"]))
    return row


def _seq_scan_times(torch, fwd_row, launches, errs, gen, parent=None):
    """The scan forward and backward at SeqDetector's campaign shape
    (720,000, 7, 16), each beside its plain version and its bound (and,
    with --parent, the parent's kernels in the same turns, which neither
    may lose to by more than the turns' spread); the forward's numbers
    join its row, the backward gets its own, with the training shape's
    numbers of both directions."""
    from repro_torch.kernels import rglru_scan as rs
    B, S, W = SEQ_SCAN
    a = torch.sigmoid(torch.randn(SEQ_SCAN, generator=gen, device=DEV))
    b = torch.randn(SEQ_SCAN, generator=gen, device=DEV)
    dh = torch.randn(SEQ_SCAN, generator=gen, device=DEV)
    h = rs.rglru_scan_cuda(a, b)
    fns = {"forward": lambda: rs.rglru_scan_cuda(a, b),
           "backward": lambda: rs.rglru_scan_bwd_cuda(a, h, None, dh)}
    if parent and "rglru_scan" in parent:
        fns["parent forward"] = lambda: _parent_rglru(torch, parent, a, b)
        fns["parent backward"] = lambda: _parent_rglru_bwd(
            torch, parent, a, h, None, dh)
    n = 48
    dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    plain = {"forward": _median_ms(
        torch, lambda: rs.rglru_scan_plain(a, b), True, 10),
        "backward": _median_ms(torch, lambda: rs.rglru_scan_backward_plain(
            a, h, None, dh), True, 10)}
    # forward: a, b read, h written, a multiply and an add an element;
    # backward: a, h, dh read, da, db written, g's multiply and add and
    # da's multiply
    work = {"forward": (3, 2), "backward": (5, 3)}
    bound = {}
    for key, (tensors, flops) in work.items():
        b_bytes = tensors * B * S * W * 4 / H100_BYTES_PER_S * 1e3
        b_ops = flops * B * S * W / H100_F32_FLOPS * 1e3
        bound[key] = (max(b_bytes, b_ops),
                      "bytes" if b_bytes >= b_ops else "operations")
        pk = f"parent {key}"
        log(f"[times] rglru_scan {key} (B, S, W) = {SEQ_SCAN} (SeqDetector, "
            f"64 scenarios), median of {n} CUDA-event timings in 4 turns, "
            f"card / call: {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms; plain "
            f"{plain[key]:.6f} ms (median of 10, its {S} steps dispatched by "
            f"the host), library none; bound {bound[key][0]:.6f} ms "
            f"({tensors * B * S * W * 4} bytes at 3.35 TB/s), "
            f"{bound[key][0] / dev_ms[key]:.1%} of it"
            + (f"; parent {dev_ms[pk]:.6f} / {call_ms[pk]:.6f} ms (turns' "
               f"spread: kernel {spread[key]:.6f}, parent {spread[pk]:.6f} "
               f"ms)" if pk in fns else "")
            + f"; clocks.sm, power.draw, temperature after: {_clocks()}")
    fwd_row.update({"seq_ms": dev_ms["forward"],
                    "seq_bound_ms": bound["forward"][0],
                    "seq_plain_ms": plain["forward"],
                    "seq_share_of_bound": bound["forward"][0]
                    / dev_ms["forward"]})
    train = _train_scan_times(torch, gen, parent)
    fwd_row.update(train["forward"])
    rows = [{**train["backward"],
        "name": "rglru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:48",
        "note": "the gradient of the recurrence, which repro takes through "
                "jax.lax.associative_scan (src/repro/models/rglru.py:72)",
        "launches": launches["rglru_scan_bwd"],
        "max_abs_err": errs["rglru_scan_bwd"],
        "ms": dev_ms["backward"], "plain_ms": plain["backward"],
        "bound_ms": bound["backward"][0], "bound_by": bound["backward"][1],
        "library_ms": None, "call_ms": call_ms["backward"],
        "share_of_bound": bound["backward"][0] / dev_ms["backward"]}]
    if "parent forward" in fns:   # the S <= 8 instances, at a parent's shape
        for row, key in ((fwd_row, "forward"), (rows[0], "backward")):
            row["seq_parent_ms"] = dev_ms[f"parent {key}"]
            _scan_vs_parent(key, SEQ_SCAN, dev_ms, spread, False)
    return rows


def _scan_vs_parent(key, shape, dev_ms, spread, must_beat):
    """The RG-LRU ``key`` direction's parent check from its turns' medians
    and spreads (keys ``key`` and "parent <key>"): with ``must_beat`` it
    must be faster than the parent's kernel, and in any case not slower
    by more than the turns' spread."""
    ms, parent_ms = dev_ms[key], dev_ms[f"parent {key}"]
    if must_beat and not ms < parent_ms:
        raise AssertionError(f"rglru_scan {key} at {shape}: {ms} ms, not "
                             f"faster than the parent's {parent_ms} ms")
    if ms > parent_ms + max(spread[key], spread[f"parent {key}"]):
        raise AssertionError(f"rglru_scan {key} at {shape}: {ms} ms, slower "
                             f"than the parent's {parent_ms} ms by more than "
                             f"the turns' spread")


def _train_scan_times(torch, gen, parent=None):
    """The scan forward and backward at ``RG_TRAIN_SCAN``, the shape
    [train-families] launches them at for RecurrentGemma-9B (each RG-LRU
    layer's backward once a step, its forward twice under remat): each
    bit for bit against its plain version (the backward with and without
    h0, and a -0 planted in dh's last step), then its card and call times
    beside the plain version's and its bound, and with --parent the
    parent's kernels in the same turns: the backward (the few-chains
    kernel) must beat the parent's, the forward (the streaming kernel at
    every shape) may not lose to it by more than the turns' spread.
    Returns {"forward": keys, "backward": keys} to add to each row."""
    import numpy as np
    from repro_torch.kernels import rglru_scan as rs
    B, S, W = RG_TRAIN_SCAN
    a = torch.sigmoid(torch.randn(RG_TRAIN_SCAN, generator=gen, device=DEV))
    b = torch.randn(RG_TRAIN_SCAN, generator=gen, device=DEV)
    dh = torch.randn(RG_TRAIN_SCAN, generator=gen, device=DEV)
    dh[:, -1, ::7] = -0.0
    h0 = torch.randn((B, W), generator=gen, device=DEV)

    def bits(x, y):
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
    h = rs.rglru_scan_cuda(a, b)
    if not bits(h, rs.rglru_scan_plain(a, b)):
        raise AssertionError(f"rglru_scan at {RG_TRAIN_SCAN} differs from "
                             f"its plain version")
    err = {"forward": 0.0}
    for with_h0 in (False, True):
        x0 = h0 if with_h0 else None
        got = rs.rglru_scan_bwd_cuda(a, h, x0, dh)
        want = rs.rglru_scan_backward_plain(a, h, x0, dh)
        for g, w in zip(got, want):
            if (g is None) != (w is None) or (w is not None
                                              and not bits(g, w)):
                raise AssertionError(f"rglru_scan_bwd at {RG_TRAIN_SCAN} "
                                     f"h0={with_h0} differs from its plain "
                                     f"version")
        err["backward"] = max(err.get("backward", 0.0), float(np.max([
            (g - w).abs().max().item() for g, w in zip(got[:2], want[:2])])))
    fns = {"forward": lambda: rs.rglru_scan_cuda(a, b),
           "backward": lambda: rs.rglru_scan_bwd_cuda(a, h, None, dh)}
    if parent and "rglru_scan" in parent:
        fns["parent forward"] = lambda: _parent_rglru(torch, parent, a, b)
        fns["parent backward"] = lambda: _parent_rglru_bwd(
            torch, parent, a, h, None, dh)
    n = 48
    dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    plain = {"forward": _median_ms(torch, lambda: rs.rglru_scan_plain(a, b),
                                   True, 10),
             "backward": _median_ms(torch, lambda: rs.rglru_scan_backward_plain(
                 a, h, None, dh), True, 10)}
    out = {}
    # forward: a, b read, h written, a multiply and an add an element;
    # backward: a, h, dh read, da, db written, three flops an element
    for key, tensors, flops in (("forward", 3, 2), ("backward", 5, 3)):
        nbytes = tensors * B * S * W * 4
        bound = max(nbytes / H100_BYTES_PER_S, flops * B * S * W
                    / H100_F32_FLOPS) * 1e3
        pk = f"parent {key}"
        log(f"[times] rglru_scan {key} (B, S, W) = {RG_TRAIN_SCAN} "
            f"(RecurrentGemma-9B's RG-LRU in [train-families]), bit for bit "
            f"its plain version; median of {n} CUDA-event timings in 4 "
            f"turns, card / call: {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms; "
            f"plain {plain[key]:.6f} ms (median of 10, its {S} steps "
            f"dispatched by the host), library none; bound {bound:.6f} ms "
            f"({nbytes} bytes at 3.35 TB/s), {bound / dev_ms[key]:.1%} of it"
            + (f"; parent {dev_ms[pk]:.6f} / {call_ms[pk]:.6f} ms, "
               f"kernel {dev_ms[pk] / dev_ms[key]:.3f}x its speed (turns' spread: "
               f"kernel {spread[key]:.6f}, parent {spread[pk]:.6f} ms)"
               if pk in fns else "")
            + f"; clocks.sm, power.draw, temperature after: {_clocks()}")
        out[key] = {"train_shape": list(RG_TRAIN_SCAN),
                    "train_ms": dev_ms[key], "train_call_ms": call_ms[key],
                    "train_plain_ms": plain[key], "train_bound_ms": bound,
                    "train_share_of_bound": bound / dev_ms[key],
                    "train_max_abs_err": err[key]}
        if pk in fns:
            out[key]["train_parent_ms"] = dev_ms[pk]
            _scan_vs_parent(key, RG_TRAIN_SCAN, dev_ms, spread,
                            key == "backward")
    return out


def _faster_than_parent(row, parent_ms):
    """Record the parent's time of a kernel row; the kernel must beat it."""
    row["parent_ms"] = parent_ms
    if not row["ms"] < parent_ms:
        raise AssertionError(f"{row['name']}: {row['ms']} ms on the card, not "
                             f"faster than the parent's {parent_ms} ms")


def _parent_gate(row, name, dev_ms, spread):
    """The parent check of kernel ``name``'s row from its turns' medians and
    spreads (keys "kernel" and "parent kernel"): a kernel whose own source
    changed must beat the parent's; one whose source is the parent's
    (``PARENT_SAME_SOURCE``: only a shared header differs) may not be
    slower than it by more than the turns' spread."""
    if name in PARENT_SAME_SOURCE:
        _no_slower_than_parent(row, dev_ms["parent kernel"],
                               max(spread["kernel"], spread["parent kernel"]))
    else:
        _faster_than_parent(row, dev_ms["parent kernel"])


def _no_slower_than_parent(row, parent_ms, spread_ms):
    """Record the parent's time of a kernel row, and the turns' spread; the
    kernel may not be slower than the parent by more than that spread."""
    row["parent_ms"] = parent_ms
    row["turns_spread_ms"] = spread_ms
    if row["ms"] > parent_ms + spread_ms:
        raise AssertionError(f"{row['name']} ({row.get('arch')}): {row['ms']} "
                             f"ms on the card, slower than the parent's "
                             f"{parent_ms} ms by more than the turns' spread "
                             f"{spread_ms} ms")


def _parent_attn(torch, parent, q, k, v, causal, window):
    """The parent's tensor-core attention forward (its serving entry
    point) on q, k, v."""
    B, Sq, H, D = q.shape
    o = torch.empty_like(q)
    err = parent["flash_attention_wgmma"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
        k.shape[1], H, k.shape[2], D, int(causal),
        -1 if window is None else window,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's flash_attention_wgmma failed: {err}")
    return o


def _parent_attn_lse(torch, parent, q, k, v, causal, window):
    """The parent's tensor-core attention forward through its lse entry
    point (the one training launches): (o, lse)."""
    B, Sq, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = parent["flash_attention_wgmma_lse"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, k.shape[1], H, k.shape[2], D, int(causal),
        -1 if window is None else window,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's flash_attention_wgmma_lse failed: "
                           f"{err}")
    return o, lse


def _parent_rglru(torch, parent, a, b):
    """The parent's RG-LRU kernel on a, b (no h0)."""
    out = torch.empty_like(a)
    err = parent["rglru_scan"](a.data_ptr(), b.data_ptr(), None,
                               out.data_ptr(), *a.shape,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's rglru_scan failed: {err}")
    return out


def _parent_rglru_bwd(torch, parent, a, h, h0, dh):
    """The parent's RG-LRU backward: (da, db, dh0), dh0 None without h0."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    err = parent["rglru_scan_bwd"](
        a.data_ptr(), h.data_ptr(), None if h0 is None else h0.data_ptr(),
        dh.data_ptr(), da.data_ptr(), db.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), *a.shape,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's rglru_scan_bwd failed: {err}")
    return da, db, dh0


def _parent_wkv(torch, parent, r, k, v, w, u, s0):
    """The parent's WKV kernel: (y, final state)."""
    y, st = torch.empty_like(r), torch.empty_like(s0)
    err = parent["rwkv6_scan"](r.data_ptr(), k.data_ptr(), v.data_ptr(),
                               w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                               y.data_ptr(), st.data_ptr(), *r.shape,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's rwkv6_scan failed: {err}")
    return y, st


# ---------------------------------------------------------------------------
# Slice 14: zoo training (the mesh engine's train step, the optimizers,
# the token pipeline, checkpoints, launch/train) and the backward kernels
# ---------------------------------------------------------------------------
#: (B, Sq, Sk, H, KVH, D, causal, window, dtype) at which the attention's
#: backward kernels are held to the plain backward: causal, bidirectional
#: and windowed; G = 1, 2, 4, 5, 6 and 16; D = 32 .. 256; Sq != Sk;
#: ragged last tiles; rows that see no key (bidirectional, window 8,
#: Sq > Sk + 7); lse rows off a 16-byte boundary (Sq = 201); the shapes
#: the training path gives it, [train]'s qwen1.5-0.5b (8, 1024, 16 heads
#: of 64, causal), internlm2's heads (16 on 8 of 128), [train-bf16-8b]'s
#: Qwen3-8B (1, 2048, 32 heads on 8 of 128, causal: the fused kernel's
#: head split, hs = 2, and its dk/dv partials' sum) and
#: [train-families]' RecurrentGemma-9B (1, 2048, 16 heads on 1 kv head of
#: 256, window 2,048), in bf16 and, as [times] times the float32 backward
#: (BWD_TIME_F32), in float32, with a window that binds and a ragged
#: bidirectional case with rows that see no key at D = 256; and bf16 at
#: D = 32, which the split-TF32 kernel serves.
ATTN_BWD_CASES = [
    (2, 300, 300, 4, 4, 64, True, None, "float32"),
    (1, 257, 257, 8, 4, 128, True, None, "float32"),
    (1, 200, 333, 8, 2, 32, False, None, "float32"),
    (1, 190, 190, 10, 2, 64, True, 64, "float32"),
    (1, 150, 150, 6, 1, 256, True, 48, "float32"),
    (1, 100, 40, 4, 2, 64, False, 8, "float32"),
    (8, 1024, 1024, 16, 16, 64, True, None, "float32"),
    (1, 2048, 2048, 16, 1, 256, True, 2048, "float32"),
    (2, 333, 200, 12, 2, 32, False, 50, "bfloat16"),
    (2, 333, 200, 12, 2, 128, False, 50, "bfloat16"),
    (1, 100, 40, 4, 2, 64, False, 8, "bfloat16"),
    (8, 1024, 1024, 16, 16, 64, True, None, "bfloat16"),
    (1, 201, 201, 4, 4, 64, True, None, "bfloat16"),
    (1, 1000, 1000, 5, 1, 128, True, 300, "bfloat16"),
    (8, 1024, 1024, 16, 8, 128, True, None, "bfloat16"),
    (1, 2048, 2048, 32, 8, 128, True, None, "bfloat16"),
    (1, 2048, 2048, 16, 1, 256, True, 2048, "bfloat16"),
    (1, 700, 700, 4, 1, 256, True, 300, "bfloat16"),
    (1, 333, 200, 4, 2, 256, False, 50, "bfloat16"),
]
#: (B, S, H, N, with_state0, with_dstate) of the WKV backward's checks: S
#: past and short of the 16-step sub-chunk and the 64-step checkpoint
#: stride, every head size, a non-zero state0 and a gradient of the final
#: state; [train-families]' RWKV6-7B shape (a cluster of 2 blocks a head)
#: as training runs it (zero state0, no final-state gradient) and with
#: both, a ragged S at its heads, and 4 batches (512 blocks)
WKV_BWD_CASES = [(2, 100, 4, 64, True, True), (1, 33, 2, 8, True, True),
                 (2, 64, 3, 16, True, False), (1, 70, 2, 32, False, True),
                 (1, 1, 2, 64, True, True), (1, 2048, 64, 64, False, False),
                 (1, 2048, 64, 64, True, True), (1, 1000, 64, 64, True, True),
                 (4, 100, 64, 64, True, True)]
#: [train]: qwen1.5-0.5b at full width and depth, the launcher's flags
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 10
#: [train-families]: (arch, layers kept, batch, seq)
TRAIN_FAMILIES = (("rwkv6-7b", 2, 1, 2048), ("recurrentgemma-9b", 3, 1, 2048))
#: [train-families]' RecurrentGemma step-2 loss on the parent's attention
#: backward (--parent), relative: room for a backward whose sums run in
#: another order, so that its bf16 gradients round otherwise
FAMILY_PARENT_TOL = 1e-3
TRAIN_BWD_KERNELS = ("flash_attention_bwd", "flash_attention_bwd_wgmma",
                     "rwkv6_scan_bwd", "rglru_scan_bwd")
#: the device kernels of one rwkv6_scan_bwd call (csrc/rwkv6_scan_bwd.cu)
WKV_BWD_KERNELS = ("wkv_bwd_kernel", "wkv_du_sum_kernel")


def _bwd_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import rwkv6_scan as wk
    return {"flash_attention_bwd": fa, "rwkv6_scan_bwd": wk,
            "rglru_scan_bwd": rs}


def _reset_train_launches():
    _reset_launches()
    for mod in _bwd_counters().values():
        mod.BWD_LAUNCHES = 0
    _bwd_counters()["flash_attention_bwd"].TC_BWD_LAUNCHES = 0
    _bwd_counters()["flash_attention_bwd"].TF32_BWD_LAUNCHES = 0


def _train_launches():
    """Each kernel's launches: every attention backward counts in
    ``flash_attention_bwd``, the tensor-core one also in
    ``flash_attention_bwd_wgmma`` and the split-TF32 one in
    ``flash_attention_bwd_tf32x3``."""
    out = _launches()
    out.update({k: m.BWD_LAUNCHES for k, m in _bwd_counters().items()})
    fa = _bwd_counters()["flash_attention_bwd"]
    out["flash_attention_bwd_wgmma"] = fa.TC_BWD_LAUNCHES
    out["flash_attention_bwd_tf32x3"] = fa.TF32_BWD_LAUNCHES
    return out


def _expected_train_launches(cfg, steps):
    """Each kernel's launches over ``steps`` training steps: under
    ``remat == "full"`` every layer's forward in a unit (and every encoder
    layer) runs twice a step (forward and recompute), a tail layer's
    once; each backward once.  Attention once per
    attention layer (for an encoder-decoder also per encoder layer and
    per cross-attention), the RG-LRU scan per recurrent layer, the WKV
    scan per RWKV6 layer; each attention backward on the bf16 tensor
    cores or in split TF32, where ``bwd_route`` sends the config's dtype
    and head dim."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import unit_counts, unit_pattern
    fwd, _ = _expected_launches(cfg)
    out = {f"{k}_bwd": v * steps for k, v in fwd.items()}
    route = (fa.bwd_route(getattr(torch, cfg.dtype), cfg.attention.head_dim)
             if out["flash_attention_bwd"] > 0 else None)
    out["flash_attention_bwd_wgmma"] = out["flash_attention_bwd"] * (
        route == "tensor_core")
    out["flash_attention_bwd_tf32x3"] = out["flash_attention_bwd"] * (
        route == "tf32x3")
    if cfg.remat == "full":
        # the tail layers (those that do not fill a unit) run unwrapped
        tail = [kind for kind, _ in unit_pattern(cfg)[:unit_counts(cfg)[1]]]
        once = {"flash_attention": tail.count("attn") + tail.count("local"),
                "rglru_scan": tail.count("rec"),
                "rwkv6_scan": tail.count("rwkv")}
        fwd = {k: 2 * v - once[k] for k, v in fwd.items()}
    out.update({k: v * steps for k, v in fwd.items()})
    return out


def _check_launches(tag, got, want):
    log(f"[{tag}] kernel launches {got} (expected {want})")
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"[{tag}] {k}: {got[k]} launches, "
                                 f"expected {v}")


def _rows_rel(torch, got, want):
    """Largest |diff| of a row (last dim) over the row's RMS, the RMS
    floored at 1e-2 of the whole tensor's: a row whose exact value is 0
    (a query that sees one key has dq = 0: p = 1 and dO . v = delta)
    holds only rounding noise of either side."""
    diff = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().pow(2).mean(-1).sqrt()
    floor = 1e-2 * float(want.float().pow(2).mean().sqrt())
    return float((diff / rms.clamp_min(max(floor, 1e-30))).max())


def phase_train_kernels(torch):
    """[kernel] flash_attention_bwd and rwkv6_scan_bwd: each backward
    kernel against its plain backward on the card, on the same inputs.
    Attention, on the route ``bwd_route`` picks (the split-TF32 kernel for
    float32 and bf16 at D = 32, the tensor-core one for bf16 at D 64, 128
    and 256), reading the forward's lse: float32 within 2e-4 of each
    gradient's largest |value|, bfloat16 with each row's largest |diff|
    within ATTN_ROW_TOL of the row's RMS (floored at 1e-2 of the
    gradient's); a query that sees no key and a key no query sees must
    get exactly 0; two launches must give the same bits, and the
    forward's lse entry point (the tensor-core or the split-TF32 one) must
    return the serving entry point's output bit for bit and an lse within
    1e-5 of the plain one.
    WKV: within 1e-4 x max(1, the gradient's largest |value|), and two
    launches bit for bit.  An unsupported dtype or D must raise.  Returns
    the max |diff| of each."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    gen = torch.Generator(device=DEV).manual_seed(21)
    worst = {"flash_attention_bwd": 0.0, "flash_attention_bwd_wgmma": 0.0,
             "rwkv6_scan_bwd": 0.0}
    for B, Sq, Sk, H, KVH, D, causal, window, dt in ATTN_BWD_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, Sq, H, D), generator=gen, device=DEV).to(dtype)
        k, v = (torch.randn((B, Sk, KVH, D), generator=gen,
                            device=DEV).to(dtype) for _ in range(2))
        do = torch.randn((B, Sq, H, D), generator=gen, device=DEV).to(dtype)
        o = fa.flash_attention_cuda(q, k, v, causal, window)
        kernel = fa.bwd_route(dtype, D)
        o_lse, lse = fa.flash_attention_cuda(q, k, v, causal, window,
                                             return_lse=True)
        _, lse_plain = fa.flash_attention_plain(q, k, v, causal, window,
                                                return_lse=True)
        lse_err = float((lse - lse_plain).abs().max())
        lse_note = (f"; the {fa.route(dtype, D)} lse forward's output bit "
                    f"for bit the serving one's: {torch.equal(o_lse, o)}, "
                    f"lse max_abs_err {lse_err:.3g} (tolerance 1e-5)")
        if not (torch.equal(o_lse, o) and lse_err <= 1e-5):
            raise AssertionError(f"flash_attention lse entry point at "
                                 f"{(B, Sq, Sk, H, KVH, D)}{lse_note}")
        del o_lse, lse_plain
        want = fa.flash_attention_backward_plain(q, k, v, o, do, causal,
                                                 window)
        seen = fa.visible(Sq, Sk, causal, window, DEV).any(dim=1)
        keys_seen = fa.visible(Sq, Sk, causal, window, DEV).any(dim=0)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window,
                                          lse=lse)
        torch.cuda.synchronize()
        errs, notes = [], []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            errs.append(float((g - w).abs().max()))
            scale = float(w.abs().max())
            if dtype == torch.float32:
                ok = errs[-1] <= 2e-4 * scale
                note = f"{errs[-1]:.3g} of max {scale:.3g}"
            else:
                rel = _rows_rel(torch, g, w)
                ok = rel <= ATTN_ROW_TOL
                note = f"row |diff| / RMS {rel:.4f}"
            notes.append(note)
            if not ok:
                raise AssertionError(f"flash_attention_bwd {kernel} {name} "
                                     f"at {(B, Sq, Sk, H, KVH, D)} {dt} "
                                     f"causal={causal} window={window}: "
                                     f"{note}")
        # a query that sees no key, and a key that no query sees, have
        # zero gradient
        for grad, live in ((got[0], seen), (got[1], keys_seen),
                           (got[2], keys_seen)):
            if not bool(live.all()) and float(
                    grad[:, ~live].float().abs().max()) != 0.0:
                raise AssertionError(f"{kernel}: an unseen row got a "
                                     f"non-zero gradient")
        again = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal,
                                            window, lse=lse)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        det = f"; two launches bit for bit: {same}"
        if not same:
            raise AssertionError(f"the {kernel} backward at "
                                 f"{(B, Sq, Sk, H, KVH, D)} differs "
                                 f"between two launches")
        log(f"[kernel] flash_attention_bwd {kernel} (B, Sq, Sk, H, KVH, D)"
            f" = {(B, Sq, Sk, H, KVH, D)} G={H // KVH} causal={causal} "
            f"window={window} {dt}: max_abs_err dq/dk/dv "
            f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} "
            f"({'; '.join(notes)}); rows with no key "
            f"{int((~seen).sum())}, keys no query sees "
            f"{int((~keys_seen).sum())} (tolerance: float32 2e-4 x "
            f"max|grad|, bf16 row |diff| <= {ATTN_ROW_TOL} x RMS)"
            + det + lse_note)
        key = ("flash_attention_bwd_wgmma" if kernel == "tensor_core"
               else "flash_attention_bwd")
        worst[key] = max(worst[key], *errs)
        del q, k, v, do, o, lse, want, got, again
    for bad in ((torch.float16, 64), (torch.float32, 96)):
        x = torch.zeros((1, 8, 2, bad[1]), dtype=bad[0], device=DEV)
        try:
            fa.flash_attention_bwd_cuda(x, x, x, x, x)
        except (TypeError, ValueError) as e:
            log(f"[kernel] flash_attention_bwd {bad[0]} D={bad[1]} raises: "
                f"{e}")
        else:
            raise AssertionError(f"flash_attention_bwd took {bad}")
    for B, S, H, N, with_s0, with_ds in WKV_BWD_CASES:
        r, k, v, w, u, s0 = wk.random_inputs(B, S, H, N, with_s0, gen)
        dy = torch.randn((B, S, H, N), generator=gen, device=DEV)
        ds = (torch.randn((B, H, N, N), generator=gen, device=DEV)
              if with_ds else None)
        got = wk.rwkv6_scan_bwd_cuda(r, k, v, w, u, s0, dy, ds)
        again = wk.rwkv6_scan_bwd_cuda(r, k, v, w, u, s0, dy, ds)
        want = wk.rwkv6_scan_backward_plain(r, k, v, w, u, s0, dy, ds)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not same:
            raise AssertionError(f"rwkv6_scan_bwd at {(B, S, H, N)} differs "
                                 f"between two launches")
        del again
        errs, scales = [], []
        for name, g, ref in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                                want):
            err = float((g - ref).abs().max())
            scales.append(float(ref.abs().max()))
            bound = 1e-4 * max(1.0, scales[-1])
            if not err <= bound:
                raise AssertionError(f"rwkv6_scan_bwd {name} at "
                                     f"{(B, S, H, N)}: {err} > {bound}")
            errs.append(err)
        log(f"[kernel] rwkv6_scan_bwd (B, S, H, N) = {(B, S, H, N)} "
            f"state0={with_s0} dstate={with_ds}: max_abs_err / max|grad| "
            + ", ".join(f"{name} {e:.3g} / {m:.3g}" for name, e, m in zip(
                ("dr", "dk", "dv", "dw", "du", "ds0"), errs, scales))
            + " (tolerance 1e-4 x max(1, max|grad|)); two launches bit for "
            f"bit: {same}")
        worst["rwkv6_scan_bwd"] = max(worst["rwkv6_scan_bwd"], *errs)
    return worst


def _train_args(*extra):
    from repro_torch.launch import train
    return train.parse_args(
        ["--arch", TRAIN_ARCH, "--no-reduced", "--steps", str(TRAIN_STEPS),
         "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
         "--data-axis", "1", "--schedule", "tolfl_ring", "--device", DEV]
        + list(extra))


def phase_train(torch):
    """[train]: launch/train's loop at qwen1.5-0.5b full width and depth
    (24 layers, d 1,024, 16 heads of 64, tied 151,936-word embeddings,
    remat full), Adam with the cosine schedule, 10 steps of the ring
    schedule on a world of one rank.  The loss must be finite and lower at
    step 10 than at step 1, and the kernels' launches must equal the
    config's count.  Then the same with a server failure at step 5: n_eff
    0 from step 5 on, and a step under the failure applies exactly the
    optimizer's update of zero gradients.  Returns each kernel's
    launches over the first run."""
    from repro_torch.core import distributed as D
    from repro_torch.core.failure import FailureSpec, alive_mask
    from repro_torch.core.topology import Topology
    from repro_torch.launch import train
    from repro_torch.models import params as P
    from repro_torch.optim.optimizers import apply_updates, make_optimizer
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_launches()
    t0 = time.perf_counter()
    out = train.run(_train_args(), log=lambda m: log(f"[train] {m}"))
    wall = time.perf_counter() - t0
    launches = _train_launches()
    cfg = out["config"]
    _check_launches("train", launches,
                    _expected_train_launches(cfg, TRAIN_STEPS))
    losses = out["losses"]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[train] losses {losses}")
    _against_pr35_losses("train", losses)
    ms = statistics.median(out["step_s"][1:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    TRAIN_READINGS.update(ms=ms, peak=torch.cuda.max_memory_allocated() / 1e9,
                          losses=losses)
    log(f"[train] {cfg.name} {cfg.num_layers} layers d {cfg.d_model}, "
        f"{P.param_count(out['state']['params'])} params, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps in {wall:.2f} s "
        f"(init included): loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"{ms:.2f} ms/step (median of steps 2-{TRAIN_STEPS}), "
        f"{tokens / ms * 1e3:.0f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; clocks.sm, "
        f"power.draw, temperature after: {_clocks()}")
    del out
    torch.cuda.empty_cache()

    # the failure run
    fail = train.run(_train_args("--fail-epoch", "5", "--fail-kind",
                                 "server"),
                     log=lambda m: None)
    n_eff = fail["n_eff"]
    if not (all(n > 0 for n in n_eff[:5]) and all(n == 0 for n in n_eff[5:])
            and all(map(math.isfinite, fail["losses"]))):
        raise AssertionError(f"[train] failure run n_eff {n_eff}, losses "
                             f"{fail['losses']}")
    # one more step under the failure, against Adam's update of zeros
    state, mesh, cfg = fail["state"], fail["mesh"], fail["config"]
    args = _train_args("--fail-epoch", "5")
    tolfl = train.TolFLConfig(num_clusters=1, schedule="tolfl_ring")
    ocfg = train.OptimizerConfig(lr=args.lr, warmup_steps=5,
                                 total_steps=args.steps)
    step_fn = D.make_train_step(cfg, tolfl, ocfg, mesh)
    alive = alive_mask(FailureSpec(epoch=5, kind="server"), Topology(1, 1),
                       TRAIN_STEPS, device=DEV)
    batch = {k: torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64,
                            device=DEV) for k in ("tokens", "labels")}
    opt = make_optimizer(ocfg)
    zeros = P.tree_zeros_like(state["params"])
    upd, _ = opt.update(zeros, state["opt"], state["params"])
    want = apply_updates(state["params"], upd)
    new, metrics = step_fn(state, batch, alive)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(P.tree_items(new["params"]), P.tree_items(want)))
    log(f"[train] --fail-epoch 5 --fail-kind server: losses "
        f"{[round(x, 4) for x in fail['losses']]}, n_eff {n_eff}; a step "
        f"under the failure: n_effective {float(metrics['n_effective'])}, "
        f"params equal to Adam's update of zero gradients bit for bit: "
        f"{same} (Adam's moments keep moving the params after has_update "
        f"turns 0, as in repro)")
    if not (same and float(metrics["n_effective"]) == 0.0):
        raise AssertionError("[train] a step under the failure applied a "
                             "gradient")
    del fail, state, new, want, upd, zeros
    torch.cuda.empty_cache()
    return launches


#: [train]'s ms/step, peak memory (GB) and losses, which [train-bf16]
#: prints beside its own
TRAIN_READINGS = {}
#: PR 35's [train] and [train-bf16] losses (its call 9): step 1 as it
#: printed it (a forward alone, the same bits whatever the backward) and
#: step 10, which another backward's rounding may move by TRAIN_LOSS_DRIFT
PR35_TRAIN_LOSSES = {"train": ("12.0243", 8.2548),
                     "train-bf16": ("11.9862", 8.1543)}
TRAIN_LOSS_DRIFT = 0.01


def _against_pr35_losses(tag, losses):
    """Hold a run's step-1 and step-10 losses to PR 35's."""
    first, last = PR35_TRAIN_LOSSES[tag]
    drift = abs(losses[-1] - last) / last
    log(f"[{tag}] step 1 loss {losses[0]!r} (PR 35: {first}), step 10 "
        f"{losses[-1]!r} (PR 35: {last}, {drift:.3%} apart, at most "
        f"{TRAIN_LOSS_DRIFT:.0%})")
    if f"{losses[0]:.4f}" != first or drift > TRAIN_LOSS_DRIFT:
        raise AssertionError(f"[{tag}] losses {losses[0]}, {losses[-1]} "
                             f"against PR 35's {first}, {last}")
#: [train-bf16-8b]: Qwen3-8B at published width, its 36 layers cut to 8,
#: bf16 params, 1 x 2,048 tokens, two ring steps of Adam
TRAIN_8B = ("qwen3-8b", 8, 1, 2048)


def _zero_grad_step(torch, step_fn, ocfg, state, batch, alive):
    """One step under a failure (n_eff 0) against ``ocfg``'s update of
    zero gradients of the params' dtypes: (same bit for bit, metrics,
    new state)."""
    from repro_torch.models import params as P
    from repro_torch.optim.optimizers import apply_updates, make_optimizer
    zeros = P.tree_zeros_like(state["params"])
    upd, _ = make_optimizer(ocfg).update(zeros, state["opt"],
                                         state["params"])
    want = apply_updates(state["params"], upd)
    new, metrics = step_fn(state, batch, alive)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(P.tree_items(new["params"]), P.tree_items(want)))
    return same, metrics, new


def phase_train_bf16(torch):
    """[train-bf16]: [train]'s configuration (qwen1.5-0.5b at full width
    and depth, Adam, 10 ring steps of 8 x 1,024 tokens on a world of one
    rank through launch/train's loop) at ``param_dtype="bfloat16"``, set
    on the config (there is no flag, as in repro).  The loss must be
    finite and lower at step 10 than at step 1, the kernels' launches the
    config's count, and the step-1 loss bit for bit that of a step with
    float32 params holding the same bf16-rounded values.  Then the
    failure run: n_eff 0 from step 5, and a step under the failure applies
    exactly Adam's update of zero gradients in bf16; and
    [train-bf16-no-sync]: one more step under
    ``torch.cuda.set_sync_debug_mode("error")``.  Prints ms/step, tokens/s,
    peak memory and the step-10 loss beside [train]'s.  Returns each
    kernel's launches over the 10-step run."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import distributed as D
    from repro_torch.core.failure import (NO_FAILURE, FailureSpec,
                                          alive_mask)
    from repro_torch.core.topology import Topology
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch import train
    from repro_torch.models import params as P
    f32_cfg = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(f32_cfg, param_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_launches()
    t0 = time.perf_counter()
    out = train.run(_train_args(), log=lambda m: log(f"[train-bf16] {m}"),
                    cfg=cfg)
    wall = time.perf_counter() - t0
    launches = _train_launches()
    _check_launches("train-bf16", launches,
                    _expected_train_launches(cfg, TRAIN_STEPS))
    losses = out["losses"]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[train-bf16] losses {losses}")
    _against_pr35_losses("train-bf16", losses)
    dtypes = sorted({str(x.dtype) for t in (out["state"]["params"],
                                            out["state"]["opt"].mu,
                                            out["state"]["opt"].nu)
                     for _, x in P.tree_items(t)})
    if dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"[train-bf16] state dtypes {dtypes}")
    ms = statistics.median(out["step_s"][1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ref = TRAIN_READINGS
    log(f"[train-bf16] {cfg.name} at bf16 params, {cfg.num_layers} layers d "
        f"{cfg.d_model}, {P.param_count(out['state']['params'])} params "
        f"({P.param_bytes(out['state']['params']) / 1e9:.3f} GB), params "
        f"and Adam moments {dtypes}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps in {wall:.2f} s (init included): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ([train] float32 params: "
        f"{ref['losses'][0]:.4f} -> {ref['losses'][-1]:.4f}); {ms:.2f} "
        f"ms/step ([train] {ref['ms']:.2f}), {tokens / ms * 1e3:.0f} "
        f"tokens/s ([train] {tokens / ref['ms'] * 1e3:.0f}); peak memory "
        f"{peak:.2f} GB ([train] {ref['peak']:.2f} GB); clocks.sm, "
        f"power.draw, temperature after: {_clocks()}")
    del out
    torch.cuda.empty_cache()

    # step 1 with float32 params holding the same bf16-rounded values
    mesh = train.make_host_mesh(data=1, model=1, device=DEV)
    args = _train_args()
    tolfl = train.TolFLConfig(num_clusters=1, schedule="tolfl_ring")
    ocfg = train.OptimizerConfig(lr=args.lr, warmup_steps=5,
                                 total_steps=args.steps)
    batch = shard_batch(next(TokenPipeline(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=args.seed,
        num_groups=1).batches(1)), mesh)
    alive = alive_mask(NO_FAILURE, Topology(1, 1), 0, device=DEV)
    params = P.cast_tree(D.init_state(
        torch.Generator(device=DEV).manual_seed(args.seed), cfg,
        ocfg)["params"], torch.float32)
    f32_state = {"params": params, "opt": D.make_optimizer(ocfg).init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=DEV)}
    _, metrics = D.make_train_step(f32_cfg, tolfl, ocfg, mesh)(
        f32_state, batch, alive)
    f32_loss = float(metrics["loss"])
    log(f"[train-bf16] step 1 with float32 params holding the bf16 params' "
        f"values: loss {f32_loss!r}, bf16 params {losses[0]!r}: bit for "
        f"bit {f32_loss == losses[0]}")
    if f32_loss != losses[0]:
        raise AssertionError("[train-bf16] bf16 params and their float32 "
                             "values give other step-1 losses")
    del f32_state, params, metrics
    torch.cuda.empty_cache()

    # the failure run, a step under the failure, then one under the sync
    # debug mode
    fail = train.run(_train_args("--fail-epoch", "5", "--fail-kind",
                                 "server"), log=lambda m: None, cfg=cfg)
    n_eff = fail["n_eff"]
    if not (all(n > 0 for n in n_eff[:5]) and all(n == 0 for n in n_eff[5:])
            and all(map(math.isfinite, fail["losses"]))):
        raise AssertionError(f"[train-bf16] failure run n_eff {n_eff}, "
                             f"losses {fail['losses']}")
    step_fn = D.make_train_step(cfg, tolfl, ocfg, fail["mesh"])
    alive = alive_mask(FailureSpec(epoch=5, kind="server"), Topology(1, 1),
                       TRAIN_STEPS, device=DEV)
    zero = {k: torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64,
                           device=DEV) for k in ("tokens", "labels")}
    same, metrics, state = _zero_grad_step(torch, step_fn, ocfg,
                                           fail["state"], zero, alive)
    log(f"[train-bf16] --fail-epoch 5 --fail-kind server: losses "
        f"{[round(x, 4) for x in fail['losses']]}, n_eff {n_eff}; a step "
        f"under the failure: n_effective {float(metrics['n_effective'])}, "
        f"bf16 params equal to Adam's update of zero gradients bit for bit: "
        f"{same}")
    if not (same and float(metrics["n_effective"]) == 0.0):
        raise AssertionError("[train-bf16] a step under the failure applied "
                             "a gradient")
    del fail
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step_fn(state, batch, torch.ones((1,), device=DEV))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[train-bf16-no-sync] 1 step of {cfg.name} at bf16 params under "
        f"the sync debug mode 'error': no synchronising call; loss "
        f"{float(metrics['loss']):.4f}")
    del state, metrics
    torch.cuda.empty_cache()
    return launches


def phase_train_bf16_8b(torch):
    """[train-bf16-8b]: Qwen3-8B at published width (d 4,096, 32 heads and
    8 kv heads of 128, d_ff 12,288, untied 151,936-word embedding and
    head), its depth cut from 36 to ``TRAIN_8B``'s, at bf16 params (a
    mixed tree: the qk-norm scales stay float32), Adam as repro's (the
    moments in each leaf's dtype), two ring steps of 1 x 2,048 tokens: the
    first with its warm-up, the second timed warm.  Gates: both losses
    finite, every param finite, every layer's attention and MLP leaves
    moved, launches as expected after each step.  Prints the memory held
    before each step and its peak.  Returns the launches of both steps."""
    import dataclasses
    from repro_torch.configs.base import OptimizerConfig, TolFLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    arch, layers, B, S = TRAIN_8B
    cfg = dataclasses.replace(_family_cfg(arch, layers),
                              param_dtype="bfloat16")
    mesh = make_host_mesh(data=1, model=1, device=DEV)
    # lr 1e-4: Adam's first update is ~lr an element, past half a bf16 ulp
    # of a weight of the init's scale (|w| < 2^-5); at 1e-3 the second
    # step's loss rose 12.39 -> 19.62 on the same batch (a trial)
    ocfg = OptimizerConfig(lr=1e-4, schedule="constant", warmup_steps=0)
    step_fn = D.make_train_step(
        cfg, TolFLConfig(num_clusters=1, schedule="tolfl_ring"), ocfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    state = D.init_state(torch.Generator(device=DEV).manual_seed(5), cfg,
                         ocfg)
    kinds = sorted({str(x.dtype) for _, x in P.tree_items(state["params"])})
    before = {p: x.clone() for p, x in P.tree_items(state["params"])
              if p[0] == "units" and p[2] in ("mix", "mlp")}
    copies = sum(x.numel() * x.element_size() for x in before.values()) / 1e9
    batch = shard_batch(next(TokenPipeline(cfg.vocab_size, S, B).batches(1)),
                        mesh)
    alive = torch.ones((1,), device=DEV)
    _reset_train_launches()
    walls, peaks, held, losses = [], [], [], []
    for n_step in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held.append(torch.cuda.memory_allocated() / 1e9)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, alive)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        got = _train_launches()
        _check_launches(f"train-bf16-8b step {n_step}", got,
                        _expected_train_launches(cfg, n_step))
    finite = all(bool(torch.isfinite(x).all())
                 for _, x in P.tree_items(state["params"]))
    after = dict(P.tree_items(state["params"]))
    # (leaf, layer) pairs whose slice did not move
    still = [("/".join(p), i) for p, x in before.items()
             for i in range(x.shape[0]) if torch.equal(x[i], after[p][i])]
    n = P.param_count(state["params"])
    log(f"[train-bf16-8b] {cfg.name} cut to {layers} of "
        f"{get_arch(arch).num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.attention.num_heads} / kv {cfg.attention.num_kv_heads} of "
        f"{cfg.attention.head_dim}, {n} params "
        f"({P.param_bytes(state['params']) / 1e9:.3f} GB, leaves {kinds}), "
        f"Adam moments in the leaves' dtypes, batch {B} x {S}: losses "
        f"{losses}; first step {walls[0]:.6f} s (with warm-up), peak memory "
        f"{peaks[0]:.2f} GB ({held[0]:.2f} GB held before it); warm step "
        f"{walls[1]:.6f} s (host clock, synchronize before, the loss's "
        f".item() after; {B * S / walls[1]:.0f} tokens/s), peak memory "
        f"{peaks[1]:.2f} GB ({held[1]:.2f} GB held before it; {copies:.2f} "
        f"GB of the held are the attention and MLP leaves' copies that "
        f"check they moved); params "
        f"finite {finite}; (leaf, layer) slices of the attention and MLP "
        f"that did not move: {still}; clocks.sm, power.draw, temperature "
        f"after: {_clocks()}")
    if not (all(map(math.isfinite, losses)) and finite and not still):
        raise AssertionError(f"[train-bf16-8b] losses {losses}, finite "
                             f"{finite}, unmoved {still}")
    del state, before, after, batch, metrics
    torch.cuda.empty_cache()
    return got


def _family_cfg(arch, layers):
    import dataclasses
    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch(arch), num_layers=layers)


def phase_train_families(torch, parent=None):
    """[train-families]: two ring steps (SGD) at full width with the depth
    cut (RWKV6-7B over 2 of its 32 layers: the WKV forward and backward at
    (1, 2048, 64, 64); RecurrentGemma-9B over one unit: two RG-LRU layers
    and a local-attention layer at D = 256, window 2,048, whose backward
    runs on the tensor cores): the first step with its warm-up, the second
    timed warm after a synchronize, each with its peak memory and the
    memory held before it; both losses finite, every param finite after
    the steps and every mixing layer moved, launches as expected after
    each step.  With --parent, RecurrentGemma's two steps run again from
    the same state on the parent's tensor-core attention backward: the
    step-1 loss (the forward's alone) must be the current run's bit for
    bit, the step-2 loss within ``FAMILY_PARENT_TOL`` of it.  Returns the
    launches of both steps."""
    from repro_torch.configs.base import OptimizerConfig, TolFLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    total = dict.fromkeys(list(_counters()) + list(TRAIN_BWD_KERNELS), 0)
    mesh = make_host_mesh(data=1, model=1, device=DEV)
    for arch, layers, B, S in TRAIN_FAMILIES:
        cfg = _family_cfg(arch, layers)
        # SGD: Adam's two moments of RecurrentGemma's 1.05 G-word embedding
        # and unit would not leave room for the step on the card
        ocfg = OptimizerConfig(name="sgd", lr=1e-3, schedule="constant",
                               warmup_steps=0, grad_clip=0.0)
        step_fn = D.make_train_step(
            cfg, TolFLConfig(num_clusters=1, schedule="tolfl_ring"), ocfg,
            mesh)
        batch = shard_batch(next(TokenPipeline(
            cfg.vocab_size, S, B).batches(1)), mesh)
        alive = torch.ones((1,), device=DEV)

        def steps(check):
            """Two steps from the seeded initial state: (losses, walls,
            peaks, held, the state, its mixing leaves before the steps,
            the launches after step 2)."""
            state = D.init_state(torch.Generator(device=DEV).manual_seed(3),
                                 cfg, ocfg)
            before = {p: x.clone() for p, x in P.tree_items(state["params"])
                      if p[0] in ("units",) and p[2] == "mix"}
            _reset_train_launches()
            walls, peaks, held, losses, got = [], [], [], [], None
            for n_step in (1, 2):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held.append(torch.cuda.memory_allocated() / 1e9)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch, alive)
                losses.append(float(metrics["loss"]))
                walls.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated() / 1e9)
                got = _train_launches()
                if check:
                    _check_launches(f"train-families {arch} step {n_step}",
                                    got, _expected_train_launches(cfg,
                                                                  n_step))
            return losses, walls, peaks, held, state, before, got

        losses, walls, peaks, held, state, before, got = steps(True)
        finite = all(bool(torch.isfinite(x).all())
                     for _, x in P.tree_items(state["params"]))
        after = dict(P.tree_items(state["params"]))
        still = [p for p, x in before.items() if torch.equal(x, after[p])]
        # every mixing layer must have moved (a leaf whose gradient is
        # below its ulp / lr, as the RG-LRU's lam under lr 1e-3, may not)
        mixers = {p[:2] for p in before}
        stuck = sorted(m for m in mixers
                       if all(p in still for p in before if p[:2] == m))
        log(f"[train-families] {cfg.name} cut to {layers} of "
            f"{get_arch(arch).num_layers} layers ({cfg.layer_pattern}), d "
            f"{cfg.d_model}, batch {B} x {S}: losses {losses}; first step "
            f"{walls[0]:.6f} s (with warm-up), peak memory {peaks[0]:.2f} "
            f"GB ({held[0]:.2f} GB held before it); warm step "
            f"{walls[1]:.6f} s (host clock, synchronize before, the loss's "
            f".item() after), peak memory {peaks[1]:.2f} GB ({held[1]:.2f} "
            f"GB held before it); attention backward launches "
            f"{got['flash_attention_bwd_wgmma']} on the tensor cores; "
            f"params finite {finite}, mixing leaves that did not move "
            f"{still}, mixing layers that did not move {stuck}")
        if not (all(map(math.isfinite, losses)) and finite and not stuck):
            raise AssertionError(f"[train-families] {arch}: losses "
                                 f"{losses}, finite {finite}, unmoved "
                                 f"{stuck}")
        for k in total:
            total[k] += got[k]
        del state, before, after
        torch.cuda.empty_cache()
        if (arch == "recurrentgemma-9b" and parent
                and "flash_attention_bwd_wgmma" in parent):
            current = fa.flash_attention_bwd_cuda

            def parent_bwd(q, k, v, o, do, causal=True, window=None,
                           lse=None):
                assert causal
                return _parent_attn_bwd(torch, parent, q, k, v, o, do, lse,
                                        window)
            fa.flash_attention_bwd_cuda = parent_bwd
            try:
                theirs, their_walls, *_ = steps(False)
            finally:
                fa.flash_attention_bwd_cuda = current
            rel = abs(losses[1] - theirs[1]) / abs(theirs[1])
            log(f"[train-families] {cfg.name} on the parent's tensor-core "
                f"attention backward from the same state: losses {theirs} "
                f"(warm step {their_walls[1]:.6f} s); step 1 bit for bit "
                f"{losses[0] == theirs[0]}, step 2 relative difference "
                f"{rel:.3e} (tolerance {FAMILY_PARENT_TOL})")
            if not (losses[0] == theirs[0] and rel <= FAMILY_PARENT_TOL):
                raise AssertionError(f"[train-families] {arch}: losses "
                                     f"{losses} against the parent's "
                                     f"{theirs}")
            torch.cuda.empty_cache()
        del batch
    return total


def phase_train_no_sync(torch):
    """[train-no-sync]: two [train] steps (qwen1.5-0.5b at full size, the
    batch and alive mask already on the card) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in the step,
    remat's recompute and the backward kernels included, waits on the
    card."""
    from repro_torch.configs.base import TolFLConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.configs.registry import get_arch
    args = _train_args()
    cfg = get_arch(TRAIN_ARCH)
    mesh = make_host_mesh(data=1, model=1, device=DEV)
    ocfg = train.OptimizerConfig(lr=args.lr, warmup_steps=5,
                                 total_steps=args.steps)
    step_fn = D.make_train_step(
        cfg, TolFLConfig(num_clusters=1, schedule="tolfl_ring"), ocfg, mesh)
    state = D.init_state(torch.Generator(device=DEV).manual_seed(0), cfg,
                         ocfg)
    batches = [shard_batch(b, mesh) for b in TokenPipeline(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH).batches(3)]
    alive = torch.ones((1,), device=DEV)
    state, _ = step_fn(state, batches[0], alive)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[1:]:
            state, metrics = step_fn(state, b, alive)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[train-no-sync] 2 steps of {cfg.name} under the sync debug mode "
        f"'error': no synchronising call; loss {float(metrics['loss']):.4f}")
    return step_fn, state, batches[0], alive


MESH1_STEPS = 3
#: [dryrun]'s records on the 16x16 mesh (arch, shape): the ring with heads
#: over 16, FSDP with the weighted all-reduce and experts on the model
#: axis, an RWKV6 decode step, RecurrentGemma at 500k tokens
DRYRUN_CASES = (("qwen3-8b", "train_4k"), ("llama4-scout-17b-a16e", "train_4k"),
                ("rwkv6-7b", "decode_32k"),
                ("recurrentgemma-9b", "long_500k"))
DRYRUN_TIMEOUT_S = 240


def phase_mesh1_train(torch):
    """[mesh1-train]: three [train] steps (qwen1.5-0.5b at full size, the
    ring on a world of one rank) through the mesh seam: under
    ``activate_mesh(make_host_mesh(1, 1), rules_for("replicated_data"))``
    the batch is a DTensor on the (1, 1) device mesh and every constraint
    is the identity.  The losses must be bitwise those of the same three
    steps without a mesh, the kernels' launches (counted from 0 over each
    run) those of the config's count in both, and steps 2 and 3 must not
    wait on the card (sync debug mode "error")."""
    from repro_torch.configs.base import TolFLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import logical as L
    from torch.distributed.tensor import DTensor
    args = _train_args()
    cfg = get_arch(TRAIN_ARCH)
    mesh = make_host_mesh(data=1, model=1, device=DEV)
    mesh.device_mesh            # the one-rank process group, made once
    ocfg = train.OptimizerConfig(lr=args.lr, warmup_steps=5,
                                 total_steps=args.steps)
    host = list(TokenPipeline(cfg.vocab_size, TRAIN_SEQ,
                              TRAIN_BATCH).batches(MESH1_STEPS))

    def run(meshed):
        ctx = (L.activate_mesh(mesh, L.rules_for("replicated_data"))
               if meshed else contextlib.nullcontext())
        with ctx:
            step_fn = D.make_train_step(
                cfg, TolFLConfig(num_clusters=1, schedule="tolfl_ring"),
                ocfg, mesh)
            state = D.init_state(torch.Generator(device=DEV).manual_seed(0),
                                 cfg, ocfg)
            batches = [shard_batch(b, mesh) for b in host]
            if meshed != isinstance(batches[0]["tokens"], DTensor):
                raise AssertionError("[mesh1-train] shard_batch's rows are "
                                     "not a DTensor under the mesh")
            alive = torch.ones((1,), device=DEV)
            torch.cuda.synchronize()
            _reset_train_launches()
            losses = []
            for i, b in enumerate(batches):
                if i == 1:
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    state, metrics = step_fn(state, b, alive)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            launches = _train_launches()
        del state, step_fn
        torch.cuda.empty_cache()
        return [x.item() for x in losses], launches

    plain, plain_launches = run(False)
    meshed, mesh_launches = run(True)
    want = _expected_train_launches(cfg, MESH1_STEPS)
    _check_launches("mesh1-train", mesh_launches, want)
    _check_launches("mesh1-train", plain_launches, want)
    same = [a == b for a, b in zip(meshed, plain)]   # float32s, exactly
    log(f"[mesh1-train] {MESH1_STEPS} steps of {cfg.name} under a (1, 1) "
        f"mesh: losses {meshed}, without a mesh {plain}, bitwise equal "
        f"{same}; flash_attention launches {mesh_launches['flash_attention']}"
        f" / backward {mesh_launches['flash_attention_bwd']} with and "
        f"{plain_launches['flash_attention']} / "
        f"{plain_launches['flash_attention_bwd']} without; steps 2-3 under "
        f"the sync debug mode 'error'")
    if not all(same):
        raise AssertionError("[mesh1-train] the mesh seam changed a loss")
    return mesh_launches


def phase_dryrun(torch):
    """[dryrun]: ``python -m repro_torch.launch.dryrun`` at full width on
    the 16x16 mesh for DRYRUN_CASES, one process each (a fake process
    group of 256 ranks, meta tensors: the card is not used), all at once.
    Each record must be ok; prints its analytic roofline terms (H100
    datasheet constants), this rank's traced collective bytes by kind and
    its state bytes."""
    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape in DRYRUN_CASES]
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for (arch, shape), p, text in zip(DRYRUN_CASES, procs, outs):
        path = out / f"{arch}__{shape}__pod16x16.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if p.returncode != 0 or rec.get("status") != "ok":
            raise AssertionError(f"[dryrun] {arch} x {shape}: rc "
                                 f"{p.returncode}, {rec.get('error')}\n"
                                 f"{text[-3000:]}")
        rl, tr = rec["roofline"], rec["roofline_trace"]
        log(f"[dryrun] {arch} x {shape} x pod16x16: {rec['status']}, "
            f"{rec['chips']} chips, {rec.get('schedule', rec['mode'])}, "
            f"trace {rec['t_trace']} s; analytic t_compute "
            f"{rl['t_compute']:.3e} s, t_memory {rl['t_memory']:.3e} s, "
            f"t_collective {rl['t_collective']:.3e} s -> {rl['bottleneck']};"
            f" traced collective bytes / rank "
            f"{ {k: v for k, v in tr['coll_breakdown'].items() if v} }; "
            f"state {rec['state_bytes']} B / rank, batch "
            f"{rec['batch_bytes']} B / rank; traced flops (global) "
            f"{rec['trace_flops']:.3e}")
    log(f"[dryrun] {len(DRYRUN_CASES)} records in {wall:.1f} s")


def _wkv_bwd_inputs(torch, gen):
    """The WKV backward's inputs at [train-families]' RWKV6-7B shape (1,
    2048, 64, 64): (r, k, v, w, u, state0, dy)."""
    from repro_torch.kernels import rwkv6_scan as wk
    B, S, H, N = 1, TRAIN_FAMILIES[0][3], 64, 64
    r, k, v, w, u, s0 = wk.random_inputs(B, S, H, N, True, gen)
    return r, k, v, w, u, s0, torch.randn((B, S, H, N), generator=gen,
                                          device=DEV)


def _wkv_bwd_split(torch):
    """Each device kernel of one WKV backward call at [train-families]'
    shape, in ms a call under torch.profiler: the mean over the events a
    window of 8 calls kept (records at a window's edge can be lost), a
    window taken again (up to 3) where a kernel has none; None where no
    window had one."""
    from repro_torch.kernels import rwkv6_scan as wk
    args = _wkv_bwd_inputs(torch, torch.Generator(device=DEV).manual_seed(29))
    for _ in range(3):
        _, _, by_name = _profiled(torch, lambda: wk.rwkv6_scan_bwd_cuda(
            *args), calls=8)
        seen = {name: [(us, n) for ev, (us, n) in by_name.items()
                       if name in ev] for name in WKV_BWD_KERNELS}
        if all(seen.values()):
            break
    return {name: (sum(us for us, _ in hits) / sum(n for _, n in hits)
                   / 1e3) if hits else None for name, hits in seen.items()}


def phase_train_profile(torch, step_fn, state, batch, alive):
    """[train-profile]: one [train] step under torch.profiler: the card's
    busy share of the step's wall time and its top operations, and the
    share of each kernel of the port: the attention forward, the
    backward's delta kernels, the tensor-core backward's fused, dq convert
    and partial-sum kernels (D 64 / 128) and its dq and dk/dv kernels (D =
    256), the split-TF32 backward's dq and dk/dv kernels, and the attention
    backward's whole share; then
    each of
    the WKV backward's two kernels at [train-families]' RWKV6-7B shape
    (:func:`_wkv_bwd_split`), which it returns for [times]."""
    split = _wkv_bwd_split(torch)
    log("[train-profile] rwkv6_scan_bwd (1, 2048, 64, 64), device time by "
        "kernel, ms a call: " + ", ".join(
            f"{name} " + ("not measured" if t is None else f"{t:.6f}")
            for name, t in split.items()))
    with _device_profile(torch) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch, alive)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    busy, by_name = _device_time(prof)
    if busy == 0:
        log("[train-profile] the profiler recorded no device time: not "
            "measured")
        return split
    mine = {k: sum(us for name, (us, _) in by_name.items() if k in name)
            for k in ("flash_attention_wgmma", "attn_bwd_delta",
                      "attn_bwd_fused", "attn_bwd_dq_convert",
                      "attn_bwd_dkdv_sum", "attn_bwd_dq_wgmma",
                      "attn_bwd_dkdv_wgmma", "attn_bwd_dq_tf32",
                      "attn_bwd_dkdv_tf32")}
    mine["attention backward"] = sum(v for k, v in mine.items()
                                     if k.startswith("attn_bwd"))
    log(f"[train-profile] one {TRAIN_ARCH} step ({TRAIN_BATCH} x "
        f"{TRAIN_SEQ}) under the profiler: wall {wall / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({busy / wall:.1%} of wall); port kernels "
        + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy:.1%})"
                    for k, v in mine.items())
        + "; top device events: " + _top(by_name, 12, 1e3, "ms"))
    return split


def _reference_batch(cfg, B, S, seed):
    import numpy as np
    from repro_torch.data.pipeline import TokenPipeline
    batch = next(TokenPipeline(cfg.vocab_size, S, B, seed=seed).batches(1))
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    if cfg.frontend.kind == "vision":
        batch["prefix"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    return batch


#: [train-reference]'s limit on the card's gradients and updated params
#: against the CPU's (see _train_reference_diff): above the sound
#: readings (card vs CPU, and the CPU's float32 WKV scan vs one in
#: float64, ~1e-7 to 1e-4) and below the bfloat16 control (~1e-2)
TRAIN_REF_TOL = 1e-3


def _state_to(torch, state, dev):
    """A copy of a train state ({"params", "opt", "step"}) on ``dev``."""
    from repro_torch.models import params as P

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(dev, copy=True)
        return None if x is None else P.tree_map(move, x)
    return {"params": move(state["params"]),
            "opt": type(state["opt"])(*(move(f) for f in state["opt"])),
            "step": move(state["step"])}


def _train_reference_step(torch, cfg, dev, ocfg, state, seed):
    """One ring step of ``cfg`` on ``dev`` from a copy of ``state`` on
    [train-reference]'s batch ``seed``: (loss, the gradient tree as
    numpy, the new state on the CPU)."""
    from repro_torch.configs.base import TolFLConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    mesh = make_host_mesh(data=1, model=1, device=dev)
    step_fn = D.make_train_step(
        cfg, TolFLConfig(num_clusters=1, schedule="tolfl_ring"), ocfg, mesh)
    state = _state_to(torch, state, dev)
    batch = shard_batch(_reference_batch(cfg, 4, 64, seed), mesh)
    items = P.tree_items(state["params"])
    leaves = [x.detach().requires_grad_(True) for _, x in items]
    loss, _ = T.loss_fn(P.tree_from_items(
        (path, x) for (path, _), x in zip(items, leaves)), cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = P.to_numpy_tree(P.tree_from_items(
        (path, torch.zeros_like(x) if g is None else g)
        for (path, x), g in zip(items, grads)))
    state, m = step_fn(state, batch, torch.ones((1,), device=dev))
    return float(m["loss"]), grads, _state_to(torch, state, "cpu")


def _train_reference_diff(P, got, want, before):
    """Two readings of one step ``got`` against ``want`` (results of
    _train_reference_step from the same state, whose params are
    ``before``), each the worst leaf's: the gradient, max |diff| over the
    leaf's max |gradient|; the params after the step, max (|diff| less
    one float32 ulp of the value) over the leaf's max |change| in
    ``want``'s step: two right updates θ - lr g from gradients a rounding
    apart land up to an ulp apart, which for a norm's scale (1 + a small
    change) is most of the change.  Each scale is floored at 1e-3 of the
    largest over all leaves: a leaf whose exact gradient is 0 (a key's
    bias, which shifts every score of a row alike) holds only rounding
    noise of either side.  Returns ((grad, leaf), (params, leaf))."""
    import numpy as np

    def worst(diffs, scales):
        floor = 1e-3 * max(scales.values())
        return max(((float(d / max(scales[p], floor, 1e-30)), p)
                    for p, d in diffs.items()), default=(0.0, None))

    def leaves(state):
        return dict(P.tree_items(P.to_numpy_tree(state["params"])))
    g_want = dict(P.tree_items(want[1]))
    grad = worst({p: abs(g - g_want[p]).max()
                  for p, g in P.tree_items(got[1])},
                 {p: abs(g).max() for p, g in g_want.items()})
    p0, p1 = leaves(before), leaves(want[2])
    par = worst({p: np.maximum(abs(x - p1[p]) - np.spacing(abs(p1[p])),
                               0).max()
                 for p, x in leaves(got[2]).items()},
                {p: abs(p1[p] - p0[p]).max() for p in p0})
    return grad, par


def _wkv_float64(torch):
    """``ops.rwkv6``'s stand-in for a rounding control: the WKV scan's
    plain forward and backward in float64, rounded to float32."""
    from repro_torch.kernels import rwkv6_scan as wk

    class WKV64(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return tuple(t.float() for t in wk.rwkv6_scan_plain(
                *(t.double() for t in args)))

        @staticmethod
        def backward(ctx, dy, dstate):
            args = [t.double() for t in ctx.saved_tensors]
            return tuple(t.float() for t in wk.rwkv6_scan_backward_plain(
                *args, dy.double(),
                None if dstate is None else dstate.double()))
    return WKV64.apply


def phase_train_reference(torch):
    """[train-reference]: every arch's reduced config (float32, remat
    none), 2 ring steps of SGD (lr 0.05, constant, no clip) on the CPU,
    and each of those steps again on the card from the CPU's state before
    it, on the same batch.  The losses within 1e-4 relative; each step's
    gradient of every leaf, and every leaf after the step, within
    TRAIN_REF_TOL (see _train_reference_diff).  Each step starts from the
    same state on both sides: chained over steps, a gap of rounding
    grows, and where step 2 undoes part of step 1 the net change of a
    leaf holds no scale to measure it by.  The limit is held against a
    bfloat16 control, the same steps on the CPU with the config's compute
    dtype bf16, which must land above it in every arch; for the archs with
    an RWKV6 layer, the CPU's float32 WKV scan against one in float64
    gives the size of the scan's rounding alone.  The MoE configs route by
    argmax: a route flipped by a near tie would show here as a failure.
    Every attention backward of the card steps must run on the split-TF32
    kernel (float32).  Returns the card steps' kernel launches."""
    import dataclasses
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.models import params as P
    ocfg = OptimizerConfig(name="sgd", lr=0.05, schedule="constant",
                           warmup_steps=0, grad_clip=0.0)
    worst = {"loss": 0.0, "grad": 0.0, "params": 0.0, "control": math.inf}
    _reset_train_launches()
    for arch in ARCHS:
        cfg = ARCHS[arch].reduced()
        bf16 = dataclasses.replace(cfg, dtype="bfloat16")
        states = [D.init_state(torch.Generator().manual_seed(9), cfg, ocfg)]
        read = {"loss": 0.0, "grad": (0.0, None), "params": (0.0, None),
                "control": math.inf, "wkv64": ((0.0, None), (0.0, None))}
        losses = {"card": [], "cpu": []}
        for seed in range(2):
            before = states[-1]
            cpu = _train_reference_step(torch, cfg, "cpu", ocfg, before, seed)
            states.append(cpu[2])
            card = _train_reference_step(torch, cfg, DEV, ocfg, before, seed)
            ctrl = _train_reference_step(torch, bf16, "cpu", ocfg, before,
                                         seed)
            losses["cpu"].append(cpu[0])
            losses["card"].append(card[0])
            g, p = _train_reference_diff(P, card, cpu, before)
            (cg, _), (cp, _) = _train_reference_diff(P, ctrl, cpu, before)
            read = {"loss": max(read["loss"], abs(card[0] - cpu[0])
                                / abs(cpu[0])),
                    "grad": max(read["grad"], g), "params": max(
                        read["params"], p),
                    "control": min(read["control"], cg, cp),
                    "wkv64": read["wkv64"]}
            if "rwkv" in cfg.layer_pattern:
                plain = ops.rwkv6
                ops.rwkv6 = _wkv_float64(torch)
                try:
                    f64 = _train_reference_step(torch, cfg, "cpu", ocfg,
                                                before, seed)
                finally:
                    ops.rwkv6 = plain
                fg, fp = _train_reference_diff(P, f64, cpu, before)
                read["wkv64"] = (max(read["wkv64"][0], fg),
                                 max(read["wkv64"][1], fp))
        note = ""
        if "rwkv" in cfg.layer_pattern:
            (fg, fg_at), (fp, fp_at) = read["wkv64"]
            note = (f"; the CPU's float32 WKV scan vs one in float64: grad "
                    f"{fg:.3g} at {fg_at}, params {fp:.3g} at {fp_at}")
        (g, g_at), (p, p_at) = read["grad"], read["params"]
        log(f"[train-reference] {cfg.name}: losses card {losses['card']} vs "
            f"CPU {losses['cpu']} (rel diff {read['loss']:.3g}); gradient, "
            f"max |diff| / max |grad| {g:.3g} at {g_at}; params after the "
            f"step, max (|diff| - ulp) / max |change| {p:.3g} at {p_at}; bf16 "
            f"control's least reading {read['control']:.3g}{note}")
        if not (read["loss"] <= 1e-4 and g <= TRAIN_REF_TOL
                and p <= TRAIN_REF_TOL):
            raise AssertionError(f"[train-reference] {arch}: loss rel "
                                 f"{read['loss']}, grad {g} at {g_at}, "
                                 f"params {p} at {p_at}")
        if not read["control"] > TRAIN_REF_TOL:
            raise AssertionError(f"[train-reference] {arch}: the bf16 "
                                 f"control ({read['control']}) is within "
                                 f"the limit {TRAIN_REF_TOL}")
        worst = {"loss": max(worst["loss"], read["loss"]),
                 "grad": max(worst["grad"], g),
                 "params": max(worst["params"], p),
                 "control": min(worst["control"], read["control"])}
    got = _train_launches()
    log(f"[train-reference] all {len(ARCHS)} archs: worst loss rel diff "
        f"{worst['loss']:.3g} (bound 1e-4), worst grad {worst['grad']:.3g} "
        f"and params {worst['params']:.3g} (bound {TRAIN_REF_TOL}); the "
        f"bf16 control's least reading {worst['control']:.3g}; attention "
        f"backward launches {got['flash_attention_bwd']}, on the split-TF32 "
        f"kernel {got['flash_attention_bwd_tf32x3']}")
    if not 0 < got["flash_attention_bwd_tf32x3"] == got["flash_attention_bwd"]:
        raise AssertionError(f"[train-reference]: {got} attention backward "
                             f"launches, not all on the split-TF32 kernel")
    return got


def phase_train_ckpt(torch):
    """[train-ckpt]: qwen1.5-0.5b reduced in bf16 with remat (the
    tensor-core forward and the backward kernel), Adam: 10 steps
    uninterrupted; then 5 steps, a checkpoint of the whole state (params,
    Adam's moments, step) saved and restored into a fresh state, and
    steps 6-10: the params, moments and losses must equal the
    uninterrupted run's bit for bit on the card."""
    import dataclasses
    from repro_torch.configs.base import OptimizerConfig, TolFLConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.checkpoint import CheckpointManager, tree_leaves
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).reduced(),
                              dtype="bfloat16", remat="full")
    mesh = make_host_mesh(data=1, model=1, device=DEV)
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=5, total_steps=10)
    step_fn = D.make_train_step(
        cfg, TolFLConfig(num_clusters=1, schedule="tolfl_ring"), ocfg, mesh)
    batches = [shard_batch(b, mesh) for b in TokenPipeline(
        cfg.vocab_size, 256, 8).batches(10)]
    alive = torch.ones((1,), device=DEV)

    def fresh():
        return D.init_state(torch.Generator(device=DEV).manual_seed(4), cfg,
                            ocfg)

    def steps(state, lo, hi, losses):
        for i in range(lo, hi):
            state, m = step_fn(state, batches[i], alive)
            losses.append(float(m["loss"]))
        return state

    lw = []
    whole = steps(fresh(), 0, 10, lw)
    la = []
    half = steps(fresh(), 0, 5, la)
    directory = ROOT / "build" / "chip_smoke" / "train_ckpt"
    if directory.exists():
        for f in directory.iterdir():
            f.unlink()
    mgr = CheckpointManager(str(directory), keep=2)
    path = mgr.save(half, 5)
    restored, at = mgr.restore_latest(fresh())
    resumed = steps(restored, at, 10, la)
    same = (la == lw and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                          tree_leaves(whole))))
    log(f"[train-ckpt] {cfg.name} bf16 remat full, Adam: saved at step 5 "
        f"({Path(path).stat().st_size} bytes), restored at step {at}, run "
        f"to step 10: params, moments and losses equal to the "
        f"uninterrupted run bit for bit: {same}; losses {lw}")
    if not same:
        raise AssertionError("[train-ckpt] the resumed run differs")


def phase_examples_train(torch):
    """[examples] train_100m at its default 12 x 768 size with --steps 5
    on the card: the loss finite and the checkpoint written."""
    import contextlib
    import io
    from repro_torch.examples import train_100m
    directory = ROOT / "build" / "chip_smoke" / "train_100m"
    if directory.exists():
        for f in directory.iterdir():
            f.unlink()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = train_100m.main(["--steps", "5", "--ckpt-dir", str(directory),
                               "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    files = sorted(p.name for p in directory.iterdir())
    ok = (all(map(math.isfinite, out["losses"])) and out["latest_step"] == 5
          and files == ["ckpt_00000005.msgpack"])
    tail = " | ".join(ln for ln in buf.getvalue().splitlines()[-3:]
                      if ln.strip())
    log(f"[examples] train_100m --steps 5 on the card: {wall:.2f} s, losses "
        f"{[round(x, 4) for x in out['losses']]}, checkpoint {files}, checks "
        f"{'passed' if ok else 'FAILED'}; last lines: {tail}")
    if not ok:
        raise AssertionError(f"[examples] train_100m: {out}, {files}")


#: [times]' attention backward shapes, (B, S, H, KVH, D, window), bf16,
#: causal, on the tensor-core route: [train]'s qwen1.5-0.5b, internlm2's
#: heads, [train-families]' RecurrentGemma-9B local attention and
#: [train-bf16-8b]'s Qwen3-8B
BWD_TIME_TC = ((TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, None),
               (TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128, None),
               (1, 2048, 16, 1, 256, 2048),
               (1, 2048, 32, 8, 128, None))
#: the float32 backward's timing shapes, causal: [train-families]'
#: RecurrentGemma-9B local attention and [train]'s qwen1.5-0.5b
BWD_TIME_F32 = ((1, 2048, 16, 1, 256, 2048),
                (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, None))
#: the float32 forward's [times] shapes: [serve-consistency]'s
#: RecurrentGemma-9B attention and [train]'s qwen1.5-0.5b heads in float32
#: (through the lse entry point, as a training step calls it):
#: (B, S, H, KVH, D, causal, window, lse)
F32_FWD_TIMES = ((1, 4097, 16, 1, 256, True, 2048, False),
                 (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, True, None, True))


def _attn_bwd_times(torch, gen, shape, n=20, parent=None):
    """One attention backward shape's readings: the routed backward, SDPA's
    backward (``enable_gqa``, a band mask where the window cuts the causal
    band) and, on the tensor-core route, the serving forward, the
    forward's lse entry point and (with --parent) the parent's tensor-core
    backward and lse entry point, in turns, card and call times (the
    backward at D = 256 must beat the parent's; at D 64 / 128 give its dq,
    dk, dv bit for bit and not be slower than it by more than the turns'
    spread; the lse forward, which training launches, may not be slower
    than the parent's by more than the turns' spread); at D = 256 each
    backward kernel's device time under torch.profiler
    (:func:`_bwd_kernels_ms`), the parent's too; the plain backward; the
    bound
    (10 D flops per visible (query, head, key) triple at 989 TFLOP/s, or
    q, o, dO, k, v and lse read and dq, dk, dv written once at 3.35
    TB/s)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, H, KVH, D, window = shape
    q = torch.randn((B, S, H, D), generator=gen, device=DEV).bfloat16()
    k, v = (torch.randn((B, S, KVH, D), generator=gen, device=DEV).bfloat16()
            for _ in range(2))
    do = torch.randn((B, S, H, D), generator=gen, device=DEV).bfloat16()
    tc = fa.bwd_route(torch.bfloat16, D) == "tensor_core"
    o, lse = fa.flash_attention_cuda(q, k, v, True, window, return_lse=True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    # a window of S or more cuts nothing from the causal band
    mask = (None if window is None or window >= S else
            fa.visible(S, S, True, window, DEV))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=mask is None,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    fns = {"kernel": lambda: fa.flash_attention_bwd_cuda(
        q, k, v, o, do, True, window, lse=lse)}
    fns["library sdpa backward"] = lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True)
    if tc:
        fns["forward"] = lambda: fa.flash_attention_cuda(q, k, v, True,
                                                         window)
        fns["forward lse"] = lambda: fa.flash_attention_cuda(
            q, k, v, True, window, return_lse=True)
    same = None
    if tc and parent and "flash_attention_bwd_wgmma" in parent:
        fns["parent kernel"] = lambda: _parent_attn_bwd(
            torch, parent, q, k, v, o, do, lse, window)
        same = all(torch.equal(a, b) for a, b in zip(
            fns["kernel"](), fns["parent kernel"]()))
    if tc and parent and "flash_attention_wgmma_lse" in parent:
        fns["parent forward lse"] = lambda: _parent_attn_lse(
            torch, parent, q, k, v, True, window)
    dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    split = ({key: _bwd_kernels_ms(torch, fns[key])
              for key in ("kernel", "parent kernel") if key in fns}
             if tc and D == 256 else {})
    plain_ms = _median_ms(torch, lambda: fa.flash_attention_backward_plain(
        q, k, v, o, do, True, window), True, 3)
    pairs = visible_pairs(S, True, window)
    flops = 10 * D * pairs * B * H
    moved = (4 * B * S * H * D + 4 * B * S * KVH * D) * 2 + B * H * S * 4
    b_ops = flops / H100_BF16_FLOPS * 1e3
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    bound = max(b_ops, b_bytes)
    ms = dev_ms["kernel"]
    log(f"[times] flash_attention_bwd {'tensor_core' if tc else 'tf32x3'}"
        f" bf16 (B, S, H, KVH, D) = {(B, S, H, KVH, D)} causal window="
        f"{window}, median of {n} CUDA-event timings in 4 turns, card / "
        f"call: " + ", ".join(f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f}"
                              f" ms" for key in fns)
        + f"; plain {plain_ms:.6f} ms (median of 3); bound {bound:.6f} ms "
        f"({flops} flops over {pairs} visible pairs x B x H at 989 TFLOP/s; "
        f"{moved} bytes take {b_bytes:.6f} ms); kernel "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of the bound, "
        f"{dev_ms['library sdpa backward'] / ms:.2f}x SDPA backward's speed"
        + (f", {dev_ms['parent kernel'] / ms:.3f}x the parent's (turns' "
           f"spread: kernel {spread['kernel']:.6f}, parent "
           f"{spread['parent kernel']:.6f} ms; dq, dk, dv bitwise equal to "
           f"the parent's: {same})" if same is not None else "")
        + "".join(f"; {key}'s device kernels under torch.profiler, ms a "
                  f"call: " + (", ".join(f"{name} {t:.6f}"
                                         for name, t in times.items())
                               or "not measured")
                  for key, times in split.items())
        + (f"; the forward's lse entry point "
           f"{dev_ms['parent forward lse'] / dev_ms['forward lse']:.3f}x the "
           f"parent's speed (turns' spread: "
           f"{spread['forward lse']:.6f}, parent "
           f"{spread['parent forward lse']:.6f} ms)"
           if "parent forward lse" in fns else "")
        + f"; clocks.sm, power.draw, temperature after: {_clocks()}")
    if same is not None:
        # D = 256 must beat the parent's; D 64 / 128 is the parent's code and
        # must give its bits, as fast
        row = {"name": "flash_attention_bwd_wgmma", "arch": f"D = {D}",
               "ms": ms}
        if D == 256:
            _faster_than_parent(row, dev_ms["parent kernel"])
        elif not same:
            raise AssertionError(f"the D = {D} backward at {shape}: dq, dk, "
                                 f"dv differ from the parent's")
        else:
            _no_slower_than_parent(row, dev_ms["parent kernel"], max(
                spread["kernel"], spread["parent kernel"]))
    fwd = None
    if "parent forward lse" in fns:
        # the forward [train] launches: not slower than the parent's
        fwd = {"name": "flash_attention", "arch": "forward lse entry",
               "ms": dev_ms["forward lse"]}
        _no_slower_than_parent(fwd, dev_ms["parent forward lse"], max(
            spread["forward lse"], spread["parent forward lse"]))
    return {"shape": [B, S, S, H, KVH, D], "window": window, "ms": ms,
            "call_ms": call_ms["kernel"], "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": dev_ms["library sdpa backward"],
            "tflops": flops / ms / 1e9, "share_of_bound": bound / ms,
            **{f"{key.replace(' ', '_')}_ms": dev_ms[key] for key in fns
               if key in ("forward", "forward lse")},
            **({"parent_ms": dev_ms["parent kernel"], "parent_equal": same,
                "turns_spread_ms": spread["kernel"]}
               if same is not None else {}),
            **({"kernels_ms": split["kernel"]} if split else {}),
            **({"parent_kernels_ms": split["parent kernel"]}
               if "parent kernel" in split else {}),
            **({"forward_lse_parent_ms": fwd["parent_ms"],
                "forward_lse_turns_spread_ms": fwd["turns_spread_ms"]}
               if fwd is not None else {})}


#: a child process's SDPA float32 backward under torch.profiler: argv[1]
#: a JSON list of causal (B, S, H, KVH, D, window); prints, for each, its
#: device kernels' ms a call
SDPA_BWD_PROFILE = """
import json, sys
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = []
for B, S, H, KVH, D, window in json.loads(sys.argv[1]):
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, H, S, D), generator=g, device="cuda").requires_grad_()
    k, v = (torch.randn((B, KVH, S, D), generator=g,
                        device="cuda").requires_grad_() for _ in range(2))
    mask = None
    if window is not None and window < S:
        d = torch.arange(S, device="cuda")[:, None] - torch.arange(
            S, device="cuda")[None, :]
        mask = (d >= 0) & (d < window)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       is_causal=mask is None,
                                       enable_gqa=True)
    do = torch.randn_like(o)
    for _ in range(3):
        torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
        torch.cuda.synchronize()
    out.append({e.key: e.device_time_total / 4e3 for e in prof.key_averages()
                if e.device_time_total > 0})
print(json.dumps(out))
"""


def _sdpa_bwd_kernels(shapes):
    """SDPA's float32 backward at each causal training shape: its device
    kernels by name, ms a call, under torch.profiler in a child process
    (in this one, after the phases before, the profiler records no device
    event of the backward autograd runs on its device thread)."""
    got = subprocess.run([sys.executable, "-c", SDPA_BWD_PROFILE,
                          json.dumps([list(shape) for shape in shapes])],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(got.stdout.strip().splitlines()[-1])


def _attn_bwd_f32_times(torch, gen, shape, sdpa_kernels, n=8, parent=None):
    """The split-TF32 backward (the float32 route) at one causal training
    shape on float32 inputs, in turns with SDPA's backward on the same
    float32 inputs and, with --parent, the parent's float32 backward
    (given a copy of the forward's lse), which it must beat, or, where
    its dq, dk and dv are bitwise the parent's (the same arithmetic: a
    change that only moved code), not lose to by more than the turns'
    spread; SDPA's device kernels
    (``sdpa_kernels``, {name: ms a call}); the plain backward; the bound,
    the larger of the split products' three TF32
    passes of 10 D flops per visible (query, head, key) triple at 495
    TFLOP/s and q, o, dO, k, v, lse read and dq, dk, dv written once at
    3.35 TB/s, beside the float32 CUDA cores' 67 TFLOP/s."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, H, KVH, D, window = shape
    q = torch.randn((B, S, H, D), generator=gen, device=DEV)
    k, v = (torch.randn((B, S, KVH, D), generator=gen, device=DEV)
            for _ in range(2))
    do = torch.randn((B, S, H, D), generator=gen, device=DEV)
    assert fa.bwd_route(torch.float32, D) == "tf32x3"
    o, lse = fa.flash_attention_cuda(q, k, v, True, window, return_lse=True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    mask = (None if window is None or window >= S else
            fa.visible(S, S, True, window, DEV))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=mask is None,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    fns = {"kernel": lambda: fa.flash_attention_bwd_cuda(
               q, k, v, o, do, True, window, lse=lse),
           "library sdpa backward": lambda: torch.autograd.grad(
               out, (qt, kt, vt), dot, retain_graph=True)}
    same = None
    if parent and "flash_attention_bwd" in parent:
        scratch_lse = lse.clone()
        fns["parent kernel"] = lambda: _parent_attn_bwd_f32(
            torch, parent, q, k, v, o, do, scratch_lse, window)
        same = all(torch.equal(a, b) for a, b in zip(fns["kernel"](),
                                                     fns["parent kernel"]()))
    dev_ms, spread = _turns_spread_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    plain_ms = _median_ms(torch, lambda: fa.flash_attention_backward_plain(
        q, k, v, o, do, True, window), True, 3)
    pairs = visible_pairs(S, True, window)
    flops = 10 * D * pairs * B * H
    moved = (4 * B * S * H * D + 4 * B * S * KVH * D) * 4 + B * H * S * 4
    b_ops = 3 * flops / H100_TF32_FLOPS * 1e3
    b_f32 = flops / H100_F32_FLOPS * 1e3
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    bound = max(b_ops, b_bytes)
    ms = dev_ms["kernel"]
    log(f"[times] flash_attention_bwd tf32x3 float32 (B, S, H, KVH, D) = "
        f"{(B, S, H, KVH, D)} causal window={window}, median of {n} "
        f"CUDA-event timings in 4 turns, card / call: " + ", ".join(
            f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms" for key in fns)
        + f" (turns' spread: " + ", ".join(
            f"{key} {spread[key]:.6f}" for key in fns)
        + f"); plain {plain_ms:.6f} ms (median of 3); bound {bound:.6f} ms "
        f"({flops} flops over {pairs} visible pairs x B x H, three TF32 "
        f"passes at 495 TFLOP/s; {moved} bytes take {b_bytes:.6f} ms; on "
        f"the CUDA cores at 67 TFLOP/s float32 {b_f32:.6f} ms); kernel "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of the bound, "
        f"{dev_ms['library sdpa backward'] / ms:.3f}x SDPA's float32 "
        f"backward's speed"
        + (f", {dev_ms['parent kernel'] / ms:.3f}x the parent's, dq, dk, "
           f"dv bitwise the parent's: {same}" if "parent kernel" in fns
           else "")
        + "; SDPA's backward's device kernels under torch.profiler (a "
        "child process), ms a call: " + ("; ".join(f"{name} {t:.6f}" for name, t in sorted(
            sdpa_kernels.items(), key=lambda kv: -kv[1])) or "not measured")
        + f"; clocks.sm, power.draw, temperature after: {_clocks()}")
    row = {"name": "flash_attention_bwd", "shape": [B, S, S, H, KVH, D],
           "window": window, "ms": ms, "call_ms": call_ms["kernel"],
           "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "operations" if b_ops >= b_bytes else "bytes",
           "bound_cuda_core_ms": b_f32,
           "library_ms": dev_ms["library sdpa backward"],
           "library_kernels": sorted(sdpa_kernels),
           "tflops": flops / ms / 1e9, "share_of_bound": bound / ms,
           "dtype": "float32"}
    if "parent kernel" in fns:
        row["parent_equal"] = same
        if same:
            _no_slower_than_parent(row, dev_ms["parent kernel"], max(
                spread["kernel"], spread["parent kernel"]))
        else:
            _faster_than_parent(row, dev_ms["parent kernel"])
        row["turns_spread_ms"] = spread["kernel"]
    del q, k, v, do, o, lse, qt, kt, vt, out
    return row


def _parent_attn_bwd_f32(torch, parent, q, k, v, o, do, lse, window):
    """The parent's float32 attention backward, causal: (dq, dk, dv).  It
    reads ``lse`` (a copy of the forward's) and writes delta and its head
    split's partials into the scratch, which has this plan's size
    (``f32_bwd_scratch``, at least delta's)."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, D = q.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((fa.f32_bwd_scratch(B, Sq, k.shape[1], H, k.shape[2],
                                            D),),
                        dtype=torch.float32, device=q.device)
    err = parent["flash_attention_bwd"](
        *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, lse, delta)), B,
        Sq, k.shape[1], H, k.shape[2], D, 1, -1 if window is None else window,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's float32 attention backward failed: "
                           f"{err}")
    return dq, dk, dv


#: the device kernels of one tensor-core attention backward call at D =
#: 256, the current one's and the parent's (delta, dq, dk/dv, the sum)
TC_BWD_D256_KERNELS = 4


def _bwd_kernels_ms(torch, fn):
    """Each device kernel of one tensor-core attention backward call
    ``fn``, by name (``attn_bwd_*``), in ms a launch under torch.profiler:
    the mean over the launches a window of 8 calls kept (records at a
    window's edge can be lost), a window taken again (up to 3) until
    ``TC_BWD_D256_KERNELS`` kernels were seen; {} where no window saw
    one."""
    for _ in range(3):
        _, _, by_name = _profiled(torch, fn, calls=8)
        kernels = {}
        for name, (us, count) in by_name.items():
            m = re.search(r"attn_bwd_\w+", name)
            if m:
                total = kernels.setdefault(m.group(0), [0.0, 0])
                total[0] += us
                total[1] += count
        if len(kernels) >= TC_BWD_D256_KERNELS:
            break
    return {name: us / count / 1e3 for name, (us, count) in kernels.items()}


def _parent_attn_bwd(torch, parent, q, k, v, o, do, lse, window):
    """The parent's tensor-core attention backward, causal, on its own head
    split and scratch: (dq, dk, dv).  Its D 64 / 128 plan is the current
    one (``bwd_head_split``, ``tc_bwd_scratch``); at D = 256 its heads
    split by the smallest divisor of G whose dk/dv grid (64-key blocks of
    2 warpgroups) holds 2 x 132 warpgroups (else G), and its scratch
    holds the partials (hs, 2, B, Sk, KVH, D) alone."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    if D == 256:
        hs = fa._head_split(-(-Sk // 64) * B * KVH * 2, G, 2 * fa.SMS)
        n = 2 * hs * B * Sk * KVH * D if hs > 1 else 0
    else:
        hs = fa.bwd_head_split(B, Sk, KVH, G, D, Sq, True, window)
        n = fa.tc_bwd_scratch(B, Sq, Sk, H, KVH, D, True, window)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    part = torch.empty((max(n, 1),), dtype=torch.float32, device=q.device)
    err = parent["flash_attention_bwd_wgmma"](
        *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv, delta,
                                 part)),
        B, Sq, Sk, H, KVH, D, 1, -1 if window is None else window, hs,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's attention backward failed: {err}")
    return dq, dk, dv


def phase_train_times(torch, launches, errs, wkv_split, parent=None):
    """The backward kernels at their training shapes beside the plain
    backward, the bound and, for attention, SDPA's backward: the
    tensor-core attention backward at [train]'s (8, 1024, 16, 16, 64),
    internlm2's heads (8, 1024, 16, 8, 128), [train-families]'
    RecurrentGemma-9B local attention (1, 2048, 16, 1, 256, window 2,048)
    and [train-bf16-8b]'s Qwen3-8B (1, 2048, 32, 8, 128), bf16 causal,
    with the serving forward beside the forward's lse entry point; the
    split-TF32 backward on float32 inputs at RecurrentGemma's and
    [train]'s shapes; the WKV scan at [train-families]' RWKV6-7B shape
    (1, 2048, 64, 64).  With --parent the parent's tensor-core and
    float32 backwards are timed in turns with them."""
    from repro_torch.kernels import rwkv6_scan as wk
    gen = torch.Generator(device=DEV).manual_seed(23)
    tc = [_attn_bwd_times(torch, gen, shape, parent=parent)
          for shape in BWD_TIME_TC]
    rows = [{
        "name": "flash_attention_bwd_wgmma", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:90",
        "note": "the gradient of the attention on the tensor cores (bf16, D "
                "64, 128 and 256), which repro takes through its jnp "
                "attention (use_pallas=False in training); reads the lse "
                "that flash_attention_wgmma.cu's lse entry point writes",
        "launches": launches["flash_attention_bwd_wgmma"],
        "max_abs_err": errs["flash_attention_bwd_wgmma"],
        **tc[0], "also": tc[1:]}]
    f32 = [_attn_bwd_f32_times(torch, gen, shape, names, parent=parent)
           for shape, names in zip(BWD_TIME_F32,
                                   _sdpa_bwd_kernels(BWD_TIME_F32))]
    rows.append({
        **f32[0], "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:90",
        "note": "the gradient of the attention in split TF32 on the tensor "
                "cores (float32, and bf16 at D = 32), which repro takes "
                "through its jnp attention (use_pallas=False in training); "
                "reads the lse that flash_attention.cu's lse entry point "
                "writes; timed on float32 inputs at RecurrentGemma's shape "
                "beside SDPA's float32 backward (also at [train]'s shape in "
                "float32), its launches from [train-reference]'s float32 "
                "steps",
        "launches": launches["flash_attention_bwd_tf32x3"],
        "max_abs_err": errs["flash_attention_bwd"], "also": f32[1:]})

    r, kk, vv, w, u, s0, dy = _wkv_bwd_inputs(torch, gen)
    B, S, H, N = r.shape
    fns = {"kernel": lambda: wk.rwkv6_scan_bwd_cuda(r, kk, vv, w, u, s0, dy)}
    dev_ms = _turns_ms(torch, fns, True, 8)
    call_ms = _turns_ms(torch, fns, False, 8)
    plain_ms = _median_ms(torch, lambda: wk.rwkv6_scan_backward_plain(
        r, kk, vv, w, u, s0, dy), True, 2)
    # r, k, v, w, dy read and dr, dk, dv, dw written once, u and the two
    # states (s0 read, ds0 written), du written
    moved = (9 * B * S * H * N + 2 * B * H * N * N + 2 * H * N) * 4
    # per (b, t, h, n, m): dr's and dk's, dv's and dw's multiply-adds and
    # dS's update (w dS + r dy): 6 multiply-adds, 12 flops
    flops = 12 * B * S * H * N * N
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    b_ops = flops / H100_F32_FLOPS * 1e3
    bound = max(b_bytes, b_ops)
    ms = dev_ms["kernel"]
    log(f"[times] rwkv6_scan_bwd (B, S, H, N) = {(B, S, H, N)} "
        f"([train-families]' RWKV6-7B), median of 8 CUDA-event timings in 4 "
        f"turns, card / call: kernel {ms:.6f} / {call_ms['kernel']:.6f} ms; "
        f"plain {plain_ms:.6f} ms (median "
        f"of 2, its {S} steps dispatched by the host), library none (no "
        f"single PyTorch call computes the recurrence's gradient); bound "
        f"{bound:.6f} ms ({moved} bytes at 3.35 TB/s take {b_bytes:.6f} ms; "
        f"{flops} flops at 67 TFLOP/s float32 {b_ops:.6f} ms), kernel "
        f"{bound / ms:.1%} of the bound; device time by kernel under "
        f"torch.profiler ([train-profile]): "
        + ", ".join(f"{name} " + ("not measured" if t is None
                                   else f"{t:.6f} ms")
                    for name, t in wkv_split.items())
        + f"; clocks.sm, power.draw, temperature after: {_clocks()}")
    rows.append({
        "name": "rwkv6_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:59",
        "note": "the gradient of the WKV recurrence, which repro takes "
                "through its jnp scan (use_pallas=False in training)",
        "launches": launches["rwkv6_scan_bwd"],
        "max_abs_err": errs["rwkv6_scan_bwd"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None, "call_ms": call_ms["kernel"],
        "kernels_ms": wkv_split, "shape": [B, S, H, N],
        "share_of_bound": bound / ms})
    return rows


# every phase is timed for the [clock] line
for _name in [n for n in globals() if n.startswith("phase_")]:
    globals()[_name] = _clocked(globals()[_name])


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None, help=(
        "a checkout (e.g. a git archive) of another commit: those of its "
        "kernels whose sources differ from the current ones are built too "
        "and timed in turns with the current ones in [times]"))
    ap.add_argument("--aot-child", choices=tuple(AOT_RUNS), default=None,
                    help="run one of [aot]'s processes (phase_aot starts "
                         "them)")
    ap.add_argument("--aot-out", default=None,
                    help="where an --aot-child process writes its results")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import row_dense
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.aot_child:
        return aot_child(torch, args.aot_child, args.aot_out)

    t_start = time.perf_counter()
    name, smi, parent = phase_device(torch, args.parent)
    errs = phase_kernels(torch)
    errs["row_dense"] = phase_score_kernels(torch, parent)
    serve_errs = phase_serve_kernels(torch)
    split, dx, counts = _paper_split()
    launches = phase_slice(torch, split, dx, counts)
    phase_no_sync(torch, split, dx, counts)
    phase_profile(torch, split, dx, counts, parent)
    phase_reference(torch, split, dx, counts)
    launches["tolfl_round_update"] += phase_campaign(torch, split, dx, counts)
    phase_campaign_no_sync(torch, split, dx, counts)
    phase_campaign_profile(torch, split, dx, counts)
    phase_campaign_reference(torch, split, dx, counts)
    phase_multi_campaign(torch, split, dx, counts)
    phase_multi_no_sync(torch, split, dx, counts)
    phase_multi_profile(torch, split, dx, counts)
    phase_multi_reference(torch, split, dx, counts)
    bank, bank_launches = phase_anomaly_bank(torch, split, dx, counts)
    launches["tolfl_round_update"] += bank_launches["tolfl_round_update"]
    _, _, ae_serve = phase_anomaly_serve(torch, bank, split)
    phase_score_path_turns(torch, bank, split)
    phase_anomaly_warm(torch, bank, split)
    phase_anomaly_profile(torch, bank, split)
    phase_anomaly_reference(torch, split, dx, counts)
    seq_bank, seq_serve, _ = phase_seq_anomaly(torch, split, dx, counts)
    launches["tolfl_round_update"] += seq_bank["tolfl_round_update"]
    for key in ("launches", "graph_launches"):
        launches[f"row_dense {key}"] = sum(
            serve[key]["row_dense"] for serve in (ae_serve, seq_serve))
    seq_errs = phase_seq_kernels(torch)
    seq = phase_seq_slice(torch, split, dx, counts)
    phase_seq_no_sync(torch, split, dx, counts)
    exp = phase_experiment(torch, split, dx, counts)
    phase_experiment_reference(torch, split, dx, counts)
    aot = phase_aot(torch, smi)
    phase_plancheck(torch, split, dx, counts)
    shard = phase_shard_campaign(torch, split, dx, counts)
    launches["tolfl_round_update"] += (seq["tolfl_round_update"]
                                       + exp["tolfl_round_update"]
                                       + aot["tolfl_round_update"]
                                       + shard["tolfl_round_update"])
    phase_examples(torch)
    train_errs = phase_train_kernels(torch)
    train_launches = phase_train(torch)
    for kernel, count in phase_train_bf16(torch).items():
        train_launches[kernel] += count
    families = phase_train_families(torch, parent)
    for kernel, count in families.items():
        train_launches[kernel] += count
    for kernel, count in phase_train_bf16_8b(torch).items():
        train_launches[kernel] += count
    train_run = phase_train_no_sync(torch)
    wkv_split = phase_train_profile(torch, *train_run)
    del train_run
    torch.cuda.empty_cache()
    train_reference = phase_train_reference(torch)
    for kernel, count in train_reference.items():
        train_launches[kernel] += count
    fa = _counters()["flash_attention"]
    # its float32 steps' forwards: the split-TF32 kernel's launches
    f32_launches = fa.LAUNCHES - fa.TC_LAUNCHES
    phase_train_ckpt(torch)
    phase_examples_train(torch)
    phase_mesh1_train(torch)
    kernels = phase_times(torch, launches, errs, parent)
    serve_launches = dict.fromkeys(SERVE_KERNELS, 0)
    arch_launches = {}
    for arch, tag in SERVE_ARCHS:
        with _clock(f"{tag}serve*"):
            cfg, params = _full_params(torch, arch, tag)
            arch_launches[arch] = phase_serve(torch, cfg, params, tag)
            for kernel, count in arch_launches[arch].items():
                serve_launches[kernel] += count
            if cfg.param_dtype == "float32":
                before = fa.LAUNCHES - fa.TC_LAUNCHES
                phase_serve_consistency(torch, cfg, params, tag)
                f32_launches += fa.LAUNCHES - fa.TC_LAUNCHES - before
            if arch in CONSISTENCY_BF16:
                phase_serve_consistency(torch, cfg, params, tag, "bfloat16")
            phase_serve_profile(torch, cfg, params, tag)
            del params      # the next arch's params need the room
            torch.cuda.empty_cache()
            phase_serve_reference(torch, arch, tag)
    phase_bf16_params(torch)
    torch.cuda.empty_cache()
    serve_launches["rglru_scan"] += (
        seq["rglru_scan"] + exp["rglru_scan"] + seq_bank["rglru_scan"]
        + seq_serve["launches"]["rglru_scan"] + aot["rglru_scan"]
        + shard["rglru_scan"])
    serve_launches["rglru_scan graph_launches"] = \
        seq_serve["graph_launches"]["rglru_scan"]
    serve_launches["rglru_scan_bwd"] = (seq["rglru_scan_bwd"]
                                        + exp["rglru_scan_bwd"]
                                        + seq_bank["rglru_scan_bwd"]
                                        + aot["rglru_scan_bwd"]
                                        + shard["rglru_scan_bwd"])
    serve_errs["rglru_scan"] = max(serve_errs["rglru_scan"],
                                   seq_errs["rglru_scan"])
    serve_errs["rglru_scan_bwd"] = seq_errs["rglru_scan_bwd"]
    serve_launches["flash_attention f32"] = f32_launches
    # the training path's launches join the forward kernels' and the
    # RG-LRU backward's counts
    for kernel in SERVE_KERNELS + ("rglru_scan_bwd",):
        serve_launches[kernel] += train_launches[kernel]
    # where the RG-LRU scan's launches in the kernels line come from
    by_phase = {
        "[serve]": sum(a["rglru_scan"] for a in arch_launches.values()),
        "[seq-anomaly-bank]": seq_bank, "[seq-anomaly-serve]":
        seq_serve["launches"], "[seq-slice]": seq, "[experiment]": exp,
        "[aot]": aot, "[shard-campaign]": shard, "[train-families]":
        families, "[train-reference]": train_reference}
    by_phase["[train]"] = {k: train_launches[k] - families[k]
                           - train_reference.get(k, 0)
                           for k in ("rglru_scan", "rglru_scan_bwd")}
    log("[launches] rglru_scan forward / backward by phase: " + ", ".join(
        f"{ph} " + (f"{v} / -" if isinstance(v, int) else
                    f"{v.get('rglru_scan', 0)} / {v.get('rglru_scan_bwd', 0)}")
        for ph, v in by_phase.items())
        + f"; total {serve_launches['rglru_scan']} / "
        f"{serve_launches['rglru_scan_bwd']}")
    kernels += phase_serve_times(torch, serve_launches, serve_errs,
                                 arch_launches, parent)
    kernels += phase_train_times(torch, train_launches, train_errs,
                                 wkv_split, parent)
    phase_dryrun(torch)
    log_clock(time.perf_counter() - t_start)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
