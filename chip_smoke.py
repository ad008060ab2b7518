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
   flash attention within 2e-4 in float32 (the CUDA-core kernel) and
   2e-2 in bfloat16 (the tensor-core kernel, also at the four dense
   decoders' prefill shapes), the RWKV6 WKV scan within 1e-4, and the
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
   the tensor-core attention once a layer (40, 24, 24, 36), a decode step
   no kernel;
6. times each kernel, its plain version and one library call with CUDA
   events, beside the least time the card could take; attention's two
   kernels, its plain version and SDPA in turns in one run; the WKV scan
   also at a decode step's shape; the fused round at S = 1 in turns with
   the unfused eager sequence (16 launches), beside an empty kernel's device
   time, and at the campaign's shapes (S = 64; S = 96 at k = 10) against
   its bound; the RG-LRU scan and its backward at SeqDetector's shape;
   the row-stable product at the service's products beside ``addmm``;
   the tensor-core attention at each dense decoder's prefill shape beside
   SDPA (causal, ``enable_gqa``).

    python3 chip_smoke.py --parent DIR

also builds the combine, RG-LRU and WKV kernels of another commit's
checkout in DIR (e.g. ``git archive`` of the parent, unpacked under the
ignored ``build/``) and times them in turns with the current ones; the
eager sequence then runs the parent's combine.  The build's
compiler log gives the registers and spill bytes of the tensor-core
attention kernel and of the two scans; any spill fails the run.

It imports nothing of JAX or of the JAX package.  It exits non-zero
without a CUDA device, outside a checkout, or if any phase fails; on
success its last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
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
               ("qwen1.5-0.5b", "qwen1.5-"), ("qwen3-8b", "qwen3-"))
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


def _decoder_attn(arch):
    """(B, S, H, KVH, D, causal, window) of a dense decoder's prefill
    attention at the served shape."""
    from repro_torch.configs.registry import get_arch
    a = get_arch(arch).attention
    return (SERVE_BATCH, SERVE_PROMPT, a.num_heads, a.num_kv_heads,
            a.head_dim, True, None)


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
                      ("rwkv6_scan", "WKV scan"),
                      ("rglru_scan", "RG-LRU scan"),
                      ("tolfl_combine", "Tol-FL aggregation"),
                      ("row_dense", "row-stable product")):
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
#: arguments (the same interfaces as the current ones): the symbol, its
#: pointers, its integers and, optionally, how many of those integers at
#: the end are ``long long``; the stream comes last
PARENT_KERNELS = {"rglru_scan": ("rglru_scan_f32", 4, 3),
                  "rwkv6_scan": ("rwkv6_scan_f32", 8, 4),
                  "tolfl_combine": ("tolfl_combine_f32", 3, 2, 1)}


def _start_parent_build(parent):
    """Start one nvcc for each of the parent's kernels (``parent`` holds a
    checkout, e.g. a git archive, of another commit), beside the build of
    the current ones, into ``build/parent/``.  A kernel whose source and
    headers are the same in both is not built: it has nothing to compare."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    old_csrc = Path(parent) / "src" / "repro_torch" / "csrc"

    def text(csrc, name):
        return b"".join(p.read_bytes() for p in [csrc / f"{name}.cu"]
                        + sorted(csrc.glob("*.cuh")))
    procs = {}
    for name in PARENT_KERNELS:
        if text(old_csrc, name) == text(_build.CSRC, name):
            log(f"[build] the parent's {name} is the current one: not timed "
                f"against it")
            continue
        src = old_csrc / f"{name}.cu"
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
        symbol, n_ptr, n_int, n_long = (PARENT_KERNELS[name] + (0,))[:4]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * (n_int - n_long)
                       + [ctypes.c_longlong] * n_long + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
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
            name = (re.sub(r"^\d+", "", args.group(1)) + "<"
                    + ", ".join(re.findall(r"Li(\d+)E", args.group(2)))
                    + ">" if args else
                    f"{flags.group(1)}<"
                    + ", ".join(re.findall(r"Lb([01])E", flags.group(2)))
                    + ">" if flags else fn)
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
    worst = {"flash_attention": 0.0, "rglru_scan": 0.0}
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
            del got, want
        del base, q, k, v
    for arch in DECODERS:
        B, S, H, KVH, D, causal, window = _decoder_attn(arch)
        q = torch.randn((B, S, H, D), generator=gen, device=DEV).bfloat16()
        k, v = (torch.randn((B, S, KVH, D), generator=gen,
                            device=DEV).bfloat16() for _ in range(2))
        tc_before = fa.TC_LAUNCHES
        got = ops.attention(q, k, v, causal=causal, window=window)
        if fa.TC_LAUNCHES - tc_before != 1:
            raise AssertionError(f"{arch}'s attention did not go to the "
                                 f"tensor-core kernel")
        want = fa.flash_attention_plain(q, k, v, causal, window).float()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        err = float(diff.max())
        rel = diff.amax(-1) / want.pow(2).mean(-1).sqrt()
        at = [int(i) for i in torch.unravel_index(rel.argmax(), rel.shape)]
        rel = float(rel.max())
        log(f"[kernel] flash_attention (B, S, H, KVH, D) = "
            f"{(B, S, H, KVH, D)} causal ({arch}) bfloat16 (tensor_core "
            f"kernel): max_abs_err={err}, at |out| up to "
            f"{float(want.abs().max()):.4f}; the largest |diff| of a row over "
            f"the row's RMS {rel:.6f} at (b, s, h) = {tuple(at)} (tolerance "
            f"{ATTN_ROW_TOL})")
        if not rel <= ATTN_ROW_TOL:
            raise AssertionError(f"{arch}'s attention: a row's |diff| reaches "
                                 f"{rel} of its RMS")
        worst[f"flash_attention {arch}"] = err
        del q, k, v, got, want, diff
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


def phase_score_kernels(torch):
    """The score path's row-stable product against its plain version at
    the 64-bucket's products of both detector bodies and at ragged
    shapes, within ``row_dense.error_bound``, and each row's bits alone
    equal to the batch's; returns the max |diff|."""
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
        torch.cuda.synchronize()
        log(f"[kernel] row_dense (M, K, N) = {(M, K, N)}: max_abs_err "
            f"{float(err.max())} (within error_bound: {ok}; |y| max "
            f"{float(want.abs().max())}); rows alone bitwise_equal={rows}")
        if not (ok and rows):
            raise AssertionError(f"row_dense at {(M, K, N)}: within bound "
                                 f"{ok}, rows alone equal {rows}")
        worst = max(worst, float(err.max()))
    return worst


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
    times = {key: [] for key in fns}
    for t in range(turns):
        for key in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            times[key] += _samples_ms(torch, fns[key], device_only,
                                      samples // turns)
    return {key: statistics.median(v) for key, v in times.items()}


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
    rows.append(_row_dense_times(torch, launches, errs))
    return rows


def _row_dense_times(torch, launches, errs):
    """The score path's row-stable product at the service's largest
    product (the autoencoder's first layer over a 64-bucket, (2,048, 112,
    128)) and at SeqDetector's (14,336, 16, 16): kernel, plain version
    (``x @ w + b``) and ``torch.addmm``, beside the bound."""
    from repro_torch.kernels import row_dense as rd
    gen = torch.Generator(device=DEV).manual_seed(10)
    row = None
    for key, (M, K, N) in (("ae", (64 * ANOMALY_WINDOW, 112, 128)),
                           ("seq", (64 * ANOMALY_WINDOW * 7, 16, 16))):
        x = torch.randn((M, K), generator=gen, device=DEV)
        w = torch.randn((K, N), generator=gen, device=DEV)
        b = torch.randn((N,), generator=gen, device=DEV)
        fns = {"kernel": lambda: rd.row_dense_cuda(x, w, b),
               "plain": lambda: rd.row_dense_plain(x, w, b),
               "library addmm": lambda: torch.addmm(b, x, w)}
        dev_ms = _turns_ms(torch, fns, True, SAMPLES)
        call_ms = _turns_ms(torch, fns, False, SAMPLES)
        _, _, by_name = _profiled(torch, fns["kernel"])
        prof_us = _event_us(by_name, "row_dense_kernel")
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
            + f"; the kernel's device duration under torch.profiler "
            f"{prof_us:.3f} us (32 calls); bound {bound:.6f} ms ({flops} "
            f"flops at 67 TFLOP/s float32; {moved} bytes take "
            f"{b_bytes:.6f} ms), {bound / ms:.1%} of it")
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
                "share_of_bound": bound / ms}
        else:
            row.update({f"{key}_ms": ms, f"{key}_plain_ms": dev_ms["plain"],
                        f"{key}_library_ms": dev_ms["library addmm"],
                        f"{key}_bound_ms": bound})
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
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=DEV).manual_seed(0),
                           cfg, DEV)
    torch.cuda.synchronize()
    log(f"[{tag}serve] {cfg.name}: {cfg.num_layers} layers "
        f"{''.join(k[0] for k in cfg.layer_pattern)}, d {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        f"{'' if cfg.tie_embeddings else ' (untied head)'}; params "
        f"{P.param_count(params)} ({P.param_bytes(params)} bytes, "
        f"{cfg.param_dtype}; analytic {cfg.param_count()}), activations "
        f"{cfg.dtype}; random init on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import rwkv6_scan as wk
    return {"flash_attention": fa, "rglru_scan": rs, "rwkv6_scan": wk}


def _reset_launches():
    for mod in _counters().values():
        mod.LAUNCHES = 0
    _counters()["flash_attention"].TC_LAUNCHES = 0


def _launches():
    return {name: mod.LAUNCHES for name, mod in _counters().items()}


def _expected_launches(cfg):
    """Each serving kernel's launches per prefill and per decode step:
    attention once per attention layer and the RG-LRU scan once per
    recurrent layer in a prefill only; the WKV scan once per RWKV6 layer
    in a prefill and in every decode step."""
    pat = cfg.layer_pattern
    n_rwkv = pat.count("rwkv")
    prefill = {"flash_attention": pat.count("attn") + pat.count("local"),
               "rglru_scan": pat.count("rec"), "rwkv6_scan": n_rwkv}
    step = {"flash_attention": 0, "rglru_scan": 0, "rwkv6_scan": n_rwkv}
    return prefill, step


def phase_serve(torch, cfg, params, tag):
    """A serving main path: prefill, pad_cache, greedy decode at full
    width and depth.  Returns each kernel's launches over the run."""
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    want_prefill, want_step = _expected_launches(cfg)
    gen = torch.Generator(device=DEV).manual_seed(1)
    # warm-up (cuBLAS handles and heuristics, the allocator), off the path
    prefill(params, cfg, synthetic_batch(cfg, 1, 256, gen, DEV))
    batch = synthetic_batch(cfg, SERVE_BATCH, SERVE_PROMPT, gen, DEV)
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
    tc = _counters()["flash_attention"].TC_LAUNCHES
    if tc != counts["flash_attention"]:
        raise AssertionError(f"{tc} of the prefill's "
                             f"{counts['flash_attention']} attention launches "
                             f"went to the tensor-core kernel")
    cache = pad_cache(cache, cfg, prompt_len=SERVE_PROMPT,
                      target_len=SERVE_PROMPT + SERVE_TOKENS)
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    out = [tok]
    steps = SERVE_TOKENS - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(steps):
            logits, cache = decode_step(params, cfg, tok, cache,
                                        SERVE_PROMPT + i)
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
    log(f"[{tag}serve] batch {SERVE_BATCH} x prompt {SERVE_PROMPT}, "
        f"{SERVE_TOKENS} greedy tokens: prefill {prefill_ms:.3f} ms "
        f"({SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3:.1f} tokens/s), "
        f"decode {decode_ms:.3f} ms/token over {steps} steps "
        f"(under sync debug mode 'error'); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes; launches per prefill "
        f"{counts} ({tc} attention launches on the tensor cores), per decode "
        f"step {want_step}, over the run {after}; all "
        f"logits finite; sample[0] {gen_toks[0, :12].tolist()}; clocks.sm, "
        f"power.draw, temperature after decode: {_clocks()}")
    return after


def phase_serve_consistency(torch, cfg, params, tag):
    """float32, batch 1: decode_step at position S against the last
    logits of a prefill over S + 1 tokens (tests/test_serving.py's 2e-3)."""
    import dataclasses
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    S = SERVE_PROMPT
    toks = synthetic_batch(cfg32, 1, S + 1,
                           torch.Generator(device=DEV).manual_seed(3),
                           DEV)["tokens"]
    want, _ = prefill(params, cfg32, {"tokens": toks})
    _, cache = prefill(params, cfg32, {"tokens": toks[:, :S]})
    cache = pad_cache(cache, cfg32, prompt_len=S, target_len=S + 1)
    got, _ = decode_step(params, cfg32, toks[:, S:], cache, S)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"[{tag}serve-consistency] float32, batch 1: decode_step "
        f"at position {S} vs prefill of {S + 1} tokens: max_abs_diff {err} "
        f"(max |logit| {float(want.abs().max())}; tolerance rtol = atol = "
        f"2e-3)")
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def phase_serve_profile(torch, cfg, params, tag):
    """One prefill and 8 decode steps, each under its own torch.profiler
    window: the device's busy share, its top kernels and each kernel's
    share."""
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    steps = 8
    batch = synthetic_batch(cfg, SERVE_BATCH, SERVE_PROMPT,
                            torch.Generator(device=DEV).manual_seed(4),
                            DEV)
    torch.cuda.synchronize()
    state = {}

    def run_prefill():
        state["logits"], cache = prefill(params, cfg, batch)
        state["cache"] = pad_cache(cache, cfg, SERVE_PROMPT,
                                   SERVE_PROMPT + steps)

    def run_decode():
        tok = torch.argmax(state["logits"][:, :cfg.vocab_size], dim=-1)
        tok = tok[:, None]
        for i in range(steps):
            logits, state["cache"] = decode_step(params, cfg, tok,
                                                 state["cache"],
                                                 SERVE_PROMPT + i)
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
        log(f"[{tag}serve-profile] {what} ({SERVE_BATCH} x {SERVE_PROMPT}"
            + (f", {steps} steps, per step" if per > 1 else "")
            + f") under the profiler: wall {wall / per / 1e3:.3f} ms, "
            f"device busy {busy / per / 1e3:.3f} ms ({busy / wall:.1%} of "
            f"wall); {shares}; top device events per "
            f"{'step' if per > 1 else 'prefill'}: "
            + _top(by_name, 10, per * 1e3, "ms"))


def phase_serve_reference(torch, arch, tag):
    """The reduced config on the card against the same calls on the CPU:
    a ragged prompt of 100 tokens (past RecurrentGemma's reduced window,
    so the ring roll runs), pad_cache, 3 decode steps, the same params on
    both."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    cfg = get_arch(arch).reduced()
    cpu = T.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    gpu = P.from_numpy_tree(P.to_numpy_tree(cpu), DEV)
    S, steps = 100, 3
    toks = torch.randint(0, cfg.vocab_size, (2, S + steps),
                         generator=torch.Generator().manual_seed(6))
    runs = {}
    for dev, params in ((DEV, gpu), ("cpu", cpu)):
        t = toks.to(dev)
        logits, cache = prefill(params, cfg, {"tokens": t[:, :S]})
        seq = [logits]
        cache = pad_cache(cache, cfg, S, S + steps)
        for i in range(S, S + steps):
            logits, cache = decode_step(params, cfg, t[:, i:i + 1], cache, i)
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
    log(f"[{tag}serve-reference] {cfg.name} (float32), prompt {S}"
        + (f" past the window {window}" if window else "")
        + f", {steps} decode steps: card vs CPU max_abs_diff {worst} over "
        f"the logits and every cache leaf (tolerance rtol = atol = 1e-4)")


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
           "CUDA-core kernel": lambda: fa.flash_attention_cuda(
               q, k, v, causal, window, kernel="cuda_core"),
           "plain": lambda: fa.flash_attention_plain(q, k, v, causal, window),
           "library sdpa": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=band, enable_gqa=True)}
    n = 20
    dev_ms = _turns_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    pairs = visible_pairs(S, causal, window)
    flops = 4 * B * H * D * pairs
    moved = (2 * B * S * H * D + 2 * B * S * KVH * D) * 2
    b_ops = flops / H100_BF16_FLOPS * 1e3
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    bound = max(b_ops, b_bytes)
    tc_ms = dev_ms["tensor-core kernel"]
    tiles = sum(count for _, count in fa.wgmma_tiles(S, S, H // KVH, causal,
                                                     window))
    tile_pairs = tiles * fa.TC_KEYS * fa.TC_ROWS * B * KVH
    log(f"[times] flash_attention bf16 (B, S, H, KVH, D) = "
        f"{(B, S, H, KVH, D)} window {window}, median of {n} CUDA-event "
        f"timings in 4 turns, card / call: " + ", ".join(
            f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms"
            for key in fns)
        + f"; bound {bound:.6f} ms ({flops} flops over "
        f"{pairs} visible pairs at 989 TFLOP/s; {moved} bytes take "
        f"{b_bytes:.6f} ms); tensor-core kernel {flops / tc_ms / 1e9:.1f} "
        f"TFLOP/s, {bound / tc_ms:.1%} of the bound, "
        f"{dev_ms['CUDA-core kernel'] / tc_ms:.2f}x faster than the CUDA-core "
        f"kernel and {dev_ms['library sdpa'] / tc_ms:.2f}x than SDPA; its "
        f"tiles hold {tile_pairs} (query, key) pairs of rows, "
        f"{tile_pairs / (B * H * pairs) - 1:.2%} more than visible; clocks.sm, "
        f"power.draw, temperature after: {_clocks()}")
    if not tc_ms < min(dev_ms["library sdpa"], dev_ms["CUDA-core kernel"]):
        raise AssertionError("the tensor-core kernel is not faster than SDPA "
                             "and the CUDA-core kernel")
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
    del q, k, v, qt, kt, vt, band, fns
    for arch in DECODERS:
        rows.append(_decoder_attn_times(torch, arch, arch_launches[arch],
                                        errs, gen))

    B, S, W, _ = SCAN_CASES[0]
    a = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=DEV))
    b = torch.randn((B, S, W), generator=gen, device=DEV)
    fns = {"kernel": lambda: rs.rglru_scan_cuda(a, b)}
    if parent and "rglru_scan" in parent:
        fns["parent kernel"] = lambda: _parent_rglru(torch, parent, a, b)
        if not torch.equal(fns["kernel"](), fns["parent kernel"]()):
            raise AssertionError("rglru_scan differs from the parent's kernel")
    n = 48
    dev_ms = _turns_ms(torch, fns, True, n)
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
    if "parent kernel" in fns:
        _faster_than_parent(rows[-1], dev_ms["parent kernel"])
    del a, b, fns
    rows += _seq_scan_times(torch, rows[-1], launches, errs, gen)

    for B, S, H, N, _, _ in (wk.CARD_CASES[0], WKV_DECODE):
        args = wk.random_inputs(B, S, H, N, True, gen)
        fns = {"kernel": lambda: wk.rwkv6_scan_cuda(*args)}
        if parent and "rwkv6_scan" in parent:
            fns["parent kernel"] = lambda: _parent_wkv(torch, parent, *args)
            for got, want in zip(fns["kernel"](), fns["parent kernel"]()):
                torch.testing.assert_close(got, want, rtol=WKV_TOL,
                                           atol=WKV_TOL)
        n = 48 if S > 1 else 200
        dev_ms = _turns_ms(torch, fns, True, n)
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
            _faster_than_parent(rows[-1], dev_ms["parent kernel"])
        del args, fns
    return rows


def _decoder_attn_times(torch, arch, launches, errs, gen):
    """The tensor-core attention at a dense decoder's prefill shape
    (causal, no window) beside SDPA (``is_causal``, ``enable_gqa``), the
    plain version and the bound.  A shape where the kernel loses to SDPA
    is logged as such: it stays on the kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, H, KVH, D, causal, window = _decoder_attn(arch)
    q = torch.randn((B, S, H, D), generator=gen, device=DEV).bfloat16()
    k = torch.randn((B, S, KVH, D), generator=gen, device=DEV).bfloat16()
    v = torch.randn((B, S, KVH, D), generator=gen, device=DEV).bfloat16()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"tensor-core kernel": lambda: fa.flash_attention_cuda(
               q, k, v, causal, window),
           "library sdpa": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)}
    n = 20
    dev_ms = _turns_ms(torch, fns, True, n)
    call_ms = _turns_ms(torch, fns, False, n)
    plain_ms = _median_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal, window), True, 3)
    pairs = visible_pairs(S, causal, window)
    flops = 4 * B * H * D * pairs
    moved = (2 * B * S * H * D + 2 * B * S * KVH * D) * 2
    b_ops = flops / H100_BF16_FLOPS * 1e3
    b_bytes = moved / H100_BYTES_PER_S * 1e3
    bound = max(b_ops, b_bytes)
    tc_ms = dev_ms["tensor-core kernel"]
    sdpa = dev_ms["library sdpa"]
    log(f"[times] flash_attention bf16 (B, S, H, KVH, D) = "
        f"{(B, S, H, KVH, D)} causal ({arch}'s prefill), median of {n} "
        f"CUDA-event timings in 4 turns, card / call: " + ", ".join(
            f"{key} {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms"
            for key in fns)
        + f"; plain {plain_ms:.6f} ms (median of 3); bound {bound:.6f} ms "
        f"({flops} flops over {pairs} visible pairs at 989 TFLOP/s; {moved} "
        f"bytes take {b_bytes:.6f} ms); tensor-core kernel "
        f"{flops / tc_ms / 1e9:.1f} TFLOP/s, {bound / tc_ms:.1%} of the "
        f"bound, {sdpa / tc_ms:.2f}x SDPA's speed"
        + ("" if tc_ms < sdpa else " (LOSES to SDPA)")
        + f"; clocks.sm, power.draw, temperature after: {_clocks()}")
    return {
        "name": "flash_attention", "arch": arch, "route": "cuda",
        "shape": [B, S, H, KVH, D],
        "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:90",
        "launches": launches["flash_attention"],
        "max_abs_err": errs[f"flash_attention {arch}"],
        "ms": tc_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations" if b_ops >= b_bytes else "bytes",
        "library_ms": sdpa, "call_ms": call_ms["tensor-core kernel"],
        "tflops": flops / tc_ms / 1e9, "share_of_bound": bound / tc_ms}


def _seq_scan_times(torch, fwd_row, launches, errs, gen):
    """The scan forward and backward at SeqDetector's campaign shape
    (720,000, 7, 16), each beside its plain version and its bound; the
    forward's numbers join its row, the backward gets its own."""
    from repro_torch.kernels import rglru_scan as rs
    B, S, W = SEQ_SCAN
    a = torch.sigmoid(torch.randn(SEQ_SCAN, generator=gen, device=DEV))
    b = torch.randn(SEQ_SCAN, generator=gen, device=DEV)
    dh = torch.randn(SEQ_SCAN, generator=gen, device=DEV)
    h = rs.rglru_scan_cuda(a, b)
    fns = {"forward": lambda: rs.rglru_scan_cuda(a, b),
           "backward": lambda: rs.rglru_scan_bwd_cuda(a, h, None, dh)}
    n = 48
    dev_ms = _turns_ms(torch, fns, True, n)
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
        log(f"[times] rglru_scan {key} (B, S, W) = {SEQ_SCAN} (SeqDetector, "
            f"64 scenarios), median of {n} CUDA-event timings in 4 turns, "
            f"card / call: {dev_ms[key]:.6f} / {call_ms[key]:.6f} ms; plain "
            f"{plain[key]:.6f} ms (median of 10, its {S} steps dispatched by "
            f"the host), library none; bound {bound[key][0]:.6f} ms "
            f"({tensors * B * S * W * 4} bytes at 3.35 TB/s), "
            f"{bound[key][0] / dev_ms[key]:.1%} of it; clocks.sm, power.draw, "
            f"temperature after: {_clocks()}")
    fwd_row.update({"seq_ms": dev_ms["forward"],
                    "seq_bound_ms": bound["forward"][0],
                    "seq_plain_ms": plain["forward"],
                    "seq_share_of_bound": bound["forward"][0]
                    / dev_ms["forward"]})
    return [{
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


def _faster_than_parent(row, parent_ms):
    """Record the parent's time of a kernel row; the kernel must beat it."""
    row["parent_ms"] = parent_ms
    if not row["ms"] < parent_ms:
        raise AssertionError(f"{row['name']}: {row['ms']} ms on the card, not "
                             f"faster than the parent's {parent_ms} ms")


def _parent_rglru(torch, parent, a, b):
    """The parent's RG-LRU kernel on a, b (no h0)."""
    out = torch.empty_like(a)
    err = parent["rglru_scan"](a.data_ptr(), b.data_ptr(), None,
                               out.data_ptr(), *a.shape,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's rglru_scan failed: {err}")
    return out


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


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None, help=(
        "a checkout (e.g. a git archive) of another commit: its combine, "
        "RG-LRU and WKV kernels are built too and timed in turns with the "
        "current ones in [times]"))
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
    errs["row_dense"] = phase_score_kernels(torch)
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
    launches["tolfl_round_update"] += (seq["tolfl_round_update"]
                                       + exp["tolfl_round_update"]
                                       + aot["tolfl_round_update"])
    phase_examples(torch)
    kernels = phase_times(torch, launches, errs, parent)
    serve_launches = dict.fromkeys(SERVE_KERNELS, 0)
    arch_launches = {}
    for arch, tag in SERVE_ARCHS:
        cfg, params = _full_params(torch, arch, tag)
        arch_launches[arch] = phase_serve(torch, cfg, params, tag)
        for kernel, count in arch_launches[arch].items():
            serve_launches[kernel] += count
        phase_serve_consistency(torch, cfg, params, tag)
        phase_serve_profile(torch, cfg, params, tag)
        del params      # the next arch's params need the room
        torch.cuda.empty_cache()
        phase_serve_reference(torch, arch, tag)
    serve_launches["rglru_scan"] += (
        seq["rglru_scan"] + exp["rglru_scan"] + seq_bank["rglru_scan"]
        + seq_serve["launches"]["rglru_scan"] + aot["rglru_scan"])
    serve_launches["rglru_scan graph_launches"] = \
        seq_serve["graph_launches"]["rglru_scan"]
    serve_launches["rglru_scan_bwd"] = (seq["rglru_scan_bwd"]
                                        + exp["rglru_scan_bwd"]
                                        + seq_bank["rglru_scan_bwd"]
                                        + aot["rglru_scan_bwd"])
    serve_errs["rglru_scan"] = max(serve_errs["rglru_scan"],
                                   seq_errs["rglru_scan"])
    serve_errs["rglru_scan_bwd"] = seq_errs["rglru_scan_bwd"]
    kernels += phase_serve_times(torch, serve_launches, serve_errs,
                                 arch_launches, parent)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
