"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc`` into
``build/repro_torch/``, then:

1. prints the card's name and power limit and the build's compiler log;
2. holds every kernel against its plain PyTorch version on the card at
   the main path's shapes (bitwise equality);
3. drives the main path, the Tol-FL simulator (``run_simulation``), at
   the paper's full width and data scale: Comms-ML (12,000 x 112), 10
   devices in 5 clusters, the paper autoencoder (P = 49,680), 100 rounds
   with dropout; Tol-FL without failure, Tol-FL with a head failure and
   FL with a server failure.  Each kernel's launch counter is set to 0
   just before and read just after; every run must launch the combine
   kernel once per round.  The round loop also runs under PyTorch's sync
   debug mode, which raises on any host sync; a 10-round run under
   torch.profiler gives the device's busy share and the combine's share
   of it; small dropout-free runs on the card must agree with the same
   runs on the CPU (FL at lr 1e-3 up to the round where both diverge);
4. times each kernel, its plain version and one library call with CUDA
   events, beside the least time the card could take.

It imports nothing of JAX or of the JAX package.  It exits non-zero
without a CUDA device, outside a checkout, or if any phase fails; on
success its last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
COMBINE_SHAPES = [(5, 49_680), (1, 49_680), (10, 49_680), (5, 1_000_003)]
ROUNDS = 100
FAIL_EPOCH = 5         # head / server failure round of the failure runs
SAMPLES = 200          # CUDA-event timings per function
SPIN_CYCLES = 5_000_000   # ~2.5 ms of the card's clock: covers the host's
#                           dispatch of the slowest timed call (~1 ms)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
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
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s: {sorted(libs)}")
    for lib in sorted(libs):
        log(f"[build] {lib}: " + " | ".join(
            ln.strip() for ln in _build.build_log(lib).splitlines()
            if ln.strip()))
    return name, smi


def phase_kernels(torch):
    """Kernel vs plain version on the card; returns the max |diff|."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import tolfl_combine as tc
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(k, p, "random") for k, p in COMBINE_SHAPES]
    cases += [(5, 49_680, "all-zero"), (5, 49_680, "partial-zero")]
    worst = 0.0
    for k, p, counts in cases:
        gs = torch.randn((k, p), generator=gen, device="cuda")
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
        worst = max(worst, err)
    return worst


def _paper_split():
    from repro_torch.data import commsml, federated
    X, y = commsml.generate(seed=0)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    return split, dx, counts


def phase_slice(torch, split, dx, counts):
    """The main path at full width; returns the combine's launch count."""
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
    results = {}
    tc.LAUNCHES = 0
    for scheme, k, failure in runs:
        before = tc.LAUNCHES
        cfg = SimConfig(scheme=scheme, num_devices=10, num_clusters=k,
                        rounds=ROUNDS, lr=1e-3, dropout=True, seed=0)
        t0 = time.perf_counter()
        res = run_simulation(COMMSML, dx, counts, split.test_x,
                             split.test_y, cfg, failure)
        wall = time.perf_counter() - t0   # ends in a host copy: synchronised
        added = tc.LAUNCHES - before
        log(f"[slice] {scheme} k={k} failure={failure.kind}@"
            f"{failure.epoch if failure.kind != 'none' else '-'}: "
            f"auroc={res.final_auroc:.4f} used={res.auroc_used:.4f} "
            f"iso_active={res.iso_active} loss {res.loss_curve[0]:.3f} -> "
            f"{res.loss_curve[-1]:.3f}; {wall / ROUNDS * 1e3:.3f} ms/round; "
            f"tolfl_combine launches {added}")
        if added != ROUNDS:
            raise AssertionError(f"{scheme}: {added} combine launches, "
                                 f"expected {ROUNDS}")
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
    launches = tc.LAUNCHES
    if not results[("fl", "server")].iso_active:
        raise AssertionError("fl with a dead server did not fall back to "
                             "isolated training")
    auc = results[("tolfl", "none")].final_auroc
    if not auc > 0.7:
        raise AssertionError(f"tolfl without failure: AUROC {auc} <= 0.7")
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


def phase_profile(torch, split, dx, counts):
    """Where a Tol-FL round's time goes: device busy share and the
    combine kernel's share, from torch.profiler over a short run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.autoencoder_paper import COMMSML
    from repro_torch.core.simulate import SimConfig, run_simulation
    rounds = 10
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                    rounds=rounds, lr=1e-3, dropout=True, seed=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_simulation(COMMSML, dx, counts, split.test_x, split.test_y, cfg)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events)
    combine = sum(e.self_device_time_total for e in events
                  if "tolfl_combine" in e.key)
    if busy == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] tolfl {rounds} rounds under the profiler: wall "
        f"{wall_us / rounds / 1e3:.3f} ms/round, device busy "
        f"{busy / rounds / 1e3:.3f} ms/round ({busy / wall_us:.1%} of wall), "
        f"tolfl_combine {combine / rounds:.2f} us/round "
        f"({combine / busy:.2%} of device time); top device ops: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / rounds:.1f} us/round"
            for e in top))


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


def _median_ms(torch, fn, device_only):
    """Median over SAMPLES calls of the time between CUDA events recorded
    before and after one call of ``fn``.  With ``device_only`` a spin
    kernel keeps the card busy while the host enqueues the events and the
    call, so the events time the call's work on the card alone; without
    it they also time the host's dispatch of the call."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_times(torch, launches, max_abs_err):
    from repro_torch.kernels import tolfl_combine as tc
    k, p = COMBINE_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    gs = torch.randn((k, p), generator=gen, device="cuda")
    ns = torch.tensor([1125.0, 1125.0, 1125.0, 0.0, 0.0], device="cuda")
    fns = {"kernel": lambda: tc.tolfl_combine_cuda(gs, ns),
           "plain": lambda: tc.tolfl_combine_plain(gs, ns),
           "library (ns/ns.sum())@gs": lambda: (ns / ns.sum()) @ gs}
    dev_ms = {key: _median_ms(torch, fn, True) for key, fn in fns.items()}
    call_ms = {key: _median_ms(torch, fn, False) for key, fn in fns.items()}
    kernel_ms, plain_ms, library_ms = dev_ms.values()
    moved = (k * p + k + p) * 4          # each input read, output written
    flops = 3 * k * p + 3 * k            # 2 mul + 1 add per element per i
    bound_bytes = moved / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_F32_FLOPS * 1e3
    log(f"[times] tolfl_combine k={k} P={p}, median of {SAMPLES} CUDA-event "
        f"timings, on the card alone: " + ", ".join(
            f"{key} {v:.6f} ms" for key, v in dev_ms.items())
        + "; per call with the host's dispatch: " + ", ".join(
            f"{key} {v:.6f} ms" for key, v in call_ms.items())
        + f"; bound {max(bound_bytes, bound_ops):.6f} ms ({moved} bytes)")
    return [{
        "name": "tolfl_combine", "route": "cuda",
        "source": "src/repro_torch/csrc/tolfl_combine.cu",
        "replaces": "src/repro/kernels/tolfl_combine.py:44",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": library_ms,
    }]


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    max_abs_err = phase_kernels(torch)
    split, dx, counts = _paper_split()
    launches = phase_slice(torch, split, dx, counts)
    phase_no_sync(torch, split, dx, counts)
    phase_profile(torch, split, dx, counts)
    phase_reference(torch, split, dx, counts)
    kernels = phase_times(torch, launches, max_abs_err)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
