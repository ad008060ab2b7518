"""Tests that need an NVIDIA card: the hand-written CUDA kernels against
their plain PyTorch versions, on the card.

This file imports neither jax nor ``repro``, so it also runs where only
PyTorch is installed.  Without a card every test skips.  On a machine
with one, from the root of the repository:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import functools

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as wk
from repro_torch.kernels import tolfl_combine as tc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,p,zeros", [(5, 49_680, []), (1, 49_680, []),
                                       (10, 49_680, []), (5, 1_000_003, []),
                                       (5, 49_680, [0, 1, 2, 3, 4]),
                                       (5, 49_680, [3, 4]), (5, 49_681, []),
                                       (17, 1_003, [16]), (40, 4_096, [])])
def test_tolfl_combine_cuda_kernel_bitwise(cuda_device, k, p, zeros):
    """On the card the hand-written kernel equals its plain version bit
    for bit (rounded intrinsics, IEEE division, no FMA contraction)."""
    g = torch.Generator(device=cuda_device).manual_seed(k + p)
    gs = torch.randn((k, p), generator=g, device=cuda_device)
    ns = torch.rand((k,), generator=g, device=cuda_device) * 50
    ns[zeros] = 0.0
    before = tc.LAUNCHES
    got = ops.tolfl_combine(gs, ns)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == before + 1
    assert torch.equal(got, tc.tolfl_combine_plain(gs, ns))


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(5, 49_680), (3, 4_097), (20, 1_000)])
def test_tolfl_combine_cuda_kernel_misaligned(cuda_device, k, p):
    """Rows that do not start on a 16-byte boundary take the scalar
    loads, still bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(k)
    buf = torch.randn((k * p + 1,), generator=g, device=cuda_device)
    gs = buf[1:].view(k, p)
    ns = torch.rand((k,), generator=g, device=cuda_device) * 50
    got = tc.tolfl_combine_cuda(gs, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, tc.tolfl_combine_plain(gs, ns))


@pytest.mark.cuda
@pytest.mark.parametrize("case", tc.ROUND_CARD_CASES, ids=lambda c: c.name)
def test_tolfl_round_update_cuda_kernel_bitwise(cuda_device, case):
    """The fused round kernel equals its plain version bit for bit: the
    paper's round and its edges, more than 16 devices, ragged and
    misaligned columns, 64 scenarios."""
    g = torch.Generator(device=cuda_device).manual_seed(case.P + case.N)
    args = tc.round_inputs(case, g)
    before = tc.ROUND_LAUNCHES, tc.LAUNCHES
    new, n_tot = ops.tolfl_round_update(*args, 1e-3, case.k)
    torch.cuda.synchronize()
    assert (tc.ROUND_LAUNCHES, tc.LAUNCHES) == (before[0] + 1, before[1])
    want, want_tot = tc.tolfl_round_update_plain(*args, 1e-3, case.k)
    assert torch.equal(new, want)
    assert torch.equal(n_tot, want_tot)
    if case.counts == "zero":
        assert torch.equal(new, args[-1])     # the params come back as they were


@pytest.mark.cuda
@pytest.mark.parametrize("combine,fused", [("streaming", 5), ("direct", 0)])
def test_round_loop_launches(cuda_device, combine, fused):
    """A 5-round Tol-FL run aggregates through the fused kernel once a
    round and never through the standalone combine; a direct run through
    neither."""
    from repro_torch.configs.autoencoder_paper import AutoencoderConfig
    from repro_torch.core.simulate import SimConfig, run_simulation
    from repro_torch.data import commsml, federated
    X, y = commsml.generate(seed=0, samples_per_class=200)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                    rounds=5, dropout=False, combine=combine)
    before = tc.ROUND_LAUNCHES, tc.LAUNCHES
    res = run_simulation(AutoencoderConfig(input_dim=112, hidden=(32, 16),
                                           code_dim=8), dx, counts,
                         split.test_x, split.test_y, cfg)
    assert (tc.ROUND_LAUNCHES - before[0], tc.LAUNCHES - before[1]) == (
        fused, 0)
    assert res.loss_curve[-1] < res.loss_curve[0]



def _small_campaign_inputs():
    """A small Tol-FL / FL campaign: the conftest-size Comms-ML split, the
    tiny autoencoder, sampled traces and a head failure, 3 seeds."""
    import numpy as np

    from repro_torch.configs.autoencoder_paper import AutoencoderConfig
    from repro_torch.core import failure as F
    from repro_torch.core.topology import Topology
    from repro_torch.data import commsml, federated
    X, y = commsml.generate(seed=0, samples_per_class=200)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    traces = F.sample_traces(np.random.default_rng(0), Topology(10, 5), 0.3,
                             max_events=8, rounds=6, num_traces=4,
                             device="cpu")
    traces.append(F.FailureSpec(2, "server"))
    ae = AutoencoderConfig(input_dim=112, hidden=(32, 16), code_dim=8)
    return ae, dx, counts, split.test_x, split.test_y, traces, [0, 1, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,k,chunk", [("tolfl", 5, None),
                                            ("tolfl", 5, 4), ("fl", 1, 7)])
def test_campaign_on_card_launches_and_matches_cpu(cuda_device, scheme, k,
                                                   chunk):
    """A dropout-free campaign on the card launches the fused kernel once
    a round per chunk, for every scenario of the chunk, never the
    standalone combine, and agrees with the same campaign on the CPU
    within rtol 1e-4 (float32 sums in other orders on the card)."""
    import numpy as np

    from repro_torch.core.campaign import ExecPlan, run_campaign
    from repro_torch.core.simulate import SimConfig
    ae, dx, counts, tx, ty, traces, seeds = _small_campaign_inputs()
    cfg = SimConfig(scheme=scheme, num_devices=10, num_clusters=k, rounds=6,
                    lr=5e-4, dropout=False)
    plan = ExecPlan(chunk_size=chunk)
    B = len(traces) * len(seeds)
    chunks = 1 if chunk is None else -(-B // chunk)
    before = tc.ROUND_LAUNCHES, tc.LAUNCHES
    gpu = run_campaign(ae, dx, counts, tx, ty, cfg, traces, seeds,
                       exec_plan=plan)
    assert (tc.ROUND_LAUNCHES - before[0], tc.LAUNCHES - before[1]) == (
        cfg.rounds * chunks, 0)
    cpu = run_campaign(ae, dx, counts, tx, ty, cfg, traces, seeds,
                       exec_plan=plan, device="cpu")
    np.testing.assert_array_equal(gpu.iso_active, cpu.iso_active)
    np.testing.assert_allclose(gpu.loss_curves, cpu.loss_curves, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gpu.auroc_used, cpu.auroc_used, rtol=0,
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,k", [("tolfl", 5), ("fl", 1)])
def test_campaign_round_loop_never_syncs(cuda_device, scheme, k,
                                         monkeypatch):
    """The S > 1 round loop under the sync debug mode, which raises on
    any call that makes the host wait for the card."""
    from repro_torch.core import simulate
    from repro_torch.core.campaign import run_campaign
    ae, dx, counts, tx, ty, traces, seeds = _small_campaign_inputs()
    loop = simulate._round_loop

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(simulate, "_round_loop", guarded)
    cfg = simulate.SimConfig(scheme=scheme, num_devices=10, num_clusters=k,
                             rounds=4)
    res = run_campaign(ae, dx, counts, tx, ty, cfg, traces, seeds)
    assert res.num_scenarios == len(traces) * len(seeds)

@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["fedgroup", "ifca", "fesem"])
def test_multimodel_campaign_on_card_matches_cpu(cuda_device, scheme):
    """A dropout-free multi-model campaign (cells of M = 3 and M = 2 fused,
    padded to 3) on the card launches no ported kernel and agrees with the
    same campaign on the CPU: loss curves within rtol 1e-4, AUROCs within
    1e-3, assignments equal."""
    import dataclasses

    import numpy as np

    from repro_torch.core.baselines import MultiModelConfig
    from repro_torch.core.campaign import run_fused_multimodel_campaigns
    ae, dx, counts, tx, ty, traces, seeds = _small_campaign_inputs()
    cfg = MultiModelConfig(scheme=scheme, num_devices=10, num_models=3,
                           rounds=6, lr=5e-4, dropout=False)
    cells = [(cfg, traces), (dataclasses.replace(cfg, num_models=2), traces)]
    before = tc.ROUND_LAUNCHES, tc.LAUNCHES
    gpu = run_fused_multimodel_campaigns(ae, dx, counts, tx, ty, cells, seeds)
    assert (tc.ROUND_LAUNCHES, tc.LAUNCHES) == before
    cpu = run_fused_multimodel_campaigns(ae, dx, counts, tx, ty, cells, seeds,
                                         device="cpu")
    for g, c in zip(gpu, cpu):
        np.testing.assert_array_equal(g.assignments, c.assignments)
        np.testing.assert_allclose(g.loss_curves, c.loss_curves, rtol=1e-4,
                                   atol=1e-5)
        for f in ("best_auroc", "multi_auroc"):
            np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=0,
                                       atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["fedgroup", "ifca", "fesem"])
def test_multimodel_round_loop_never_syncs(cuda_device, scheme, monkeypatch):
    """The multi-model round loop, dropout on, under the sync debug mode,
    which raises on any call that makes the host wait for the card."""
    from repro_torch.core import baselines
    from repro_torch.core.campaign import run_multimodel_campaign
    ae, dx, counts, tx, ty, traces, seeds = _small_campaign_inputs()
    loop = baselines._multimodel_loop

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(baselines, "_multimodel_loop", guarded)
    cfg = baselines.MultiModelConfig(scheme=scheme, num_devices=10,
                                     num_models=3, rounds=4, lr=1e-3)
    res = run_multimodel_campaign(ae, dx, counts, tx, ty, cfg, traces, seeds)
    assert res.num_scenarios == len(traces) * len(seeds)


# ---------------------------------------------------------------------------
# the anomaly-scoring service: one CUDA graph a bucket
# ---------------------------------------------------------------------------
ANOMALY_WINDOW = 16


@functools.lru_cache(maxsize=2)
def _card_bank(seed):
    """A small bank trained on the card (tiny autoencoder, 2 rounds, the
    fused kernel once a round a run) and a pool of (16, 112) windows."""
    import numpy as np

    from repro_torch.configs.autoencoder_paper import AutoencoderConfig
    from repro_torch.core.simulate import SimConfig
    from repro_torch.data import commsml, federated
    from repro_torch.serving.anomaly import train_model_bank
    X, y = commsml.generate(seed=0, samples_per_class=200)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                    rounds=2, lr=1e-3, dropout=False, seed=seed)
    before = tc.ROUND_LAUNCHES
    bank = train_model_bank(AutoencoderConfig(input_dim=112, hidden=(32, 16),
                                              code_dim=8), dx, counts, cfg)
    assert tc.ROUND_LAUNCHES - before == 2 * cfg.rounds
    tx = np.asarray(split.test_x, np.float32)
    n = tx.shape[0] // ANOMALY_WINDOW
    return bank, tx[:n * ANOMALY_WINDOW].reshape(n, ANOMALY_WINDOW, -1)


@functools.lru_cache(maxsize=1)
def _card_seq_bank():
    """A small ``SeqDetector`` bank trained on the card (2 rounds at lr
    1e-4: the scan forward and backward, the fused round kernel) and the
    same pool of (16, 112) windows."""
    from repro_torch.core.simulate import SimConfig
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.models.detector import SeqDetector
    from repro_torch.serving.anomaly import train_model_bank
    _, wins = _card_bank(0)
    dx, counts = _seq_inputs(200)[1:3]
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                    rounds=2, lr=1e-4, dropout=False, seed=0)
    before = (tc.ROUND_LAUNCHES, rs.LAUNCHES, rs.BWD_LAUNCHES)
    bank = train_model_bank(SeqDetector(), dx, counts, cfg)
    assert (tc.ROUND_LAUNCHES - before[0], rs.BWD_LAUNCHES - before[2]) \
        == (2 * cfg.rounds, 2 * cfg.rounds)
    assert rs.LAUNCHES - before[1] >= 2 * cfg.rounds
    return bank, wins


def _direct(bank, params, x):
    """Direct scoring of one model at the batch shape of ``x`` (B, W, D),
    through the score path's row-stable products."""
    from repro_torch.serving.anomaly import engine
    return engine.score_windows(bank.detector, params, x)


def _bank(kind):
    return _card_bank(0) if kind == "ae" else _card_seq_bank()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bias", [
    (2048, 112, 128, True), (2048, 128, 64, True), (2048, 32, 64, True),
    (2048, 128, 112, True), (14_336, 16, 16, True), (14_336, 16, 16, False),
    (32, 112, 128, True), (7, 5, 33, True), (1, 1, 1, False),
    (100_003, 16, 8, True)])
def test_row_dense_cuda_kernel(cuda_device, M, K, N, bias):
    """The row-stable product against its plain version within
    ``error_bound`` (two float32 summation orders), and every row the
    same bits alone as inside the batch."""
    from repro_torch.kernels import row_dense as rd
    g = torch.Generator(device=cuda_device).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda_device) * 3
    w = torch.randn((K, N), generator=g, device=cuda_device)
    b = torch.randn((N,), generator=g, device=cuda_device) if bias else None
    before = rd.LAUNCHES
    got = rd.row_dense(x, w, b)
    torch.cuda.synchronize()
    assert rd.LAUNCHES == before + 1 and got.shape == (M, N)
    err = (got.double() - rd.row_dense_plain(x, w, b).double()).abs()
    assert bool((err <= rd.error_bound(x, w, b)).all()), float(err.max())
    for i in sorted({0, M // 2, M - 1}):
        assert torch.equal(rd.row_dense(x[i:i + 1], w, b)[0], got[i])
    assert torch.equal(rd.row_dense(x[:M // 3 + 1], w, b), got[:M // 3 + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ae", "seq"])
def test_anomaly_scores_bitwise_across_buckets(cuda_device, kind):
    """A window's scores are the same bits alone (bucket 1), at the head
    of a padded 8-bucket and inside a full 64-bucket, against rows 0 and
    1 (``repro``'s padded-equals-exact contract, on the card)."""
    import numpy as np

    from repro_torch.serving.anomaly import engine
    bank, wins = _bank(kind)
    x = torch.from_numpy(wins[np.arange(64) % len(wins)]).to(cuda_device)
    x *= 1.0 + 0.5 * (torch.arange(64, device=cuda_device)
                      // len(wins))[:, None, None]     # 64 distinct windows
    entries = {bs: engine.score_entry(bank.detector, bank.row_params,
                                      (bs, ANOMALY_WINDOW, bank.input_dim)
                                      )[0] for bs in (1, 8, 64)}
    for row in (0, 1):
        for e in entries.values():
            e.row.fill_(row)
        entries[64].x.copy_(x)
        entries[64].replay()
        full = entries[64].out.clone()
        for i in range(0, 64, 9):
            entries[1].x.copy_(x[i:i + 1])
            entries[1].replay()
            entries[8].x.zero_()
            entries[8].x[0].copy_(x[i])
            entries[8].replay()
            assert torch.equal(entries[1].out[0], full[i]), (row, i)
            assert torch.equal(entries[8].out[0], full[i]), (row, i)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [1, 8, 64])
def test_seq_bucket_graph_equals_eager_core(cuda_device, bs):
    """A Seq bucket's CUDA graph, which holds the scan kernel, replays
    the eager core bit for bit."""
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.serving.anomaly import engine
    bank, _ = _card_seq_bank()
    before = rs.LAUNCHES
    entry, source = engine.score_entry(bank.detector, bank.row_params,
                                       (bs, ANOMALY_WINDOW, bank.input_dim))
    assert entry.graph is not None
    if source == "capture":            # two warm-ups and the capture
        assert rs.LAUNCHES - before == 3
    core = engine.score_core(bank.detector)
    g = torch.Generator(device=cuda_device).manual_seed(bs)
    for row in (0, 1, bank.num_clients):
        entry.x.copy_(torch.randn(entry.x.shape, generator=g,
                                  device=cuda_device) * 50)
        entry.row.fill_(row)
        entry.replay()
        want = core(bank.row_params,
                    torch.tensor([row], device=cuda_device), entry.x)
        torch.cuda.synchronize()
        assert torch.equal(entry.out, want), row


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [1, 8, 64])
def test_anomaly_bucket_graph_equals_eager_core(cuda_device, bs):
    """Each bucket's graph replay equals the eager core on the same
    inputs bit for bit, for the global row, the first isolated row and
    the last."""
    from repro_torch.serving.anomaly import engine
    bank, _ = _card_bank(0)
    entry, _ = engine.score_entry(bank.detector, bank.row_params,
                                  (bs, ANOMALY_WINDOW, bank.input_dim))
    assert entry.graph is not None
    core = engine.score_core(bank.detector)
    g = torch.Generator(device=cuda_device).manual_seed(bs)
    for row in (0, 1, bank.num_clients):
        entry.x.copy_(torch.randn(entry.x.shape, generator=g,
                                  device=cuda_device) * 50)
        entry.row.fill_(row)
        entry.replay()
        want = core(bank.row_params,
                    torch.tensor([row], device=cuda_device), entry.x)
        torch.cuda.synchronize()
        assert torch.equal(entry.out, want), row


@pytest.mark.cuda
def test_anomaly_failover_bitwise_on_card(cuda_device):
    """A window served by its isolated model while its head is dead
    equals the isolated model scoring the same padded bucket directly;
    a head-served one, the global model."""
    import numpy as np

    from repro_torch.core.processes import trace_from_rows
    from repro_torch.serving.anomaly import AnomalyService, ServiceConfig
    bank, wins = _card_bank(0)
    svc = AnomalyService(bank, ServiceConfig(bucket_sizes=(1, 8, 64),
                                             window=ANOMALY_WINDOW),
                         failure=trace_from_rows([(0, 0, 0.0, 2)], 4,
                                                 device="cpu"))
    svc.submit(1, wins[0])            # cluster 0, head dead: isolated
    svc.submit(1, wins[1])
    svc.submit(7, wins[2])            # cluster 3: head
    res = svc.tick()
    assert [r.served_by for r in res] == ["isolated", "isolated", "head"]
    for members, params, got in (
            ((0, 1), bank.client_iso_params(1), res[:2]),
            ((2,), bank.global_params, res[2:])):
        x = torch.zeros((8 if len(members) > 1 else 1, ANOMALY_WINDOW,
                         bank.input_dim), device=cuda_device)
        x[:len(members)] = torch.from_numpy(wins[list(members)]).to(
            cuda_device)
        want = _direct(bank, params, x)[:len(members)].cpu().numpy()
        np.testing.assert_array_equal(np.stack([r.scores for r in got]),
                                      want)


@pytest.mark.cuda
def test_anomaly_warm_service_captures_nothing(cuda_device):
    """Once its buckets are captured, serving every bucket and a failover
    captures no graph and leaves the allocated memory as it was; a second
    service over the same bank resolves every bucket from memory."""
    from repro_torch.core.processes import trace_from_rows
    from repro_torch.serving.anomaly import (AnomalyService, ServiceConfig,
                                             engine)
    bank, wins = _card_bank(0)
    cfg = ServiceConfig(bucket_sizes=(1, 8, 64), window=ANOMALY_WINDOW)
    svc = AnomalyService(bank, cfg, failure=trace_from_rows(
        [(2, 0, 0.0, 2)], 4, device="cpu"))
    svc.submit(0, wins[0])
    svc.tick()
    torch.cuda.synchronize()
    captures, mem = engine.CAPTURES, torch.cuda.memory_allocated()
    for t, n in enumerate((1, 5, 64, 70)):
        for j in range(n):
            svc.submit(j % 10, wins[(t + j) % len(wins)])
        svc.tick()
    torch.cuda.synchronize()
    rep = svc.report()
    assert rep.failovers > 0 and rep.dropped == 0
    assert all(rep.bucket_batches[b] > 0 for b in (1, 8, 64))
    assert engine.CAPTURES == captures
    assert torch.cuda.memory_allocated() == mem
    again = AnomalyService(bank, cfg)
    assert again.compile_sources == {1: "memory", 8: "memory", 64: "memory"}
    assert engine.CAPTURES == captures


@pytest.mark.cuda
def test_anomaly_second_bank_gets_its_own_graphs(cuda_device):
    """A graph reads its bank's tensors at the captured addresses: a
    second bank of the same shapes captures its own graphs and scores
    with its own weights."""
    import numpy as np

    from repro_torch.serving.anomaly import AnomalyService, ServiceConfig
    cfg = ServiceConfig(bucket_sizes=(1, 8), window=ANOMALY_WINDOW)
    scores = []
    for seed in (0, 1):
        bank, wins = _card_bank(seed)
        svc = AnomalyService(bank, cfg)
        if seed == 1:
            assert set(svc.compile_sources.values()) == {"capture"}
        svc.submit(3, wins[4])
        (res,) = svc.tick()
        x = torch.from_numpy(wins[4:5]).to(cuda_device)
        np.testing.assert_array_equal(
            res.scores, _direct(bank, bank.global_params, x)[0].cpu().numpy())
        scores.append(res.scores)
    assert not np.array_equal(scores[0], scores[1])


# ---------------------------------------------------------------------------
# flash attention: within 2e-4 of the plain version in float32 and 2e-2 in
# bfloat16 (the tolerances of tests/test_kernels.py): the kernels sum the
# same products in another order, and the tensor-core kernel rounds p to
# bf16 before its second product.  float32 (and bf16 at D = 32) runs on the
# CUDA-core kernel, bf16 at D >= 64 on the tensor-core kernel
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # (B, S, H, KVH, D, causal, window)
    (1, 128, 4, 2, 64, True, None),
    (2, 200, 16, 1, 256, True, 64),           # ragged S, window < S
    (1, 130, 8, 8, 32, False, None),          # bidirectional, MHA
    (1, 97, 4, 1, 128, True, 1),              # window 1: only the diagonal
    (4, 4096, 16, 1, 256, True, 2048),        # the serving prefill
    (1, 4097, 16, 1, 256, True, 2048),        # its ragged consistency run
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,D,causal,window", ATTN_CASES)
def test_flash_attention_cuda_kernel(cuda_device, dtype, B, S, H, KVH, D,
                                     causal, window):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda_device).manual_seed(S + D)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    before, tc_before = fa.LAUNCHES, fa.TC_LAUNCHES
    got = ops.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tc = fa.route(dtype, D) == "tensor_core"
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before + 1, tc_before + tc)
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the tensor-core kernel (bfloat16, D in {64, 128, 256}): within 2e-2 of the
# plain version, every launch counted in TC_LAUNCHES
# ---------------------------------------------------------------------------
TC_CASES = [
    # (B, Sq, Sk, H, KVH, D, causal, window)
    (1, 128, 128, 4, 4, 64, True, None),      # G = 1
    (2, 200, 200, 4, 2, 128, True, 64),       # G = 2, ragged S, window < S
    (1, 97, 97, 10, 2, 64, True, 1),          # G = 5, window 1
    (2, 200, 200, 16, 1, 256, True, 64),      # G = 16
    (1, 333, 333, 8, 2, 128, True, 100),      # G = 4
    (1, 130, 130, 8, 8, 128, False, None),    # bidirectional
    (2, 97, 200, 12, 2, 256, False, 50),      # Sq < Sk, G = 6, two-sided window
    (1, 200, 97, 16, 1, 128, True, None),     # Sq > Sk
    (3, 1000, 1000, 5, 1, 64, True, 300),     # G = 5 over many blocks
    (1, 4097, 4097, 16, 1, 256, True, 2048),  # ragged past the window
    (4, 4096, 4096, 16, 1, 256, True, 2048),  # the serving prefill
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,causal,window", TC_CASES)
def test_flash_attention_tensor_core_kernel(cuda_device, B, Sq, Sk, H, KVH,
                                            D, causal, window):
    from repro_torch.kernels import flash_attention as fa
    assert fa.route(torch.bfloat16, D) == "tensor_core"
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + D)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).bfloat16()
               for shape in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))
    before, tc_before = fa.LAUNCHES, fa.TC_LAUNCHES
    got = ops.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before + 1, tc_before + 1)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got).all()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_tensor_core_masked_rows_are_zero(cuda_device):
    """Sq = 300 queries on Sk = 100 keys, causal, window 64: query i sees
    keys (i - 64, i] below 100, none from i = 163 on.  Those rows are
    exactly 0, the others match the plain version."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q = torch.randn((2, 300, 16, 256), generator=g, device=cuda_device)
    k, v = (torch.randn((2, 100, 1, 256), generator=g, device=cuda_device)
            for _ in range(2))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    tc_before = fa.TC_LAUNCHES
    got = ops.attention(q, k, v, causal=True, window=64)
    torch.cuda.synchronize()
    assert fa.TC_LAUNCHES == tc_before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, 163:], torch.zeros_like(got[:, 163:]))
    assert got[:, :163].abs().amax() > 0
    want = fa.flash_attention_plain(q, k, v, causal=True, window=64)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_cuda_core_kernel_bf16_on_request(cuda_device):
    """The CUDA-core kernel still takes bf16 at D = 256 when asked (the
    timing phase compares the two kernels); it counts in LAUNCHES only."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda_device).manual_seed(12)
    q = torch.randn((1, 200, 16, 256), generator=g, device=cuda_device)
    k, v = (torch.randn((1, 200, 1, 256), generator=g, device=cuda_device)
            for _ in range(2))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    before, tc_before = fa.LAUNCHES, fa.TC_LAUNCHES
    got = fa.flash_attention_cuda(q, k, v, True, 64, kernel="cuda_core")
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before + 1, tc_before)
    want = fa.flash_attention_plain(q, k, v, True, 64)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# RG-LRU scan: bit for bit equal to the plain version
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,with_h0", [
    (2, 100, 70, False), (2, 100, 70, True), (1, 1, 5, True),
    (4, 4096, 4096, False), (4, 4096, 4096, True), (3, 4097, 4000, True),
    (2, 2, 4096, True), (2, 3, 4096, False), (4, 4096, 4097, True)])
def test_rglru_scan_cuda_kernel_bitwise(cuda_device, B, S, W, with_h0):
    from repro_torch.kernels import rglru_scan as rs
    g = torch.Generator(device=cuda_device).manual_seed(B * S + W)
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=cuda_device))
    b = torch.randn((B, S, W), generator=g, device=cuda_device)
    h0 = (torch.randn((B, W), generator=g, device=cuda_device)
          if with_h0 else None)
    before = rs.LAUNCHES
    got = ops.rglru(a, b, h0)
    torch.cuda.synchronize()
    assert rs.LAUNCHES == before + 1
    assert torch.equal(got, rs.rglru_scan_plain(a, b, h0))


# ---------------------------------------------------------------------------
# RG-LRU scan backward: bit for bit equal to the plain backward; both
# directions at SeqDetector's campaign batch (B past gridDim.y's 65,535)
# ---------------------------------------------------------------------------
def _scan_inputs(device, B, S, W, with_h0, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device=device))
    b = torch.randn((B, S, W), generator=g, device=device)
    dh = torch.randn((B, S, W), generator=g, device=device)
    h0 = (torch.randn((B, W), generator=g, device=device)
          if with_h0 else None)
    return a, b, h0, dh


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,with_h0", [
    (2, 100, 70, False), (2, 100, 70, True), (1, 1, 5, True),
    (3, 7, 16, False), (3, 7, 16, True), (5, 33, 40, True),
    (4, 4096, 4096, True), (2, 3, 4096, False), (3, 4097, 4000, True)])
def test_rglru_scan_backward_cuda_kernel_bitwise(cuda_device, B, S, W,
                                                 with_h0):
    from repro_torch.kernels import rglru_scan as rs
    a, b, h0, dh = _scan_inputs(cuda_device, B, S, W, with_h0, B + S * W)
    h = rs.rglru_scan_cuda(a, b, h0)
    before = rs.BWD_LAUNCHES
    got = rs.rglru_scan_bwd_cuda(a, h, h0, dh)
    torch.cuda.synchronize()
    assert rs.BWD_LAUNCHES == before + 1
    want = rs.rglru_scan_backward_plain(a, h, h0, dh)
    for g_, w_ in zip(got, want):
        assert (g_ is None) == (w_ is None)
        if w_ is not None:
            assert torch.equal(g_, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [70_000, 720_000])
def test_rglru_scan_both_directions_at_campaign_batch(cuda_device, B):
    """SeqDetector folds every device row into the scan's batch: (S * N *
    n_max, 7, 16), 720,000 rows at 64 scenarios of the paper's split."""
    from repro_torch.kernels import rglru_scan as rs
    a, b, h0, dh = _scan_inputs(cuda_device, B, 7, 16, False, B)
    h = ops.rglru(a, b)
    assert torch.equal(h, rs.rglru_scan_plain(a, b))
    got = rs.rglru_scan_bwd_cuda(a, h, None, dh)
    want = rs.rglru_scan_backward_plain(a, h, None, dh)
    assert got[2] is None and want[2] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_rglru_scan_autograd_launches_kernels(cuda_device):
    """``ops.rglru`` is differentiable on the card: the forward and the
    backward each launch their kernel once, and the gradients equal the
    plain backward's."""
    from repro_torch.kernels import rglru_scan as rs
    a, b, h0, dh = _scan_inputs(cuda_device, 6, 9, 16, True, 3)
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    before = rs.LAUNCHES, rs.BWD_LAUNCHES
    h = ops.rglru(*leaves)
    grads = torch.autograd.grad(h, leaves, dh)
    assert (rs.LAUNCHES - before[0], rs.BWD_LAUNCHES - before[1]) == (1, 1)
    want = rs.rglru_scan_backward_plain(a, h.detach(), h0, dh)
    for g_, w_ in zip(grads, want):
        assert torch.equal(g_, w_)


def _seq_inputs(samples_per_class=60):
    from repro_torch.data import commsml, federated
    from repro_torch.models.detector import SeqDetector
    X, y = commsml.generate(seed=0, samples_per_class=samples_per_class)
    split = federated.make_split(X, y, num_devices=10, num_clusters=5,
                                 anomaly_classes=[3], seed=0)
    dx, counts = federated.pad_devices(split)
    return SeqDetector(), dx, counts, split.test_x, split.test_y


@pytest.mark.cuda
def test_seq_detector_round_on_card_matches_cpu(cuda_device):
    """A dropout-free SeqDetector run on the card: two forward scans and
    one backward scan a round (the loss and its gradient, the test
    scores), the fused round kernel once a round, and loss curves within
    rtol 1e-5 of the same run on the CPU; one round's per-device
    gradients within rtol 1e-5 (atol 1e-5 of the largest)."""
    import numpy as np

    from repro_torch.core import simulate
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.models.params import FlatLayout
    det, dx, counts, tx, ty = _seq_inputs()
    p0 = det.init_params(torch.Generator().manual_seed(0), device="cpu")
    cfg = simulate.SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                             rounds=3, lr=1e-4, dropout=False)
    before = rs.LAUNCHES, rs.BWD_LAUNCHES, tc.ROUND_LAUNCHES
    gpu = simulate.run_simulation(det, dx, counts, tx, ty, cfg, params0=p0)
    assert (rs.LAUNCHES - before[0], rs.BWD_LAUNCHES - before[1],
            tc.ROUND_LAUNCHES - before[2]) == (2 * 3 + 1, 3, 3)
    cpu = simulate.run_simulation(det, dx, counts, tx, ty, cfg, params0=p0,
                                  device="cpu")
    np.testing.assert_allclose(gpu.loss_curve, cpu.loss_curve, rtol=1e-5)
    layout = FlatLayout.of(p0)
    flat = layout.flatten(p0)[None, None].expand(1, 10, -1)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        dxd, _, valid = simulate.device_arrays(dx, counts, dev)
        grads.append(simulate._device_grads(
            det, layout, flat.to(dev), dxd[None], valid, None).cpu())
    scale = float(grads[1].abs().max())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.cuda
def test_seq_experiment_on_card_matches_cpu(cuda_device):
    """A small SeqDetector experiment (tolfl, fl and IFCA cells) through
    plan -> execute on the card against the CPU: loss curves within rtol
    1e-4, AUROCs within 1e-3, assignments and iso_active equal."""
    import numpy as np

    from repro_torch.core import experiment as X
    from repro_torch.core.failure import NO_FAILURE, FailureSpec
    from repro_torch.core.simulate import SimConfig
    from repro_torch.models.detector import SeqDetector
    _, dx, counts, tx, ty = _seq_inputs()
    spec = X.ExperimentSpec(
        data=X.DataSpec(model=SeqDetector(d_model=8), device_x=dx,
                        device_counts=counts, test_x=tx, test_y=ty),
        base=SimConfig(num_devices=10, rounds=3, lr=1e-4, dropout=False),
        cells=(X.CellSpec("tolfl", 2), X.CellSpec("fl", 1),
               X.CellSpec("ifca", 2)),
        traces=X.TraceSpec(traces=(NO_FAILURE, FailureSpec(1, "server")),
                           p_grid=(0.3,), traces_per_p=2),
        seeds=X.SeedSpec((0, 1)))
    p = X.plan(spec)
    gpu, cpu = X.execute(p), X.execute(p, device="cpu")
    for g, c in zip(gpu.results, cpu.results):
        np.testing.assert_allclose(g.loss_curves, c.loss_curves, rtol=1e-4,
                                   atol=1e-5)
        if hasattr(g, "auroc_used"):
            np.testing.assert_array_equal(g.iso_active, c.iso_active)
            np.testing.assert_allclose(g.auroc_used, c.auroc_used, rtol=0,
                                       atol=1e-3)
        else:
            np.testing.assert_array_equal(g.assignments, c.assignments)
            np.testing.assert_allclose(g.best_auroc, c.best_auroc, rtol=0,
                                       atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["ae", "seq"])
def test_aot_bitwise_equal_to_plain_on_card(cuda_device, body):
    """``ExecPlan(aot=True)`` on the card: every bucket warms up at its
    predicted shapes (``aval_match``), launches each kernel of its rounds
    plus one warm-up round, and the results are the same bits as with
    ``aot=False``."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.autoencoder_paper import AutoencoderConfig
    from repro_torch.core import experiment as X
    from repro_torch.core.campaign import ExecPlan
    from repro_torch.core.failure import NO_FAILURE, FailureSpec
    from repro_torch.core.simulate import SimConfig
    from repro_torch.models.detector import SeqDetector
    _, dx, counts, tx, ty = _seq_inputs()
    model = (SeqDetector(d_model=8) if body == "seq" else
             AutoencoderConfig(input_dim=112, hidden=(32, 16), code_dim=8))
    spec = X.ExperimentSpec(
        data=X.DataSpec(model=model, device_x=dx, device_counts=counts,
                        test_x=tx, test_y=ty),
        base=SimConfig(num_devices=10, rounds=3, lr=1e-4),
        cells=(X.CellSpec("tolfl", 2), X.CellSpec("fl", 1),
               X.CellSpec("ifca", 2)),
        traces=X.TraceSpec(traces=(NO_FAILURE, FailureSpec(1, "server")),
                           p_grid=(0.3,), traces_per_p=2),
        seeds=X.SeedSpec((0, 1)))
    plain = X.execute(X.plan(spec))
    before = tc.ROUND_LAUNCHES
    aot = X.execute(X.plan(dataclasses.replace(
        spec, exec_plan=ExecPlan(aot=True))))
    # the rounds of the two single-model buckets, and one warm-up each
    assert tc.ROUND_LAUNCHES - before == 2 * (3 + 1)
    rep = aot.compile_report
    assert rep.aot and all(b.aval_match for b in rep.buckets)
    assert {b.cache for b in rep.buckets} <= {"compiled", "disk", "memory"}
    assert all(b.lower_s > 0 for b in rep.buckets)
    for g, w in zip(aot.results, plain.results):
        for name in ("loss_curves", "auroc_used", "best_auroc",
                     "assignments", "iso_active"):
            if hasattr(w, name):
                assert np.array_equal(getattr(g, name), getattr(w, name),
                                      equal_nan=True), name


_RESOLVE_CHILD = """
import json
from repro_torch.core import compilecache
from repro_torch.kernels import _build
source, seconds = _build.resolve()
print(json.dumps({"source": source, "seconds": seconds,
                  "stats": compilecache.xla_compile_stats()}))
"""


@pytest.mark.cuda
def test_warm_cache_second_process_builds_nothing(cuda_device, tmp_path):
    """Two processes resolve every kernel library against one new
    ``REPRO_CACHE_DIR``: the first runs nvcc for each ``csrc/*.cu``, the
    second loads them all from the directory and runs none."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import _build
    env = dict(os.environ, REPRO_CACHE_DIR=str(tmp_path / "cache"),
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _RESOLVE_CHILD],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    n = len(_build.sources())
    assert runs[0]["source"] == "compiled"
    assert (runs[0]["stats"]["misses"], runs[0]["stats"]["hits"]) == (n, 0)
    assert runs[1]["source"] == "disk"
    assert (runs[1]["stats"]["misses"], runs[1]["stats"]["hits"]) == (0, n)


# ---------------------------------------------------------------------------
# RWKV6 WKV scan: within rtol = atol = 1e-4 of the plain version (the JAX
# kernel's own tolerance): the kernel factors the bonus out, contracts into
# FMAs and sums over n in another order.  A case with calls = 2 runs the
# kernel twice over S / 2, the second call from the first's state, against
# one plain call over S
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N,with_state0,calls", wk.CARD_CASES)
def test_rwkv6_scan_cuda_kernel(cuda_device, B, S, H, N, with_state0,
                                calls):
    g = torch.Generator(device=cuda_device).manual_seed(S + N)
    args = wk.random_inputs(B, S, H, N, with_state0, g)
    s0_before = args[-1].clone()
    before = wk.LAUNCHES
    y, st = wk.in_calls(ops.rwkv6, calls, *args)
    torch.cuda.synchronize()
    assert wk.LAUNCHES == before + calls
    assert torch.equal(args[-1], s0_before)      # the state in is kept
    y_want, st_want = wk.rwkv6_scan_plain(*args)
    torch.testing.assert_close(y, y_want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# serving: a prefill launches one attention kernel per attention layer, one
# scan per recurrent layer and one WKV scan per RWKV6 layer; a decode step
# launches the WKV scan once per RWKV6 layer and no other kernel
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch,num_layers", [("recurrentgemma-9b", 2),
                                             ("recurrentgemma-9b", 5),
                                             ("rwkv6-7b", 2)])
def test_serving_kernel_launches(cuda_device, arch, num_layers):
    import dataclasses

    from repro_torch.configs.base import LOCAL_ATTN, RECURRENT, RWKV
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    cfg = ARCHS[arch].reduced()
    if num_layers == 5:
        cfg = dataclasses.replace(cfg, num_layers=5, recurrent=dataclasses.replace(
            cfg.recurrent, block_pattern=(RECURRENT, RECURRENT, LOCAL_ATTN)))
    n_attn = cfg.layer_pattern.count(LOCAL_ATTN)
    n_rec = cfg.layer_pattern.count(RECURRENT)
    n_rwkv = cfg.layer_pattern.count(RWKV)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = T.init_params(g, cfg, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=g,
                           device=cuda_device)
    fa.LAUNCHES = rs.LAUNCHES = wk.LAUNCHES = 0
    logits, cache = prefill(params, cfg, {"tokens": tokens})
    assert (fa.LAUNCHES, rs.LAUNCHES, wk.LAUNCHES) == (n_attn, n_rec, n_rwkv)
    cache = pad_cache(cache, cfg, 100, 102)
    fa.LAUNCHES = rs.LAUNCHES = wk.LAUNCHES = 0
    for t in (100, 101):
        logits, cache = decode_step(params, cfg, tokens[:, -1:], cache, t)
    assert (fa.LAUNCHES, rs.LAUNCHES, wk.LAUNCHES) == (0, 0, 2 * n_rwkv)
    assert torch.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "tensor_core"),
                                          ("float32", "cuda_core")])
def test_serving_prefill_attention_kernel(cuda_device, dtype, kernel):
    """A RecurrentGemma prefill's attention goes through the kernel its
    dtype routes to: the reduced config's D = 64 in bf16 on the tensor
    cores, in float32 on the CUDA cores."""
    import dataclasses

    from repro_torch.configs.base import LOCAL_ATTN
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import prefill
    cfg = dataclasses.replace(ARCHS["recurrentgemma-9b"].reduced(),
                              dtype=dtype)
    assert fa.route(getattr(torch, dtype), cfg.attention.head_dim) == kernel
    g = torch.Generator(device=cuda_device).manual_seed(1)
    params = T.init_params(g, cfg, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=g,
                           device=cuda_device)
    fa.LAUNCHES = fa.TC_LAUNCHES = 0
    logits, _ = prefill(params, cfg, {"tokens": tokens})
    n_attn = cfg.layer_pattern.count(LOCAL_ATTN)
    assert fa.LAUNCHES == n_attn
    assert fa.TC_LAUNCHES == (n_attn if kernel == "tensor_core" else 0)
    assert torch.isfinite(logits).all()


@pytest.mark.cuda
def test_qk_norm_prefill_on_card_matches_cpu(cuda_device):
    """Qwen3's reduced config (qk-norm, 2 layers) in float32 on 2 kv
    heads: prefill and two decode steps on the card agree with the CPU
    within 1e-4, the prefill through the attention kernel."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    cfg = ARCHS["qwen3-8b"].reduced()
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, num_kv_heads=2))
    assert cfg.attention.qk_norm
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 98),
                           generator=torch.Generator().manual_seed(1))
    dev = P.tree_map_with_path(lambda _, x: x.to(cuda_device), params)
    outs = []
    for p, toks in ((params, tokens), (dev, tokens.to(cuda_device))):
        fa.LAUNCHES = 0
        logits, cache = prefill(p, cfg, {"tokens": toks[:, :96]})
        assert fa.LAUNCHES == (2 if toks.is_cuda else 0)
        steps = [logits]
        cache = pad_cache(cache, cfg, 96, 98)
        for t in (96, 97):
            logits, cache = decode_step(p, cfg, toks[:, t:t + 1], cache, t)
            steps.append(logits)
        outs.append([s.float().cpu() for s in steps])
    for want, got in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
