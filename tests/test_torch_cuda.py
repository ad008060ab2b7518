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
def test_sharded_campaign_bitwise_on_card(cuda_device, monkeypatch):
    """``ExecPlan(shard=True, chunk_size=6)`` over two shards placed on
    the one card (the shard devices' one source patched) equals the
    unsharded run at chunk 3 bit for bit, dropout on: each shard is one
    chunk of that run, its own generator seeded as that chunk's.  Every
    shard launches the fused kernel once a round."""
    import dataclasses

    from repro_torch.core import campaign
    from repro_torch.core.simulate import SimConfig
    ae, dx, counts, tx, ty, traces, seeds = _small_campaign_inputs()
    cfg = SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                    rounds=4, lr=5e-4, dropout=True)
    monkeypatch.setattr(campaign, "_local_devices",
                        lambda: [torch.device("cuda", 0)] * 2)
    B = len(traces) * len(seeds)
    before = tc.ROUND_LAUNCHES
    got = campaign.run_campaign(ae, dx, counts, tx, ty, cfg, traces, seeds,
                                exec_plan=campaign.ExecPlan(shard=True,
                                                            chunk_size=6))
    assert tc.ROUND_LAUNCHES - before == cfg.rounds * 2 * -(-B // 6)
    want = campaign.run_campaign(ae, dx, counts, tx, ty, cfg, traces, seeds,
                                 exec_plan=campaign.ExecPlan(chunk_size=3))
    for f in dataclasses.fields(got):
        if f.name != "cfg":
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name

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
    (100_003, 16, 8, True),
    # the plan's edges: a last row block of 1 row (BM 32 / 64), a last
    # column block of 1 column (BN 32 / 16), runtime K in 2 and 3 chunks
    # of 128 with a ragged last slab, N % 4 != 0 (4-byte copies of w)
    (33, 112, 33, True), (65, 16, 17, True), (2049, 129, 128, True),
    (300, 300, 5, False), (64, 13, 16, True)])
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
# split-TF32 kernel, bf16 at D >= 64 on the tensor-core kernel
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
    # whisper-large-v3: the encoder (Sk = 1,500 = 18 x 80 + 60, a ragged
    # last K/V tile), the cross-attention (Sq 416 on Sk 1,500) and the
    # decoder's self-attention, all at D = 64 on 20 heads
    (4, 1500, 1500, 20, 20, 64, False, None),
    (4, 416, 1500, 20, 20, 64, False, None),
    (4, 416, 416, 20, 20, 64, True, None),
    # GQA groups of 5 (Scout: 40 heads on 8) and 6 (InternVL2: 48 on 8) at
    # D = 128, where a 128-row block straddles queries
    (1, 4096, 4096, 40, 8, 128, True, None),
    (1, 4352, 4352, 48, 8, 128, True, None),
    (2, 333, 333, 40, 8, 128, True, None),
    (2, 333, 333, 48, 8, 128, True, None),
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


# the warp-specialized kernel (bfloat16 at D 64 and 128): GQA groups 1, 2,
# 4, 5, 6, 8 and 16, ragged Sq up to 4,097, Sq != Sk both ways (whisper's
# 416 queries on 1,500 frames), bidirectional, windows down to 1, and rows
# that see no key (Sq 300 on Sk 100, window 64: none from query 163 on)
WS_CASES = [
    # (B, Sq, Sk, H, KVH, D, causal, window)
    (1, 256, 256, 8, 8, 64, True, None),       # G = 1
    (2, 300, 300, 8, 4, 128, True, None),      # G = 2, ragged
    (1, 333, 333, 16, 4, 64, True, None),      # G = 4
    (2, 257, 257, 40, 8, 128, True, None),     # G = 5 (Scout's heads)
    (2, 257, 257, 48, 8, 64, True, None),      # G = 6 (InternVL2's)
    (1, 200, 200, 64, 8, 128, True, 100),      # G = 8, window
    (1, 4097, 4097, 16, 1, 64, True, None),    # G = 16, ragged past 4,096
    (1, 4097, 4097, 16, 8, 128, True, None),
    (4, 416, 1500, 20, 20, 64, False, None),   # whisper's cross-attention
    (2, 130, 130, 8, 2, 128, False, None),     # bidirectional
    (1, 97, 97, 12, 2, 64, True, 1),           # window 1: the diagonal
    (1, 300, 100, 16, 2, 128, True, 64),       # rows that see no key
    (1, 300, 100, 16, 16, 64, True, 64),
    (2, 97, 200, 12, 4, 128, False, 50),       # Sq < Sk, two-sided window
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,causal,window", WS_CASES)
def test_flash_attention_ws_kernel(cuda_device, B, Sq, Sk, H, KVH, D, causal,
                                   window):
    """bf16 at D 64 and 128 runs the warp-specialized kernel: within 2e-2
    of the plain version, two launches bit for bit, the lse entry point's
    output the serving one's bit for bit and its lse within 1e-5 of the
    plain lse, and a row that sees no key exactly 0 (lse 0)."""
    from repro_torch.kernels import flash_attention as fa
    assert D in fa.WS_HEAD_DIMS
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + D + H)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).bfloat16()
               for shape in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))
    before = fa.TC_LAUNCHES, fa.WS_LAUNCHES
    got = ops.attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention_cuda(q, k, v, causal, window)
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window,
                                     return_lse=True)
    torch.cuda.synchronize()
    assert (fa.TC_LAUNCHES, fa.WS_LAUNCHES) == (before[0] + 3, before[1] + 3)
    assert torch.equal(got, again) and torch.equal(got, o)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal, window,
                                              return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    seen = fa.visible(Sq, Sk, causal, window, cuda_device).any(1)
    if not bool(seen.all()):
        assert torch.equal(got[:, ~seen], torch.zeros_like(got[:, ~seen]))
        assert torch.equal(lse[:, :, ~seen], torch.zeros_like(lse[:, :, ~seen]))
        assert got[:, seen].abs().amax() > 0


@pytest.mark.cuda
def test_flash_attention_cuda_core_kernel_bf16_on_request(cuda_device):
    """The split-TF32 kernel still takes bf16 at D = 256 when asked (the
    timing phase compares the two kernels); it counts in LAUNCHES only."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda_device).manual_seed(12)
    q = torch.randn((1, 200, 16, 256), generator=g, device=cuda_device)
    k, v = (torch.randn((1, 200, 1, 256), generator=g, device=cuda_device)
            for _ in range(2))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    before, tc_before = fa.LAUNCHES, fa.TC_LAUNCHES
    got = fa.flash_attention_cuda(q, k, v, True, 64, kernel="tf32x3")
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before + 1, tc_before)
    want = fa.flash_attention_plain(q, k, v, True, 64)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# the split-TF32 forward (float32 at every D, bf16 at D = 32 and on request):
# within 2e-4 of the plain version in float32 and 2e-2 in bf16, rows that see
# no key exactly 0, every launch counted in LAUNCHES and none in TC_LAUNCHES
# ---------------------------------------------------------------------------
F32_FWD_CASES = [
    # (B, Sq, Sk, H, KVH, D, causal, window, dtype)
    (1, 128, 128, 4, 2, 32, True, None, "float32"),
    (2, 200, 200, 8, 2, 64, True, 64, "float32"),       # ragged, window
    (1, 130, 130, 8, 8, 128, False, None, "float32"),   # bidirectional, MHA
    (1, 97, 97, 16, 1, 256, True, 1, "float32"),        # only the diagonal
    (1, 300, 100, 16, 1, 128, True, 64, "float32"),     # rows 163 on: no key
    (1, 40, 67, 6, 3, 64, False, 8, "float32"),         # Sk > Sq
    (2, 333, 200, 12, 2, 32, False, 50, "bfloat16"),    # bf16 at D = 32
    (1, 77, 77, 4, 1, 64, True, None, "bfloat16"),      # bf16 by name, D 64
    (1, 150, 150, 16, 1, 256, True, 64, "bfloat16"),    # bf16 by name, D 256
    (1, 4097, 4097, 16, 1, 256, True, 2048, "float32"),  # [serve-consistency]
    (8, 1024, 1024, 16, 16, 64, True, None, "float32"),  # [train]'s heads
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_FWD_CASES)
def test_flash_attention_tf32_fwd_matches_plain(cuda_device, case):
    """The split-TF32 forward against the plain version at every D of
    HEAD_DIMS, causal, windowed and bidirectional, ragged, Sq != Sk, and
    at the two shapes chip_smoke.py times."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KVH, D, causal, window, dt = case
    q, k, v, _ = _f32_inputs(case, cuda_device, Sq + Sk + D)
    before, tc_before = fa.LAUNCHES, fa.TC_LAUNCHES
    got = fa.flash_attention_cuda(q, k, v, causal, window, kernel="tf32x3")
    want = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before + 1, tc_before)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-4 if dt == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    seen = fa.visible(Sq, Sk, causal, window, cuda_device).any(1)
    if not bool(seen.all()):
        assert float(got[:, ~seen].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("at", ["q", "k", "v"])
def test_flash_attention_tf32_fwd_keeps_nan(cuda_device, D, at):
    """A NaN in q, k or v makes NaN the outputs of every row that sees it
    (a NaN in v: that column), as in the plain version; the split of a NaN
    operand keeps it a NaN.  The other batch entry stays finite."""
    from repro_torch.kernels import flash_attention as fa
    case = (2, 150, 150, 8, 2, D, True, 40, "float32")
    q, k, v, _ = _f32_inputs(case, cuda_device, 13)
    pos = 75
    (q if at == "q" else k if at == "k" else v)[0, pos, 0, 3] = float("nan")
    got = fa.flash_attention_cuda(q, k, v, True, 40)
    want = fa.flash_attention_plain(q, k, v, True, 40)
    torch.cuda.synchronize()
    if at == "q":
        rows, heads = torch.arange(150, device=cuda_device) == pos, slice(0, 1)
    else:
        rows, heads = fa.visible(150, 150, True, 40, cuda_device)[:, pos], \
            slice(0, 4)
    cols = 3 if at == "v" else slice(None)
    for o in (got, want):
        assert torch.isnan(o[0, rows, heads][..., cols]).all()
        assert torch.isfinite(o[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt,D", [("float32", 64), ("float32", 256),
                                  ("bfloat16", 32)])
def test_flash_attention_tf32_fwd_takes_misaligned_inputs(cuda_device, dt, D):
    """q, k and v one element past a 16-byte boundary (which the kernel's
    16-byte copies cannot read) give their aligned copies' output and lse
    bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    case = (1, 100, 100, 4, 2, D, True, None, dt)
    q, k, v, _ = _f32_inputs(case, cuda_device, 17)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 != 0
        return out
    want = fa.flash_attention_cuda(q, k, v, True, None, return_lse=True)
    got = fa.flash_attention_cuda(*map(shifted, (q, k, v)), True, None,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# RG-LRU scan: bit for bit equal to the plain version
# ---------------------------------------------------------------------------
#: RecurrentGemma's training shapes, B = 1 and 2 (the backward's few-chains
#: kernel: at most 264 one-warp blocks), a ragged one, W % 4 != 0 (no TMA:
#: the streaming kernel), and the few-chains rule's edge, 8 x 33 = 264
#: blocks and 9 x 32 = 288
FEW_CHAIN_CASES = [
    (1, 2048, 4096, False), (1, 2048, 4096, True), (2, 2048, 4096, False),
    (2, 2048, 4096, True), (1, 4097, 4000, True), (1, 300, 4094, True),
    (8, 100, 1056, True), (9, 100, 1024, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,with_h0", [
    (2, 100, 70, False), (2, 100, 70, True), (1, 1, 5, True),
    (4, 4096, 4096, False), (4, 4096, 4096, True), (3, 4097, 4000, True),
    (2, 2, 4096, True), (2, 3, 4096, False), (4, 4096, 4097, True)]
    + FEW_CHAIN_CASES)
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
    (4, 4096, 4096, True), (2, 3, 4096, False), (3, 4097, 4000, True)]
    + FEW_CHAIN_CASES)
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
@pytest.mark.parametrize("B,S,W", [(1, 2048, 4096), (5, 33, 40),
                                   (1, 300, 4094), (3, 7, 16)])
def test_rglru_scan_backward_keeps_signed_zeros(cuda_device, B, S, W):
    """A -0 in dh's last step stays -0 in db and in da's sign, as in the
    plain backward: compared as bits, which ``torch.equal`` is not (-0 ==
    +0).  The few-chains kernel reaches it through a zero fill (its g
    starts at -0), the streaming kernels through a branch."""
    from repro_torch.kernels import rglru_scan as rs
    a, b, h0, dh = _scan_inputs(cuda_device, B, S, W, True, S + W)
    dh[:, -1, ::2] = -0.0
    dh[:, -1, 1::4] = 0.0
    h = rs.rglru_scan_cuda(a, b, h0)
    got = rs.rglru_scan_bwd_cuda(a, h, h0, dh)
    torch.cuda.synchronize()
    want = rs.rglru_scan_backward_plain(a, h, h0, dh)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.view(torch.int32), w_.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(1, 2048, 4096), (2, 100, 64)])
def test_rglru_scan_backward_misaligned_bitwise(cuda_device, B, S, W):
    """Tensors one element past a 16-byte boundary (which TMA cannot read)
    take the streaming kernel, still bit for bit, and give the aligned
    copies' bits."""
    from repro_torch.kernels import rglru_scan as rs
    a, b, h0, dh = _scan_inputs(cuda_device, B, S, W, True, W)
    h = rs.rglru_scan_cuda(a, b, h0)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 != 0
        return out
    got = rs.rglru_scan_bwd_cuda(shifted(a), shifted(h), h0, shifted(dh))
    want = rs.rglru_scan_bwd_cuda(a, h, h0, dh)
    torch.cuda.synchronize()
    for g_, w_, p_ in zip(got, want,
                          rs.rglru_scan_backward_plain(a, h, h0, dh)):
        assert torch.equal(g_, w_) and torch.equal(g_, p_)


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
                                          ("float32", "tf32x3")])
def test_serving_prefill_attention_kernel(cuda_device, dtype, kernel):
    """A RecurrentGemma prefill's attention goes through the kernel its
    dtype routes to: the reduced config's D = 64 in bf16 on the bf16
    tensor cores, in float32 on the split-TF32 kernel."""
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


# ---------------------------------------------------------------------------
# the rest of the zoo: whisper's encoder-decoder, the MoE decoders and the
# vision prefix, reduced, on the card against the CPU
# ---------------------------------------------------------------------------
NEW_ARCHS = ("whisper-large-v3", "llama4-scout-17b-a16e",
             "llama4-maverick-400b-a17b", "internvl2-26b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_zoo_prefill_decode_on_card_matches_cpu(cuda_device, arch):
    """The reduced config in float32: prefill (whisper's 16 frames,
    InternVL2's 16 patches first), pad_cache and three decode steps on
    the card agree with the CPU within 1e-4 on the logits and every cache
    leaf.  A prefill launches the attention kernel once a layer (whisper:
    once an encoder layer, and twice a decoder layer: self and cross), a
    decode step never."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    cfg = ARCHS[arch].reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = synthetic_batch(cfg, 2, 99, torch.Generator().manual_seed(1),
                            "cpu")
    dev = P.tree_map_with_path(lambda _, x: x.to(cuda_device), params)
    base = 96 + (batch["prefix"].shape[1] if "prefix" in batch else 0)
    want_launches = cfg.num_layers * (2 if cfg.is_encdec else 1) \
        + cfg.num_encoder_layers
    outs = []
    for p, on in ((params, "cpu"), (dev, cuda_device)):
        b = {k: v.to(on) for k, v in batch.items()}
        toks = b["tokens"]
        fa.LAUNCHES = 0
        logits, cache = prefill(p, cfg, dict(b, tokens=toks[:, :96]))
        assert fa.LAUNCHES == (want_launches if on != "cpu" else 0)
        steps = [logits]
        cache = pad_cache(cache, cfg, base, base + 3)
        for i in range(3):
            logits, cache = decode_step(p, cfg, toks[:, 96 + i:97 + i], cache,
                                        base + i)
            steps.append(logits)
        assert fa.LAUNCHES == (want_launches if on != "cpu" else 0)
        outs.append([s.cpu() for s in steps]
                    + [x.cpu() for _, x in P.tree_items(cache)])
    for want, got in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_zoo_bf16_prefill_on_tensor_cores(cuda_device, arch):
    """In bf16 every prefill attention of the reduced config (D = 64) goes
    to the tensor-core kernel; a decode step launches none and its
    logits are finite, under the sync debug mode."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    from repro_torch.serving.inputs import synthetic_batch
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="bfloat16")
    g = torch.Generator(device=cuda_device).manual_seed(2)
    params = T.init_params(g, cfg, cuda_device)
    batch = synthetic_batch(cfg, 2, 100, g, cuda_device)
    base = 100 + (batch["prefix"].shape[1] if "prefix" in batch else 0)
    fa.LAUNCHES = fa.TC_LAUNCHES = 0
    logits, cache = prefill(params, cfg, batch)
    n = cfg.num_layers * (2 if cfg.is_encdec else 1) + cfg.num_encoder_layers
    assert fa.LAUNCHES == fa.TC_LAUNCHES == n
    cache = pad_cache(cache, cfg, base, base + 2)
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2):
            logits, cache = decode_step(params, cfg, tok, cache, base + i)
            tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fa.LAUNCHES == n
    assert torch.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk", [(96, 512), (1024, 512), (3, 1)])
def test_moe_apply_on_card_matches_cpu(cuda_device, S, chunk):
    """The reduced Scout's MoE layer at capacity 1.25 (a 96- or 512-token
    chunk drops tokens) in float32: the same dispatch on the card as on
    the CPU, the output and losses within 1e-5."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import moe as M
    from repro_torch.models import params as P
    cfg = ARCHS["llama4-scout-17b-a16e"].reduced()
    g = torch.Generator().manual_seed(3)
    p = M.moe_init(g, cfg.d_model, cfg.d_ff, cfg.moe, cfg.glu, "cpu")
    x = torch.randn((2, S, cfg.d_model), generator=g)
    dev = P.tree_map_with_path(lambda _, w: w.to(cuda_device), p)
    x_dev = x.to(cuda_device)
    want, want_aux = M.moe_apply(p, x, cfg.moe, cfg.act, cfg.glu, chunk)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_aux = M.moe_apply(dev, x_dev, cfg.moe, cfg.act, cfg.glu,
                                   chunk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for name in ("lb_loss", "z_loss"):
        torch.testing.assert_close(got_aux[name].cpu(), want_aux[name],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# bf16 params (ModelConfig.param_dtype) on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "qwen3-8b"])
def test_bf16_params_equal_rounded_float32_on_card(cuda_device, arch, dtype):
    """A reduced MoE and a reduced dense decoder (qk-norm) with bf16 params
    against float32 params that hold the same rounded values, in float32
    activations (the split-TF32 attention) and bf16 (the tensor cores):
    prefill, pad_cache and three decode steps give equal logits and cache
    leaves under torch.equal, and the same attention launches."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    from repro_torch.serving.decode import decode_step, pad_cache, prefill
    cfg = dataclasses.replace(ARCHS[arch].reduced(), param_dtype="bfloat16",
                              dtype=dtype)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    p16 = T.init_params(g, cfg, cuda_device)
    assert {x.dtype for _, x in P.tree_items(p16)} <= {torch.bfloat16,
                                                       torch.float32}
    rounded = P.cast_tree(p16, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 99), generator=g,
                         device=cuda_device)
    runs = []
    for params in (p16, rounded):
        fa.LAUNCHES = fa.TC_LAUNCHES = 0
        logits, cache = prefill(params, cfg, {"tokens": toks[:, :96]})
        out = [logits]
        cache = pad_cache(cache, cfg, 96, 99)
        for t in (96, 97, 98):
            logits, cache = decode_step(params, cfg, toks[:, t:t + 1], cache,
                                        t)
            out.append(logits)
        torch.cuda.synchronize()
        runs.append((out + [x for _, x in P.tree_items(cache)],
                     (fa.LAUNCHES, fa.TC_LAUNCHES)))
    (a, la), (b, lb) = runs
    assert la == lb and la[0] == cfg.num_layers
    assert la[1] == (cfg.num_layers if dtype == "bfloat16" else 0)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.cuda
def test_weight_bridge_onto_card(cuda_device):
    """The weight bridge on a bf16 tree: ``to_numpy_tree`` widens each bf16
    leaf exactly to float32 and ``from_numpy_tree`` puts it on the card,
    where the cast back gives the same bits; a tree of numpy bf16 leaves
    (``repro``'s, through ``ml_dtypes`` where it is installed) lands on
    the card as bf16, bit for bit."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(ARCHS["llama4-maverick-400b-a17b"].reduced(),
                              param_dtype="bfloat16")
    p = T.init_params(torch.Generator(device=cuda_device).manual_seed(5), cfg,
                      cuda_device)
    wide = P.to_numpy_tree(p)
    back = dict(P.tree_items(P.from_numpy_tree(wide, cuda_device)))
    for path, x in P.tree_items(p):
        y = back[path]
        assert y.is_cuda and y.dtype == torch.float32, path
        assert torch.equal(y.to(x.dtype), x), path
    try:
        import ml_dtypes
    except ImportError:
        return
    bits = P.tree_map_with_path(
        lambda _, x: np.asarray(x).astype(ml_dtypes.bfloat16), wide)
    got = dict(P.tree_items(P.from_numpy_tree(bits, cuda_device)))
    for path, x in P.tree_items(p):
        assert got[path].is_cuda and torch.equal(got[path], x), path


# ---------------------------------------------------------------------------
# Training: the backward kernels and the train step on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,causal,window,dt", [
    (2, 300, 300, 4, 4, 64, True, None, "float32"),
    (1, 257, 257, 8, 4, 128, True, None, "float32"),
    (1, 200, 333, 8, 2, 32, False, None, "float32"),
    (1, 190, 190, 10, 2, 64, True, 64, "float32"),
    (1, 150, 150, 6, 1, 256, True, 48, "float32"),
    (1, 100, 40, 4, 2, 64, False, 8, "float32"),
    (2, 333, 200, 12, 2, 128, False, 50, "bfloat16"),
    (2, 128, 128, 16, 16, 64, True, None, "bfloat16")])
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, B, Sq, Sk, H,
                                                  KVH, D, causal, window,
                                                  dt):
    """The routed backward kernel, given the forward's lse, against the
    plain backward on the same card inputs: float32 within 2e-4 of each
    gradient's largest |value| (the split-TF32 kernel); bfloat16 within
    2e-2 of it (one bf16 rounding of each output; at D 64 and 128 the
    tensor-core kernel, which also rounds p and ds); rows that see no key
    get exactly 0."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + D)
    dtype = getattr(torch, dt)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn((B, Sk, KVH, D), generator=g,
                        device=cuda_device).to(dtype) for _ in range(2))
    do = torch.randn((B, Sq, H, D), generator=g, device=cuda_device).to(dtype)
    tc = fa.bwd_route(dtype, D) == "tensor_core"
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    before = fa.BWD_LAUNCHES, fa.TC_BWD_LAUNCHES, fa.TF32_BWD_LAUNCHES
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, causal, window)
    torch.cuda.synchronize()
    assert (fa.BWD_LAUNCHES, fa.TC_BWD_LAUNCHES, fa.TF32_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale
    seen = fa.visible(Sq, Sk, causal, window, cuda_device).any(dim=1)
    if not bool(seen.all()):
        assert float(got[0][:, ~seen].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float16, 64),
                                     (torch.float32, 96)])
def test_flash_attention_bwd_kernel_rejects(cuda_device, dtype, D):
    from repro_torch.kernels import flash_attention as fa
    x = torch.zeros((1, 8, 2, D), dtype=dtype, device=cuda_device)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_bwd_cuda(x, x, x, x, x)


# ---------------------------------------------------------------------------
# the split-TF32 backward (float32 at every D, bf16 at D = 32) and the
# split-TF32 forward's lse entry point it reads
# ---------------------------------------------------------------------------
F32_BWD_CASES = [
    # (B, Sq, Sk, H, KVH, D, causal, window, dtype)
    (1, 700, 700, 16, 1, 256, True, 300, "float32"),   # KVH = 1: heads split
    (1, 300, 100, 16, 1, 128, True, 64, "float32"),    # rows 163 on: no key
    (2, 333, 200, 12, 2, 32, False, 50, "bfloat16"),   # bf16 at D = 32
    (1, 6, 10, 2, 2, 64, True, None, "float32"),       # keys no query sees
    (1, 2048, 2048, 16, 1, 256, True, 2048, "float32"),  # RecurrentGemma-9B
    (8, 1024, 1024, 16, 16, 64, True, None, "float32"),  # [train]'s heads
]


def _f32_inputs(case, device, seed):
    B, Sq, Sk, H, KVH, D, _, _, dt = case
    dtype = getattr(torch, dt)
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=device).to(dtype)
    k, v = (torch.randn((B, Sk, KVH, D), generator=g,
                        device=device).to(dtype) for _ in range(2))
    do = torch.randn((B, Sq, H, D), generator=g, device=device).to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_BWD_CASES)
def test_flash_attention_cuda_core_lse_entry_point(cuda_device, case):
    """The split-TF32 forward's lse entry point returns the serving entry
    point's output bit for bit and an lse within 1e-6 (relative and
    absolute) of the plain one, 0 where a row sees no key; both count as
    launches of the split-TF32 kernel."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KVH, D, causal, window, _ = case
    q, k, v, _ = _f32_inputs(case, cuda_device, D)
    assert fa.route(q.dtype, D) == "tf32x3"
    before = fa.LAUNCHES, fa.TC_LAUNCHES
    served = fa.flash_attention_cuda(q, k, v, causal, window)
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window,
                                     return_lse=True)
    _, want = fa.flash_attention_plain(q, k, v, causal, window,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before[0] + 2, before[1])
    assert torch.equal(o, served)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)
    seen = fa.visible(Sq, Sk, causal, window, cuda_device).any(1)
    assert torch.all(lse[:, :, ~seen] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_BWD_CASES)
def test_flash_attention_tf32_bwd_matches_plain(cuda_device, case):
    """The split-TF32 backward against the plain backward: float32 within
    2e-4 of each gradient's largest |value|, bf16 within 2e-2; zeros
    exact for rows that see no key and keys no row sees; KVH = 1 splits
    the heads over blocks (f32_bwd_head_split above 1) and sums their
    partials; RecurrentGemma-9B's local attention and [train]'s heads in
    float32, the shapes chip_smoke.py times, among the cases."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KVH, D, causal, window, dt = case
    q, k, v, do = _f32_inputs(case, cuda_device, Sq + D)
    assert fa.bwd_route(q.dtype, D) == "tf32x3"
    if KVH == 1:
        assert fa.f32_bwd_head_split(B, Sk, KVH, H, D) > 1
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    before = fa.TF32_BWD_LAUNCHES
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, causal, window)
    torch.cuda.synchronize()
    assert fa.TF32_BWD_LAUNCHES == before + 1
    tol = 2e-4 if dt == "float32" else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == q.dtype and torch.isfinite(a).all()
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale
    ok = fa.visible(Sq, Sk, causal, window, cuda_device)
    for grad, live in ((got[0], ok.any(1)), (got[1], ok.any(0)),
                       (got[2], ok.any(0))):
        if not bool(live.all()):
            assert float(grad[:, ~live].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_BWD_CASES[:3]
                         + [(1, 2048, 2048, 16, 1, 256, True, 2048,
                             "float32")])
def test_flash_attention_tf32_bwd_is_deterministic(cuda_device, case):
    """Two launches give the same bits (no atomics; the head split's
    partials summed in a fixed order), RecurrentGemma-9B's local
    attention in float32 among them."""
    from repro_torch.kernels import flash_attention as fa
    causal, window = case[6], case[7]
    q, k, v, do = _f32_inputs(case, cuda_device, 11)
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    first = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
    second = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_attention_tf32_bwd_needs_lse(cuda_device):
    """float32 on a CUDA tensor goes to the split-TF32 backward, which
    raises without the forward's lse: nothing falls back."""
    from repro_torch.kernels import flash_attention as fa
    x = torch.zeros((1, 8, 2, 64), device=cuda_device)
    before = fa.BWD_LAUNCHES, fa.TF32_BWD_LAUNCHES
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(x, x, x, x, x)
    assert (fa.BWD_LAUNCHES, fa.TF32_BWD_LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [F32_BWD_CASES[0], F32_BWD_CASES[2],
                                  (2, 70, 70, 4, 2, 64, True, None,
                                   "float32")])
@pytest.mark.parametrize("at", ["q", "do"])
def test_flash_attention_tf32_bwd_keeps_nan(cuda_device, case, at):
    """A NaN in q or dO makes NaN the gradients it reaches, as in the
    plain backward: dq of its row, dk and dv of every key the row sees
    (dv only in the NaN's column when dO holds it); the split of a NaN
    operand keeps it a NaN.  The other batch entries stay finite."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KVH, D, causal, window, dt = case
    q, k, v, do = _f32_inputs(case, cuda_device, 3)
    row = Sq // 2
    (q if at == "q" else do)[0, row, 0, 3] = float("nan")
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, causal, window)
    torch.cuda.synchronize()
    keys = fa.visible(Sq, Sk, causal, window, cuda_device)[row]
    assert bool(keys.any())
    cols = 3 if at == "do" else slice(None)
    for dq, dk, dv in (got, want):
        assert torch.isnan(dq[0, row, 0]).all()
        assert torch.isnan(dk[0, keys, 0]).all()
        assert torch.isnan(dv[0, keys, 0][..., cols]).all()
    if B > 1:
        assert all(torch.isfinite(g[1:]).all() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dt,D", [("float32", 64), ("bfloat16", 32),
                                  ("bfloat16", 64)])
def test_flash_attention_bwd_takes_misaligned_inputs(cuda_device, dt, D):
    """q, k, v, o and dO one element past a 16-byte boundary (which the
    kernels' 16-byte loads cannot read) give the gradients of their
    aligned copies bit for bit, on both routes."""
    from repro_torch.kernels import flash_attention as fa
    case = (1, 100, 100, 4, 2, D, True, None, dt)
    q, k, v, do = _f32_inputs(case, cuda_device, 5)
    o, lse = fa.flash_attention_cuda(q, k, v, True, None, return_lse=True)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 != 0
        return out
    want = fa.flash_attention_bwd_cuda(q, k, v, o, do, True, None, lse)
    got = fa.flash_attention_bwd_cuda(*map(shifted, (q, k, v, o, do)), True,
                                      None, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the tensor-core backward (bf16, D 64, 128 and 256) and the forward's lse
# entry point: each gradient row's largest |diff| within 0.05 of the row's RMS
# (chip_smoke.py's ATTN_ROW_TOL: p and ds are rounded to bf16 before their
# products) and within 2e-2 of the gradient's largest |value|; zeros exact;
# the same bits on every launch (no atomics)
# ---------------------------------------------------------------------------
TC_BWD_CASES = [
    # (B, Sq, Sk, H, KVH, D, causal, window)
    (2, 333, 200, 12, 2, 128, False, 50),     # Sq > Sk, G = 6, window
    (1, 100, 40, 4, 2, 64, False, 8),         # rows that see no key
    (8, 1024, 1024, 16, 16, 64, True, None),  # [train]'s qwen1.5-0.5b
    (1, 201, 201, 4, 4, 64, True, None),      # lse rows off 16 bytes
    (1, 1000, 1000, 5, 1, 128, True, 300),    # G = 5, causal window
    (8, 1024, 1024, 16, 8, 128, True, None),  # internlm2's heads
    (1, 200, 333, 8, 2, 128, False, None),    # Sq < Sk
    (1, 6, 10, 2, 2, 64, True, None),         # keys no query sees
    (1, 2048, 2048, 32, 8, 128, True, None),  # [train-bf16-8b]'s Qwen3-8B
]
#: D = 256 (column halves, the head split): [train-families]'
#: RecurrentGemma-9B local attention, a window that binds, and a ragged
#: bidirectional case with rows that see no key
TC_BWD_D256 = [
    (1, 2048, 2048, 16, 1, 256, True, 2048),
    (1, 700, 700, 4, 1, 256, True, 300),
    (1, 333, 200, 4, 2, 256, False, 50),
]
TC_BWD_CASES += TC_BWD_D256


def _row_rel(got, want):
    """Largest |diff| of a row over its RMS, floored at 1e-2 of the
    gradient's RMS (chip_smoke.py's _rows_rel)."""
    diff = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().pow(2).mean(-1).sqrt()
    floor = 1e-2 * float(want.float().pow(2).mean().sqrt())
    return float((diff / rms.clamp_min(max(floor, 1e-30))).max())


def _tc_inputs(case, device, seed):
    B, Sq, Sk, H, KVH, D, _, _ = case
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=device).bfloat16()
    k, v = (torch.randn((B, Sk, KVH, D), generator=g,
                        device=device).bfloat16() for _ in range(2))
    do = torch.randn((B, Sq, H, D), generator=g, device=device).bfloat16()
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_BWD_CASES)
def test_flash_attention_tensor_core_bwd_matches_plain(cuda_device, case):
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KVH, D, causal, window = case
    assert fa.bwd_route(torch.bfloat16, D) == "tensor_core"
    q, k, v, do = _tc_inputs(case, cuda_device, Sq + Sk)
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window,
                                     return_lse=True)
    before = fa.BWD_LAUNCHES, fa.TC_BWD_LAUNCHES
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, causal, window)
    torch.cuda.synchronize()
    assert (fa.BWD_LAUNCHES, fa.TC_BWD_LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        assert _row_rel(a, b) <= 0.05
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale
    ok = fa.visible(Sq, Sk, causal, window, cuda_device)
    for grad, live in ((got[0], ok.any(1)), (got[1], ok.any(0)),
                       (got[2], ok.any(0))):
        if not bool(live.all()):
            assert float(grad[:, ~live].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [TC_BWD_CASES[0], TC_BWD_CASES[2],
                                  TC_BWD_CASES[8]] + TC_BWD_D256)
def test_flash_attention_tensor_core_bwd_is_deterministic(cuda_device, case):
    """Two launches give the same bits: no unordered atomics (at D 64 / 128
    the key blocks add dq's partials in a fixed order)."""
    from repro_torch.kernels import flash_attention as fa
    causal, window = case[6], case[7]
    q, k, v, do = _tc_inputs(case, cuda_device, 7)
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window,
                                     return_lse=True)
    first = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
    second = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 4096, 4096, 4, 1, 64, False, None),
                                  (1, 2048, 2048, 4, 1, 256, False, None)])
def test_flash_attention_tensor_core_bwd_dq_order_bitwise(cuda_device, case):
    """Five launches give the same bits where 64 key blocks add their dq
    partials into every query tile (D = 64, bidirectional, 4,096 keys) and
    where every dq row block runs 64 K/V tiles and the head split's four
    partials add into every key (D = 256, bidirectional, 2,048 keys), and
    the gradients stay within the tolerances of the plain backward."""
    from repro_torch.kernels import flash_attention as fa
    causal, window = case[6], case[7]
    q, k, v, do = _tc_inputs(case, cuda_device, 11)
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window,
                                     return_lse=True)
    runs = [fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window, lse)
            for _ in range(5)]
    want = fa.flash_attention_backward_plain(q, k, v, o, do, causal, window)
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
    for a, b in zip(runs[0], want):
        assert _row_rel(a, b) <= 0.05
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,causal,window", [
    (1, 300, 100, 16, 1, 64, True, 64),       # rows 163 on see no key
    (2, 333, 200, 12, 2, 128, False, 50),
    (8, 1024, 1024, 16, 16, 64, True, None),
    (1, 200, 200, 16, 1, 256, True, 64)] + TC_BWD_D256)
def test_flash_attention_lse_entry_point(cuda_device, B, Sq, Sk, H, KVH, D,
                                         causal, window):
    """The forward's lse entry point returns the serving entry point's
    output bit for bit, and an lse within 1e-5 of the plain one (0 where a
    row sees no key); both count as tensor-core launches."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _tc_inputs((B, Sq, Sk, H, KVH, D, causal, window),
                            cuda_device, D)
    before = fa.LAUNCHES, fa.TC_LAUNCHES
    served = fa.flash_attention_cuda(q, k, v, causal, window)
    o, lse = fa.flash_attention_cuda(q, k, v, causal, window,
                                     return_lse=True)
    _, want = fa.flash_attention_plain(q, k, v, causal, window,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.TC_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert torch.equal(o, served)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= 1e-5
    seen = fa.visible(Sq, Sk, causal, window, cuda_device).any(1)
    if not bool(seen.all()):
        assert torch.equal(lse[:, :, ~seen], torch.zeros_like(
            lse[:, :, ~seen]))


@pytest.mark.cuda
def test_flash_attention_tensor_core_bwd_needs_lse(cuda_device):
    """bf16 at D 64 on a CUDA tensor goes to the tensor-core backward,
    which raises without the forward's lse: no fallback to the split-TF32
    kernel."""
    from repro_torch.kernels import flash_attention as fa
    x = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda_device)
    before = fa.BWD_LAUNCHES
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(x, x, x, x, x)
    assert fa.BWD_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N,with_s0,with_ds", [
    (2, 100, 4, 64, True, True), (1, 33, 2, 8, True, True),
    (2, 64, 3, 16, True, False), (1, 70, 2, 32, False, True),
    (1, 1, 2, 64, True, True), (1, 2048, 64, 64, True, True),
    (1, 1000, 64, 64, True, True), (4, 100, 64, 64, True, True)])
def test_rwkv6_scan_bwd_kernel_matches_plain(cuda_device, B, S, H, N,
                                             with_s0, with_ds):
    """The WKV backward kernel against the plain backward: S past and
    short of the 16-step sub-chunk and the 64-step checkpoint stride,
    every head size, RWKV6-7B's training shape (a cluster of 2 blocks a
    head), a ragged S at its heads and 512 blocks, a state0, a final-state
    gradient; within 1e-4 x max(1, each gradient's largest |value|)."""
    g = torch.Generator(device=cuda_device).manual_seed(S * N)
    r, k, v, w, u, s0 = wk.random_inputs(B, S, H, N, with_s0, g)
    dy = torch.randn((B, S, H, N), generator=g, device=cuda_device)
    ds = (torch.randn((B, H, N, N), generator=g, device=cuda_device)
          if with_ds else None)
    before = wk.BWD_LAUNCHES
    got = wk.rwkv6_scan_bwd_cuda(r, k, v, w, u, s0, dy, ds)
    want = wk.rwkv6_scan_backward_plain(r, k, v, w, u, s0, dy, ds)
    torch.cuda.synchronize()
    assert wk.BWD_LAUNCHES == before + 1
    for a, b in zip(got, want):
        bound = 1e-4 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N", [(1, 2048, 64, 64), (2, 77, 3, 32)])
def test_rwkv6_scan_bwd_kernel_is_deterministic(cuda_device, B, S, H, N):
    """Two launches of the WKV backward give the same bits: no atomics, dv
    summed across the cluster and du over b in a fixed order."""
    g = torch.Generator(device=cuda_device).manual_seed(B * S + N)
    r, k, v, w, u, s0 = wk.random_inputs(B, S, H, N, True, g)
    dy = torch.randn((B, S, H, N), generator=g, device=cuda_device)
    ds = torch.randn((B, H, N, N), generator=g, device=cuda_device)
    a = wk.rwkv6_scan_bwd_cuda(r, k, v, w, u, s0, dy, ds)
    b = wk.rwkv6_scan_bwd_cuda(r, k, v, w, u, s0, dy, ds)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_rwkv6_scan_bwd_kernel_takes_misaligned_inputs(cuda_device):
    """Inputs one float past a 16-byte boundary (which TMA and the
    kernel's 16-byte loads cannot read) give the gradient of their aligned
    copies, bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, S, H, N = 1, 40, 2, 16
    r, k, v, w, u, s0 = wk.random_inputs(B, S, H, N, True, g)
    dy = torch.randn((B, S, H, N), generator=g, device=cuda_device)
    ds = torch.randn((B, H, N, N), generator=g, device=cuda_device)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=cuda_device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    want = wk.rwkv6_scan_bwd_cuda(r, k, v, w, u, s0, dy, ds)
    got = wk.rwkv6_scan_bwd_cuda(*(shifted(t) for t in (r, k, v, w)), u,
                                 shifted(s0), shifted(dy), shifted(ds))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _layer_grads(fn, params, x):
    """Gradients of sum(fn(params, x) * c) w.r.t. every leaf and x."""
    from repro_torch.models import params as P
    leaves = {p: t.clone().requires_grad_(True)
              for p, t in P.tree_items(params)}
    xg = x.clone().requires_grad_(True)
    out = fn(P.tree_from_items(leaves.items()), xg)
    c = torch.ones_like(out).mul_(0.01).add_(torch.linspace(
        0, 1, out.numel(), device=out.device).reshape(out.shape))
    (out * c).sum().backward()
    return {p: t.grad for p, t in leaves.items()}, xg.grad


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b"])
def test_layer_gradients_reach_the_kernels_inputs(cuda_device, arch):
    """A reduced layer (attention, or RWKV6's time mix) on the card in
    float32: the gradients of every projection feeding the kernel (q, k,
    v; r, k, v, the decay's LoRA and the bonus) are non-zero and match
    the same layer on the CPU (plain versions) within 1e-4 x each
    gradient's largest |value|, and so does the input's; the backward
    kernel ran once."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A
    from repro_torch.models import params as P
    from repro_torch.models import rwkv6 as R
    cfg = ARCHS[arch].reduced()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 48, cfg.d_model), generator=g)
    if arch == "rwkv6-7b":
        p = R.timemix_init(g, cfg, "cpu")

        def fn(pp, xx):
            return R.timemix_apply(pp, xx, cfg)[0]
        feeds, mod = ("r", "k", "v", "decay_a", "decay_b", "bonus"), wk
    else:
        p = A.attn_init(g, cfg.d_model, cfg.attention, "cpu")

        def fn(pp, xx):
            return A.attn_apply(pp, xx, cfg.attention, cfg.norm_eps)
        feeds, mod = ("q", "k", "v"), fa
    before = mod.BWD_LAUNCHES
    dev_grads, dev_dx = _layer_grads(
        fn, P.tree_map_with_path(lambda _, t: t.to(cuda_device), p),
        x.to(cuda_device))
    torch.cuda.synchronize()
    assert mod.BWD_LAUNCHES == before + 1
    cpu_grads, cpu_dx = _layer_grads(fn, p, x)
    for path, want in cpu_grads.items():
        got = dev_grads[path].cpu()
        scale = max(float(want.abs().max()), 1e-6)
        err = float((got - want).abs().max())
        assert err <= 1e-4 * scale, (path, err, scale)
        if path[0] in feeds:
            assert float(got.abs().max()) > 0, path
    err = float((dev_dx.cpu() - cpu_dx).abs().max())
    assert err <= 1e-4 * float(cpu_dx.abs().max()), err


@pytest.mark.cuda
def test_train_step_on_card_launches_kernels_without_sync(cuda_device):
    """Two ring steps of the reduced qwen1.5-0.5b in bf16 with remat on
    the card: the forward kernel twice and the backward once per layer a
    step, the backward on the tensor cores (D = 64), no synchronising call
    in the second step, a finite falling loss."""
    import dataclasses
    from repro_torch.configs.base import OptimizerConfig, TolFLConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    cfg = dataclasses.replace(ARCHS["qwen1.5-0.5b"].reduced(),
                              dtype="bfloat16", remat="full")
    mesh = make_host_mesh(device="cuda")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    step = D.make_train_step(cfg, TolFLConfig(num_clusters=1), ocfg, mesh)
    state = D.init_state(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg, ocfg)
    batches = [shard_batch(b, mesh) for b in
               TokenPipeline(cfg.vocab_size, 128, 4).batches(3)]
    alive = torch.ones((1,), device=cuda_device)
    state, m0 = step(state, batches[0], alive)
    fwd, bwd, tc_bwd = fa.LAUNCHES, fa.BWD_LAUNCHES, fa.TC_BWD_LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m1 = step(state, batches[1], alive)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    state, m2 = step(state, batches[2], alive)
    assert fa.LAUNCHES - fwd == 2 * 2 * cfg.num_layers
    assert fa.BWD_LAUNCHES - bwd == 2 * cfg.num_layers
    assert fa.TC_BWD_LAUNCHES - tc_bwd == 2 * cfg.num_layers
    losses = [float(m["loss"]) for m in (m0, m1, m2)]
    assert all(map(lambda v: v == v and abs(v) < 1e4, losses))
    assert losses[-1] < losses[0]


def _bf16_qwen3_ring_step(device):
    """One ring step (SGD at lr 10, where most bf16 elements move) of the
    reduced Qwen3 at bf16 params, from the same params and batch, on
    ``device``: (params before, params after, loss, bwd launches)."""
    import dataclasses
    from repro_torch.configs.base import OptimizerConfig, TolFLConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import distributed as D
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(ARCHS["qwen3-8b"].reduced(),
                              param_dtype="bfloat16")
    ocfg = OptimizerConfig(name="sgd", lr=10.0, schedule="constant",
                           warmup_steps=0, grad_clip=0.0)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params = P.tree_map(lambda x: x.to(device), params)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
             .to(device) for k in ("tokens", "labels")}
    step = D.make_train_step(cfg, TolFLConfig(num_clusters=1), ocfg,
                             make_host_mesh(device=device))
    before = fa.BWD_LAUNCHES
    state = {"params": params, "opt": D.make_optimizer(ocfg).init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    new, metrics = step(state, batch, torch.ones(1, device=device))
    return (P.tree_map(lambda x: x.cpu(), params),
            P.tree_map(lambda x: x.cpu(), new["params"]),
            float(metrics["loss"]), fa.BWD_LAUNCHES - before, cfg)


@pytest.mark.cuda
def test_bf16_ring_step_on_card_matches_cpu(cuda_device):
    """The reduced Qwen3 at bf16 params (a mixed tree: float32 qk-norm
    scales), one ring step on the card against the same step on the CPU,
    within the bf16 parity bounds of ``test_torch_train_bf16.py``: the
    loss within rtol 2e-6, each element's widened update within one ulp
    of its param + 1e-2 x its leaf's largest update + 1e-5 x the largest
    of any leaf; every leaf keeps its dtype, most elements move, and the
    attention backward ran on the card once a layer."""
    import numpy as np
    from repro_torch.models import params as P
    p0, cpu, cpu_loss, _, cfg = _bf16_qwen3_ring_step("cpu")
    _, card, card_loss, launches, _ = _bf16_qwen3_ring_step(cuda_device)
    assert launches == cfg.num_layers
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=2e-6)
    ups = {}
    for (path, x), (_, w), (_, c) in zip(P.tree_items(p0),
                                         P.tree_items(cpu),
                                         P.tree_items(card)):
        assert w.dtype == c.dtype == x.dtype, path
        ups[path] = (x.float(), w.float(), c.float())
    assert {x.dtype for _, x in P.tree_items(card)} == {torch.bfloat16,
                                                        torch.float32}
    top = max(float((w - x).abs().max()) for x, w, _ in ups.values())
    moved = sum(int((c != x).sum()) for x, _, c in ups.values())
    assert moved > 0.5 * sum(x.numel() for x, _, _ in ups.values())
    for path, (x, w, c) in ups.items():
        m = w.abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
        excess = ((c - x) - (w - x)).abs() - ulp
        bound = 1e-2 * float((w - x).abs().max()) + 1e-5 * top
        assert float(excess.max()) <= bound, path
