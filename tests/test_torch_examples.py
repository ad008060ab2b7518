"""The port's example scripts (``repro_torch.examples``), each run with
``--smoke --device cpu`` in-process, against direct calls of
``repro_torch.api`` (and the serving functions) with the same arguments.

* ``quickstart``: the three AUROCs it prints equal three direct
  ``run_simulation`` calls.
* ``failure_scenarios`` (with ``--shard``, which splits the scenarios
  over the local cards and here, on the CPU's one device, warns and
  degrades): every cell's results equal a hand-built spec executed
  directly, bit for bit, and its printed rows carry their means; the
  ``--process`` path likewise.
* ``score_stream``: its bank equals a directly trained one bit for bit,
  every window scores as its routed model scored directly, none dropped.
* ``serve_batch``: the greedy tokens of each default arch (whisper's
  encoder-decoder among them) and of ``--arch granite-3-2b`` and
  ``--arch internvl2-26b`` (a vision prefix before the prompt) equal a
  direct prefill and decode loop.
"""
import re
import warnings

import numpy as np
import pytest
import torch

import repro_torch.api as T
from repro_torch.configs.registry import ARCHS
from repro_torch.data import commsml, federated
from repro_torch.examples import (failure_scenarios, quickstart,
                                  score_stream, serve_batch)
from repro_torch.models import transformer as TT
from repro_torch.models.params import tree_items
from repro_torch.serving.anomaly.engine import score_windows
from repro_torch.serving.decode import decode_step, pad_cache, prefill
from repro_torch.serving.inputs import synthetic_batch
from torch_threads import one_torch_thread  # noqa: F401

SMOKE = ["--smoke", "--device", "cpu"]


def _split(samples, devices=10, clusters=5):
    X, y = commsml.generate(seed=0, samples_per_class=samples)
    split = federated.make_split(X, y, devices, clusters,
                                 anomaly_classes=[3], seed=0)
    return split, federated.pad_devices(split)


def test_quickstart(capsys):
    got = quickstart.main(SMOKE)
    out = capsys.readouterr().out
    split, (dx, counts) = _split(60)

    def run(scheme, k, failure):
        cfg = T.SimConfig(scheme=scheme, num_devices=10, num_clusters=k,
                          rounds=8, lr=1e-3, seed=0)
        return T.run_simulation(T.AutoencoderConfig(), dx, counts,
                                split.test_x, split.test_y, cfg, failure,
                                device="cpu")
    fail = T.FailureSpec(epoch=5, kind="server")
    want = {"tolfl": run("tolfl", 5, T.NO_FAILURE).final_auroc,
            "tolfl_head_failure": run("tolfl", 5, fail).auroc_used,
            "fl_server_failure": run("fl", 1, fail).auroc_used}
    assert got == want
    assert f"no failures:     AUROC = {want['tolfl']:.3f}" in out
    assert f"head failure:    AUROC = {want['tolfl_head_failure']:.3f}" in out
    assert "Tol-FL advantage under server failure:" in out


def _smoke_spec(traces):
    split, (dx, counts) = _split(40)
    return T.ExperimentSpec(
        data=T.DataSpec(model=T.AutoencoderConfig(), device_x=dx,
                        device_counts=counts, test_x=split.test_x,
                        test_y=split.test_y, name="commsml"),
        base=T.SimConfig(num_devices=10, rounds=5, lr=1e-3),
        cells=(T.CellSpec("tolfl", 5), T.CellSpec("fl", 1),
               T.CellSpec("sbt", 10), T.CellSpec("ifca", 2)),
        traces=traces, seeds=T.SeedSpec.range(1))


def _same_results(a, b):
    for x, y in zip(a.results, b.results, strict=True):
        for f in ("trace_index", "seed", "loss_curves"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), f)
        for f in ("auroc_used", "best_auroc"):
            if hasattr(x, f):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_failure_scenarios_sharded_smoke(capsys):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = failure_scenarios.main(SMOKE + ["--shard"])
    out = capsys.readouterr().out
    assert [str(w.message)[:48] for w in rec] == [
        "ExecPlan(shard=True) found a single local device"]
    traces = T.TraceSpec(traces=(T.NO_FAILURE,
                                 T.FailureSpec(epoch=1, kind="client"),
                                 T.FailureSpec(epoch=1, kind="server")),
                         p_grid=(0.2,), traces_per_p=1)
    spec = _smoke_spec(traces)
    want = T.execute(T.plan(spec), device="cpu")
    _same_results(got, want)
    assert T.plan(spec).describe() in out
    rows = {line.split()[0]: line for line in out.splitlines()
            if re.match(r"(Tol-FL|FL|SBT|ifca\*) ", line)}
    assert sorted(rows) == ["FL", "SBT", "Tol-FL", "ifca*"]
    cell = want.plan.cells[0]
    mean, std, _ = T.mean_ci95(want.results[0].select(
        cell.explicit_index[2]))
    assert rows["Tol-FL"].split()[7:10] == [f"{mean:.3f}", "+-",
                                            f"{std:.3f}"]


def test_failure_scenarios_process_smoke(capsys):
    got = failure_scenarios.main(SMOKE + ["--process", "cascade"])
    out = capsys.readouterr().out
    spec = _smoke_spec(T.TraceSpec.generated(T.ProcessGrid(
        T.family_process("cascade", 0.3), 1)))
    want = T.execute(T.plan(spec), device="cpu")
    _same_results(got["cascade"], want)
    assert out.startswith(T.plan(spec).describe())
    assert "cascade process" in out and "E[AUROC] x=0.30" in out


def test_score_stream_smoke(capsys):
    bank, rep, scored = score_stream.main(SMOKE)
    out = capsys.readouterr().out
    split, (dx, counts) = _split(60)
    cfg = T.SimConfig(scheme="tolfl", num_devices=10, num_clusters=5,
                      rounds=3, lr=1e-3, dropout=False)
    model = T.AutoencoderConfig(input_dim=commsml.N_FEATURES,
                                hidden=(32, 16), code_dim=8, dropout=0.2)
    direct = T.train_model_bank(model, dx, counts, cfg, device="cpu")
    for (path, a), (_, b) in zip(tree_items(bank.row_params),
                                 tree_items(direct.row_params), strict=True):
        assert torch.equal(a, b), path
    assert rep.dropped == 0 and rep.windows == len(scored) == 12 * 10
    assert rep.failovers > 0
    tx = np.asarray(split.test_x, np.float32)
    W = score_stream.WINDOW
    wins = tx[:tx.shape[0] // W * W].reshape(-1, W, tx.shape[-1])
    for r in scored:
        i = (r.epoch * bank.num_clients + r.client) % len(wins)
        params = (bank.client_iso_params(r.client)
                  if r.served_by == "isolated" else bank.global_params)
        want = score_windows(bank.detector, params,
                             torch.from_numpy(wins[i][None]))[0].numpy()
        np.testing.assert_array_equal(r.scores, want)
    assert "failover timeline" in out and "dropped=0" in out


def _direct_tokens(arch, batch, prompt, tokens):
    cfg = ARCHS[arch].reduced()
    params = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    inp = synthetic_batch(cfg, batch, prompt, torch.Generator().manual_seed(0),
                          "cpu")
    logits, cache = prefill(params, cfg, inp)
    base = prompt + (inp["prefix"].shape[1] if "prefix" in inp else 0)
    cache = pad_cache(cache, cfg, base, base + tokens)
    out = [torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]]
    for i in range(tokens - 1):
        logits, cache = decode_step(params, cfg, out[-1], cache, base + i)
        out.append(torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None])
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("arch", [None, "granite-3-2b", "internvl2-26b"])
def test_serve_batch_smoke(capsys, arch):
    got = serve_batch.main(SMOKE + ([] if arch is None else ["--arch", arch]))
    out = capsys.readouterr().out
    archs = serve_batch.DEFAULT_ARCHS if arch is None else (arch,)
    assert tuple(got) == archs
    for a in archs:
        assert torch.equal(got[a], _direct_tokens(a, 2, 16, 4)), a
        assert re.search(rf"^{re.escape(a)} +prefill .* sample: ", out,
                         re.M)
    assert out.startswith("batched serving: batch=2 prompt=16 generate=4")
