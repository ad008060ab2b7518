"""The port's production-mesh dry-run (``repro_torch.launch.dryrun``) and
its input stand-ins (``repro_torch.launch.specs``).

The CLI runs in subprocesses (its world is a fake process group of 256
or 512 ranks, which may not share this process's default group): a
reduced MoE config (FSDP rules, the weighted all-reduce, experts on the
model axis) over every input shape on the 2x16x16 mesh, and
qwen1.5-0.5b's train_4k at its published width on the 16x16 mesh; each
record must be ``ok`` on the mesh's chips, with its analytic block
``costmodel``'s.  The stand-ins' shapes and dtypes must be ``repro``'s
(on ``repro``'s one-device host mesh, as
``tests/test_system.py::test_input_specs_cover_all_arch_shape_combos``
builds them) for every arch x shape.  ``repro.launch.dryrun`` is not
imported here: it sets ``XLA_FLAGS`` on import.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import pytest

from repro.configs import ARCHS as R_ARCHS
from repro.configs import OptimizerConfig as ROptimizerConfig
from repro.core import distributed as RD
from repro.launch import specs as RSP
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro.sharding import logical as RL
from repro_torch.analysis import costmodel as CM
from repro_torch.analysis.roofline import Roofline, model_flops_for
from repro_torch.configs import (ARCHS, ASSIGNED, INPUT_SHAPES,
                                 OptimizerConfig)
from repro_torch.launch import specs as SP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tmp_path, *args):
    out = tmp_path / "records"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out), *args],
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "dry-run complete; failures=0" in r.stdout
    return {p.name: json.loads(p.read_text()) for p in out.iterdir()}


def _analytic(rec, reduced=False):
    """The record's analytic block rebuilt from costmodel."""
    cfg = ARCHS[rec["arch"]].reduced() if reduced else ARCHS[rec["arch"]]
    shape = INPUT_SHAPES[rec["shape"]]
    pods = 2 if rec["mesh"] == "2pod16x16" else 1
    cb = CM.step_costs(cfg, shape, rec["chips"], model_shards=16,
                       data_shards=16,
                       schedule=rec.get("schedule", "tolfl_ring"),
                       num_clusters=4, pods=pods,
                       long_ctx=rec["shape"] == "long_500k",
                       fsdp=rec["arch"] in ("llama4-scout-17b-a16e",
                                            "llama4-maverick-400b-a17b",
                                            "internvl2-26b"))
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        chips=rec["chips"], flops_per_chip=cb.flops,
        bytes_per_chip=cb.hbm_bytes, coll_bytes_per_chip=cb.coll_bytes,
        coll_breakdown=rec["roofline"]["coll_breakdown"],
        model_flops=model_flops_for(cfg, shape, shape.mode),
        memory_per_device=rec["roofline"]["memory_per_device"]).to_dict()


def test_dryrun_cli_reduced_moe_every_shape_multi_pod(tmp_path):
    recs = _cli(tmp_path, "--reduced", "--arch", "llama4-scout-17b-a16e",
                "--mesh", "multi")
    assert len(recs) == len(INPUT_SHAPES)
    for rec in recs.values():
        assert rec["status"] == "ok", rec
        assert rec["chips"] == 512 and rec["mesh"] == "2pod16x16"
        assert rec["roofline"] == _analytic(rec, reduced=True)
        assert rec["trace_flops"] > 0 and rec["state_bytes"] > 0
    train = recs["llama4-scout-17b-a16e__train_4k__2pod16x16.json"]
    assert train["schedule"] == "tolfl_psum"
    # FSDP: the params are gathered over the data axes at use, and the
    # step's gradient all-reduce runs within the model column
    coll = train["roofline_trace"]["coll_breakdown"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0


def test_dryrun_cli_qwen_train_full_width(tmp_path):
    recs = _cli(tmp_path, "--arch", "qwen1.5-0.5b", "--shape", "train_4k")
    rec = recs["qwen1.5-0.5b__train_4k__pod16x16.json"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["schedule"] == "tolfl_ring"
    assert rec["roofline"] == _analytic(rec)
    # the ring's chain: this rank (group 0) is cluster 0's head and sends
    assert rec["roofline_trace"]["coll_breakdown"]["collective-permute"] > 0
    # its state: 1/16 of the params' bytes plus Adam's two moments, more or
    # less the replicated vectors
    p = ARCHS["qwen1.5-0.5b"].param_count() * 4 * 3 / 16
    assert 0.9 * p < rec["state_bytes"] < 1.3 * p


@functools.lru_cache(maxsize=None)
def _repro_state(arch):
    cfg = R_ARCHS[arch]
    return jax.eval_shape(lambda k: RD.init_state(k, cfg, ROptimizerConfig()),
                          jax.random.PRNGKey(0))


def _sig(tree):
    """{path: (shape, dtype name)} of a tree of jax structs or tensors."""
    out = {}

    def rec(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, path + (k,))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for k, v in zip(t._fields, t):
                rec(v, path + (k,))
        elif t is not None:
            out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    rec(tree, ())
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_shapes_and_dtypes_equal_repro(arch):
    mesh = r_make_host_mesh(data=1, model=1)
    rules = RL.rules_for("replicated_data")
    rcfg, cfg = R_ARCHS[arch], ARCHS[arch]
    for name, shape in INPUT_SHAPES.items():
        if shape.mode == "train":
            want = RSP.train_batch_specs(rcfg, shape, mesh, rules)
            got = SP.train_batch_specs(cfg, shape, None, rules)
        elif shape.mode == "prefill":
            want = RSP.prefill_specs(rcfg, shape, mesh, rules)
            got = SP.prefill_specs(cfg, shape, None, rules)
        else:
            long_ctx = name == "long_500k"
            want = RSP.decode_specs(rcfg, shape, mesh, rules,
                                    long_context=long_ctx)
            got = SP.decode_specs(cfg, shape, None, rules,
                                  long_context=long_ctx)
        assert _sig(got) == _sig(want), (arch, name)
    want = _repro_state(arch)
    assert _sig(SP.state_specs(cfg, OptimizerConfig(), None, rules)) == \
        _sig(want)
    assert _sig(SP.params_specs(cfg, None, rules)) == _sig(want["params"])
    assert SP.alive_spec(None).shape == (1,)
