"""``chip_smoke.py``'s ``[train-reference]`` readings on the CPU: a
gradient 1% off in one output of either backward lands above
``TRAIN_REF_TOL``, and a step whose WKV scan runs in float64 (a rounding
apart from the float32 one) lands below it.  The card stands in nowhere
here: both sides of each reading are CPU steps of ``repro_torch``."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.configs.base import OptimizerConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wk  # noqa: E402
from repro_torch.models import params as P  # noqa: E402

OCFG = OptimizerConfig(name="sgd", lr=0.05, schedule="constant",
                       warmup_steps=0, grad_clip=0.0)


def _step(arch, seed=0):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), num_layers=1)
    state = D.init_state(torch.Generator().manual_seed(9), cfg, OCFG)
    return cfg, state, chip_smoke._train_reference_step(
        torch, cfg, "cpu", OCFG, state, seed)


def _readings(arch, monkeypatch, module, name, wrap):
    cfg, state, want = _step(arch)
    monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    got = chip_smoke._train_reference_step(torch, cfg, "cpu", OCFG, state, 0)
    (g, _), (p, _) = chip_smoke._train_reference_diff(P, got, want, state)
    return g, p


def _scaled(i):
    def wrap(fn):
        def off(*args):
            out = list(fn(*args))
            out[i] = out[i] * 1.01
            return tuple(out)
        return off
    return wrap


@pytest.mark.parametrize("i,grad", list(enumerate(("dr", "dk", "dv", "dw",
                                                     "du"))))
def test_wkv_gradient_one_percent_off_fails(monkeypatch, i, grad):
    g, p = _readings("rwkv6-7b", monkeypatch, wk, "rwkv6_scan_backward_plain",
                     _scaled(i))
    assert g > chip_smoke.TRAIN_REF_TOL and p > chip_smoke.TRAIN_REF_TOL, \
        (grad, g, p)


@pytest.mark.parametrize("i,grad", list(enumerate(("dq", "dk", "dv"))))
def test_attention_gradient_one_percent_off_fails(monkeypatch, i, grad):
    g, p = _readings("qwen1.5-0.5b", monkeypatch, fa,
                     "flash_attention_backward_plain", _scaled(i))
    assert g > chip_smoke.TRAIN_REF_TOL and p > chip_smoke.TRAIN_REF_TOL, \
        (grad, g, p)


def test_float64_wkv_scan_passes(monkeypatch):
    """A rounding apart: the WKV scan in float64, rounded to float32."""
    g, p = _readings("rwkv6-7b", monkeypatch, ops, "rwkv6",
                     lambda fn: chip_smoke._wkv_float64(torch))
    assert g <= chip_smoke.TRAIN_REF_TOL and p <= chip_smoke.TRAIN_REF_TOL, \
        (g, p)
