"""Port parity for serving: every arch of the zoo -- RecurrentGemma,
RWKV6, the dense GQA decoders (Granite-3-2B, InternLM2-1.8B, Qwen1.5-0.5B,
Qwen3-8B), whisper-large-v3 (encoder-decoder), Llama-4 Scout and Maverick
(MoE) and InternVL2-26B (vision prefix) -- prefill, ``pad_cache`` and
greedy ``decode_step`` against ``repro``'s ``prefill(..., use_pallas=True)``
(its Pallas kernels in interpret mode) and ``decode_step``, the configs,
the cache tree and the launcher.

RecurrentGemma's reduced config (one recurrent + one local-attention
layer, d 256, window 64) runs at (B, S) = (2, 96), so the prompt is
longer than the window and ``pad_cache`` rolls the ring; a 5-layer (rec,
rec, local) variant adds the tail layers.  RWKV6's reduced config (two
RWKV6 layers, d 256, 4 heads of 64) runs at (2, 128): ``repro``'s Pallas
WKV kernel tiles time in blocks of 64.  The dense decoders' reduced
configs (two attention layers, d 256, 4 heads of 64 on 4 kv heads; QKV
bias for Qwen1.5, qk-norm for Qwen3, also on 2 kv heads) run at (2, 96)
with full-length caches.  Whisper's reduced config (2 encoder and 2
decoder layers, d 256, 4 heads of 64, QKV bias, sinusoidal positions,
GELU MLP without gate) runs at (2, 96) on 16 frames; the reduced Scout
(4 experts, top-1, capacity 1.25, a shared expert) and Maverick (its
2-layer unit: MoE, then dense) at (2, 96), where a 96-token chunk's
capacity of 30 drops tokens; InternVL2's at 16 patches + 80 tokens.
Frames and patches come from numpy like the prompts.  Params come from
``repro``'s ``init_params`` through the weight bridge.  Logits
and every cache leaf agree within rtol = atol = 1e-4 (float32 sums in
another order; ``repro``'s own two paths differ by ~1e-6 here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import transformer as JT
from repro.serving import decode as JD
from repro_torch.configs import base as TB
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.serving import decode as TD
from repro_torch.serving.inputs import synthetic_batch

TOL = dict(rtol=1e-4, atol=1e-4)
B, STEPS = 2, 3
RG = "recurrentgemma-9b"
#: the dense GQA decoders (full-length caches, no window)
DENSE = ("granite-3-2b", "internlm2-1.8b", "qwen1.5-0.5b", "qwen3-8b")
WHISPER, VLM = "whisper-large-v3", "internvl2-26b"
MOE = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b")
#: prompt lengths inside the Pallas kernels' block domains (one block of
#: queries up to 256 for attention, 64-step WKV blocks); InternVL2's 80
#: tokens follow its reduced 16-patch prefix
PROMPT = {RG: 96, "rwkv6-7b": 128, **{a: 96 for a in DENSE + MOE},
          WHISPER: 96, VLM: 80}
#: (arch, layers): the reduced configs, RecurrentGemma's tail variant and
#: the dense decoders, which ``reduced()`` cuts to 4 heads on 4 kv heads;
#: layers -2 keeps 2 layers on 2 kv heads, so the reduced Qwen3 is a GQA
#: decoder with qk-norm; -3 sets its ``norm_eps`` to 0.25, which the
#: qk-norm must follow as ``repro``'s does
ARCH_CASES = ([pytest.param(RG, 2, id="2"), pytest.param(RG, 5, id="5"),
               pytest.param("rwkv6-7b", 2, id="rwkv6-7b")]
              + [pytest.param(a, 2, id=a) for a in DENSE]
              + [pytest.param("qwen3-8b", -2, id="qwen3-8b-gqa"),
                 pytest.param("qwen3-8b", -3, id="qwen3-8b-norm-eps")]
              + [pytest.param(a, 2, id=a) for a in (WHISPER, *MOE, VLM)])


def _variant(cfg, n_layers):
    if n_layers == 2:
        return cfg
    if n_layers == -2:
        return dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, num_kv_heads=2))
    if n_layers == -3:
        return dataclasses.replace(cfg, norm_eps=0.25)
    return dataclasses.replace(cfg, num_layers=n_layers, recurrent=(
        dataclasses.replace(cfg.recurrent, block_pattern=(
            TB.RECURRENT, TB.RECURRENT, TB.LOCAL_ATTN))))


def _cfgs(n_layers, arch=RG):
    return (_variant(JARCHS[arch].reduced(), n_layers),
            _variant(TARCHS[arch].reduced(), n_layers))


def _close_trees(jtree, ttree):
    jitems = TP.tree_items(jax.tree.map(np.asarray, jtree))
    titems = TP.tree_items(ttree)
    assert [p for p, _ in jitems] == [p for p, _ in titems]
    for (path, a), (_, b) in zip(jitems, titems):
        assert a.shape == tuple(b.shape), path
        np.testing.assert_allclose(b.numpy(), a, err_msg=str(path), **TOL)


def _inputs(jcfg, seed, S, total):
    """numpy prompt tokens (B, total), and 'frames' / 'prefix' (B, 16, d)
    float32 where the config takes them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (B, total))}
    if jcfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    if jcfg.frontend.kind == "vision":
        out["prefix"] = rng.standard_normal(
            (B, jcfg.frontend.frontend_seq, jcfg.d_model)).astype(np.float32)
    return out


def _batches(inp, S):
    """repro's and the port's prefill batches of the first S tokens."""
    jb = {k: jnp.asarray(v[:, :S], jnp.int32) if k == "tokens"
          else jnp.asarray(v) for k, v in inp.items()}
    tb = {k: torch.from_numpy(v[:, :S] if k == "tokens" else v)
          for k, v in inp.items()}
    return jb, tb


@pytest.mark.parametrize("arch,n_layers", ARCH_CASES)
def test_prefill_pad_decode_match_repro(arch, n_layers):
    jcfg, tcfg = _cfgs(n_layers, arch)
    S = PROMPT[arch]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TP.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    assert TT.unit_counts(tcfg) == JT.unit_counts(jcfg)
    inp = _inputs(jcfg, abs(n_layers), S, S + STEPS)
    toks = inp["tokens"]
    # a vision prefix's patches take the first positions
    P0 = inp["prefix"].shape[1] if "prefix" in inp else 0

    jb, tb = _batches(inp, S)
    jl, jc = JD.prefill(jp, jcfg, jb, use_pallas=True)
    tl, tc = TD.prefill(tp, tcfg, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_trees(jc, tc)

    jc = JD.pad_cache(jc, jcfg, prompt_len=P0 + S, target_len=P0 + S + STEPS)
    tc = TD.pad_cache(tc, tcfg, prompt_len=P0 + S, target_len=P0 + S + STEPS)
    _close_trees(jc, tc)
    for t in range(S, S + STEPS):
        jl, jc = JD.decode_step(jp, jcfg, jnp.asarray(toks[:, t:t + 1],
                                                      jnp.int32), jc,
                                jnp.int32(P0 + t))
        tl, tc = TD.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                tc, P0 + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_trees(jc, tc)


@pytest.mark.parametrize("prompt,target", [(96, 99), (70, 75), (40, 50),
                                           (64, 64), (128, 130)])
def test_pad_cache_rolls_and_pads_like_repro(prompt, target):
    """Windowed layers keep their window and roll by prompt % Sc; full
    attention layers are padded with zero slots."""
    jcfg, tcfg = _cfgs(5)
    cfg_full = dataclasses.replace(jcfg, recurrent=dataclasses.replace(
        jcfg.recurrent, block_pattern=(TB.RECURRENT, TB.ATTN)))
    rng = np.random.default_rng(prompt)
    for jc, tc in ((jcfg, tcfg), (cfg_full, dataclasses.replace(
            tcfg, recurrent=dataclasses.replace(
                tcfg.recurrent, block_pattern=(TB.RECURRENT, TB.ATTN))))):
        shapes = JD.cache_shape(jc, 2, prompt)
        cache = jax.tree.map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
        want = JD.pad_cache(jax.tree.map(jnp.asarray, cache), jc, prompt,
                            target)
        got = TD.pad_cache(TP.from_numpy_tree(cache, device="cpu"), tc,
                           prompt, target)
        _close_trees(want, got)


@pytest.mark.parametrize("arch,n_layers", ARCH_CASES)
def test_cache_shape_and_init_cache(arch, n_layers):
    jcfg, tcfg = _cfgs(n_layers, arch)
    for seq_len in (16, 200):
        want = JD.cache_shape(jcfg, 3, seq_len)
        got = TD.cache_shape(tcfg, 3, seq_len)
        jitems = TP.tree_items(want)
        titems = TP.tree_items(got)
        assert [p for p, _ in jitems] == [p for p, _ in titems]
        for (_, a), (_, b) in zip(jitems, titems):
            assert a.shape == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    zeros = TD.init_cache(tcfg, 2, 16, device="cpu")
    assert all(not x.any() for _, x in TP.tree_items(zeros))


@pytest.mark.parametrize("arch,n_layers", [(RG, 5), ("rwkv6-7b", 2)]
                         + [(a, 2) for a in DENSE + (WHISPER, VLM) + MOE])
def test_init_params_has_repros_tree(arch, n_layers):
    """Same keys and shapes as repro's init, all float32; the stacked
    units hold independent draws."""
    jcfg, tcfg = _cfgs(n_layers, arch)
    want = jax.eval_shape(lambda k: JT.init_params(k, jcfg)[0],
                          jax.random.PRNGKey(0))
    got = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    jitems, titems = TP.tree_items(want), TP.tree_items(got)
    assert [p for p, _ in jitems] == [p for p, _ in titems]
    for (_, a), (_, b) in zip(jitems, titems):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
    if arch == RG:
        lam = got["units"]["l0"]["mix"]["lam"]
        a = torch.sigmoid(lam)
        assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    elif arch in MOE:
        mlp = got["units"]["l0"]["mlp"]
        E = tcfg.moe.num_experts
        assert mlp["experts"]["up"]["w"].shape[:2] == (
            TT.unit_counts(tcfg)[0], E)
        assert not torch.equal(mlp["experts"]["up"]["w"][0, 0],
                               mlp["experts"]["up"]["w"][0, 1])
        assert float(mlp["router"]["w"].std()) < 0.03     # stddev 0.02
        assert "shared" in mlp
    elif arch == WHISPER:
        enc, cross = got["encoder"]["layers"], got["cross"]["layers"]
        assert enc["attn"]["q"]["w"].shape[0] == tcfg.num_encoder_layers
        assert cross["attn"]["q"]["w"].shape[0] == tcfg.num_layers
        assert "gate" not in enc["mlp"] and "b" in cross["attn"]["k"]
    elif arch in DENSE + (VLM,):
        mix = got["units"]["l0"]["mix"]
        assert ("b" in mix["q"]) == tcfg.attention.qkv_bias
        assert ("q_norm" in mix) == tcfg.attention.qk_norm
        if tcfg.attention.qk_norm:
            assert torch.equal(mix["k_norm"]["scale"],
                               torch.ones_like(mix["k_norm"]["scale"]))
    else:
        ln = got["units"]["l0"]["mix"]["ln_x"]
        assert torch.equal(ln["scale"], torch.ones_like(ln["scale"]))
        assert not torch.equal(got["units"]["l0"]["mix"]["r"]["w"][0],
                               got["units"]["l0"]["mix"]["r"]["w"][1])
    again = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(titems, TP.tree_items(again)))


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_configs_equal_repros(arch):
    jcfg, tcfg = JARCHS[arch], TARCHS[arch]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.layer_pattern == jcfg.layer_pattern
    assert tcfg.param_count() == jcfg.param_count()
    assert dataclasses.asdict(tcfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert tcfg.reduced().param_count() == jcfg.reduced().param_count()
    assert TT.padded_vocab(tcfg) == JT.padded_vocab(jcfg)
    assert TT.unit_pattern(tcfg) == JT.unit_pattern(jcfg)
    assert TT.unit_counts(tcfg) == JT.unit_counts(jcfg)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_every_repro_arch_resolves(arch):
    """get_arch gives each of repro's ten ids its config, and the reduced
    config's init and cache tree have repro's keys and shapes."""
    assert set(TARCHS) == set(JARCHS)
    tcfg = get_arch(arch)
    assert tcfg is TARCHS[arch] and tcfg.name == arch
    jcfg = JARCHS[arch].reduced()
    want = jax.eval_shape(lambda k: JT.init_params(k, jcfg)[0],
                          jax.random.PRNGKey(0))
    got = TT.init_params(torch.Generator().manual_seed(1), tcfg.reduced(),
                         "cpu")
    assert [(p, tuple(x.shape)) for p, x in TP.tree_items(want)] == \
        [(p, tuple(x.shape)) for p, x in TP.tree_items(got)]


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


@pytest.mark.parametrize("arch,n_layers", [(WHISPER, 2), (VLM, 2)])
def test_pad_cache_keeps_cross_and_prefix_positions(arch, n_layers):
    """pad_cache leaves whisper's cross k / v as they were (the same
    tensors) and pads the self-attention cache past the prompt; with a
    vision prefix the prompt length counts the patches."""
    _, tcfg = _cfgs(n_layers, arch)
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    batch = synthetic_batch(tcfg, 2, 24, torch.Generator().manual_seed(1),
                            "cpu")
    n = 24 + (batch["prefix"].shape[1] if "prefix" in batch else 0)
    _, cache = TD.prefill(tp, tcfg, batch)
    padded = TD.pad_cache(cache, tcfg, n, n + 5)
    k = padded["units"]["l0"]["k"]
    assert k.shape[2] == n + 5 and torch.equal(k[:, :, :n],
                                               cache["units"]["l0"]["k"])
    assert not k[:, :, n:].any()
    if arch == WHISPER:
        assert padded["cross"]["k"] is cache["cross"]["k"]
        assert padded["cross"]["k"].shape == (
            tcfg.num_layers, 2, tcfg.encoder_seq,
            tcfg.attention.num_kv_heads, tcfg.attention.head_dim)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = TARCHS["recurrentgemma-9b"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--prompt", "8", "--tokens", "2"])


def test_synthetic_batch_is_seeded():
    cfg = TARCHS["recurrentgemma-9b"].reduced()
    a = synthetic_batch(cfg, 2, 9, torch.Generator().manual_seed(3), "cpu")
    b = synthetic_batch(cfg, 2, 9, torch.Generator().manual_seed(3), "cpu")
    assert a["tokens"].shape == (2, 9) and torch.equal(a["tokens"],
                                                       b["tokens"])
    assert int(a["tokens"].max()) < cfg.vocab_size


def test_serve_launcher_runs_on_cpu(capsys):
    assert tserve.main(["--device", "cpu", "--batch", "2", "--prompt", "70",
                        "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-9b-reduced" in out and "device=cpu" in out
    assert "prefill:" in out and "decode:" in out and "sample[0]" in out


def test_serve_launcher_runs_rwkv6_on_cpu(capsys):
    test_serve_launcher_runs_arch_on_cpu(capsys, "rwkv6-7b")


@pytest.mark.parametrize("arch", [WHISPER, *MOE, VLM])
def test_serve_launcher_runs_arch_on_cpu(capsys, arch):
    assert tserve.main(["--arch", arch, "--device", "cpu", "--batch",
                        "2", "--prompt", "33", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "device=cpu" in out
    assert "prefill:" in out and "decode:" in out and "sample[0]" in out
