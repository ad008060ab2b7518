"""Mixture-of-Experts layer: Llama-4-style top-k routing with GShard-style
capacity dispatch.

Port of ``repro.models.moe``, with its sharding constraints (experts
over the model axis).
Dispatch is a pair of one-hot einsums computed chunk by chunk over the
sequence, so the (tokens x experts x capacity) tensor never exceeds
(B, chunk, E, C).  Within a chunk each expert takes at most C tokens, in
token order; a token past its expert's capacity is dropped (its residual
keeps its value).  The load-balance (Switch) and router z-losses are
returned beside the output.

One-hot tensors are built by comparison with an ``arange``, never with
``F.one_hot``: an index past the capacity must give a zero row (as
``jax.nn.one_hot`` gives), and ``F.one_hot`` on CUDA checks its input on
the host.  Expert weights are in the config's ``param_dtype`` and cast
to the activation dtype once a call: a copy of every expert (8.81 GB a
layer for Scout in float32) unless the two dtypes agree, when the cast
is the weight itself.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import MoEConfig
from repro_torch.models import params as P
from repro_torch.models.mlp import mlp_apply, mlp_axes, mlp_init
from repro_torch.sharding import logical as L


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             cfg: MoEConfig, glu: bool, device: DeviceLike = None,
             lead: Tuple[int, ...] = (),
             dtype: torch.dtype = torch.float32) -> P.Params:
    """``router`` (d, E) at stddev 0.02, ``experts`` (an MLP's params with
    a leading E dim after ``lead``) and ``shared`` where the config has a
    shared expert, all in ``dtype``."""
    p = {"router": P.dense_init(generator, d_model, cfg.num_experts,
                                device=device, scale=0.02, lead=lead,
                                dtype=dtype),
         "experts": mlp_init(generator, d_model, d_ff, glu, device,
                             lead=(*lead, cfg.num_experts), dtype=dtype)}
    if cfg.shared_expert:
        p["shared"] = mlp_init(generator, d_model, d_ff, glu, device, lead,
                               dtype)
    return p


def moe_axes(cfg: MoEConfig, glu: bool) -> P.Axes:
    """:func:`moe_init`'s logical axes (``repro``'s): the experts' MLP
    axes behind an ``experts`` dim."""
    a = {"router": P.dense_axes("embed", "experts"),
         "experts": P.add_axes(mlp_axes(glu), "experts")}
    if cfg.shared_expert:
        a["shared"] = mlp_axes(glu)
    return a


def _capacity(chunk: int, cfg: MoEConfig) -> int:
    c = int(chunk * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts)
    return max(c, 1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _dispatch_mask(logits: torch.Tensor, cfg: MoEConfig, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits: (B, T, E) -> dispatch (B, T, E, C) of 0/1, combine (B, T,
    E, C) (dispatch times the token's router probability) and the router
    probabilities (B, T, E), all float32.

    Top-k by repeated argmax (the first maximum, as ``jnp.argmax``), each
    expert's buffer filled in token order from a running per-expert
    count (GShard position-in-expert)."""
    B, T, E = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    dispatch = torch.zeros((B, T, E, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    fill = torch.zeros((B, E), dtype=torch.int32, device=logits.device)
    masked = probs
    for _ in range(cfg.num_experts_per_tok):
        onehot = _one_hot(torch.argmax(masked, dim=-1), E)      # (B,T,E)
        gate = torch.sum(probs * onehot, dim=-1)                 # (B,T)
        pos_in_exp = torch.cumsum(onehot, dim=1) - onehot        # (B,T,E)
        pos = (torch.sum(pos_in_exp * onehot, dim=-1)
               + torch.sum(fill[:, None, :] * onehot, dim=-1))  # (B,T)
        keep = (pos < capacity).to(torch.float32)
        pos_oh = _one_hot(pos.to(torch.int32), capacity)         # (B,T,C)
        d = (onehot[..., None] * pos_oh[:, :, None, :]
             * keep[:, :, None, None])
        dispatch = dispatch + d
        combine = combine + d * gate[:, :, None, None]
        fill = fill + torch.sum(onehot, dim=1).to(torch.int32)
        masked = masked * (1.0 - onehot)                         # drop chosen
    return dispatch, combine, probs


def _experts(experts: P.Params, dispatch: torch.Tensor,
             combine: torch.Tensor, xc: torch.Tensor, act: str, glu: bool
             ) -> torch.Tensor:
    """A chunk's expert layer: dispatch (B, T, E, C) of xc (B, T, d) to
    the experts, their MLPs, and the combine back to (B, T, d).  The
    expert weights carry a leading E dim and are in xc's dtype."""
    ws = {n: experts[n]["w"] for n in experts}
    if not L.any_dtensor(dispatch, xc, *ws.values()):
        return _experts_local(ws, dispatch, combine, xc, act, glu)
    # DTensors: each rank's experts and rows on their local shards, the
    # combine a Partial sum over the ranks that shard the experts.  The
    # hidden layers then lie as repro constrains them, ("batch",
    # "experts", None, "embed" / "ff") with ff whole, since the experts
    # take the model axis.  (DTensor's own einsums merge the sharded
    # (E, C) dims into strided shards, whose redistribution plans cost
    # seconds a chunk on a 3-d mesh.)
    names = tuple(ws)
    tok, exp = ("b", None, "e", None), ("e", None, None)
    return L.local_call(
        lambda d, c, x, *w: _experts_local(dict(zip(names, w)), d, c, x, act,
                                           glu),
        (dispatch, combine, xc, *ws.values()),
        (tok, tok, ("b", None, None)) + (exp,) * len(names), ("b", "e"),
        (("b", None, None),), sums=(True,))


def _experts_local(ws: Dict[str, torch.Tensor], dispatch: torch.Tensor,
                   combine: torch.Tensor, xc: torch.Tensor, act: str,
                   glu: bool) -> torch.Tensor:
    h = torch.einsum("btec,btd->becd", dispatch.to(xc.dtype), xc)
    return torch.einsum("btec,becd->btd", combine.to(xc.dtype),
                        _expert_mlp(ws, h, act, glu))


def _expert_mlp(ws: Dict[str, torch.Tensor], h: torch.Tensor, act: str,
                glu: bool) -> torch.Tensor:
    """h: (B, E, C, d); expert weights (E, in, out) in h's dtype."""
    f = P.activation(act)
    up = torch.einsum("becd,edf->becf", h, ws["up"])
    if glu:
        mid = f(torch.einsum("becd,edf->becf", h, ws["gate"])) * up
    else:
        mid = f(up)
    return torch.einsum("becf,efd->becd", mid, ws["down"])


def moe_apply(p: P.Params, x: torch.Tensor, cfg: MoEConfig, act: str,
              glu: bool, chunk: int = 512, sums: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out, aux) with aux = {'lb_loss', 'z_loss'}, float32
    scalars.  The router's logits are float32; dispatch, the experts and
    the combine run in x's dtype, the combine weights rounded to it.

    With ``sums`` aux also holds ``'sums'`` (chunks, 2 E + 2) float32: a
    chunk's sums over its B T tokens of the dispatch counts (E), of the
    router probabilities (E) and of the squared logsumexp, then B T.  The
    losses are means of these, so a batch cut into row blocks gets its
    losses from the blocks' summed sums."""
    from repro_torch.models.transformer import divisor_block
    B, S, d = x.shape
    chunk = divisor_block(S, chunk)
    C = _capacity(chunk, cfg)
    # cast once a call (no copy where the params are in x's dtype); a
    # DTensor expert weight is gathered here, once, to the experts-only
    # layout every chunk's products use
    experts = P.tree_map_with_path(
        lambda _, w: L.keep_shard(w.to(x.dtype), 0), p["experts"])
    outs, lbs, zs, rows = [], [], [], []
    for c0 in range(0, S, chunk):
        xc = x[:, c0:c0 + chunk]
        logits = P.dense_apply(p["router"], xc.to(torch.float32),
                               torch.float32)                    # (B,T,E)
        dispatch, combine, probs = _dispatch_mask(logits, cfg, C)
        outs.append(L.constrain(
            _experts(experts, dispatch, combine, xc, act, glu),
            ("batch", "seq", "embed")))
        tokens = torch.sum(dispatch, dim=-1)
        frac_tokens = torch.mean(tokens, dim=(0, 1))
        frac_probs = torch.mean(probs, dim=(0, 1))
        lbs.append(cfg.num_experts * torch.sum(frac_tokens * frac_probs))
        z2 = torch.square(torch.logsumexp(logits, dim=-1))
        zs.append(torch.mean(z2))
        if sums:
            rows.append(torch.cat([
                torch.sum(tokens, dim=(0, 1)), torch.sum(probs, dim=(0, 1)),
                torch.sum(z2).reshape(1),
                torch.full((1,), float(z2.numel()), device=x.device)]))
    out = torch.cat(outs, dim=1)
    if cfg.shared_expert:
        out = out + mlp_apply(p["shared"], x, act, glu)
    aux = {"lb_loss": torch.mean(torch.stack(lbs)),
           "z_loss": torch.mean(torch.stack(zs))}
    if sums:
        aux["sums"] = torch.stack(rows)
    return out, aux
