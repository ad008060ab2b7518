"""Plain PyTorch oracles for the port's kernels (the allclose targets).

Port of ``repro.kernels.ref``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None
                        ) -> torch.Tensor:
    """Naive O(S^2) attention.  q (B,Sq,H,D); k,v (B,Sk,KVH,D)."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(D)
    dpos = (torch.arange(Sq, device=q.device)[:, None]
            - torch.arange(Sk, device=q.device)[None, :])
    ok = torch.ones(dpos.shape, dtype=torch.bool, device=q.device)
    if causal:
        ok &= dpos >= 0
    if window is not None:
        ok &= dpos < window
    s = torch.where(ok[None, :, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def rwkv6_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV6.  r,k,v,w: (B,S,H,N) f32; u: (H,N); state0: (B,H,N,N).

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S + k v^T.
    Returns (y (B,S,H,N), final state (B,H,N,N))."""
    state = state0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", rt,
                               state + u[None, :, :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, dim=1), state


def rglru_reference(a_t: torch.Tensor, b_t: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential diagonal linear recurrence h_t = a_t h_{t-1} + b_t.
    a_t, b_t: (B,S,W) f32; h0: (B,W) or None."""
    h = torch.zeros_like(a_t[:, 0]) if h0 is None else h0
    hs = []
    for t in range(a_t.shape[1]):
        h = a_t[:, t] * h + b_t[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def tolfl_combine_reference(gs: torch.Tensor, ns: torch.Tensor
                            ) -> torch.Tensor:
    """Streaming weighted mean over the leading axis of a stacked gradient
    block.  gs: (K, ...) f32; ns: (K,) f32.  Equals the direct weighted
    mean (the paper's k-invariance)."""
    n = torch.zeros((), dtype=torch.float32, device=gs.device)
    g = torch.zeros_like(gs[0])
    for i in range(gs.shape[0]):
        n_new = n + ns[i]
        r = torch.where(n_new > 0, ns[i] / torch.clamp_min(n_new, 1e-30),
                        torch.zeros_like(n_new))
        g = (1 - r) * g + r * gs[i]
        n = n_new
    return g
