"""Tol-FL round aggregation: the streaming weighted-mean combine and the
round's fused aggregation, each a Hopper kernel beside its plain PyTorch
version.

Port of ``repro.kernels.tolfl_combine`` (a Pallas TPU kernel).  Both
kernels are hand-written CUDA C++ for ``sm_90a`` in one source,
``repro_torch/csrc/tolfl_combine.cu``, sharing one column loop:

* :func:`tolfl_combine`: the streaming combine over (k, P) stacked
  cluster gradients, each read once, the k-step recurrence in registers;
  ``(k + 1) * P * 4`` bytes moved.
* :func:`tolfl_round_update`: a round's whole aggregation for S
  scenarios at once: the per-cluster FedAvg of the (S, N, P) device
  deltas, the streaming combine across cluster heads and the gated SGD
  step, ``(S N P + 2 S P) * 4`` bytes moved and no (k, P) intermediate.
  The round loop calls it (``aggregation.round_update``).

Each entry point launches its kernel on a CUDA device and runs its plain
version on the CPU; there is no fallback from one to the other.
``LAUNCHES`` and ``ROUND_LAUNCHES`` count kernel launches, so a run can
show that its aggregation went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import _build

#: kernel launches in this process (one per :func:`tolfl_combine_cuda`)
LAUNCHES = 0
#: fused kernel launches (one per :func:`tolfl_round_update_cuda`)
ROUND_LAUNCHES = 0


class RoundCase(NamedTuple):
    """A test case of the fused kernel (:func:`round_inputs` makes its
    operands).  counts: "paper" (``[1125] * 6 + [0] * 4``), "zero" or
    "random"; ids: "contiguous" (``i * k // N``, the paper's clusters),
    "padded" (``i * 5 // N`` of a larger k: empty cluster slots),
    "sparse" (``2 * (i // 2)``: an empty cluster between each two) or
    "random"; misaligned: the float operands start 4 bytes past a 16-byte
    boundary."""
    name: str
    S: int
    N: int
    k: int
    P: int
    counts: str = "paper"
    dead: Tuple[int, ...] = ()
    ids: str = "contiguous"
    faulty: bool = False
    misaligned: bool = False


#: the fused kernel's cases on the card, shared by tests/test_torch_cuda.py
#: and chip_smoke.py: the paper's round (N = 10, k = 5, P = 49,680) and its
#: edges, above 16 devices (the chunked member loop), ragged or misaligned
#: columns (the scalar loads), 64 scenarios, and a fused campaign sweep's
#: 96 scenarios with the cluster axis padded to 10
ROUND_CARD_CASES = [
    RoundCase("paper", 1, 10, 5, 49_680),
    RoundCase("dead_head", 1, 10, 5, 49_680, dead=(2, 3)),
    RoundCase("all_zero", 1, 10, 5, 49_680, counts="zero"),
    RoundCase("k1", 1, 10, 1, 49_680),
    RoundCase("kN", 1, 10, 10, 49_680, dead=(4,)),
    RoundCase("padded_k", 1, 10, 8, 49_680, ids="padded"),
    RoundCase("sparse_ids", 2, 10, 10, 49_680, ids="sparse"),
    RoundCase("faulty", 1, 10, 5, 49_680, faulty=True),
    RoundCase("ragged_p", 1, 10, 5, 49_681, faulty=True),
    RoundCase("misaligned", 2, 10, 5, 49_680, faulty=True, misaligned=True),
    RoundCase("tiny", 3, 7, 3, 6, counts="random", ids="random",
              faulty=True),
    RoundCase("many_devices", 4, 20, 4, 1_001, counts="random", dead=(5,),
              ids="random", faulty=True),
    RoundCase("many_devices_vec", 2, 40, 6, 4_096, counts="random",
              ids="random"),
    RoundCase("scenarios", 64, 10, 5, 49_680, faulty=True),
    RoundCase("campaign_sweep", 96, 10, 10, 49_680, ids="padded"),
]


def round_inputs(case: RoundCase, generator: torch.Generator):
    """Seeded operands (gs, counts, w, scale, cluster_ids, params) of
    ``case`` on ``generator``'s device.  With S > 1 each scenario also
    loses a random fifth of its devices; a faulty channel scales by
    values in [-1.5, 1.5), every third device's by 0."""
    dev = generator.device
    S, N, k, P = case.S, case.N, case.k, case.P

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)
    gs = torch.randn((S, N, P), generator=generator, device=dev)
    if case.counts == "paper":
        counts = torch.tensor([1125.0] * 6 + [0.0] * (N - 6), device=dev)
    elif case.counts == "zero":
        counts = torch.zeros((N,), device=dev)
    else:
        counts = torch.randint(0, 2251, (N,), generator=generator,
                               device=dev).to(torch.float32)
    w = torch.ones((S, N), device=dev)
    w[:, list(case.dead)] = 0.0
    if S > 1:
        w = w * (rand(S, N) > 0.2).to(torch.float32)
    scale = None
    if case.faulty:
        scale = rand(S, N) * 3.0 - 1.5
        scale[:, ::3] = 0.0
    rows = torch.arange(N, device=dev)
    ids = {"contiguous": rows * k // N, "padded": rows * 5 // N,
           "sparse": rows // 2 * 2}.get(case.ids)
    if ids is None:
        ids = torch.randint(0, k, (S, N), generator=generator, device=dev)
    ids = ids.expand(S, N).to(torch.int32).contiguous()
    params = torch.randn((S, P), generator=generator, device=dev)
    out = [gs, counts, w, scale, ids, params]
    if case.misaligned:
        for i, t in enumerate(out):
            if t is not None and t.dtype == torch.float32:
                buf = torch.empty((t.numel() + 1,), device=dev)
                out[i] = buf[1:].view(t.shape)
                out[i].copy_(t)
    return tuple(out)


def tolfl_combine_plain(gs: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """The k-step loop of ``combine_pair`` on tensors, with the kernel's
    exact order of rounded operations: on the card the kernel equals it
    bit for bit.  gs: (k, P) f32; ns: (k,) f32 -> (P,) f32."""
    tot = torch.zeros((), dtype=torch.float32, device=gs.device)
    acc = torch.zeros(gs.shape[1:], dtype=torch.float32, device=gs.device)
    for i in range(gs.shape[0]):
        tot = tot + ns[i]
        r = torch.where(tot > 0, ns[i] / torch.clamp_min(tot, 1e-30),
                        torch.zeros_like(tot))
        acc = (1.0 - r) * acc + r * gs[i]
    return acc


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors with one rounding, as the card's
    ``fmaf``: the product is exact in float64, the float64 sum is rounded
    to odd (an inexact sum takes the neighbour with an odd last bit), and
    float64's 29 extra bits then make the rounding to float32 correct."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    back = s - p                                   # TwoSum: s + err == p + c
    err = (p - (s - back)) + (c - back)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    odd = torch.where((err != 0) & even & torch.isfinite(s),
                      torch.nextafter(s, toward), s)
    return odd.to(torch.float32)


def tolfl_round_update_plain(gs: torch.Tensor, counts: torch.Tensor,
                             w: torch.Tensor, scale: Optional[torch.Tensor],
                             cluster_ids: torch.Tensor, params: torch.Tensor,
                             lr: float, k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A round's aggregation for S scenarios with the fused kernel's exact
    order of rounded operations: on the card the kernel equals it bit for
    bit.  Per scenario: ``ns = counts * w``; each cluster's FedAvg takes
    its members in device order, ``num = fma(g * scale, ns, num)`` and
    ``n_c += ns`` from 0, and divides by ``max(n_c, 1e-30)``; the clusters
    stream into the combine in order; the params step by
    ``(lr * has_update) * g``.  The fused multiply-add is how XLA
    accumulates ``repro``'s one-hot product at k = 1.

    gs: (S, N, P); counts: (N,); w, scale (or None): (S, N); cluster_ids:
    (S, N) int32; params: (S, P), all f32 but the ids.  Returns the new
    params (S, P) and the total counts n_tot (S,)."""
    S, N, P = gs.shape
    dev = gs.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ns = counts[None, :] * w                                    # (S, N)
    member = cluster_ids[:, :, None] == torch.arange(k, device=dev)
    n_c = torch.zeros((S, k), dtype=torch.float32, device=dev)
    num = torch.zeros((S, k, P), dtype=torch.float32, device=dev)
    for i in range(N):
        g = gs[:, i] if scale is None else gs[:, i] * scale[:, i, None]
        n_c = torch.where(member[:, i], n_c + ns[:, i, None], n_c)
        num = torch.where(member[:, i, :, None],
                          fma(g[:, None], ns[:, i, None, None], num), num)
    tot = torch.zeros((S,), dtype=torch.float32, device=dev)
    acc = torch.zeros((S, P), dtype=torch.float32, device=dev)
    for c in range(k):
        red = num[:, c] / torch.clamp_min(n_c[:, c], 1e-30)[:, None]
        tot = tot + n_c[:, c]
        r = torch.where(tot > 0, n_c[:, c] / torch.clamp_min(tot, 1e-30),
                        zero)
        acc = (1.0 - r)[:, None] * acc + r[:, None] * red
    has_update = (tot > 0).to(torch.float32)
    return params - (lr * has_update)[:, None] * acc, tot


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("tolfl_combine").tolfl_combine_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _round_entry():
    fn = _build.load("tolfl_combine").tolfl_round_update_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _empty_entry():
    fn = _build.load("tolfl_combine").tolfl_empty_f32
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(gs: torch.Tensor, ns: torch.Tensor) -> None:
    if gs.dim() != 2:
        raise ValueError(f"gs must be (k, P), got shape {tuple(gs.shape)}")
    k, P = gs.shape
    if k < 1 or P < 1:
        raise ValueError(f"gs must have k >= 1 and P >= 1, got {(k, P)}")
    if tuple(ns.shape) != (k,):
        raise ValueError(f"ns must be ({k},), got {tuple(ns.shape)}")
    for name, t in (("gs", gs), ("ns", ns)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if gs.device != ns.device:
        raise ValueError(f"gs on {gs.device} but ns on {ns.device}")


def tolfl_combine_cuda(gs: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    global LAUNCHES
    _check(gs, ns)
    if gs.device.type != "cuda":
        raise ValueError(f"tolfl_combine_cuda needs CUDA tensors, got "
                         f"{gs.device}")
    if not (gs.is_contiguous() and ns.is_contiguous()):
        raise ValueError("gs and ns must be contiguous")
    k, P = gs.shape
    out = torch.empty((P,), dtype=torch.float32, device=gs.device)
    with torch.cuda.device(gs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(gs.data_ptr(), ns.data_ptr(), out.data_ptr(), k, P,
                       stream)
    if err != 0:
        raise RuntimeError(f"tolfl_combine kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out


def _on(device: DeviceLike, **tensors) -> torch.device:
    """The device asked for (``None`` means CUDA; the meta device, where
    nothing executes, takes the plain version as the CPU does); raises if
    a tensor lies elsewhere."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device(device) if meta else resolve_device(device)
    for name, t in tensors.items():
        if t is not None and (t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index)):
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    return dev


def tolfl_combine(gs: torch.Tensor, ns: torch.Tensor,
                  device: DeviceLike = None) -> torch.Tensor:
    """gs: (k, P) stacked flattened cluster gradients (f32); ns: (k,)
    sample counts.  Returns the Tol-FL combined gradient (P,).

    The one entry point of the combine (``ops.tolfl_combine`` re-exports
    it).  ``device=None`` means CUDA, where the kernel launches or the
    call raises; ``device="cpu"`` runs the plain version.  The tensors
    must already lie on that device."""
    if _on(device, gs=gs, ns=ns).type == "cuda":
        return tolfl_combine_cuda(gs, ns)
    _check(gs, ns)
    return tolfl_combine_plain(gs, ns)


def _check_round(gs, counts, w, scale, cluster_ids, params, k) -> None:
    if gs.dim() != 3:
        raise ValueError(f"gs must be (S, N, P), got shape {tuple(gs.shape)}")
    S, N, P = gs.shape
    if min(S, N, P) < 1 or k < 1:
        raise ValueError(f"need S, N, P, k >= 1, got {(S, N, P, k)}")
    want = {"counts": (counts, (N,), torch.float32),
            "w": (w, (S, N), torch.float32),
            "scale": (scale, (S, N), torch.float32),
            "cluster_ids": (cluster_ids, (S, N), torch.int32),
            "params": (params, (S, P), torch.float32)}
    if gs.dtype != torch.float32:
        raise TypeError(f"gs must be float32, got {gs.dtype}")
    for name, (t, shape, dtype) in want.items():
        if t is None and name == "scale":
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != gs.device:
            raise ValueError(f"{name} on {t.device} but gs on {gs.device}")


def tolfl_round_update_cuda(gs: torch.Tensor, counts: torch.Tensor,
                            w: torch.Tensor, scale: Optional[torch.Tensor],
                            cluster_ids: torch.Tensor, params: torch.Tensor,
                            lr: float, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused kernel on PyTorch's current stream.  The cluster
    ids are not checked on the device (that would sync the round loop):
    an id outside [0, k) makes its device a member of no cluster."""
    global ROUND_LAUNCHES
    _check_round(gs, counts, w, scale, cluster_ids, params, k)
    if gs.device.type != "cuda":
        raise ValueError(f"tolfl_round_update_cuda needs CUDA tensors, got "
                         f"{gs.device}")
    if not all(t.is_contiguous() for t in (gs, counts, w, cluster_ids, params)
               ) or not (scale is None or scale.is_contiguous()):
        raise ValueError("the operands must be contiguous")
    S, N, P = gs.shape
    out = torch.empty((S, P), dtype=torch.float32, device=gs.device)
    n_tot = torch.empty((S,), dtype=torch.float32, device=gs.device)
    with torch.cuda.device(gs.device):
        err = _round_entry()(
            gs.data_ptr(), counts.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            cluster_ids.data_ptr(), params.data_ptr(), out.data_ptr(),
            n_tot.data_ptr(), S, N, k, P, lr,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tolfl_round_update kernel launch failed: CUDA "
                           f"error {err}")
    ROUND_LAUNCHES += 1
    return out, n_tot


def tolfl_round_update(gs: torch.Tensor, counts: torch.Tensor,
                       w: torch.Tensor, scale: Optional[torch.Tensor],
                       cluster_ids: torch.Tensor, params: torch.Tensor,
                       lr: float, k: int, device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Tol-FL round's aggregation for S scenarios: per-cluster FedAvg of
    the device deltas ``gs`` (S, N, P) scaled by ``scale`` (S, N) (or
    None), weighted by ``counts * w``; the streaming combine over the k
    clusters; the SGD step of ``params`` (S, P) gated on a nonzero total
    count.  Returns the new params (S, P) and the total counts (S,).

    ``device=None`` means CUDA, where the fused kernel launches or the
    call raises; ``device="cpu"`` runs the plain version."""
    if _on(device, gs=gs, counts=counts, w=w, scale=scale,
           cluster_ids=cluster_ids, params=params).type == "cuda":
        return tolfl_round_update_cuda(gs, counts, w, scale, cluster_ids,
                                       params, lr, k)
    _check_round(gs, counts, w, scale, cluster_ids, params, k)
    return tolfl_round_update_plain(gs, counts, w, scale, cluster_ids,
                                    params, lr, k)


def empty_launch(S: int, P: int) -> None:
    """Launch an empty kernel on the fused kernel's grid for (S, P) on the
    current stream: the launch floor its time is read against."""
    err = _empty_entry()(S, P, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def tolfl_combine_tree(gs_tree, ns: torch.Tensor,
                       device: DeviceLike = None):
    """Apply the combine leaf-wise over a stacked gradient tree (leaves
    (k, ...)); returns a tree of (...) leaves."""
    if isinstance(gs_tree, dict):
        return {key: tolfl_combine_tree(v, ns, device)
                for key, v in gs_tree.items()}
    k = gs_tree.shape[0]
    flat = gs_tree.reshape(k, -1).to(torch.float32).contiguous()
    return tolfl_combine(flat, ns, device).reshape(gs_tree.shape[1:]).to(
        gs_tree.dtype)
