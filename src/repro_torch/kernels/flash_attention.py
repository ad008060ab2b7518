"""Flash attention: the Hopper kernels and their plain PyTorch version.

Port of ``repro.kernels.flash_attention`` (a Pallas TPU kernel):
online-softmax GQA attention with a causal and a sliding-window mask,
float32 scores and accumulators, output in the inputs' dtype, ragged
sequence lengths masked.  It is bound by its operations (4 B H D flops
per visible (query, key) pair).  Two hand-written CUDA C++ kernels for
``sm_90a`` compute it; :func:`route` picks one from the dtype and the
head dim D, with no fallback from one to the other:

- ``"tensor_core"``, ``repro_torch/csrc/flash_attention_wgmma.cu``:
  bfloat16 at D in {64, 128, 256}.  wgmma on the bf16 tensor cores, K/V
  tiles brought by TMA, warpgroups of 64 (query, head) rows.  At D = 256
  two warpgroups share a two-stage ring; at D 64 and 128 a producer warp
  keeps a ring of 4 and 3 stages full for 3 and 2 warpgroups, each of
  which runs a tile's softmax while the previous tile's P V runs, row
  blocks heaviest first and ending at the last row (:func:`wgmma_plan`,
  :func:`wgmma_blocks`, :func:`wgmma_order`).
- ``"tf32x3"``, ``repro_torch/csrc/flash_attention.cu``: float32 at D in
  {32, 64, 128, 256} and bfloat16 at D = 32 (and bf16 at any of those D
  when a caller names the route).  Both products on the tensor cores in
  split TF32, as the backward's: each operand x = hi + lo
  (:func:`split_tf32`), lo.hi + hi.lo + hi.hi summed in float32 (three
  TF32 ``mma.sync`` a product, as accurate as float32), so float32 inputs
  are not rounded to bf16.  Q is split once a block into shared memory,
  K/V tiles of 32 keys come by ``cp.async`` (two stages at D <= 128; K's
  and V's copies staggered at D = 256), a warp owns 16 (query, head) rows
  (at D = 256 a warp pair, each a half of D, adding their partial S), and
  the online softmax runs on the S accumulator fragments, which feed
  P V as they are (:func:`f32_fwd_tiles` mirrors the plan).  Its lse
  entry point (``flash_attention_cuda(..., return_lse=True)``) also
  writes each row's lse for the split-TF32 backward.

Any other dtype or D raises.  :func:`flash_attention` launches the
routed kernel for CUDA tensors and runs :func:`flash_attention_plain` for
CPU tensors.  ``LAUNCHES`` counts every attention kernel launch,
``TC_LAUNCHES`` the tensor-core kernel's and ``WS_LAUNCHES`` those of its
warp-specialized kernel (D 64 and 128), so a run can show which kernel
served it.

The gradient (:class:`FlashAttentionFn`) has two hand-written kernels;
:func:`bwd_route` picks one, again with no fallback:

- ``"tensor_core"``, ``repro_torch/csrc/flash_attention_bwd_wgmma.cu``:
  bfloat16 at D in {64, 128, 256}, each product on wgmma, no atomics.
  At D 64 and 128 a delta pre-pass, then one warp-specialized kernel a
  block of 64 keys (a producer warp keeps a TMA ring of Q / dO tiles
  full for two consumer warpgroups) forms dk, dv and each tile's dq
  partial from five products; two writer warps add the partials into a
  float32 scratch in descending key-block order, each block waiting on a
  turn counter a tile (:func:`dq_turn`), and a last pass converts dq.
  At D = 256 a delta pre-pass, dq by (query, head) rows (a producer warp
  keeps a TMA ring of K / V tiles full for two consumer warpgroups of 64
  rows) and dk, dv by key blocks (two warpgroups a key block, one a column
  half, and a producer warp for the Q / dO ring).  Where the
  key blocks are too few to fill the card, each group's heads are split
  over :func:`bwd_head_split` blocks whose float32 partials a last pass
  sums in a fixed order (:func:`bwd_tiles` mirrors the plans).  It reads
  each row's lse, which the forward's lse entry point
  (``flash_attention_cuda(..., return_lse=True)``) writes when a gradient
  is needed.
- ``"tf32x3"``, ``repro_torch/csrc/flash_attention_bwd.cu``: float32 at D
  in ``HEAD_DIMS`` and bfloat16 at D = 32.  Every product on the tensor
  cores in split TF32: each operand x = hi + lo (:func:`split_tf32`), and
  lo.hi + hi.lo + hi.hi summed in float32 (three TF32 ``mma.sync`` a
  product, as accurate as float32).  A delta pre-pass, dq by 16-row slices of (query, head)
  rows (at D = 256 a warp pair a slice, each a column half of dq), dk and
  dv by warp pairs of 16 keys (one forms P^T and dv, the other dS^T and
  dk), no atomics; heads split over :func:`f32_bwd_head_split` blocks
  where the key blocks are few (:func:`f32_bwd_tiles` mirrors the plan).
  It reads the forward's lse too.

On CPU tensors the gradient is :func:`flash_attention_backward_plain`,
written out (not autograd through the plain forward).  ``BWD_LAUNCHES``
counts every backward launch, ``TC_BWD_LAUNCHES`` the tensor-core
backward's and ``TF32_BWD_LAUNCHES`` the split-TF32 backward's.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.sharding import logical as L

#: kernel launches in this process (one per :func:`flash_attention_cuda`)
LAUNCHES = 0
#: launches of the tensor-core kernel among them
TC_LAUNCHES = 0
#: launches of its warp-specialized kernel (bf16 at D in ``WS_HEAD_DIMS``)
#: among those
WS_LAUNCHES = 0
#: backward kernel launches (one per :func:`flash_attention_bwd_cuda`)
BWD_LAUNCHES = 0
#: launches of the tensor-core backward among them
TC_BWD_LAUNCHES = 0
#: launches of the split-TF32 backward among them
TF32_BWD_LAUNCHES = 0
#: head dims the split-TF32 kernels are built for
HEAD_DIMS = (32, 64, 128, 256)
#: head dims the tensor-core kernel is built for (bfloat16 only), and
#: those its warp-specialized kernel serves
TC_HEAD_DIMS = (64, 128, 256)
WS_HEAD_DIMS = (64, 128)
#: the tensor-core forward's tiles at each D (``Smem`` at D = 256 and
#: ``WsPlan`` at D 64 / 128 in the source): see :func:`wgmma_plan`
TC_PLANS = {64: (192, 80, 4), 128: (128, 96, 3), 256: (128, 80, 2)}
#: head dims the tensor-core backward is built for (bfloat16 only)
TC_BWD_HEAD_DIMS = (64, 128, 256)
#: the tensor-core backward's dk/dv blocks at every D: keys a warpgroup's
#: key group, queries a Q/dO tile and warpgroups a block; keys a block, and
#: the column parts dk and dv (and dq at D 64 / 128) are cut into, one a
#: warpgroup (``FusedPlan`` and ``KvPlan`` in the source: at D = 64 the
#: two warpgroups hold a key group each, at 128 and 256 a column half of
#: the block's 64 keys each)
TC_BWD_KEYS, TC_BWD_QUERIES, TC_BWD_WARPGROUPS = 64, 64, 2
TC_BWD_BLOCK_KEYS = {64: 128, 128: 64, 256: 64}
TC_BWD_HALVES = {64: 1, 128: 2, 256: 2}
#: :func:`bwd_head_split`'s model of the fused kernel on the H100 (fitted
#: to each block's start and end on the card at [train]'s, internlm2's and
#: Qwen3-8B's shapes): a tile's time on an SM (a block's keys x 64 queries
#: x one head), a block's set-up in tiles, and the rate at which the head
#: split's partials are written and summed
TC_BWD_TILE_US = {64: 1.70, 128: 1.69}
TC_BWD_BLOCK_TILES = 3
TC_BWD_PART_BYTES_PER_US = 3.0e6
#: the D = 256 dq kernel's (query, head) rows a block (two warpgroups of
#: 64) and keys a K/V tile (``DqPlan`` in the source)
TC_BWD_DQ = (128, 48)
#: the H100 SXM's SMs, and the warpgroups a dk/dv grid should hold (two
#: for each SM) before :func:`bwd_head_split` stops splitting heads
SMS = 132
BWD_MIN_WARPGROUPS = 2 * SMS
#: the split-TF32 forward's tiles at each D (``FwdPlan`` in
#: csrc/flash_attention.cu): (query, head) rows a block (16 a warp, or a
#: warp pair where D is halved), keys a K/V tile, K/V stages, and the warps
#: that share a 16-row slice (each reducing S over, and holding O of, a
#: half of D)
F32_FWD_PLANS = {32: (128, 32, 2, 1), 64: (128, 32, 2, 1),
                 128: (128, 32, 2, 1), 256: (64, 32, 1, 2)}
#: the split-TF32 backward's tiles at each D (``DqPlan`` and ``KvPlan`` in
#: csrc/flash_attention_bwd.cu): (query, head) rows a dq block (16 a warp),
#: keys a dq K/V tile, keys a dk/dv block (16 a warp pair) and queries a
#: dk/dv Q/dO tile
F32_BWD_PLANS = {32: (128, 64, 64, 64), 64: (128, 64, 64, 64),
                 128: (128, 32, 64, 64), 256: (64, 32, 64, 32)}
#: the dk/dv blocks the split-TF32 backward's grid should hold (two an SM)
#: before :func:`f32_bwd_head_split` stops splitting heads
F32_BWD_MIN_BLOCKS = 2 * SMS
NEG_INF = -1e30
#: the library, the C entry point and the one that also writes lse, of
#: each (route, dtype)
_ENTRIES = {
    ("tensor_core", torch.bfloat16): ("flash_attention_wgmma",
                                      "flash_attention_wgmma_bf16",
                                      "flash_attention_wgmma_lse_bf16"),
    ("tf32x3", torch.bfloat16): ("flash_attention", "flash_attention_bf16",
                                 "flash_attention_lse_bf16"),
    ("tf32x3", torch.float32): ("flash_attention", "flash_attention_f32",
                                "flash_attention_lse_f32"),
}


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that serves (dtype, D): ``"tensor_core"`` for bfloat16 at
    D in ``TC_HEAD_DIMS``, ``"tf32x3"`` (split TF32) for float32 at D in
    ``HEAD_DIMS`` and bfloat16 at D = 32; raises for anything else."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and D in TC_HEAD_DIMS:
        return "tensor_core"
    if D in HEAD_DIMS:
        return "tf32x3"
    raise ValueError(f"the kernels are built for head dims {HEAD_DIMS}, "
                     f"got {D}")


def bwd_route(dtype: torch.dtype, D: int) -> str:
    """The backward kernel that serves (dtype, D): ``"tensor_core"`` for
    bfloat16 at D in ``TC_BWD_HEAD_DIMS``, ``"tf32x3"`` (split TF32) for
    float32 at D in ``HEAD_DIMS`` and bfloat16 at D = 32; raises for
    anything else."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the backward kernels take float32 or bfloat16, "
                        f"got {dtype}")
    if dtype == torch.bfloat16 and D in TC_BWD_HEAD_DIMS:
        return "tensor_core"
    if D in HEAD_DIMS:
        return "tf32x3"
    raise ValueError(f"the backward kernels are built for head dims "
                     f"{HEAD_DIMS}, got {D}")


def _row_blocks(R: int, rows: int, end_aligned: bool
                ) -> List[Tuple[int, int]]:
    """[(r0, r1)]: the rows [r0, r1) of each block of ``rows`` rows over
    R rows, in block order; the last block is the short one, or with
    ``end_aligned`` the first (the blocks then end at row R)."""
    n = -(-R // rows)
    pad = n * rows - R if end_aligned else 0
    return [(max(0, y * rows - pad), min((y + 1) * rows - pad, R))
            for y in range(n)]


def _row_tiles(blocks: List[Tuple[int, int]], Sk: int, G: int, causal: bool,
               window: Optional[int], keys: int) -> List[Tuple[int, int]]:
    """[(first, count)] of the ``keys``-key tiles each block of (query,
    head) rows [r0, r1) of ``blocks`` visits, row r being query r // G."""
    plan = []
    for r0, r1 in blocks:
        q_lo, q_hi = r0 // G, (r1 - 1) // G
        k_lo = max(0, q_lo - window + 1) if window is not None else 0
        k_hi = min(q_hi, Sk - 1) if causal else Sk - 1
        first = k_lo // keys
        plan.append((first, k_hi // keys - first + 1 if k_hi >= k_lo else 0))
    return plan


def wgmma_plan(D: int) -> Tuple[int, int, int]:
    """(rows, keys, stages) of the tensor-core forward at head dim D: the
    (query, head) rows a block owns, in warpgroups of 64, the keys of a K/V
    tile and the stages of the K/V ring.  D = 256 runs
    ``flash_attention_wgmma_kernel`` (two warpgroups), D 64 and 128 the
    warp-specialized ``flash_attention_wgmma_ws_kernel`` (three and two
    warpgroups and a producer warp), whose warpgroups compute the block's
    key tiles up to their own rows' last (:func:`wgmma_group_tiles`)."""
    if D not in TC_PLANS:
        raise ValueError(f"the tensor-core kernel is built for head dims "
                         f"{TC_HEAD_DIMS}, got {D}")
    return TC_PLANS[D]


def wgmma_blocks(Sq: int, G: int, D: int) -> List[Tuple[int, int]]:
    """[(r0, r1)]: the (query, head) rows [r0, r1) of a (batch, kv head)
    that each row block of the tensor-core forward owns at head dim D,
    by block index y, with rows = :func:`wgmma_plan` (D)[0].  At D = 256
    block y owns rows [rows y, rows (y + 1)) and the last is short; at D
    64 and 128 the blocks end at the last row (``end`` in the source), so
    the first is the short one: under a causal mask the block whose
    warpgroups are partly idle is the lightest."""
    return _row_blocks(Sq * G, wgmma_plan(D)[0], D in WS_HEAD_DIMS)


def wgmma_tiles(Sq: int, Sk: int, G: int, causal: bool,
                window: Optional[int], D: int) -> List[Tuple[int, int]]:
    """The key tiles each row block of the tensor-core kernel visits at
    head dim D, as the kernel computes them: block y owns the rows
    :func:`wgmma_blocks` gives, row r being query r // G, and visits
    ``count`` tiles of :func:`wgmma_plan` (D)[1] keys from tile ``first``.
    Returns [(first, count)] by row block; :func:`wgmma_order` gives the
    order the blocks start in."""
    return _row_tiles(wgmma_blocks(Sq, G, D), Sk, G, causal, window,
                      wgmma_plan(D)[1])


def wgmma_group_tiles(Sq: int, Sk: int, G: int, causal: bool,
                      window: Optional[int], D: int) -> List[List[int]]:
    """How many of its block's :func:`wgmma_tiles`, from the block's
    first, each 64-row warpgroup of a block computes, by block: at D = 256
    every warpgroup all of them; at D 64 and 128 a warpgroup stops at the
    tile of the last key its own rows see (under a causal mask), and one
    past the block's last row computes none (``n_mine`` in the source)."""
    rows, keys, _ = wgmma_plan(D)
    out = []
    for (b0, b1), (first, count) in zip(
            wgmma_blocks(Sq, G, D),
            wgmma_tiles(Sq, Sk, G, causal, window, D)):
        counts = []
        for w0 in range(b0, b0 + rows, 64):
            if w0 >= b1 or count == 0:
                counts.append(0)
            elif D == 256 or not causal:
                counts.append(count)
            else:
                k_hi = min((min(w0 + 64, b1) - 1) // G, Sk - 1)
                counts.append(min(count, max(1, k_hi // keys - first + 1)))
        out.append(counts)
    return out


def wgmma_order(Sq: int, G: int, causal: bool, D: int, BKVH: int
                ) -> List[Tuple[int, int]]:
    """(bh, y) of every block of the tensor-core forward, (batch, kv head)
    bh = b KVH + kvh and row block y, in the order the blocks start
    (blockIdx x fastest).  D = 256: a grid (row blocks, B KVH), first rows
    first.  D 64 and 128: a grid (B KVH, row blocks) whose blockIdx.y
    counts from the last row block down when causal, so the blocks that
    visit the most key tiles start first."""
    rows = wgmma_plan(D)[0]
    n = -(-Sq * G // rows)
    if D == 256:
        return [(bh, y) for bh in range(BKVH) for y in range(n)]
    return [(bh, n - 1 - y if causal else y)
            for y in range(n) for bh in range(BKVH)]


def wgmma_tile_masked(k0: int, Sk: int, q_lo: int, q_hi: int, causal: bool,
                      window: Optional[int], D: int) -> bool:
    """Whether the tensor-core kernel masks the K/V tile of keys [k0, k0 +
    keys) for a block whose rows are queries [q_lo, q_hi]: every tile but
    those wholly inside every row's band (``inside`` / ``edge`` in the
    source)."""
    keys = wgmma_plan(D)[1]
    return not (k0 + keys <= Sk
                and (not causal or k0 + keys - 1 <= q_lo)
                and (window is None or k0 >= q_hi - window + 1))


def _head_split(units: int, G: int, need: int) -> int:
    """The smallest divisor hs of G with ``units`` x hs >= ``need``, else
    G: the parts a backward's dk/dv kernel splits each group's heads into
    (``units``: what one split's grid holds)."""
    for hs in range(1, G + 1):
        if G % hs == 0 and units * hs >= need:
            return hs
    return G


def _fused_block_tiles(kb: int, Sq: int, Sk: int, causal: bool,
                       window: Optional[int], keys: int) -> int:
    """The 64-query tiles the fused backward's block kb of ``keys`` keys
    sees, of one head (every tile from the block's first query to its last
    holds a pair one of its keys sees)."""
    key0 = kb * keys
    q_lo = key0 if causal else 0
    q_hi = (min(Sq - 1, min(key0 + keys, Sk) + window - 2)
            if window is not None else Sq - 1)
    return (q_hi // TC_BWD_QUERIES - q_lo // TC_BWD_QUERIES + 1
            if q_hi >= q_lo else 0)


@functools.lru_cache(maxsize=256)
def _fused_time_us(B: int, Sq: int, Sk: int, KVH: int, G: int, D: int,
                   causal: bool, window: Optional[int], hs: int) -> float:
    """The fused backward's modelled time at head split hs: its blocks
    placed in launch order on the ``SMS`` SMs, one at a time each (a block
    takes ``TC_BWD_BLOCK_TILES`` + its tiles, each ``TC_BWD_TILE_US[D]``),
    and, at hs > 1, the partials written and read again by the sum."""
    keys = TC_BWD_BLOCK_KEYS[D]
    n_kb = -(-Sk // keys)
    work = [TC_BWD_BLOCK_TILES + G // hs * _fused_block_tiles(
        kb, Sq, Sk, causal, window, keys) for kb in range(n_kb - 1, -1, -1)]
    free = [0.0] * SMS
    for _ in range(B * KVH):
        for w in work:
            for _ in range(hs):
                heapq.heappush(free, heapq.heappop(free) + w)
    part = 4 * hs * B * Sk * KVH * D * 4 if hs > 1 else 0
    return (max(free) * TC_BWD_TILE_US[D]
            + part / TC_BWD_PART_BYTES_PER_US)


def bwd_head_split(B: int, Sk: int, KVH: int, G: int, D: int,
                   Sq: Optional[int] = None, causal: bool = True,
                   window: Optional[int] = None) -> int:
    """hs, the parts the tensor-core backward's dk/dv blocks split each
    group's G heads into; hs = 1 writes dk and dv directly, a larger hs
    float32 partials (hs, 2, B, Sk, KVH, D) that a last pass sums.

    D = 256: the smallest divisor of G whose grid (key blocks of
    ``TC_BWD_BLOCK_KEYS[D]`` x B x KVH x hs blocks of
    ``TC_BWD_WARPGROUPS`` warpgroups) holds at least
    ``BWD_MIN_WARPGROUPS``, and G where none does.  D 64 / 128 (the fused kernel, Sq defaulting to Sk): the divisor
    of G with the least modelled time (:func:`_fused_time_us`): a split
    fills the card where the blocks are few, and shortens the heaviest
    blocks (the first keys under a causal mask), which the fused grid
    starts last."""
    if D == 256:
        blocks = -(-Sk // TC_BWD_BLOCK_KEYS[D]) * B * KVH
        return _head_split(blocks * TC_BWD_WARPGROUPS, G,
                           BWD_MIN_WARPGROUPS)
    Sq = Sk if Sq is None else Sq
    return min((hs for hs in range(1, G + 1) if G % hs == 0),
               key=lambda hs: _fused_time_us(B, Sq, Sk, KVH, G, D, causal,
                                             window, hs))


def tc_bwd_scratch(B: int, Sq: int, Sk: int, H: int, KVH: int, D: int,
                   causal: bool = True, window: Optional[int] = None) -> int:
    """The float32 scratch (floats) the tensor-core backward takes as its
    ``part`` argument.  D 64 / 128: dq_acc (B, H, ceil(Sq / 64), 64 D)
    float32, the dq tiles' partial sums; the tiles' turn counters (B, H,
    ceil(Sq / 64)) int32; from the next multiple of 4, the head split's
    partials (hs, 2, B, Sk, KVH, D) where hs > 1.  D = 256: those partials
    alone (0 at hs = 1)."""
    hs = bwd_head_split(B, Sk, KVH, H // KVH, D, Sq, causal, window)
    part = 2 * hs * B * Sk * KVH * D if hs > 1 else 0
    if D == 256:
        return part
    tiles = B * H * -(-Sq // TC_BWD_QUERIES)
    return -(-(tiles * TC_BWD_QUERIES * D + tiles) // 4) * 4 + part


def f32_bwd_head_split(B: int, Sk: int, KVH: int, G: int, D: int) -> int:
    """hs, the parts the split-TF32 backward's dk/dv kernel splits each
    group's G heads into: the smallest divisor of G whose grid (key blocks
    of ``F32_BWD_PLANS[D][2]`` keys x B x KVH x hs) holds at least
    ``F32_BWD_MIN_BLOCKS`` blocks, and G where none does (``head_split``
    in the source).  hs > 1 writes float32 partials that a last pass
    sums."""
    blocks = -(-Sk // F32_BWD_PLANS[D][2]) * B * KVH
    return _head_split(blocks, G, F32_BWD_MIN_BLOCKS)


def f32_bwd_scratch(B: int, Sq: int, Sk: int, H: int, KVH: int,
                    D: int) -> int:
    """The float32 scratch (floats) the split-TF32 backward takes as its
    ``delta`` argument: delta (B, H, Sq), then from the next multiple of 4
    the head split's partials (hs, 2, B, Sk, KVH, D) where hs > 1."""
    hs = f32_bwd_head_split(B, Sk, KVH, H // KVH, D)
    at = -(-B * H * Sq // 4) * 4
    return at + (2 * hs * B * Sk * KVH * D if hs > 1 else 0)


def _kv_tiles(Sq: int, Sk: int, causal: bool, window: Optional[int],
              block: int, keys: int, queries: int,
              heads: List[Tuple[int, int]]) -> Tuple[list, list]:
    """(blocks, tiles) of a dk/dv kernel whose blocks own ``block`` keys
    and walk, split z of each, the heads ``heads[z]``, then the
    ``queries``-query tiles that can see one of the block's keys; a
    worker of ``keys`` keys computes (kw0, g, q0, masked) for each tile
    one of its keys sees.  blocks: (key0, z, n) in launch order (split z
    fastest), n the tiles of the block, which follow in that order."""
    w = -1 if window is None else window
    blocks, tiles = [], []
    for key0 in range(0, Sk, block):
        key_hi = min(key0 + block - 1, Sk - 1)
        q_lo = key0 if causal else 0
        q_hi = min(Sq - 1, key_hi + w - 1) if w >= 0 else Sq - 1
        t_lo = q_lo // queries
        n_qt = q_hi // queries - t_lo + 1 if q_hi >= q_lo else 0
        for z, (g0, g1) in enumerate(heads):
            n0 = len(tiles)
            for i in range((g1 - g0) * n_qt):
                g, q0 = g0 + i // n_qt, (t_lo + i % n_qt) * queries
                q_end = q0 + queries - 1
                for kw0 in range(key0, key0 + block, keys):
                    kw_end = kw0 + keys - 1
                    if not (kw0 < Sk and (not causal or q_end >= kw0)
                            and (w < 0 or q0 - kw_end < w)):
                        continue
                    inside = (kw_end < Sk and q_end < Sq
                              and (not causal or q0 >= kw_end)
                              and (w < 0 or q_end - kw0 < w))
                    tiles.append((kw0, g, q0, not inside))
            blocks.append((key0, z, len(tiles) - n0))
    return blocks, tiles


def _dq_tiles(Sq: int, Sk: int, G: int, causal: bool,
              window: Optional[int], rows: int, keys: int,
              last_first: bool) -> list:
    """(row0, k0, masked) for each ``keys``-key tile each block of
    ``rows`` (query, head) rows of a dq kernel computes, blocks in launch
    order (``last_first``: the last rows first)."""
    w = -1 if window is None else window
    row_blocks = _row_blocks(Sq * G, rows, False)
    tiles = list(zip((r0 for r0, _ in row_blocks),
                     _row_tiles(row_blocks, Sk, G, causal, window, keys)))
    dq = []
    for row0, (first, count) in tiles[::-1] if last_first else tiles:
        q_lo, q_hi = row0 // G, (min(row0 + rows, Sq * G) - 1) // G
        for t in range(first, first + count):
            k0 = t * keys
            inside = (k0 + keys <= Sk
                      and (not causal or k0 + keys - 1 <= q_lo)
                      and (w < 0 or k0 >= q_hi - w + 1))
            dq.append((row0, k0, not inside))
    return dq


def _split_heads(G: int, hs: int) -> List[Tuple[int, int]]:
    return [(z * (G // hs), (z + 1) * (G // hs)) for z in range(hs)]


def dq_turn(key0: int, q0: int, causal: bool, n_kb: int, keys: int) -> int:
    """The turn the fused backward's block of ``keys`` keys from ``key0``
    (of ``n_kb``) waits for on the dq tile of queries from ``q0``, as its
    writer computes it: the blocks add in descending order from the last
    that sees the tile (under a causal mask the one holding the tile's
    diagonal, else the last block)."""
    last = (min((q0 + TC_BWD_QUERIES - 1) // keys, n_kb - 1) if causal
            else n_kb - 1)
    return last - key0 // keys


def _fused_tiles(Sq: int, Sk: int, causal: bool, window: Optional[int],
                 heads: List[Tuple[int, int]], keys: int
                 ) -> Tuple[list, list]:
    """(blocks, tiles) of the fused backward (D 64 / 128): blocks (key0,
    z, n) of ``keys`` keys in launch order (key blocks descending, split z
    fastest), each followed in ``tiles`` by its n entries (kw0, g, q0,
    masked) in the order it computes them: the 64-query tiles that can see
    one of its keys, first first, inside each the heads of split z, and
    for each the block's key groups of ``TC_BWD_KEYS`` from kw0 that one
    of the tile's queries sees (a group that sees none skips the tile)."""
    w = -1 if window is None else window
    Q, K = TC_BWD_QUERIES, TC_BWD_KEYS
    blocks, tiles = [], []
    for key0 in range((-(-Sk // keys) - 1) * keys, -1, -keys):
        q_lo = key0 if causal else 0
        n_t = _fused_block_tiles(key0 // keys, Sq, Sk, causal, window, keys)
        for z, (g0, g1) in enumerate(heads):
            n0 = len(tiles)
            for t in range(q_lo // Q, q_lo // Q + n_t):
                q0 = t * Q
                for g in range(g0, g1):
                    for kw0 in range(key0, key0 + keys, K):
                        if (kw0 >= Sk or (causal and q0 + Q - 1 < kw0)
                                or (w >= 0 and q0 - (kw0 + K - 1) >= w)):
                            continue   # the key group sees no pair
                        inside = (kw0 + K <= Sk and q0 + Q <= Sq
                                  and (not causal or q0 >= kw0 + K - 1)
                                  and (w < 0 or q0 + Q - 1 - kw0 < w))
                        tiles.append((kw0, g, q0, not inside))
            blocks.append((key0, z, len(tiles) - n0))
    return blocks, tiles


def bwd_tiles(Sq: int, Sk: int, G: int, causal: bool,
              window: Optional[int], D: int = 64, B: int = 1, KVH: int = 1
              ) -> Dict[str, object]:
    """The tiles the tensor-core backward's kernels compute at head dim D,
    as they compute them, for one (batch, kv head) of a (B, KVH) grid:

    - ``"hs"``: :func:`bwd_head_split`; ``"heads"``: [(g0, g1)], the heads
      [g0, g1) of the group that split z walks.
    - ``"blocks"``: (key0, z, n) for each dk/dv block in launch order:
      keys [key0, key0 + ``TC_BWD_BLOCK_KEYS[D]``), split z's heads, and
      the n entries of ``"dkdv"`` the block computes, which follow in the
      blocks' order.  D = 256: key blocks ascending (under a causal mask
      the first are the heaviest); D 64 / 128: descending, so that a block
      waits for its dq turns only on blocks launched before it.  The sum
      pass adds a key's hs partials in the order z = 0 .. hs - 1.
    - ``"columns"``: [(c0, c1)], the column parts of dk and dv (and of dq
      at D 64 / 128), each held by a warpgroup of its own whose products
      take every tile of ``"dkdv"`` (at D 128 and 256 the two form S^T and
      dP^T by query halves and share P^T and dS^T).  At D = 64 one part
      holds all columns, and ``"wg"`` gives the warpgroup that computes
      each entry (the block's key group kw0 holds).
    - ``"dkdv"``: (kw0, g, q0, masked) for each tile of a warpgroup: keys
      [kw0, kw0 + ``TC_BWD_KEYS``) against queries [q0, q0 +
      ``TC_BWD_QUERIES``) of head g of the group.  D = 256: a block walks
      its heads, then the query tiles that can see one of its keys; D 64 /
      128: the query tiles first first, inside each the heads, then (D =
      64) the block's two key groups.
    - D 64 / 128, dq from the same tiles: ``"dq_order"``: {(g, q0): [key0,
      ...]}, the blocks whose dq partials of the tile (at D = 64 its two
      key groups' summed in order) are added, in the order they are added
      (descending: the first stores, the others add; under a causal mask
      block kb + 1 computes the tile before block kb); ``"turns"``: for
      each entry of ``"dkdv"``, the turn its block waits for
      (:func:`dq_turn`), its index in that order.
    - D = 256, dq by rows: ``"dq"``: (row0, k0, masked) for each K/V tile
      a block of ``"dq_rows"`` (query, head) rows from row0 computes (both
      its warpgroups of 64 rows take every tile, in this order): keys [k0,
      k0 + ``"dq_keys"``), blocks in launch order (causal: the last rows
      first).

    ``masked`` is False only for a tile whose every pair is visible."""
    hs = bwd_head_split(B, Sk, KVH, G, D, Sq, causal, window)
    part = D // TC_BWD_HALVES[D]
    heads = _split_heads(G, hs)
    plan: Dict[str, object] = {
        "hs": hs, "heads": heads,
        "columns": [(c, c + part) for c in range(0, D, part)]}
    if D == 256:
        blocks, dkdv = _kv_tiles(Sq, Sk, causal, window, TC_BWD_KEYS,
                                 TC_BWD_KEYS, TC_BWD_QUERIES, heads)
        rows, keys = TC_BWD_DQ
        plan.update(blocks=blocks, dkdv=dkdv,
                    dq=_dq_tiles(Sq, Sk, G, causal, window, rows, keys,
                                 causal),
                    dq_rows=rows, dq_keys=keys)
        return plan
    keys = TC_BWD_BLOCK_KEYS[D]
    blocks, dkdv = _fused_tiles(Sq, Sk, causal, window, heads, keys)
    order: Dict[Tuple[int, int], set] = {}
    for kw0, g, q0, _ in dkdv:
        order.setdefault((g, q0), set()).add(kw0 - kw0 % keys)
    n_kb = -(-Sk // keys)
    plan.update(blocks=blocks, dkdv=dkdv,
                dq_order={k: sorted(v, reverse=True)
                          for k, v in order.items()},
                turns=[dq_turn(kw0 - kw0 % keys, q0, causal, n_kb, keys)
                       for kw0, _, q0, _ in dkdv],
                wg=([kw0 % keys // TC_BWD_KEYS for kw0, _, _, _ in dkdv]
                    if TC_BWD_HALVES[D] == 1 else None))
    return plan


def f32_fwd_tiles(Sq: int, Sk: int, G: int, causal: bool,
                  window: Optional[int], D: int = 64) -> Dict[str, object]:
    """The tiles the split-TF32 forward computes at head dim D, as it
    computes them, for one (batch, kv head): ``"tiles"``, (row0, k0,
    masked) for each K/V tile of ``"keys"`` keys that a block of
    ``"rows"`` (query, head) rows from row0 visits (row r: query r // G),
    blocks in launch order (causal: the last rows first), tiles in the
    order its online softmax takes them; ``masked`` is False only for a
    tile whose every pair is visible.  ``"stages"``: K/V tiles in shared
    memory; ``"halves"``: warps a 16-row slice, each reducing S over a
    half of D."""
    rows, keys, stages, halves = F32_FWD_PLANS[D]
    return {"tiles": _dq_tiles(Sq, Sk, G, causal, window, rows, keys, causal),
            "rows": rows, "keys": keys, "stages": stages, "halves": halves}


def f32_bwd_tiles(Sq: int, Sk: int, G: int, causal: bool,
                  window: Optional[int], D: int = 64, B: int = 1,
                  KVH: int = 1) -> Dict[str, list]:
    """The tiles the split-TF32 backward's kernels compute at head dim D,
    as they compute them, for one (batch, kv head) of a (B, KVH) grid,
    in :func:`bwd_tiles`' form:

    - ``"hs"``: :func:`f32_bwd_head_split`; ``"heads"``: [(g0, g1)], the
      heads [g0, g1) of the group that split z walks.
    - ``"blocks"``: (key0, z, n) for each dk/dv block in launch order:
      keys [key0, key0 + ``"kv_keys"``), split z's heads, and the n
      entries of ``"dkdv"`` its warp pairs compute.  The sum pass adds a
      key's hs partials in the order z = 0 .. hs - 1.
    - ``"dkdv"``: (kw0, g, q0, masked) for each tile a warp pair computes:
      its 16 keys [kw0, kw0 + 16) against queries [q0, q0 +
      ``"kv_queries"``) of head g of the group; a pair skips a tile none
      of its keys sees.
    - ``"dq"``: (row0, k0, masked) for each K/V tile a block of
      ``"dq_rows"`` (query, head) rows from row0 computes: keys [k0, k0 +
      ``"dq_keys"``), blocks in launch order (causal: the last rows
      first).

    ``masked`` is False only for a tile whose every pair is visible."""
    dq_rows, dq_keys, block, queries = F32_BWD_PLANS[D]
    hs = f32_bwd_head_split(B, Sk, KVH, G, D)
    heads = _split_heads(G, hs)
    blocks, dkdv = _kv_tiles(Sq, Sk, causal, window, block, 16, queries,
                             heads)
    return {"hs": hs, "heads": heads, "blocks": blocks, "dkdv": dkdv,
            "dq": _dq_tiles(Sq, Sk, G, causal, window, dq_rows, dq_keys,
                            causal),
            "dq_rows": dq_rows, "dq_keys": dq_keys, "kv_keys": block,
            "kv_queries": queries}


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x`` as the split-TF32 backward splits its
    operands and its MMAs read them (the low 13 bits dropped), by the
    kernel's integer ops on the int32 view: hi = tf32(x), lo = tf32(x -
    hi), each rounded as ``cvt.rna.tf32.f32`` rounds a finite value (to
    the nearest value with 10 bits of mantissa, ties away from zero: half
    a TF32 ulp added to the bits); x = hi + lo to within 2^-22 |x|.  An
    infinite x gives itself as hi, a NaN x a NaN hi (the kernel selects
    one: the add would carry a NaN into the sign bit or down to an
    infinity), so a product of a non-finite operand is non-finite."""
    def rna(bits: torch.Tensor) -> torch.Tensor:
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    x = x.to(torch.float32).contiguous()
    hi = torch.where(torch.isnan(x), math.nan, rna(x.view(torch.int32)))
    return hi, rna((x - hi).view(torch.int32))


def visible(Sq: int, Sk: int, causal: bool, window: Optional[int],
            device=None) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible from query i (d = i - j; d >= 0
    when causal, d < window when windowed)."""
    d = (torch.arange(Sq, device=device)[:, None]
         - torch.arange(Sk, device=device)[None, :])
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return ok


def _lse(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:  # noqa: E741
    """m + log l, 0 where no key is visible (l = 0), as the kernels."""
    return torch.where(l > 0, m + torch.log(l), 0.0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          return_lse: bool = False
                          ) -> Union[torch.Tensor,
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Masked softmax attention in float32, output in ``q.dtype``; a row
    with no visible key is 0, as in the kernel.  q (B, Sq, H, D); k, v
    (B, Sk, KVH, D).  With ``return_lse`` also each row's lse = m + log l
    (B, H, Sq) in float32, 0 for a row with no visible key, as the
    tensor-core kernel's lse entry point writes it."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (
        1.0 / math.sqrt(D))
    ok = visible(Sq, Sk, causal, window, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)  # noqa: E741
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    out = out / torch.clamp_min(l, 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    return (out, _lse(m, l).reshape(B, H, Sq)) if return_lse else out


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   do: torch.Tensor, causal: bool = True,
                                   window: Optional[int] = None,
                                   lse: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_plain` given its output o and
    the output's gradient do, written out in float32 as the backward
    kernels compute it: lse = m + log l over the visible keys (or the
    forward's ``lse`` (B, H, Sq) where given), p = exp(s - lse), delta =
    rowsum(do * o), ds = p (do v^T - delta), dq = ds k / sqrt(D), dk =
    ds^T q / sqrt(D) and dv = p^T do summed over each kv head's G query
    heads.  A row with no visible key has zero gradient.  Returned in the
    inputs' dtype."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    f32 = torch.float32
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KVH, G, D).to(f32)
    dog = do.reshape(B, Sq, KVH, G, D).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    ok = visible(Sq, Sk, causal, window, q.device)
    s = torch.where(ok, torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale,
                    NEG_INF)
    if lse is None:
        m = torch.amax(s, dim=-1, keepdim=True)
        l = torch.sum(torch.where(ok, torch.exp(s - m), 0.0),  # noqa: E741
                      dim=-1, keepdim=True)
        lse = _lse(m, l)
    else:
        lse = lse.to(f32).reshape(B, KVH, G, Sq, 1)
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    delta = torch.sum(dog * o.reshape(B, Sq, KVH, G, D).to(f32), dim=-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, dtype: torch.dtype, with_lse: bool = False):
    lib, name, lse_name = _ENTRIES[(kernel, dtype)]
    fn = getattr(_build.load(lib), lse_name if with_lse else name)
    fn.argtypes = ([ctypes.c_void_p] * (4 + with_lse) + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"k, v must be (B, Sk, KVH, D) matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    KVH = k.shape[2]
    if min(B, Sq, k.shape[1], H, KVH) < 1 or H % KVH:
        raise ValueError(f"need H % KVH == 0 and non-empty shapes, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         kernel: Optional[str] = None, return_lse: bool = False
                         ) -> Union[torch.Tensor,
                                    Tuple[torch.Tensor, torch.Tensor]]:
    """Launch a CUDA kernel on PyTorch's current stream: the one
    :func:`route` picks, or ``kernel`` ("tensor_core" or "tf32x3") where
    that kernel takes the inputs' dtype and D.  ``return_lse`` launches
    the kernel's lse entry point, which also returns each row's lse (B,
    H, Sq) float32 for the backward kernels; its output is the serving
    entry point's, bit for bit.  The split-TF32 kernel copies q, k or v
    to a 16-byte boundary where it is not on one (its ``cp.async`` copies
    need it)."""
    global LAUNCHES, TC_LAUNCHES, WS_LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    kernel = kernel or route(q.dtype, D)
    if (kernel, q.dtype) not in _ENTRIES or D not in (
            TC_HEAD_DIMS if kernel == "tensor_core" else HEAD_DIMS):
        raise ValueError(f"no {kernel} kernel for {q.dtype} at D = {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if kernel == "tensor_core" and any(x.data_ptr() % 16
                                       for x in (q, k, v)):
        raise ValueError("the tensor-core kernel needs q, k, v on 16-byte "
                         "boundaries")
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if return_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        args.append(lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(kernel, q.dtype, return_lse)(*args, B, Sq, Sk, H, KVH, D, int(causal),
                 -1 if window is None else window, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           f"error {err}")
    LAUNCHES += 1
    if kernel == "tensor_core":
        TC_LAUNCHES += 1
        if D in WS_HEAD_DIMS:
            WS_LAUNCHES += 1
    return (out, lse) if return_lse else out


@functools.lru_cache(maxsize=None)
def _bwd_entry(kernel: str, dtype: torch.dtype):
    if kernel == "tensor_core":
        fn = _build.load("flash_attention_bwd_wgmma") \
            .flash_attention_bwd_wgmma_bf16
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    else:
        lib = _build.load("flash_attention_bwd")
        fn = (lib.flash_attention_bwd_f32 if dtype == torch.float32
              else lib.flash_attention_bwd_bf16)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, causal: bool = True,
                             window: Optional[int] = None,
                             lse: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the backward kernel :func:`bwd_route` picks on PyTorch's
    current stream: (dq, dk, dv) in the inputs' dtype.  Both kernels read
    the forward's ``lse`` (B, H, Sq) float32 and raise without it.  The
    tensor-core kernel splits each group's heads as :func:`bwd_head_split`
    says, the split-TF32 one as :func:`f32_bwd_head_split` says, each with
    a float32 scratch (:func:`tc_bwd_scratch`, :func:`f32_bwd_scratch`)
    for the partials where it splits them and, at D 64 / 128, dq's
    partial sums and turn counters.  An input
    that is not on a 16-byte boundary (which the kernels' 16-byte loads
    need) is copied to one."""
    global BWD_LAUNCHES, TC_BWD_LAUNCHES, TF32_BWD_LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got "
                         f"{q.device}")
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    kernel = bwd_route(q.dtype, D)
    if lse is None or tuple(lse.shape) != (B, H, Sq) \
            or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous() or lse.data_ptr() % 16:
        raise ValueError(f"the {kernel} backward needs the forward's lse, "
                         f"({B}, {H}, {Sq}) float32 contiguous on "
                         f"{q.device}")
    if kernel == "tensor_core" and B * H * Sq >= 2 ** 31:
        raise ValueError(f"B H Sq = {B * H * Sq} rows: the tensor-core "
                         f"backward indexes them with 32-bit ints")
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not all(t.is_contiguous() for t in (q, k, v, o, do)):
        raise ValueError("q, k, v, o and do must be contiguous")
    q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ints = [B, Sq, Sk, H, KVH, D, int(causal),
                -1 if window is None else window]
        if kernel == "tensor_core":
            delta = torch.empty((B, H, Sq), dtype=torch.float32,
                                device=q.device)
            # dq's partial sums and turns, the head split's partials
            n = tc_bwd_scratch(B, Sq, Sk, H, KVH, D, causal, window)
            part = torch.empty((n,), dtype=torch.float32, device=q.device)
            ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv,
                                           delta)]
            ptrs.append(part.data_ptr() if n else 0)
            ints.append(bwd_head_split(B, Sk, KVH, H // KVH, D, Sq, causal,
                                       window))
        else:
            # delta, then the head split's partials (f32_bwd_scratch)
            scratch = torch.empty((f32_bwd_scratch(B, Sq, Sk, H, KVH, D),),
                                  dtype=torch.float32, device=q.device)
            ptrs = [t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, lse,
                                           scratch)]
        err = _bwd_entry(kernel, q.dtype)(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} backward kernel launch "
                           f"failed: error {err}")
    BWD_LAUNCHES += 1
    if kernel == "tensor_core":
        TC_BWD_LAUNCHES += 1
    else:
        TF32_BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention and its gradient: the kernels on CUDA tensors, the plain
    versions on CPU ones.  Saves q, k, v, the output and, where a
    gradient is needed (``need_lse``), each row's lse from the forward,
    which every backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, need_lse):
        lse = None
        if q.device.type == "meta":
            # shapes and dtypes alone (the dry-run): jax.eval_shape's
            # counterpart through a pallas_call
            o = torch.empty_like(q)
            if need_lse:
                lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                                  dtype=torch.float32, device="meta")
        elif q.device.type == "cuda":
            if need_lse:
                o, lse = flash_attention_cuda(q, k, v, causal, window,
                                              return_lse=True)
            else:
                o = flash_attention_cuda(q, k, v, causal, window)
        else:
            _check(q, k, v)
            if need_lse:
                o, lse = flash_attention_plain(q, k, v, causal, window,
                                               return_lse=True)
            else:
                o = flash_attention_plain(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "meta":
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        elif q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, ctx.causal,
                                                  ctx.window, lse)
        else:
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, o, do, ctx.causal, ctx.window, lse)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Sk, KVH, D); H % KVH == 0.  Returns
    (B, S, H, D) in q's dtype.

    The one entry point of the attention kernels (``ops.attention``
    re-exports it), differentiable through :class:`FlashAttentionFn`:
    CUDA tensors launch the kernels or raise; CPU tensors run the plain
    versions; ``meta`` tensors give the output's shape alone.  Only a
    call that needs a gradient launches the forward's lse entry point;
    serving launches the plain one.  DTensors go through
    :func:`_sharded_attention`."""
    if L.any_dtensor(q, k, v):
        return _sharded_attention(q, k, v, causal, window)
    need_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, causal, window, need_lse)


def _sharded_attention(q, k, v, causal: bool, window: Optional[int]):
    """Attention of DTensors, the kernels on each rank's shards
    (``sharding.logical.heads_call``: the batch and the heads stay
    sharded, the sequence and head dims are gathered, GQA's kv heads
    picked to match a rank's q heads)."""
    def fn(ql, kl, vl):
        need_lse = torch.is_grad_enabled() and any(
            t.requires_grad for t in (ql, kl, vl))
        return FlashAttentionFn.apply(ql, kl, vl, causal, window, need_lse)

    return L.heads_call(fn, q, (k, v))
