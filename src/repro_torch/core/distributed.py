"""Tol-FL over ``torch.distributed``: the production train step.

Port of ``repro.core.distributed``.  Each rank of the world is one
federated group (a data-parallel replica holding the whole model on its
device); the mesh (:mod:`repro_torch.launch.mesh`) names the ranks'
``pod`` and ``data`` axes.  Two interchangeable gradient-sync schedules:

* ``tolfl_ring`` (paper-faithful, Algorithm 1): per-rank gradients;
  intra-cluster FedAvg = one all-reduce over each cluster's process
  group; the inter-cluster SBT chain = k - 1 sequential point-to-point
  hops from ``heads[hop]`` to ``heads[hop + 1]`` carrying the running
  (n, g, loss); the pods' ring (or their weighted all-reduce); the final
  broadcast = one masked all-reduce over the world.
* ``tolfl_psum`` (beyond-paper): the algebraically identical
  failure-weighted mean as a weighted loss: each rank's gradient of its
  rows' mask-weighted loss sum, one all-reduce, divided by the global
  mask mass (computed on every rank from ``alive``), so it equals the
  single-process value.

Failure tolerance is in the step for both: ``alive: (G,)`` enters it and
weights follow the paper's head-failure semantics
(:func:`repro_torch.core.failure.effective_weights`).  Params may be
float32, bf16 or both (``ModelConfig.param_dtype``; Qwen3's qk-norm
scales stay float32): every collective sends one flat buffer a dtype
(:class:`~repro_torch.models.params.DtypeLayout`), float32's first, with
the float32 scalars (the loss, n) at its end, so a bf16 gradient is
reduced and carried in bf16, as ``repro`` reduces each leaf in its own
dtype.  Every process group is made once when the step is built (each
rank calls ``new_group`` for every group, in one order), and a
collective over one rank, or of no words, is skipped: it is the
identity.  Nothing in a step waits on the host.

Over a ``model`` axis > 1 (:func:`make_train_step` with such a mesh) the
params and the optimizer's state are DTensors laid out by
:func:`state_shardings`: sharded over ``model`` (tensor parallelism)
and, under ``FSDP_RULES``, over the data axes on their d_model dims.  A
rank's program is manual over the data axes, as ``repro``'s shard_map
is: it gathers its params over the data axes (FSDP's all-gather at use),
computes its rows' gradient with DTensors on its model column's mesh
(the ranks of its group: DTensor inserts the tensor-parallel
collectives), and runs the schedule's collectives on the flat buffer of
its local shards within its model column (the ranks with its model
index), whose cluster groups, chain hops and final all-reduce are made
once, in one order on every rank.  The update is DTensor arithmetic on
the storage layout (the clip's norm sums every shard once).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import (ModelConfig, MoEConfig, OptimizerConfig,
                                      TolFLConfig)
from repro_torch.core import aggregation as agg
from repro_torch.core.failure import effective_weights_arrays
from repro_torch.core.topology import Topology
from repro_torch.launch.mesh import HostMesh, mesh_axis_sizes
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import (AdamState, SGDState,
                                          apply_updates, make_optimizer)
from repro_torch.sharding import logical as L

Batch = Dict[str, torch.Tensor]


def data_axis_size(mesh: HostMesh) -> int:
    return mesh_axis_sizes(mesh).get("data", 1)


def num_groups(mesh: HostMesh) -> int:
    """Total federated groups = pod x data axis sizes."""
    sizes = mesh_axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def global_topology(mesh: HostMesh, tolfl: TolFLConfig) -> Topology:
    return Topology(num_groups(mesh), tolfl.num_clusters)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
def init_state(generator: torch.Generator, mcfg: ModelConfig,
               ocfg: OptimizerConfig, state_dtype: Optional[str] = None
               ) -> Dict[str, Any]:
    """``{"params", "opt", "step"}`` on ``generator``'s device: params
    drawn there, the optimizer's state and an int32 step count."""
    params = T.init_params(generator, mcfg, generator.device)
    opt = make_optimizer(ocfg, state_dtype=state_dtype)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=generator.device)}


def params_logical_axes(mcfg: ModelConfig) -> P.Axes:
    """The params' logical axes tree (``repro``'s, leaf for leaf)."""
    return T.params_axes(mcfg)


def state_logical_axes(mcfg: ModelConfig, ocfg: OptimizerConfig):
    """The train state's logical axes: the params', the moments' (the
    params'), and ``()`` for each step count."""
    a = params_logical_axes(mcfg)
    if ocfg.name in ("adam", "adamw"):
        opt = AdamState(step=(), mu=a, nu=a)
    else:
        opt = SGDState(step=(), momentum=None)
    return {"params": a, "opt": opt, "step": ()}


def state_shapes(mcfg: ModelConfig, ocfg: OptimizerConfig,
                 state_dtype: Optional[str] = None) -> Dict[str, Any]:
    """:func:`init_state`'s tree as ``meta`` tensors: shapes and dtypes,
    no storage, nothing drawn."""
    params = T.init_params(None, mcfg, "meta")
    opt = make_optimizer(ocfg, state_dtype=state_dtype)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def map_state(fn: Callable, state, *rest):
    """``fn(leaf, *leaves of rest)`` over a state tree: dicts, the
    optimizers' NamedTuples, tensors (or axes tuples / shardings in
    ``rest``) and None, which stays None."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: map_state(fn, v, *(r[k] for r in rest))
                for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(map_state(fn, v, *(r[i] for r in rest))
                             for i, v in enumerate(state)))
    return fn(state, *rest)


def state_shardings(mesh: HostMesh, mcfg: ModelConfig, ocfg: OptimizerConfig,
                    rules: dict, state_dtype: Optional[str] = None):
    """The train state's :class:`~repro_torch.sharding.logical.Sharding`
    tree: each leaf's spec from its logical axes and shape (a leaf whose
    axes do not match its rank is replicated, as ``repro`` does)."""
    shapes = state_shapes(mcfg, ocfg, state_dtype)
    axes = state_logical_axes(mcfg, ocfg)

    def mk(shp, ax):
        if not (P.is_axes_leaf(ax) and len(ax) == shp.dim()):
            ax = (None,) * shp.dim()
        return L.sharding_for(mesh, ax, tuple(shp.shape), rules)

    return map_state(mk, shapes, axes)


def shard_tree(tree, shardings):
    """Full tensors -> DTensors of ``shardings``' layouts: each rank keeps
    its own slice (no communication)."""
    def one(x, sh):
        x = DTensor.from_local(x, sh.device_mesh,
                               [Replicate()] * sh.device_mesh.ndim,
                               run_check=False)
        return x.redistribute(sh.device_mesh, sh.placements)
    return map_state(one, tree, shardings)


class _Shards:
    """The model axis's layouts for the train step: params stored as
    DTensors over the whole mesh; computed with as DTensors over the
    rank's model column (the ``model`` dim), gathered over the others."""

    def __init__(self, mesh: HostMesh, rules: dict):
        self.mesh, self.rules = mesh, rules
        self.dm = mesh.device_mesh
        self.mm = self.dm["model"]
        self.md = mesh.axis_names.index("model")
        self.manual = tuple(a for a in mesh.axis_names if a != "model")

    def _gathered(self, placements):
        return [p if i == self.md else Replicate()
                for i, p in enumerate(placements)]

    def compute(self, params: P.Params) -> P.Params:
        """The storage DTensors gathered over the data axes, on the model
        column's mesh."""
        def one(p):
            full = self._gathered(p.placements)
            if list(p.placements) != full:
                p = p.redistribute(self.dm, full)
            return DTensor.from_local(p.to_local(), self.mm,
                                      [full[self.md]], run_check=False)
        return P.tree_map(one, params)

    def local(self, grads: P.Params, like: P.Params) -> P.Params:
        """Gradients (DTensors on the column's mesh) as the local shards
        of ``like``'s layout (a Partial sum is reduced here)."""
        def one(g, p):
            if g.placements != p.placements:
                g = g.redistribute(self.mm, p.placements)
            return g.to_local()
        return P.tree_map(one, grads, like)

    def storage(self, grads: P.Params, params: P.Params) -> P.Params:
        """Local gradients of the computed layout -> DTensors of the
        stored params' layout (each rank keeps its slice of the data
        axes: no communication)."""
        def one(g, p):
            full = self._gathered(p.placements)
            g = DTensor.from_local(g, self.dm, full, run_check=False)
            return (g if full == list(p.placements)
                    else g.redistribute(self.dm, p.placements))
        return P.tree_map(one, grads, params)

    def context(self):
        """The mesh active, the data axes manual, plain tensors taken as
        replicated."""
        stack = contextlib.ExitStack()
        stack.enter_context(L.activate_mesh(self.mesh, self.rules))
        stack.enter_context(L.manual_axes(self.manual))
        stack.enter_context(implicit_replication())
        return stack


def _shards(mesh: HostMesh) -> Optional[_Shards]:
    """The model axis's layouts under the active rules, or None for a
    model axis of 1 (the step's plain-tensor path)."""
    return (_Shards(mesh, L.current_rules()) if mesh.model_size > 1
            else None)


def _context(shards: Optional[_Shards]):
    return shards.context() if shards is not None else contextlib.nullcontext()


def _locals(tree: P.Params) -> P.Params:
    """A tree's local shards (its own tensors where they are plain)."""
    return P.tree_map(lambda x: x.to_local() if isinstance(x, DTensor)
                      else x, tree)


def _plain(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a Partial one reduced), else x."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _local_batch(batch: Batch) -> Batch:
    """This rank's rows: a DTensor batch (``shard_batch`` under a mesh)
    as its local shards."""
    return {k: v.to_local() if isinstance(v, DTensor) else v
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Pieces shared by both schedules
# ---------------------------------------------------------------------------
def _weights_fn(topo: Topology, device: torch.device
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """alive (G,) -> effective weights, with the topology's index tensors
    made once on ``device`` (so a step copies nothing from the host)."""
    cids = torch.from_numpy(topo.device_cluster_array()).to(device)
    heads = torch.tensor(topo.heads, dtype=torch.int64, device=device)
    return lambda alive: effective_weights_arrays(alive, cids, heads)


def _value_and_grad(params: P.Params, loss: Callable[[P.Params], Any]
                    ) -> Tuple[torch.Tensor, Any, P.Params]:
    """(value, aux, grads) of ``loss(params) -> (value, aux)`` with
    respect to every leaf; a leaf the loss does not reach gets zeros."""
    items = P.tree_items(params)
    leaves = [x.detach().requires_grad_(True) for _, x in items]
    value, aux = loss(P.tree_from_items(
        (path, leaf) for (path, _), leaf in zip(items, leaves)))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return (value.detach(), aux, P.tree_from_items(
        (path, g) for (path, _), g in zip(items, grads)))


def _cast_params(params: P.Params, dtype: Optional[str]) -> P.Params:
    """``param_cast_dtype``: float32 leaves cast once, others as they
    are."""
    if not dtype:
        return params
    dt = getattr(torch, dtype)
    return P.tree_map(lambda q: q.to(dt) if q.dtype == torch.float32 else q,
                      params)


def _split(batch: Batch, parts: int) -> List[Batch]:
    """``parts`` consecutive row blocks of every field."""
    rows = next(iter(batch.values())).shape[0] // parts
    return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            for i in range(parts)]


class _Comm:
    """Collectives among the federated groups of this rank's model column
    (the ranks with its model index; the whole world when the model axis
    is 1), addressed by group index; skipped where a group of ranks has
    one (the identity)."""

    def __init__(self, mesh: HostMesh):
        self.world = mesh.num_groups
        self.group = mesh.group
        self.m, self.M = mesh.model_index, mesh.model_size
        # the column's own group for the world-wide all-reduces
        self.column = (self.new_groups([list(range(self.world))])
                       if self.M > 1 else {})

    def rank_of(self, g: int) -> int:
        return g * self.M + self.m

    def new_groups(self, group_lists: List[List[int]]) -> Dict[str, Any]:
        """Make a process group of each list of group indices with more
        than one, in each model column (every rank calls this with the
        same lists, in the same order); returns the ``group`` and ``size``
        of this rank's, as :meth:`all_reduce`'s keyword arguments."""
        mine: Dict[str, Any] = {}
        for m in range(self.M):
            for groups in group_lists:
                grp = (dist.new_group([g * self.M + m for g in groups])
                       if len(groups) > 1 and self.world > 1 else None)
                if m == self.m and self.group in groups:
                    mine = {"group": grp, "size": len(groups)}
        return mine

    def all_reduce(self, buf: torch.Tensor, group=None, size: int = 0
                   ) -> torch.Tensor:
        if group is None and not size:
            group, size = self.column.get("group"), self.world
        if (size or self.world) > 1 and buf.numel():
            dist.all_reduce(buf, group=group)
        return buf

    def all_reduce_with(self, bufs: List[torch.Tensor],
                        scalars: List[torch.Tensor], **group
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """All-reduce a buffer a dtype and float32 ``scalars``: the
        scalars at the end of the first buffer where it is float32 (one
        collective for both, never a ``cat`` of two dtypes), else as a
        float32 buffer of their own.  Returns (the buffers, the scalars'
        sums)."""
        tail = torch.stack([s.to(torch.float32) for s in scalars])
        if bufs[0].dtype != torch.float32:
            return ([self.all_reduce(b, **group) for b in bufs],
                    self.all_reduce(tail, **group))
        k = bufs[0].numel()
        head = self.all_reduce(torch.cat([bufs[0], tail]), **group)
        return ([head[:k]] + [self.all_reduce(b, **group) for b in bufs[1:]],
                head[k:])

    def send(self, buf: torch.Tensor, dst: int) -> None:
        dist.send(buf, dst=self.rank_of(dst))

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        buf = torch.empty_like(like)
        dist.recv(buf, src=self.rank_of(src))
        return buf


def _pack(gs: List[torch.Tensor], *scalars: torch.Tensor) -> torch.Tensor:
    """One message of float32 scalars and the buffers gs (each in its
    dtype, float32's first), as bytes: the scalars first, so every part
    stays aligned to its dtype."""
    head = torch.stack([s.to(torch.float32) for s in scalars])
    return torch.cat([head.view(torch.uint8)]
                     + [g.reshape(-1).view(torch.uint8) for g in gs])


def _unpack(buf: torch.Tensor, likes: List[torch.Tensor], count: int
            ) -> Tuple[Any, ...]:
    """:func:`_pack`'s inverse: ([g, ...], scalar, ...)."""
    head = buf[:4 * count].view(torch.float32)
    gs, off = [], 4 * count
    for like in likes:
        end = off + like.numel() * like.element_size()
        gs.append(buf[off:end].view(like.dtype).reshape(like.shape))
        off = end
    return (gs,) + tuple(head[i] for i in range(count))


# ---------------------------------------------------------------------------
# Weighted all-reduce schedule (optimised)
# ---------------------------------------------------------------------------
def make_psum_train_step(mcfg: ModelConfig, tolfl: TolFLConfig,
                         ocfg: OptimizerConfig, mesh: HostMesh,
                         state_dtype: Optional[str] = None) -> Callable:
    """``step(state, batch, alive) -> (state, {"loss", "xent",
    "moe_aux"})``, ``batch`` this rank's rows of the global batch.

    The global batch's rows carry their group's effective weight as the
    loss mask; with ``microbatches`` m > 1 the GLOBAL batch is split into
    m row blocks, each weighted by its mask mass, so the accumulated
    gradient equals the single-batch weighted mean.  A rank computes, for
    its rows of each block, the gradient of (the block's loss on those
    rows) x (their mask mass); the all-reduce sums these and the total is
    divided by the global mass.

    The MoE aux loss is ``repro``'s: that of the whole global batch (or of
    each global block, weighted by the block's mask mass), its rows of
    dead groups included.  Over more than one rank it is no sum of the
    ranks' own aux losses (the load-balance term is a product of two
    means over all rows).  So a forward without a graph first gives each
    rank's ``moe_apply`` row sums of its blocks, one all-reduce sums them
    into the global blocks' sums, and each block's forward and backward
    then takes :func:`_moe_aux` of the rank's own row sums against the
    global ones: summed over ranks, that is the gradient of the global
    aux.  That costs one forward more a step, and keeps the activations
    held at one block's, as ``microbatches`` promises.  A dense config,
    or one rank, skips it: there a block's own aux is the global one.

    Gradients reach the optimizer in ``repro``'s dtypes: at
    ``microbatches`` 1 in each leaf's (the all-reduce sends a buffer a
    dtype), else float32, accumulated as ``repro`` accumulates them.  The
    loss is a float32 word at the end of the float32 buffer."""
    topo = global_topology(mesh, tolfl)
    G = topo.num_devices
    weights = _weights_fn(topo, mesh.device)
    opt = make_optimizer(ocfg, state_dtype=state_dtype)
    comm = _Comm(mesh)
    shards = _shards(mesh)
    mb = tolfl.microbatches
    spread_moe = mcfg.moe.num_experts > 0 and G > 1

    def train_step(state, batch: Batch, alive: torch.Tensor):
        with _context(shards):
            return _train_step(state, _local_batch(batch), alive)

    def _train_step(state, batch: Batch, alive: torch.Tensor):
        params = state["params"]
        cparams = params if shards is None else shards.compute(params)
        w = weights(alive)                               # (G,)
        B_loc, S = batch["labels"].shape
        B = B_loc * G
        my_w = w[mesh.group]
        mass = torch.sum(w) * (B_loc * S)                # global mask mass
        # this rank's rows [lo, hi) of the global batch, cut at the
        # microbatch boundaries
        lo = mesh.group * B_loc
        cuts = sorted({lo, lo + B_loc} | {
            i * (B // mb) for i in range(mb + 1)
            if lo < i * (B // mb) < lo + B_loc})
        layout = P.DtypeLayout.of(_locals(cparams),
                                  None if mb == 1 else torch.float32)
        g_acc = layout.zeros(mesh.device, tail=1)
        metrics = {}
        parts = []
        for a, b in zip(cuts, cuts[1:]):
            part = {k: v[a - lo:b - lo] for k, v in batch.items()}
            part["mask"] = my_w.expand(b - a, S)
            parts.append((a // (B // mb), part, my_w * ((b - a) * S)))
        if spread_moe:
            glob = _moe_block_sums(
                _cast_params(cparams, tolfl.param_cast_dtype), mcfg,
                parts, mb, comm)
            # each global block's mask mass
            block_w = torch.sum(torch.repeat_interleave(w, B_loc).reshape(
                mb, B // mb), dim=1) * S
        for blk, part, wi in parts:

            def f(p, blk=blk, part=part, wi=wi):
                # through the cast, so the f32 master gets f32 grads
                p = _cast_params(p, tolfl.param_cast_dtype)
                if not spread_moe:
                    lv, mets = T.loss_fn(p, mcfg, part)
                    return lv * wi, mets
                _, mets = T.loss_fn(p, mcfg, part, moe_sums=True)
                lv = (mets["xent"] * wi + block_w[blk] * _moe_aux(
                    mets["moe_sums"], glob[blk], mcfg.moe))
                # repro reports the last global block's aux
                return lv, {"xent": mets["xent"],
                            "moe_aux": _moe_aux(glob[-1], glob[-1], mcfg.moe)}

            jv, metrics, g = _value_and_grad(cparams, f)
            if shards is not None:
                g = shards.local(g, cparams)
            for buf, flat in zip(g_acc, layout.flatten(g)):
                buf[:flat.numel()] += flat
            g_acc[0][-1] += _plain(jv)
        g_acc = [comm.all_reduce(buf) / torch.clamp_min(mass, 1e-30)
                 for buf in g_acc]
        grads = layout.unflatten(g_acc)
        if shards is not None:
            grads = shards.storage(grads, params)
        updates, new_opt = opt.update(grads, state["opt"], params)
        new_params = apply_updates(params, updates)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        # the loss copied out of g_acc: a view would keep the flat
        # gradient alive as long as the caller keeps the metrics
        return new_state, {"loss": g_acc[0][-1].clone(),
                           **{k: _plain(v).detach()
                              for k, v in metrics.items()}}

    return train_step


def _moe_aux(sums: torch.Tensor, glob: torch.Tensor, moe: MoEConfig
             ) -> torch.Tensor:
    """The aux loss ``loss_fn`` adds (``router_aux_loss_coef`` x the mean
    over chunks of the load-balance term plus 1e-3 x that of z, summed over
    the MoE layers) from row sums (layers, chunks, 2 E + 2) as
    ``moe_apply`` gives them.  The dispatch fractions and the token count
    come from ``glob``, the probabilities and z from ``sums``: with sums =
    glob it is the aux of glob's rows, and it is linear in ``sums``, so
    the ranks' values (and gradients) sum to the global ones."""
    E = moe.num_experts
    n = glob[..., -1:]
    lb = E * torch.sum(glob[..., :E] / n * (sums[..., E:2 * E] / n), dim=-1)
    z = sums[..., 2 * E] / n[..., 0]
    return torch.sum(moe.router_aux_loss_coef * torch.mean(lb, dim=-1)
                     + 1e-3 * torch.mean(z, dim=-1))


def _moe_block_sums(params: P.Params, mcfg: ModelConfig,
                    parts: List[Tuple[int, Batch, torch.Tensor]], mb: int,
                    comm: _Comm) -> torch.Tensor:
    """The ``mb`` global row blocks' ``moe_apply`` row sums (mb, MoE
    layers, chunks, 2 E + 2): this rank's ``parts`` (block, rows, mask
    mass) through a forward without a graph, then one all-reduce."""
    glob = None
    with torch.no_grad():
        for blk, part, _ in parts:
            sums = _plain(T.loss_fn(params, mcfg, part,
                                    moe_sums=True)[1]["moe_sums"])
            if glob is None:
                glob = torch.zeros((mb,) + tuple(sums.shape),
                                   dtype=torch.float32, device=sums.device)
            glob[blk] += sums
    return comm.all_reduce(glob)


# ---------------------------------------------------------------------------
# Paper-faithful ring schedule
# ---------------------------------------------------------------------------
def make_ring_train_step(mcfg: ModelConfig, tolfl: TolFLConfig,
                         ocfg: OptimizerConfig, mesh: HostMesh,
                         state_dtype: Optional[str] = None) -> Callable:
    """``step(state, batch, alive) -> (state, {"loss", "n_effective"})``,
    ``batch`` this rank's rows: Algorithm 1 with this rank as one group.

    Each dtype's gradient buffer goes through the cluster all-reduce, the
    chain's hops, the pods' reduction and the final masked all-reduce in
    its own dtype (``grad_sync_dtype``'s where it is set), as ``repro``'s
    ``agg_shard`` takes each leaf; n and the loss stay float32.  The
    optimizer gets the leaves' dtypes, or float32 under
    ``grad_sync_dtype``, ``microbatches`` > 1 or ``local_epochs`` > 1."""
    sizes = mesh_axis_sizes(mesh)
    d_sz = sizes.get("data", 1)
    p_sz = sizes.get("pod", 1)
    has_pod = "pod" in sizes and p_sz > 1
    topo_data = Topology(d_sz, min(tolfl.num_clusters, d_sz))
    topo_glob = Topology(p_sz * d_sz, min(tolfl.num_clusters * p_sz,
                                          p_sz * d_sz))
    heads = topo_data.heads
    last_head = heads[-1]
    weights = _weights_fn(topo_glob, mesh.device)
    opt = make_optimizer(ocfg, state_dtype=state_dtype)
    comm = _Comm(mesh)
    shards = _shards(mesh)
    gi = mesh.group
    di, pi = gi % d_sz, gi // d_sz
    f32 = torch.float32

    # bf16 grad sync: the point-to-point chain carries the narrow dtype on
    # every backend; the all-reduces only with NCCL (gloo's CPU reductions
    # stay float32, as repro keeps its CPU psums float32)
    sync_dt = getattr(torch, tolfl.grad_sync_dtype) \
        if tolfl.grad_sync_dtype else None
    psum_dt = (sync_dt if sync_dt is not None and dist.is_initialized()
               and dist.get_backend() == "nccl" else None)

    # every process group, once, in one order on every rank
    cluster = comm.new_groups([[p * d_sz + d for d in c]
                               for p in range(p_sz)
                               for c in topo_data.psum_index_groups()])
    pods = (comm.new_groups([[p * d_sz + d for p in range(p_sz)]
                             for d in range(d_sz)])
            if has_pod and not tolfl.pod_ring else {})

    def hop(carry, src: int, dst: int, is_tgt: bool):
        """One chain hop: ``src`` sends (n, gs, loss); ``dst`` combines."""
        n, gs, loss = carry
        if gi == src:
            comm.send(_pack(gs, n, loss), dst)
        elif gi == dst:
            rgs, rn, rl = _unpack(comm.recv(_pack(gs, n, loss), src), gs, 2)
            if is_tgt:
                gs_new = [agg.combine_pair(rn, rg, n, g)[1]
                          for rg, g in zip(rgs, gs)]
                n_new, l_new = agg.combine_pair(rn, rl, n, loss)
                return n_new, gs_new, l_new
        return carry

    def aggregate(gs: List[torch.Tensor], n: torch.Tensor,
                  loss: torch.Tensor):
        """gs: a gradient buffer a dtype (float32's first)."""
        # ---- intra-cluster FedAvg (an all-reduce over member groups) ----
        # normalise BEFORE the reduce: r = n_i / sum n stays in [0, 1], so
        # the payload is well-scaled even under bf16 grad sync
        den = comm.all_reduce(n.reshape(1).clone(), **cluster)[0]
        r_w = n / torch.clamp_min(den, 1e-30)
        g_c, (loss_c,) = comm.all_reduce_with(
            [(g * r_w.to(g.dtype)).to(psum_dt or g.dtype) for g in gs],
            [loss * r_w], **cluster)
        if sync_dt is not None:
            g_c = [g.to(sync_dt) for g in g_c]    # the chain's payload
        carry = (den, g_c, loss_c)
        # ---- sequential SBT chain over cluster heads (Algorithm 1) ----
        for h, perm in enumerate(topo_data.ring_perms()):
            (src, dst), = perm
            carry = hop(carry, pi * d_sz + src, pi * d_sz + dst,
                        di == heads[h + 1])
        # ---- outer SBT ring over pods ----
        at_last = di == last_head
        if has_pod and tolfl.pod_ring:
            for h in range(p_sz - 1):
                carry = hop(carry, h * d_sz + last_head,
                            (h + 1) * d_sz + last_head,
                            at_last and pi == h + 1)
            is_final = at_last and pi == p_sz - 1
        else:
            is_final = at_last
        n_c, g_c, l_c = carry
        fin = float(is_final)
        if sync_dt is not None and psum_dt is None:
            g_c = [g.to(f32) for g in g_c]
        if has_pod and not tolfl.pod_ring:
            # no pod ring: weighted all-reduce across pods at the heads,
            # each buffer in its dtype
            wn = n_c * fin
            g_c, (nsum, lsum) = comm.all_reduce_with(
                [g * wn.to(g.dtype) for g in g_c], [wn, l_c * wn], **pods)
            den = torch.clamp_min(nsum, 1e-30)
            g_c = [g / den.to(g.dtype) for g in g_c]
            l_c, n_c = lsum / den, nsum
        # ---- broadcast theta_{t+1} (masked all-reduce) ----
        g_fin, (l_fin, n_fin) = comm.all_reduce_with(
            [g * fin for g in g_c], [l_c * fin, n_c * fin])
        return g_fin, l_fin, n_fin

    def local_grads(params: P.Params, batch: Batch):
        def local_loss(p, b=batch):
            return T.loss_fn(p, mcfg, b)

        if tolfl.local_epochs > 1:
            p, lv = params, None
            for _ in range(tolfl.local_epochs):
                lv, _, g = _value_and_grad(p, local_loss)
                p = P.tree_map(lambda a, b: a - ocfg.lr * b.to(a.dtype), p, g)
            grads = P.tree_map(lambda a, b: (a - b).to(f32) / ocfg.lr,
                               params, p)
            return grads, lv
        if tolfl.microbatches > 1:
            mb = tolfl.microbatches
            grads = P.tree_map(lambda p: torch.zeros_like(p, dtype=f32),
                               params)
            lv = torch.zeros((), dtype=f32, device=mesh.device)
            for part in _split(batch, mb):
                lv_i, _, g_i = _value_and_grad(
                    params, lambda p, b=part: T.loss_fn(p, mcfg, b))
                grads = P.tree_map(lambda a, g: a + g / mb, grads, g_i)
                lv = lv + lv_i / mb
            return grads, lv
        lv, _, grads = _value_and_grad(params, local_loss)
        return grads, lv

    def train_step(state, batch: Batch, alive: torch.Tensor):
        with _context(shards):
            return _train_step(state, _local_batch(batch), alive)

    def _train_step(state, batch: Batch, alive: torch.Tensor):
        params = state["params"]
        cparams = params if shards is None else shards.compute(params)
        grads, lv = local_grads(cparams, batch)
        if shards is not None:
            grads = shards.local(grads, cparams)
        layout = P.DtypeLayout.of(grads)
        flat = layout.flatten(grads)
        del grads                         # the tree's memory, before the sync
        n = weights(alive)[gi] * batch["tokens"].numel()
        g_fin, loss, n_tot = aggregate(flat, n, _plain(lv))
        del flat
        if tolfl.grad_sync_dtype:
            # f32 master grads for the optimizer
            g_fin = [g.to(f32) for g in g_fin]
        # g_fin holds the broadcast's own buffers: masked in place (0 and
        # 1 are exact in every dtype)
        has = n_tot > 0
        g = layout.unflatten([g.mul_(has.to(g.dtype)) for g in g_fin])
        if shards is not None:
            g = shards.storage(g, params)
        updates, new_opt = opt.update(g, state["opt"], params)
        new_params = apply_updates(params, updates)
        # copied out of the broadcast's buffer: views would keep the flat
        # gradient alive as long as the caller keeps the metrics
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1},
                {"loss": loss.clone(), "n_effective": n_tot.clone()})

    return train_step


def make_train_step(mcfg: ModelConfig, tolfl: TolFLConfig,
                    ocfg: OptimizerConfig, mesh: HostMesh,
                    state_dtype: Optional[str] = None) -> Callable:
    if tolfl.schedule in ("tolfl_psum", "fedavg"):
        return make_psum_train_step(mcfg, tolfl, ocfg, mesh, state_dtype)
    if tolfl.schedule in ("tolfl_ring", "sbt_ring"):
        return make_ring_train_step(mcfg, tolfl, ocfg, mesh, state_dtype)
    raise ValueError(tolfl.schedule)
