"""Logical-axis sharding rules (MaxText-style), laid out on DTensor.

Port of ``repro.sharding.logical``.  Every parameter / activation
dimension gets a *logical* axis name; a rules table maps logical names to
physical mesh axes ("pod", "data", "model").  ``spec_for(axes, shape)``
builds a :class:`PartitionSpec`, dropping any mapping whose dimension is
not divisible by the mesh-axis size (an uneven ``Shard`` fails at the
first ``view`` of a DTensor, as GSPMD rejects it: 40 heads over a 16-wide
model axis stay replicated).

Two storage modes:

* ``replicated_data`` -- params sharded over "model" only, replicated over
  the Tol-FL data axis.  Required for the paper-faithful ring schedule
  (each federated group holds a full model replica) and for E > 1 local
  epochs.
* ``fsdp`` -- params additionally sharded over "data" on the d_model dims.
  Required for the 100B+ architectures; only compatible with the
  weighted all-reduce schedule at E = 1.

The device half is ``torch.distributed.tensor`` (DTensor), the port's
counterpart of GSPMD: a spec maps one to one onto placements (an entry
naming mesh axes is ``Shard(dim)`` on each of those mesh dims, ``None``
is ``Replicate()``), :func:`constrain` is ``DTensor.redistribute``, and
DTensor's sharding propagation inserts the collectives that XLA's
partitioner inserts in ``repro``.  The kernels see local shards only
(``kernels/flash_attention.py``, ``rwkv6_scan.py``, ``rglru_scan.py``).

A rank of the port is always "manual" over the axes its program runs
over by hand (the train step's data axes: :func:`manual_axes`), so
``repro``'s ``compat_shard_map`` / ``FULL_MANUAL_FALLBACK`` (a jax-version
shim) have no twin here.  :func:`scenario_shard_map` spreads a
campaign's independent scenarios over the local cards, one host thread a
card, with no collective and no process group.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# Logical axis vocabulary.
BATCH = "batch"
SEQ = "seq"
EMBED = "embed"          # d_model dims
FF = "ff"                # mlp hidden
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
VOCAB = "vocab"
EXPERTS = "experts"
LAYERS = "layers"        # stacked layer dim
CACHE_SEQ = "cache_seq"  # kv-cache length dim (sequence-parallel decode)
STATE = "state"          # recurrent state width
CONV = "conv"

# rules: logical -> physical mesh axis (or tuple, or None)
BASE_RULES = {
    BATCH: ("pod", "data"),
    SEQ: None,
    EMBED: None,
    FF: "model",
    HEADS: "model",
    KV_HEADS: "model",
    HEAD_DIM: None,
    VOCAB: "model",
    EXPERTS: "model",
    LAYERS: None,
    CACHE_SEQ: ("pod", "data"),   # flash-decoding style sequence-parallel cache
    STATE: "model",
    CONV: None,
}

# FSDP overlay: additionally shard the d_model dims over the data axis
# (storage + all-gather at use; the gradient sync is the weighted
# all-reduce schedule).
FSDP_RULES = dict(BASE_RULES)
FSDP_RULES.update({
    EMBED: ("pod", "data"),
})


def rules_for(mode: str = "replicated_data") -> dict:
    return FSDP_RULES if mode == "fsdp" else dict(BASE_RULES)


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None``, a mesh axis name or a tuple of
    them (``jax.sharding.PartitionSpec``'s entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


PS = PartitionSpec


# ---------------------------------------------------------------------------
# Active mesh plumbing.  Launchers call ``activate_mesh``; model code calls
# ``constrain``, which is the identity when no mesh is active.
# ---------------------------------------------------------------------------
_STATE = threading.local()


def current_mesh():
    return getattr(_STATE, "mesh", None)


def current_rules() -> dict:
    return getattr(_STATE, "rules", BASE_RULES)


@contextlib.contextmanager
def activate_mesh(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` (a :class:`~repro_torch.launch.mesh.HostMesh`) and
    ``rules`` the ones :func:`constrain` and :func:`spec_for` read."""
    prev = (current_mesh(), current_rules())
    _STATE.mesh, _STATE.rules = mesh, (rules or BASE_RULES)
    try:
        yield mesh
    finally:
        _STATE.mesh, _STATE.rules = prev


def current_manual() -> frozenset:
    return getattr(_STATE, "manual", frozenset())


@contextlib.contextmanager
def manual_axes(names):
    """Mark mesh axes as run by hand: :func:`constrain` then omits them
    (inside the train step each rank holds its own rows of the batch and
    DTensors live on the mesh of the other axes)."""
    prev = current_manual()
    _STATE.manual = prev | frozenset(names)
    try:
        yield
    finally:
        _STATE.manual = prev


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a HostMesh, a DeviceMesh or any mesh with
    ``axis_names`` and ``devices`` (a ``jax`` mesh's fields)."""
    if hasattr(mesh, "sizes"):
        return dict(mesh.sizes)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None,
             rules: Optional[dict] = None,
             mesh=None) -> PartitionSpec:
    """PartitionSpec from logical axis names, dropping uneven shardings.

    Mesh axes absent from the mesh (e.g. "pod" on single-pod) are
    dropped; a physical axis is used at most once per spec."""
    rules = rules or current_rules()
    mesh = mesh or current_mesh()
    if mesh is None:
        return PS()
    sizes = mesh_axis_sizes(mesh)
    used = set()
    out = []
    for i, ax in enumerate(axes):
        phys = rules.get(ax) if ax is not None else None
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        keep = []
        prod = 1
        for p in phys:
            if p not in sizes or p in used:
                continue
            sz = sizes[p]
            if shape is not None and shape[i] % (prod * sz) != 0:
                continue
            keep.append(p)
            prod *= sz
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return PS(*out)


def _drop(spec: PartitionSpec, names) -> PartitionSpec:
    """``spec`` without the mesh axes ``names``."""
    out = []
    for p in spec:
        if isinstance(p, tuple):
            p = tuple(q for q in p if q not in names) or None
            if p is not None and len(p) == 1:
                p = p[0]
        elif p in names:
            p = None
        out.append(p)
    return PS(*out)


def placements_for(spec: PartitionSpec, dim_names: Sequence[str]
                   ) -> Tuple:
    """DTensor placements of ``spec`` on a device mesh whose dims are
    ``dim_names``: ``Shard(i)`` on each mesh dim that tensor dim i names,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for i, p in enumerate(spec):
        for q in ((p,) if isinstance(p, str) else (p or ())):
            where[q] = i
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in dim_names)


@dataclass(frozen=True)
class Sharding:
    """A DTensor layout: the device mesh and one placement a mesh dim
    (``jax.sharding.NamedSharding``'s counterpart)."""
    device_mesh: object
    placements: Tuple
    spec: PartitionSpec

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """This rank's shard shape of a tensor of ``shape``."""
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        return tuple(compute_local_shape_and_global_offset(
            tuple(shape), self.device_mesh, list(self.placements))[0])


def sharding_for(mesh, axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None,
                 rules: Optional[dict] = None) -> Sharding:
    spec = spec_for(axes, shape, rules, mesh)
    dm = mesh.device_mesh
    return Sharding(dm, placements_for(spec, dm.mesh_dim_names), spec)


def auto_mesh():
    """The device mesh of the active mesh's axes that are not manual, or
    None (no mesh, or every axis manual)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    names = tuple(n for n in mesh.axis_names if n not in current_manual())
    if not names:
        return None
    dm = mesh.device_mesh
    return dm if len(names) == len(mesh.axis_names) else dm[names]


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]],
              rules: Optional[dict] = None) -> torch.Tensor:
    """``x`` redistributed to the spec of ``axes`` on the active mesh.

    The identity where no mesh is active, where the spec is all ``None``
    once the manual axes are dropped (as ``repro`` skips a fully
    replicated constraint), and for a plain tensor on a mesh whose mapped
    axes all have size 1.  A plain tensor elsewhere is taken as
    replicated over the mesh of the non-manual axes.

    One exception to the all-``None`` identity: a DTensor that is a
    pending sum (a ``Partial`` placement: a row-parallel product's output,
    a vocab-sharded embedding's lookup) is reduced there, which is where
    XLA's partitioner reduces it in ``repro`` (the residual stream is
    replicated).  Left pending, DTensor's per-op propagation scatters it
    over the d_model dim at the next add and gathers it back at every
    product after."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = spec_for(axes, tuple(x.shape), rules, mesh)
    manual = current_manual()
    if manual:
        spec = _drop(spec, manual)
    from torch.distributed.tensor import DTensor, Replicate
    if all(p is None for p in spec):
        if isinstance(x, DTensor) and any(p.is_partial()
                                          for p in x.placements):
            return x.redistribute(x.device_mesh, [
                Replicate() if p.is_partial() else p for p in x.placements])
        return x
    if not isinstance(x, DTensor):
        sizes = mesh_axis_sizes(mesh)
        named = [q for p in spec
                 for q in ((p,) if isinstance(p, str) else (p or ()))]
        if all(sizes[q] == 1 for q in named):
            return x
        dm = auto_mesh()
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    place = placements_for(spec, x.device_mesh.mesh_dim_names)
    if tuple(x.placements) == place:
        return x
    return x.redistribute(x.device_mesh, place)


def even_view(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``x`` ready for a view that splits its dim ``dim`` into ``parts``
    leading pieces (heads): a DTensor sharded there over mesh dims that
    ``parts`` does not divide by is gathered on them first.  DTensor
    cannot unflatten an uneven shard (8 kv heads' 1,024 columns split 16
    ways), where GSPMD reshards around the reshape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    split = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            split *= size
    if parts % split == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements])


class _EvenGrad(torch.autograd.Function):
    """The identity, whose backward passes the gradient through
    :func:`even_view` (a merge's backward unflattens the gradient)."""

    @staticmethod
    def forward(ctx, x, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return even_view(g, ctx.dim, ctx.parts), None, None


def merged_heads(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``x`` (heads merged into its dim ``dim``), whose gradient is made
    ready for the backward's view back into ``parts`` heads."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _EvenGrad.apply(x, dim, parts)


def keep_shard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor gathered on every mesh dim but those that shard its dim
    ``dim``; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    keep = [p if isinstance(p, Shard) and p.dim == dim else Replicate()
            for p in x.placements]
    return x if keep == list(x.placements) else x.redistribute(
        x.device_mesh, keep)


def shardwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of ``x``, on a DTensor's local shard, for an ``fn`` that
    treats the sharded dims' slices independently (an elementwise op, a
    pad along a dim that is not sharded): for ops that DTensor has no
    strategy for (``log_sigmoid_backward``) or whose strategy fails
    (``constant_pad_nd`` on a 3-d mesh in torch 2.11)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


# ---------------------------------------------------------------------------
# Local shards: the seam of the kernel wrappers (and of the MoE experts'
# products) for DTensor inputs.
#
# A wrapper given a DTensor calls :func:`local_call`: each input is
# redistributed to a layout the function can compute shard by shard,
# taken ``to_local``, passed to the function (a kernel wrapper's
# plain-tensor path: the kernel on the card, its plain version on the
# CPU, shapes alone on ``meta``) and the outputs are put back with
# ``from_local``.  Both steps are differentiable, so the kernels' own
# backwards run on the local shards too.  Which dims may stay sharded is
# the caller's to say, by naming each input's dims (``roles``): a mesh dim
# that shards the first DTensor input on a role in ``keep`` (batch, heads,
# channels, experts: dims computed independently) stays sharded on that
# role in every input that has it; every other placement becomes
# ``Replicate`` (an all-gather, e.g. of a sequence dim a kernel scans
# along).  An input without the role is replicated on that mesh dim and
# its gradient there is a ``Partial`` sum of the ranks' shares.
# ---------------------------------------------------------------------------
def any_dtensor(*ts) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def local_call(fn: Callable, args: Sequence[Optional[torch.Tensor]],
               roles: Sequence[Tuple[Optional[str], ...]],
               keep: Sequence[str],
               out_roles: Sequence[Tuple[Optional[str], ...]],
               info: Optional[dict] = None,
               sums: Optional[Sequence[bool]] = None):
    """``fn(*local args)`` over the mesh of the DTensors in ``args``.

    ``roles[i]`` names arg i's dims; ``out_roles`` the outputs' (a tuple
    of outputs where ``fn`` returns one).  A mesh dim stays sharded on
    the role of the first DTensor arg that shards it on a role in
    ``keep``.  An output marked in ``sums`` is a ``Partial`` sum on the
    mesh dims whose role it lacks (each rank's share of a contraction
    over them), else replicated there.  ``info``, if given, receives
    ``mesh``, ``sharded`` (mesh dim -> role) and ``offsets`` (arg index ->
    the global offset of its local shard)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    sharded = []
    for md in range(mesh.ndim):
        role = None
        for a, dims in zip(args, roles):
            pl = a.placements[md] if isinstance(a, DTensor) else None
            if isinstance(pl, Shard) and dims[pl.dim] in keep:
                role = dims[pl.dim]
                break
        sharded.append(role)

    def place(dims, partial=False):
        return [Shard(dims.index(r)) if r is not None and r in dims
                else Partial() if r is not None and partial
                else Replicate() for r in sharded]

    local, offsets = [], {}
    for i, (a, dims) in enumerate(zip(args, roles)):
        if a is None:
            local.append(None)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = place(dims)
        if list(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        offsets[i] = compute_local_shape_and_global_offset(
            tuple(a.shape), mesh, pl)[1]
        grad = [Partial() if r is not None and r not in dims else p
                for r, p in zip(sharded, pl)]
        local.append(a.to_local(grad_placements=grad))
    if info is not None:
        info.update(mesh=mesh, sharded=dict(enumerate(sharded)),
                    offsets=offsets)
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    sums = sums or (False,) * len(outs)
    wrapped = tuple(
        None if o is None else DTensor.from_local(o, mesh, place(dims, s),
                                                  run_check=False)
        for o, dims, s in zip(outs, out_roles, sums))
    return wrapped[0] if single else wrapped


def heads_call(fn: Callable, q: torch.Tensor,
               kvs: Sequence[torch.Tensor], rest: Sequence[torch.Tensor] = ()
               ) -> torch.Tensor:
    """``fn(q, *kvs, *rest)`` of attention operands on their local shards:
    q (B, Sq, H, D) and each kv (B, Sk, KVH, D) keep the batch and the
    heads sharded and gather the rest; ``rest`` is gathered whole.  Where
    q's heads are split but the kv heads do not divide by the split (GQA:
    8 kv heads over a 16-wide model axis), the kvs stay replicated and
    each rank passes ``fn`` the kv heads its own q heads use, so a kernel's
    ``h // (H / KVH)`` grouping holds locally: a slice where the local
    heads cover whole groups or share one, else one kv head a q head
    (index_select).  Their gradients are then partial sums over the
    ranks.  Returns q-shaped output laid out as q."""
    from torch.distributed.tensor import DTensor, Shard
    H, KVH = q.shape[2], kvs[0].shape[2]
    split = 1
    if isinstance(q, DTensor):
        for size, pl in zip(q.device_mesh.shape, q.placements):
            if isinstance(pl, Shard) and pl.dim == 2:
                split *= size
    kv_split = KVH % split == 0
    q_roles = ("b", None, "h", None)
    kv_roles = ("b", None, "h" if kv_split else None, None)
    info: dict = {}

    def local(ql, *more):
        kl, r = list(more[:len(kvs)]), more[len(kvs):]
        Hl = ql.shape[2]
        if not kv_split and Hl != H:
            g, h0 = H // KVH, info["offsets"][0][2]
            if Hl % g == 0 and h0 % g == 0:
                sel = slice(h0 // g, (h0 + Hl) // g)
            elif h0 // g == (h0 + Hl - 1) // g:
                sel = slice(h0 // g, h0 // g + 1)
            else:
                sel = torch.arange(h0, h0 + Hl, device=ql.device) // g
            kl = [t[:, :, sel].contiguous() for t in kl]
        return fn(ql, *kl, *r)

    return local_call(local, (q, *kvs, *rest),
                      (q_roles,) + (kv_roles,) * len(kvs)
                      + tuple((None,) * t.dim() for t in rest),
                      ("b", "h"), (q_roles,), info)


# ---------------------------------------------------------------------------
# Scenario sharding: the campaign executor's data parallelism over the
# independent scenarios of a Monte-Carlo grid.
# ---------------------------------------------------------------------------
def _place(x, device: torch.device):
    """``x`` on ``device``: a tensor moved there (no copy when it is
    there already), a tuple (a NamedTuple too) field by field, anything
    else (host arrays, ints, layouts, None) as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        fields = [_place(v, device) for v in x]
        return type(x)(*fields) if hasattr(x, "_fields") else tuple(fields)
    return x


def _on_device(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def scenario_shard_map(f: Callable, devices: Sequence, n_bcast: int,
                       n_mapped: int) -> Callable[..., list]:
    """Shard a batched campaign executable over the ``devices`` of a
    "scenario" axis: the port of ``repro.sharding.scenario_shard_map``,
    which takes a device count where this takes the list of torch devices
    (one device may appear more than once).

    The returned ``g(*args)`` replicates the leading ``n_bcast`` arguments
    (data and topology broadcasts) to each device and splits the trailing
    ``n_mapped`` arguments (the flattened (cell x trace x seed) scenario
    operands) on their leading axis into ``len(devices)`` equal parts, one
    a device; the caller pads the batch to a device-divisible size.
    Tensors are placed on their shard's device; host arrays are split and
    stay on the host.  A broadcast argument passed again as the same
    object is not copied again, so a bucket's chunks send its data to each
    device once.  ``f(i, *local_args)`` runs shard ``i`` under its
    device's guard; ``i`` is the shard's position in ``devices``, the twin
    of ``jax.lax.axis_index("scenario")`` in ``repro``'s region.  ``g``
    returns f's outputs split the same way: a list, one entry a device, in
    the order of ``devices``.

    Over more than one device each shard runs on a host thread of its own
    (named ``scenario-shard-<i>``), all started together and joined before
    ``g`` returns, so the round loops of all shards are in flight at once:
    a shard's loop neither waits on another's nor on the host.  Placement
    happens on the calling thread, before the threads start; the first
    shard's error, if any, is raised after all have ended.  There is no
    collective, as in ``repro``."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("scenario_shard_map needs at least one device")
    ndev = len(devices)
    replicas: Dict[int, Tuple[object, list]] = {}

    def g(*args) -> list:
        if len(args) != n_bcast + n_mapped:
            raise TypeError(f"scenario_shard_map: {len(args)} arguments for "
                            f"{n_bcast} broadcast + {n_mapped} mapped")
        for i, a in enumerate(args[:n_bcast]):
            if i not in replicas or replicas[i][0] is not a:
                replicas[i] = (a, [_place(a, d) for d in devices])
        mapped = args[n_bcast:]
        B = int(mapped[0].shape[0]) if mapped else 0
        if any(int(m.shape[0]) != B for m in mapped) or B % ndev:
            raise ValueError(
                f"scenario_shard_map: mapped leading axes "
                f"{[int(m.shape[0]) for m in mapped]} do not split evenly "
                f"over {ndev} devices")
        s = B // ndev
        local = [[replicas[i][1][j] for i in range(n_bcast)]
                 + [_place(m[j * s:(j + 1) * s], d) for m in mapped]
                 for j, d in enumerate(devices)]
        if ndev == 1:
            with _on_device(devices[0]):
                return [f(0, *local[0])]
        outs: list = [None] * ndev
        errors: list = [None] * ndev

        def shard(j: int) -> None:
            try:
                with _on_device(devices[j]):
                    outs[j] = f(j, *local[j])
            except BaseException as e:          # re-raised on the caller
                errors[j] = e

        threads = [threading.Thread(target=shard, args=(j,),
                                    name=f"scenario-shard-{j}")
                   for j in range(ndev)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return outs

    return g
