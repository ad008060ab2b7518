"""Declarative experiment layer: one spec -> plan -> execute pipeline.

Port of ``repro.core.experiment``.  The paper's headline results are
grids over {scheme, k, failure pattern, seed}; this module is their one
entry point:

* an :class:`ExperimentSpec` *declares* a study — dataset and detector
  body (:class:`DataSpec`), a grid of (scheme, k/M) cells
  (:class:`CellSpec`), the failure conditions (:class:`TraceSpec`:
  explicit traces, sampled failure-rate grids and generative failure
  processes), the seed population (:class:`SeedSpec`) and the execution
  policy (:class:`repro_torch.core.campaign.ExecPlan`);
* :func:`plan` *lowers* the spec to an :class:`ExecutionPlan` on the
  host alone — groups cells into fused iso-tracking buckets, chooses
  per-kind pad-k / pad-M, samples each cell's traces against its own
  topology on the CPU, and computes the chunk geometry.  It touches no
  card, so plans are printable (:meth:`ExecutionPlan.describe`) and
  testable anywhere, and equal ``repro``'s plan for the same spec;
* :func:`execute` runs each bucket as one round loop (per chunk) with a
  leading scenario axis (``campaign._run_group`` /
  ``campaign._run_multi_group``) on ``device`` and returns an
  :class:`ExperimentResult`: per-scenario arrays keyed by (cell, trace,
  seed) with ``.summary()`` / ``.per_cell()`` / ``.to_rows()``.

The legacy entry points of :mod:`repro_torch.core.campaign`
(``run_campaign``, ``run_fused_campaigns``, ``sweep_grid``,
``run_multimodel_campaign``, ``run_fused_multimodel_campaigns``) are
shims over this pipeline, as in ``repro``.

RNG, by the port's rule that draws are operands: :func:`execute` takes
``params0`` (one param tree a seed, for the single-model cells) and
``draws`` (one ``baselines.MultiDraws`` a seed, for the multi-model
cells) as the campaign entry points do; see
:mod:`repro_torch.core.campaign`.

``plan(spec, check=True)`` (or :meth:`ExecutionPlan.static_report`) runs
the plan-time static analyzer (:mod:`repro_torch.analysis.plancheck`):
one round of each bucket at its predicted shapes on the meta device,
which executes nothing.  ``ExecPlan(aot=True)`` resolves the kernel
libraries and launches each bucket's kernels once before the first
round; either way :func:`execute` attaches a :class:`CompileReport`.

Typical use::

    spec = ExperimentSpec(
        data=DataSpec(model=detector, device_x=dx, device_counts=counts,
                      test_x=tx, test_y=ty),
        base=SimConfig(num_devices=10, rounds=40, lr=1e-3),
        cells=(CellSpec("tolfl", 5), CellSpec("fl", 1),
               CellSpec("ifca", 3)),
        traces=TraceSpec(traces=(NO_FAILURE, FailureSpec(20, "server")),
                         p_grid=(0.1, 0.3), traces_per_p=4),
        seeds=SeedSpec.range(3))
    p = plan(spec)            # host only; inspect p.describe() first
    res = execute(p)          # one round loop per bucket, on the card
    res.per_cell()[("tolfl", 5)].summary()["auroc_used_mean"]
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.autoencoder_paper import AutoencoderConfig
from repro_torch.core import campaign as _c
from repro_torch.core import compilecache
from repro_torch.core.baselines import (KMEANS_ITERS, FaultyMultiModelConfig,
                                        MultiDraws, MultiModelConfig,
                                        as_multimodel_trace)
from repro_torch.core.campaign import (MULTI_SCHEMES, CampaignResult, ExecPlan,
                                       MultiCampaignResult)
from repro_torch.core.failure import (Failure, FailureSpec, FailureTrace,
                                      as_trace, sample_rate_grid)
from repro_torch.core.processes import ProcessGrid, sample_process_grids
from repro_torch.core.simulate import FaultySimConfig, SimConfig
from repro_torch.core.topology import Topology
from repro_torch.models.detector import (AutoencoderDetector, ModelLike,
                                         as_detector)
from repro_torch.models.params import Params

#: single-model schemes the simulator core understands
SINGLE_SCHEMES = ("batch", "fl", "sbt", "tolfl")

#: fired at most once per process; tests reset it to re-pin the warning
_AE_CFG_WARNED = False


# ---------------------------------------------------------------------------
# Spec dataclasses (the declarative surface)
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class DataSpec:
    """Dataset + federated partition + detector body of one experiment.

    ``model`` is the detector spec the campaign trains — any
    :class:`repro_torch.models.detector.DetectorModel` (or a raw
    :class:`AutoencoderConfig`, which normalises to the paper
    autoencoder).  ``device_x`` is the (N, n_max, D) padded per-device
    array, ``device_counts`` the (N,) true sample counts (host arrays).
    ``name`` is cosmetic (it tags :meth:`ExperimentResult.to_rows`).

    ``ae_cfg`` is the deprecated spelling of ``model``: constructing with
    it still works (one ``DeprecationWarning`` per process), and reading
    it back returns the :class:`AutoencoderConfig` of autoencoder specs
    (None otherwise)."""
    model: Optional[ModelLike] = None
    device_x: Optional[np.ndarray] = None
    device_counts: Optional[np.ndarray] = None
    test_x: Optional[np.ndarray] = None
    test_y: Optional[np.ndarray] = None
    name: str = ""
    ae_cfg: Optional[AutoencoderConfig] = None

    def __post_init__(self):
        global _AE_CFG_WARNED
        model = self.model
        if model is None:
            if self.ae_cfg is None:
                raise TypeError(
                    "DataSpec needs a detector spec: pass model= (a "
                    "DetectorModel or AutoencoderConfig)")
            if not _AE_CFG_WARNED:
                warnings.warn(
                    "DataSpec(ae_cfg=...) is deprecated; pass model= "
                    "(any repro_torch.models.detector.DetectorModel — a raw "
                    "AutoencoderConfig still normalises to the paper "
                    "autoencoder)", DeprecationWarning, stacklevel=3)
                _AE_CFG_WARNED = True
            model = self.ae_cfg
        det = as_detector(model)
        object.__setattr__(self, "model", det)
        object.__setattr__(
            self, "ae_cfg",
            det.cfg if isinstance(det, AutoencoderDetector) else None)


@dataclass(frozen=True, eq=False)
class CellSpec:
    """One grid cell: a scheme plus its k (clusters) or M (models).

    ``overrides`` are (field, value) pairs applied on top of the config
    derived from the experiment's base :class:`SimConfig`.  ``traces``
    (optional) replaces the experiment-level explicit trace list for this
    cell only (sampled grids still apply).  ``cfg`` (optional) bypasses
    derivation with a fully-formed :class:`SimConfig` /
    :class:`MultiModelConfig` — the legacy shims use it.

    Single-model schemes (batch / fl / sbt / tolfl) read k as the cluster
    count; multi-model schemes (fedgroup / ifca / fesem) read it as the
    model count M and inherit the single-model cells' total local-step
    budget (base.rounds x base.local_epochs)."""
    scheme: str
    k: int = 1
    overrides: Tuple[Tuple[str, Any], ...] = ()
    traces: Optional[Sequence[Failure]] = None
    label: Optional[str] = None
    cfg: Optional[Union[SimConfig, MultiModelConfig]] = None

    @property
    def kind(self) -> str:
        """"single" or "multi" — which engine runs this cell (a ``cfg``
        decides by its class, so its scheme must belong to it)."""
        if self.cfg is not None:
            scheme = self.cfg.scheme
            multi = isinstance(self.cfg, MultiModelConfig)
        else:
            scheme = self.scheme
            multi = scheme in MULTI_SCHEMES
        if scheme in (MULTI_SCHEMES if multi else SINGLE_SCHEMES):
            return "multi" if multi else "single"
        raise ValueError(
            f"unknown scheme {scheme!r}: single-model schemes are "
            f"{SINGLE_SCHEMES}, multi-model baselines {MULTI_SCHEMES}")

    def resolve(self, base: SimConfig
                ) -> Union[SimConfig, MultiModelConfig]:
        """The cell's full config, derived from ``base`` (or ``cfg``)."""
        if self.cfg is not None:
            return self.cfg
        if self.kind == "multi":
            cfg: Any = MultiModelConfig(
                scheme=self.scheme, num_devices=base.num_devices,
                num_models=self.k,
                rounds=base.rounds * base.local_epochs,
                lr=base.lr, dropout=base.dropout)
        else:
            cfg = dataclasses.replace(base, scheme=self.scheme,
                                      num_clusters=self.k)
        if self.overrides:
            cfg = dataclasses.replace(cfg, **dict(self.overrides))
        return cfg

    def key(self) -> Any:
        """Result-dict key: the label if given, else (scheme, k)."""
        if self.label is not None:
            return self.label
        if self.cfg is not None:
            k = (self.cfg.num_models if self.kind == "multi"
                 else self.cfg.num_clusters)
            return (self.cfg.scheme, k)
        return (self.scheme, self.k)


def cell(scheme: str, k: int = 1, traces: Optional[Sequence[Failure]] = None,
         label: Optional[str] = None, **overrides) -> CellSpec:
    """Sugar: ``cell("tolfl", 5, lr=1e-4)`` ==
    ``CellSpec("tolfl", 5, overrides=(("lr", 1e-4),))``."""
    return CellSpec(scheme, k, tuple(sorted(overrides.items())), traces,
                    label)


@dataclass(frozen=True, eq=False)
class TraceSpec:
    """Failure conditions of an experiment: three composable parts.

    * ``traces`` — explicit conditions (``FailureSpec``s or
      ``FailureTrace``s), shared by every cell (a cell may override its
      list via :attr:`CellSpec.traces`).
    * ``p_grid`` — sampled failure-rate grids: for each rate p,
      ``traces_per_p`` failure-and-recovery scenarios drawn by
      :func:`repro_torch.core.failure.sample_rate_grid` against each
      cell's own topology (multi-model baselines against the FL
      topology), deduplicated per cell with the explicit traces as the
      grid's base conditions; :attr:`CellPlan.draws` maps each draw to
      its trace.
    * ``processes`` — generative failure processes (:class:`ProcessGrid`),
      ``n_samples`` draws each against each cell's topology, into the
      same pool; :attr:`CellPlan.process_draws` maps them.  A process
      with ``needs_faulty_engine`` moves every cell onto the
      faulty-update engine.

    With ``p_grid`` or ``processes`` the explicit entries are normalised
    at one slot budget (``max_events``, default 2N or the largest
    process default) and a "client" ``FailureSpec`` is dropped for batch
    cells (recorded as ``None`` in :attr:`CellPlan.explicit_index`);
    without them they pass through verbatim.  All sampling derives from
    ``sample_seed`` alone, so equal specs lower to byte-identical trace
    grids — equal to ``repro``'s."""
    traces: Tuple[Failure, ...] = ()
    p_grid: Tuple[float, ...] = ()
    traces_per_p: int = 4
    recover_prob: float = 0.5
    sample_seed: int = 0
    max_events: Optional[int] = None
    processes: Tuple[ProcessGrid, ...] = ()

    @staticmethod
    def explicit(*traces: Failure) -> "TraceSpec":
        return TraceSpec(traces=tuple(traces))

    @staticmethod
    def sampled(p_grid: Sequence[float], traces_per_p: int = 4,
                base: Sequence[Failure] = (), recover_prob: float = 0.5,
                sample_seed: int = 0,
                max_events: Optional[int] = None) -> "TraceSpec":
        return TraceSpec(traces=tuple(base), p_grid=tuple(p_grid),
                         traces_per_p=traces_per_p,
                         recover_prob=recover_prob,
                         sample_seed=sample_seed, max_events=max_events)

    @staticmethod
    def generated(*grids: ProcessGrid, base: Sequence[Failure] = (),
                  sample_seed: int = 0,
                  max_events: Optional[int] = None) -> "TraceSpec":
        """A spec of generative failure-process grids (plus optional
        explicit base conditions)."""
        return TraceSpec(traces=tuple(base), processes=tuple(grids),
                         sample_seed=sample_seed, max_events=max_events)


@dataclass(frozen=True)
class SeedSpec:
    """The seed population every (cell, trace) pair crosses with."""
    seeds: Tuple[int, ...] = (0,)

    @staticmethod
    def range(n: int, start: int = 0) -> "SeedSpec":
        return SeedSpec(tuple(builtins_range(start, start + n)))


builtins_range = range


@dataclass(frozen=True, eq=False)
class ExperimentSpec:
    """A whole study, declaratively: see the module docstring example.

    ``base`` seeds every cell's config derivation
    (:meth:`CellSpec.resolve`); ``fuse`` / ``pad_k`` / ``k_pad`` /
    ``m_pad`` are ``sweep_grid``'s execution knobs (the defaults — fuse
    with per-kind max pads — are what you want; the per-cell paths exist
    for parity pinning)."""
    data: DataSpec
    base: SimConfig
    cells: Tuple[CellSpec, ...]
    traces: TraceSpec = TraceSpec()
    seeds: SeedSpec = SeedSpec()
    exec_plan: Optional[ExecPlan] = None
    target_loss: Optional[float] = None
    fuse: bool = True
    pad_k: bool = True
    k_pad: Optional[int] = None      # explicit pad-k override (all buckets)
    m_pad: Optional[int] = None      # explicit pad-M override (all buckets)


# ---------------------------------------------------------------------------
# The lowered plan
# ---------------------------------------------------------------------------
@dataclass
class CellPlan:
    """One cell, resolved: full config + its trace list and draw map."""
    index: int
    spec: CellSpec
    cfg: Union[SimConfig, MultiModelConfig]
    kind: str                       # "single" | "multi"
    traces: Sequence[Failure]       # resolved per-cell trace list (host)
    explicit_index: Dict[int, Optional[int]]   # explicit pos -> trace idx
    draws: Dict[float, List[int]]   # rate p -> one trace idx per draw
    num_scenarios: int              # len(traces) * len(seeds)
    #: process-grid index -> one trace idx per draw (TraceSpec.processes)
    process_draws: Dict[int, List[int]] = field(default_factory=dict)

    @property
    def key(self) -> Any:
        return self.spec.key()


@dataclass
class BucketPlan:
    """One bucket: the cells that share one round loop (per chunk) —
    with ``fused`` their scenarios stacked along one axis."""
    index: int
    kind: str                       # "single" | "multi"
    fused: bool
    cell_indices: List[int]
    key_cfg: Union[SimConfig, MultiModelConfig]   # the loop's settings
    track_iso: bool = False         # single: the fl fallback branch
    k_pad: Optional[int] = None     # single: padded cluster-axis length
    m_pad: Optional[int] = None     # multi fused: padded model-axis length
    num_scenarios: int = 0          # flattened (cell x trace x seed) B
    chunk: int = 0                  # scenarios resident per round loop
    num_chunks: int = 0
    padded_scenarios: int = 0       # B rounded up to chunk * num_chunks
    devices: Optional[int] = None   # shard width (None: one device, unsharded)

    def describe(self) -> str:
        mode = ("fused" if self.fused else
                "per-cell" if (self.k_pad or self.m_pad) else "static")
        pads = []
        if self.k_pad is not None:
            pads.append(f"pad_k={self.k_pad}")
        if self.m_pad is not None:
            pads.append(f"pad_m={self.m_pad}")
        if self.track_iso:
            pads.append("iso")
        geom = f"B={self.num_scenarios}"
        if self.padded_scenarios != self.num_scenarios:
            geom += f"(pad {self.padded_scenarios})"
        geom += f" chunks={self.num_chunks}x{self.chunk}"
        if self.devices:
            geom += f" shard={self.devices}dev"
        return (f"bucket {self.index}: {self.kind} {mode} "
                f"[{' '.join(pads) or '-'}] cells={self.cell_indices} "
                f"{geom}")


@dataclass
class ExecutionPlan:
    """What :func:`execute` will run, computed on the host alone."""
    spec: ExperimentSpec
    cells: List[CellPlan]
    buckets: List[BucketPlan]
    #: cached plancheck report (populated by static_report / check=True)
    report: Optional[object] = None

    @property
    def num_scenarios(self) -> int:
        return sum(c.num_scenarios for c in self.cells)

    @property
    def num_dispatch_buckets(self) -> int:
        return len(self.buckets)

    def cell(self, key) -> CellPlan:
        for c in self.cells:
            if c.key == key:
                return c
        raise KeyError(key)

    def static_report(self, budgets: bool = True):
        """Run the plan-time static analyzer over every bucket (one round
        at its predicted shapes on the meta device: nothing executes) and
        cache its :class:`~repro_torch.analysis.plancheck.findings.Report`."""
        if self.report is None:
            from repro_torch.analysis.plancheck import check_plan
            self.report = check_plan(self, budgets=budgets)
        return self.report

    def describe(self) -> str:
        seeds = self.spec.seeds.seeds
        lines = [f"ExperimentPlan: {len(self.cells)} cells x "
                 f"{len(seeds)} seeds -> {self.num_scenarios} scenarios "
                 f"in {len(self.buckets)} dispatch buckets"]
        for c in self.cells:
            lines.append(f"  cell {c.index} {c.key}: {len(c.traces)} "
                         f"traces, {c.num_scenarios} scenarios")
        lines.extend("  " + b.describe() for b in self.buckets)
        if self.report is not None:
            status = ("clean" if self.report.clean else
                      f"{len(self.report.findings)} finding(s)")
            lines.append(f"  static analysis: {status}")
            lines.extend("    " + f.describe().replace("\n", "\n    ")
                         for f in self.report.findings)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# plan(): spec -> ExecutionPlan
# ---------------------------------------------------------------------------
def _resolve_cell_traces(spec: ExperimentSpec, cspec: CellSpec,
                         cfg, kind: str, shared_explicit: Sequence[Failure]):
    """(traces, explicit_index, draws, process_draws) of one cell per
    the TraceSpec; sampled traces on the CPU."""
    ts = spec.traces
    explicit = (list(cspec.traces) if cspec.traces is not None
                else shared_explicit)
    if not ts.p_grid and not ts.processes:
        # verbatim pass-through: no normalisation, no dedup — the path
        # every legacy shim rides
        return explicit, {j: j for j in range(len(explicit))}, {}, {}

    if kind == "single":
        topo = cfg.topology()
        n = topo.num_devices
    else:
        # baselines have no cluster heads: sample against the FL
        # topology (device 0 = the aggregator -> server events)
        topo = Topology(cfg.num_devices, 1)
        n = cfg.num_devices
    # one cell-wide slot budget so every trace in the pool stacks
    max_events = ts.max_events or max(
        [2 * n] + [pg.process.default_max_events(topo)
                   for pg in ts.processes])

    base_traces: List[FailureTrace] = []
    explicit_index: Dict[int, Optional[int]] = {}
    for j, f in enumerate(explicit):
        if (kind == "single" and cfg.scheme == "batch"
                and isinstance(f, FailureSpec) and f.kind == "client"):
            # batch centralises the data: there are no clients to fail
            explicit_index[j] = None
            continue
        if kind == "multi":
            t = as_multimodel_trace(f, n, max_events, device="cpu")
        else:
            t = as_trace(f, topo, max_events, device="cpu")
        explicit_index[j] = len(base_traces)
        base_traces.append(t)

    rng = np.random.default_rng(ts.sample_seed)
    traces, draws = sample_rate_grid(rng, topo, ts.p_grid, cfg.rounds,
                                     ts.traces_per_p,
                                     max_events=max_events,
                                     recover_prob=ts.recover_prob,
                                     base_traces=base_traces, device="cpu")
    process_draws = sample_process_grids(ts.processes, topo, cfg.rounds,
                                         ts.sample_seed, max_events,
                                         traces, device="cpu")
    return traces, explicit_index, draws, process_draws


def _faulty_variant(cfg):
    """The faulty-update engine twin of a resolved cell config
    (idempotent): a subclass swap, so faulty cells bucket apart by class
    while plain configs stay as they are."""
    if isinstance(cfg, (FaultySimConfig, FaultyMultiModelConfig)):
        return cfg
    cls = (FaultyMultiModelConfig if isinstance(cfg, MultiModelConfig)
           else FaultySimConfig)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _geometry(bucket: BucketPlan, exec_plan: Optional[ExecPlan]) -> None:
    """Fill the bucket's chunk geometry (``campaign._run_batched``'s
    arithmetic).  ``devices`` stays None: on one device ``shard=True``
    degrades to the unsharded path, and over several cards it is not
    ported (:meth:`ExecPlan.resolved_devices`, called by :func:`execute`)."""
    plan_ = exec_plan or ExecPlan()
    B = bucket.num_scenarios
    chunk = min(plan_.chunk_size or B, B)
    bucket.devices = None
    bucket.chunk = chunk
    bucket.num_chunks = -(-B // chunk)
    bucket.padded_scenarios = bucket.num_chunks * chunk


def plan(spec: ExperimentSpec, check: bool = False) -> ExecutionPlan:
    """Lower a spec to buckets — host work only, no card.

    Raises ``ValueError`` up front for empty grids and unknown schemes.
    ``check=True`` also runs the static analyzer
    (:meth:`ExecutionPlan.static_report`): one round a bucket on the meta
    device, no card needed."""
    if not spec.cells:
        raise ValueError("empty experiment: need >= 1 cell")
    if len(spec.seeds.seeds) == 0:
        raise ValueError("empty campaign: need >=1 trace and >=1 seed")

    shared_explicit = list(spec.traces.traces)
    needs_faulty = any(pg.process.needs_faulty_engine
                       for pg in spec.traces.processes)
    cells: List[CellPlan] = []
    for i, cspec in enumerate(spec.cells):
        kind = cspec.kind            # validates the scheme
        cfg = cspec.resolve(spec.base)
        if needs_faulty:
            cfg = _faulty_variant(cfg)
        traces, explicit_index, draws, process_draws = _resolve_cell_traces(
            spec, cspec, cfg, kind, shared_explicit)
        if len(traces) == 0:
            raise ValueError("empty campaign: need >=1 trace and "
                             ">=1 seed")
        cells.append(CellPlan(
            index=i, spec=cspec, cfg=cfg, kind=kind, traces=traces,
            explicit_index=explicit_index, draws=draws,
            num_scenarios=len(traces) * len(spec.seeds.seeds),
            process_draws=process_draws))

    buckets: List[BucketPlan] = []
    fused_mode = spec.fuse and spec.pad_k

    def add(bucket: BucketPlan) -> None:
        bucket.index = len(buckets)
        bucket.num_scenarios = sum(cells[i].num_scenarios
                                   for i in bucket.cell_indices)
        _geometry(bucket, spec.exec_plan)
        buckets.append(bucket)

    singles = [c for c in cells
               if c.kind == "single" and c.cfg.scheme != "batch"]
    multis = [c for c in cells if c.kind == "multi"]
    batches = [c for c in cells
               if c.kind == "single" and c.cfg.scheme == "batch"]

    if fused_mode:
        groups: Dict[Tuple[SimConfig, bool], List[int]] = {}
        for c in singles:
            key_cfg = dataclasses.replace(c.cfg, seed=0, scheme="tolfl",
                                          num_clusters=1)
            groups.setdefault((key_cfg, c.cfg.scheme == "fl"),
                              []).append(c.index)
        for (key_cfg, track_iso), idxs in groups.items():
            kp = spec.k_pad or max(
                cells[i].cfg.topology().num_clusters for i in idxs)
            add(BucketPlan(index=0, kind="single", fused=True,
                           cell_indices=idxs, key_cfg=key_cfg,
                           track_iso=track_iso, k_pad=kp))
        mgroups: Dict[MultiModelConfig, List[int]] = {}
        for c in multis:
            key_cfg = dataclasses.replace(c.cfg, seed=0, num_models=0)
            mgroups.setdefault(key_cfg, []).append(c.index)
        for key_cfg, idxs in mgroups.items():
            mp = spec.m_pad or max(cells[i].cfg.num_models for i in idxs)
            add(BucketPlan(index=0, kind="multi", fused=True,
                           cell_indices=idxs, key_cfg=key_cfg, m_pad=mp))
    else:
        # per-cell loops: pad cluster arrays to the PER-KIND max k
        k_kind: Dict[bool, int] = {}
        if spec.pad_k:
            for c in singles:
                kind_key = (c.cfg.scheme == "fl")
                k_kind[kind_key] = max(k_kind.get(kind_key, 1),
                                       c.cfg.topology().num_clusters)
        for c in singles:
            kp = (spec.k_pad or k_kind.get(c.cfg.scheme == "fl")
                  if spec.pad_k else None)
            if kp is None:
                key_cfg = dataclasses.replace(c.cfg, seed=0)
            else:
                key_cfg = dataclasses.replace(c.cfg, seed=0,
                                              scheme="tolfl",
                                              num_clusters=1)
            add(BucketPlan(index=0, kind="single", fused=False,
                           cell_indices=[c.index], key_cfg=key_cfg,
                           track_iso=(c.cfg.scheme == "fl"), k_pad=kp))
        for c in multis:
            add(BucketPlan(index=0, kind="multi", fused=False,
                           cell_indices=[c.index],
                           key_cfg=dataclasses.replace(c.cfg, seed=0)))
    # "batch" cells centralise the data onto one device: their arrays have
    # other shapes, so each runs alone and unpadded, whatever the pads say
    for c in batches:
        add(BucketPlan(index=0, kind="single", fused=False,
                       cell_indices=[c.index],
                       key_cfg=dataclasses.replace(c.cfg, seed=0)))
    out = ExecutionPlan(spec=spec, cells=cells, buckets=buckets)
    if check:
        out.static_report()
    return out


# ---------------------------------------------------------------------------
# execute(): ExecutionPlan -> ExperimentResult
# ---------------------------------------------------------------------------
@dataclass
class BucketCompileStats:
    """What one bucket of an executed plan cost beyond its rounds.

    With ``ExecPlan(aot=True)`` on the card: ``compile_s`` is the wall
    time of resolving the kernel libraries (``nvcc`` builds, or the loads
    on a disk hit), on the first bucket, since a plan's libraries resolve
    as one set; ``cache`` is where this execute found that set:
    ``"compiled"`` (``nvcc`` ran), ``"disk"`` (loaded from the cache
    directory) or ``"memory"`` (loaded in this process already);
    ``lower_s`` is the bucket's warm-up round (``campaign.one_round``).
    On the CPU, or with ``aot=False``, those stay 0 and ``""``.
    ``execute_s`` is the bucket's whole dispatch (array builds, round
    loops, the copy and the metrics on the host).  ``aval_match`` (with
    ``aot``) records whether the operand shapes predicted at plan time
    (:func:`_bucket_shapes`) equal the ones the round loops got."""
    bucket: int
    kind: str
    fused: bool
    aot: bool
    lower_s: float = 0.0
    compile_s: float = 0.0
    execute_s: float = 0.0
    cache: str = ""
    aval_match: Optional[bool] = None


@dataclass
class CompileReport:
    """What one ``execute()`` spent on compiled work.

    ``traces`` is 0: eager code is not traced (``repro`` counts its jit
    traces here).  ``xla`` is the
    :func:`repro_torch.core.compilecache.xla_compile_stats` delta:
    ``xla['misses']`` counts the kernel libraries ``nvcc`` built, so a
    warm cache directory reads ``misses == 0``.  ``cache_dir`` is the
    cache directory in use (None when it is off)."""
    aot: bool
    buckets: List[BucketCompileStats]
    traces: int = 0
    xla: Dict[str, int] = field(default_factory=dict)
    cache_dir: Optional[str] = None

    @property
    def lower_s(self) -> float:
        return sum(b.lower_s for b in self.buckets)

    @property
    def compile_s(self) -> float:
        return sum(b.compile_s for b in self.buckets)

    @property
    def execute_s(self) -> float:
        return sum(b.execute_s for b in self.buckets)

    def describe(self) -> str:
        lines = [f"CompileReport: aot={self.aot} traces={self.traces} "
                 f"xla={self.xla or '{}'} cache_dir={self.cache_dir}"]
        for b in self.buckets:
            lines.append(
                f"  bucket {b.bucket} ({b.kind}"
                f"{' fused' if b.fused else ''}): "
                f"lower={b.lower_s:.3f}s compile={b.compile_s:.3f}s "
                f"execute={b.execute_s:.3f}s"
                + (f" cache={b.cache}" if b.cache else "")
                + (f" aval_match={b.aval_match}"
                   if b.aval_match is not None else ""))
        return "\n".join(lines)


def _bucket_shapes(data: DataSpec, bucket: BucketPlan,
                   cells: Sequence[CellPlan], scenarios: Optional[int] = None
                   ) -> Dict[str, Tuple[int, ...]]:
    """The operand shapes of one chunk's round loop
    (``campaign.operand_shapes``), predicted from the plan alone: the
    data arrays' shapes (batch cells centralise onto one device), the
    bucket's chunk (or ``scenarios``) as the scenario axis, the trace's
    slots from cell 0's first trace (the bucket's traces all stack to
    one width) and the param count from the detector's spec."""
    det = data.model
    S = bucket.chunk if scenarios is None else scenarios
    c0 = cells[0]
    dxa = np.asarray(data.device_x)
    if bucket.kind == "single" and c0.cfg.scheme == "batch":
        n_dev, n_max = 1, int(np.sum(np.asarray(data.device_counts)))
    else:
        n_dev, n_max = int(dxa.shape[0]), int(dxa.shape[1])
    P = det.param_count()
    shapes = {"dx": (n_dev, n_max, int(dxa.shape[2])), "counts": (n_dev,),
              "valid": (n_dev, n_max),
              "tx": tuple(np.asarray(data.test_x).shape)}
    if bucket.kind == "multi":
        t0 = as_multimodel_trace(c0.traces[0], c0.cfg.num_devices,
                                 device="cpu")
        m = bucket.m_pad or c0.cfg.num_models
        shapes.update(models0=(S, m, P), model_valid=(S, m))
        if bucket.key_cfg.scheme == "fedgroup":
            shapes.update(probe=(S, P), perm=(S, m),
                          reseed=(S, KMEANS_ITERS, m))
    else:
        t0 = as_trace(c0.traces[0], c0.cfg.topology(), device="cpu")
        k = bucket.k_pad or bucket.key_cfg.topology().num_clusters
        shapes.update(params0=(S, P), cluster_ids=(S, n_dev), heads=(S, k),
                      head_valid=(S, k))
    for name in ("epochs", "devices", "alive_after", "kinds"):
        shapes[name] = (S, t0.max_events)
    return shapes


def bucket_k(bucket: BucketPlan) -> Optional[int]:
    """The cluster count a single-model bucket's loop runs (padded), or
    None for a multi-model one."""
    if bucket.kind != "single":
        return None
    return bucket.k_pad or bucket.key_cfg.topology().num_clusters


def _warm_up(data: DataSpec, bucket: BucketPlan,
             shapes: Dict[str, Tuple[int, ...]], dev: torch.device) -> float:
    """One round of the bucket's loop on zeros at ``shapes`` on the card
    (``campaign.one_round``); returns its wall seconds, synchronised."""
    t0 = time.perf_counter()
    _c.one_round(data.model, bucket.key_cfg, _c.spec_layout(data.model),
                 _c.zero_operands(shapes, dev), bucket_k(bucket),
                 bucket.track_iso)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


@dataclass
class ExperimentResult:
    """Per-cell campaign results of one executed plan, in cell order.

    ``results[i]`` is the :class:`CampaignResult` /
    :class:`MultiCampaignResult` of ``plan.cells[i]`` — every scenario
    keyed by (cell, trace index, seed).  ``compile_report`` accounts for
    the compiled work of the execute (:class:`CompileReport`)."""
    plan: ExecutionPlan
    results: List[Union[CampaignResult, MultiCampaignResult]]
    compile_report: Optional[CompileReport] = None

    @property
    def num_scenarios(self) -> int:
        return sum(r.num_scenarios for r in self.results)

    def per_cell(self) -> Dict[Any, Union[CampaignResult,
                                          MultiCampaignResult]]:
        """{cell key: result} — keys from :meth:`CellSpec.key`."""
        return {c.key: r for c, r in zip(self.plan.cells, self.results)}

    def __getitem__(self, key):
        return self.per_cell()[key]

    def summary(self) -> Dict[Any, Dict[str, float]]:
        """{cell key: that cell's summary dict}.  Cells planned from
        ``TraceSpec.processes`` also carry ``E[auroc] <family>[<grid
        idx>]`` (the mean over that grid's draws x seeds)."""
        out = {}
        for c, r in zip(self.plan.cells, self.results):
            s = dict(r.summary())
            if c.process_draws:
                procs = self.plan.spec.traces.processes
                for gi, aurocs in self._cell_process(c, r).items():
                    fam = procs[gi].process.family
                    s[f"E[auroc] {fam}[{gi}]"] = float(np.mean(aurocs))
            out[c.key] = s
        return out

    @staticmethod
    def _cell_process(c: CellPlan, r) -> Dict[int, np.ndarray]:
        """{grid index: per-(draw x seed) AUROCs} of one cell."""
        sel = (r.select if isinstance(r, CampaignResult)
               else (lambda i: r.select(i, "best")))
        return {gi: np.concatenate([np.asarray(sel(i)) for i in idxs])
                for gi, idxs in c.process_draws.items()}

    def per_process(self) -> Dict[Any, Dict[int, np.ndarray]]:
        """{cell key: {process-grid index: AUROC per draw x seed}}.
        Duplicated draws repeat their deduplicated trace's values, so
        means equal the undeduplicated Monte-Carlo estimate.  Multi-model
        cells report their "best" AUROC."""
        return {c.key: self._cell_process(c, r)
                for c, r in zip(self.plan.cells, self.results)
                if c.process_draws}

    def process_summary(self) -> Dict[Any, Dict[str, float]]:
        """{cell key: {"<family>[<grid idx>]": E[AUROC]}}."""
        procs = self.plan.spec.traces.processes
        return {key: {f"{procs[gi].process.family}[{gi}]":
                      float(np.mean(aurocs))
                      for gi, aurocs in cell.items()}
                for key, cell in self.per_process().items()}

    def to_rows(self) -> List[Dict[str, Any]]:
        """One tidy dict per scenario."""
        rows: List[Dict[str, Any]] = []
        name = self.plan.spec.data.name
        for c, r in zip(self.plan.cells, self.results):
            for b in builtins_range(r.num_scenarios):
                row: Dict[str, Any] = {
                    "dataset": name, "cell": c.key,
                    "scheme": r.cfg.scheme,
                    "trace": int(r.trace_index[b]),
                    "seed": int(r.seed[b]),
                }
                if isinstance(r, CampaignResult):
                    row.update(k=r.cfg.num_clusters,
                               auroc=float(r.auroc_used[b]),
                               final_auroc=float(r.final_auroc[b]),
                               iso_active=bool(r.iso_active[b]),
                               rounds_to_loss=float(r.rounds_to_loss[b]))
                else:
                    row.update(k=r.cfg.num_models,
                               auroc=float(r.best_auroc[b]),
                               multi_auroc=float(r.multi_auroc[b]))
                rows.append(row)
        return rows


def execute(plan_: ExecutionPlan,
            params0: Optional[Sequence[Params]] = None,
            draws: Optional[Sequence[MultiDraws]] = None,
            device: DeviceLike = None) -> ExperimentResult:
    """Run every bucket of a lowered plan on ``device`` (``None``: the
    card): each bucket is one round loop per chunk, its traces and
    per-scenario operands moved to the device once a chunk.  ``params0``
    seeds the single-model cells and ``draws`` the multi-model ones (one
    entry a seed; see :mod:`repro_torch.core.campaign`).  Results align
    with ``plan_.cells``.

    ``ExecPlan(shard=True)`` warns here, once, and runs unsharded on one
    card or on the CPU; over several cards it raises (not ported).
    ``ExecPlan(aot=True)`` on the card resolves every kernel library
    (one ``nvcc`` a stale source, all at once, or loads from the cache
    directory) and runs each bucket's warm-up round before the first
    real round; the results are the same bits as without it.  The
    :class:`CompileReport` says what that cost."""
    spec = plan_.spec
    data, seeds = spec.data, list(spec.seeds.seeds)
    dev = resolve_device(device)
    if spec.exec_plan is not None:
        spec.exec_plan.resolved_devices(warn=True, device=dev)
    compilecache.ensure_persistent_cache()
    use_aot = bool(spec.exec_plan is not None and spec.exec_plan.aot)
    stats = [BucketCompileStats(bucket=b.index, kind=b.kind, fused=b.fused,
                                aot=use_aot) for b in plan_.buckets]
    xla0 = compilecache.xla_compile_stats()
    predicted = ([_bucket_shapes(data, b, [plan_.cells[i]
                                           for i in b.cell_indices])
                  for b in plan_.buckets] if use_aot else None)
    if use_aot and dev.type == "cuda":
        from repro_torch.kernels import _build
        source, seconds = _build.resolve()
        for b, st in zip(plan_.buckets, stats):
            st.cache = source
            st.lower_s = _warm_up(data, b, predicted[b.index], dev)
        if stats:
            stats[0].compile_s = seconds

    det = data.model
    arrays = (data.device_x, data.device_counts, data.test_x, data.test_y)
    results: List[Optional[Any]] = [None] * len(plan_.cells)
    norm_cache: dict = {}    # normalised single traces per resolution
    trace_cache: dict = {}   # stacked multi traces per resolution
    for bucket in plan_.buckets:
        cells = [plan_.cells[i] for i in bucket.cell_indices]
        seen: List[Dict[str, tuple]] = []
        t0 = time.perf_counter()
        if bucket.kind == "single":
            k = bucket_k(bucket)
            rows = [_c._cell_rows(c.cfg, c.traces, seeds, k, norm_cache)
                    for c in cells]
            rs = _c._run_group(det, arrays, rows, bucket.key_cfg, k,
                               bucket.track_iso, seeds, params0,
                               spec.target_loss, spec.exec_plan, dev,
                               on_chunk=seen.append)
        else:
            m = bucket.m_pad or cells[0].cfg.num_models
            rs = _c._run_multi_group(det, arrays,
                                     [(c.cfg, c.traces) for c in cells],
                                     bucket.key_cfg, m, seeds, draws,
                                     spec.exec_plan, dev, trace_cache,
                                     on_chunk=seen.append)
        st = stats[bucket.index]
        st.execute_s = time.perf_counter() - t0
        if use_aot:
            st.aval_match = all(s == predicted[bucket.index] for s in seen)
        for c, r in zip(cells, rs):
            results[c.index] = r
    xla1 = compilecache.xla_compile_stats()
    report = CompileReport(
        aot=use_aot, buckets=stats,
        xla={k: xla1[k] - xla0[k] for k in xla1},
        cache_dir=compilecache.persistent_cache_dir())
    return ExperimentResult(plan=plan_, results=results,
                            compile_report=report)


def run_experiment(spec: ExperimentSpec,
                   params0: Optional[Sequence[Params]] = None,
                   draws: Optional[Sequence[MultiDraws]] = None,
                   device: DeviceLike = None) -> ExperimentResult:
    """``execute(plan(spec), ...)`` — the one-call entry point."""
    return execute(plan(spec), params0=params0, draws=draws, device=device)
