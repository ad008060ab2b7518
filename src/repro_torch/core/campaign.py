"""Batched Monte-Carlo failure campaigns: (cell x trace x seed) grids.

Port of ``repro.core.campaign``.  The paper's
robustness claims need scenario diversity: grids of failure traces x
seeds, not one hand-picked event per run.  Where ``repro`` runs such a
grid through one ``jit(vmap(core))`` executable, the port runs it
through ONE round loop with a leading scenario axis S
(:func:`repro_torch.core.simulate._round_loop`, the same loop
``run_simulation`` runs at S = 1): a round is one batched forward and
backward pass over the S*N parameter rows and one launch of the fused
aggregation kernel for all S scenarios, so a round launches as many
kernels for 64 scenarios as for one.

Typical use::

    traces = sample_traces(np.random.default_rng(0), topo, 0.3,
                           rounds=100, num_traces=16)
    res = run_campaign(ae_cfg, dx, counts, test_x, test_y,
                       SimConfig(scheme="tolfl", num_clusters=5),
                       traces, seeds=range(4))
    res.summary()["auroc_used_mean"]

:func:`sweep_grid` runs a (scheme x k) grid: with ``fuse`` every
single-model cell of one iso-tracking kind (all sbt/tolfl cells, then
all fl cells, whose isolated fallback costs extra work a round) shares
one round loop over the flattened (cell x trace x seed) axis, each row
carrying its own cluster arrays padded to the group's max k.  Padded
cluster slots are exact no-ops, so results match the per-cell paths.

The multi-model baselines (FedGroup / IFCA / FeSEM,
:mod:`repro_torch.core.baselines`) get the same treatment:
:func:`run_multimodel_campaign` runs a (trace x seed) grid of one cell
through one round loop with a leading scenario axis
(``baselines._multimodel_loop``), and :func:`run_fused_multimodel_campaigns`
and the multi cells of :func:`sweep_grid` fuse the cells whose configs
agree on everything but ``num_models`` into one loop, the model axis
padded to the group's max M with a per-row ``model_valid`` mask.

These entry points are shims over the declarative pipeline
(:mod:`repro_torch.core.experiment`), as in ``repro``: its ``plan``
groups the cells into buckets, and its ``execute`` runs each bucket
through :func:`_run_group` or :func:`_run_multi_group`.

Execution (:class:`ExecPlan`): ``chunk_size`` runs the scenario axis in
chunks of at most that many scenarios (the last one padded by repeating
scenario 0, the padding stripped), each one round loop and one copy to
the host.  ``shard=True`` on one card (or on the CPU) warns and runs the
unsharded path, whose results are the same, as ``repro`` does on one
device; sharding over several cards is not ported.  ``aot=True``
resolves every kernel library before the first round (built by ``nvcc``
or loaded from the cache directory of :mod:`repro_torch.core.compilecache`)
and runs one round of each bucket's loop on zeros at the bucket's
shapes, so each of its kernels has launched once before the real rounds
(:func:`one_round`); the results are the same bits as with ``aot=False``.
:func:`clear_executable_caches` drops what a process holds of them.

RNG, by the port's rule that draws are operands:

* ``params0`` (optional) is a sequence of param trees aligned with
  ``seeds``, the same for every trace and cell.  Without it scenario seed
  ``s`` starts from ``det.init_params(torch.Generator().manual_seed(s))``,
  as ``run_simulation`` does for ``cfg.seed = s``, so a dropout-free
  campaign row equals ``run_simulation(dataclasses.replace(cfg, seed=s))``.
* The multi-model entry points take ``draws`` instead: one
  ``baselines.MultiDraws`` a seed (without them,
  ``baselines.default_draws``, as ``run_multimodel`` draws), so a
  dropout-free row equals ``run_multimodel`` with that seed.
* With dropout on, chunk ``c`` whose scenarios carry seeds ``s_0 ...
  s_{S-1}`` draws from one generator on the device seeded with
  ``(h + c * 0x9E3779B97F4A7C15) mod 2**63``, where ``h`` is the
  polynomial hash ``sum_i s_i * 1_000_003**i mod 2**63``.  A chunk of one
  scenario (c = 0) thus draws what ``run_simulation`` (or
  ``run_multimodel``) draws for its seed;
  otherwise parity with a looped simulator or with ``repro`` is
  statistical (AUROC means within each other's 95% CI).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.core import baselines as BL
from repro_torch.core import compilecache
from repro_torch.core import simulate as sim
from repro_torch.core.baselines import MultiDraws, MultiModelConfig
from repro_torch.core.failure import (Failure, FailureTrace, as_trace,
                                      concat_traces, stack_traces)
from repro_torch.core.simulate import SimConfig, SimOutputs
from repro_torch.models import detector as D
from repro_torch.models.detector import ModelLike
from repro_torch.models.params import FlatLayout, Params
from repro_torch.training.metrics import auroc_batch

#: the multi-model baselines
MULTI_SCHEMES = BL.SCHEMES
_HASH_BASE = 1_000_003
_CHUNK_STRIDE = 0x9E3779B97F4A7C15
_MOD = 1 << 63


@dataclass(frozen=True)
class ExecPlan:
    """How a campaign batch is executed (results never change with it).

    chunk_size
        At most this many scenarios run at once: every chunk is one round
        loop of the same padded size.  ``None`` runs the batch in one
        shot.
    shard, devices
        ``repro``'s scenario sharding over ``devices`` local devices (all
        of them when ``None``).  With one device, or on the CPU, it warns
        and degrades to the unsharded path (:meth:`resolved_devices`):
        the results are the same.  Over more than one card it is not
        ported and raises ``NotImplementedError`` when the plan runs.
    aot
        Before the first round, resolve every kernel library and launch
        the kernels of each bucket once at its shapes (see the module
        docstring); the results do not change.  ``execute`` reports what
        it cost (``experiment.CompileReport``).

    Invalid values raise ``ValueError`` at construction."""
    shard: bool = False
    chunk_size: Optional[int] = None
    devices: Optional[int] = None
    aot: bool = False

    def __post_init__(self):
        if self.chunk_size is not None and self.chunk_size <= 0:
            raise ValueError(
                f"ExecPlan.chunk_size must be a positive number of "
                f"scenarios (or None for one-shot), got "
                f"{self.chunk_size}")
        if self.devices is not None and self.devices <= 0:
            raise ValueError(
                f"ExecPlan.devices must be a positive device count "
                f"(or None for all local devices), got {self.devices}")

    def num_devices(self, device: DeviceLike = None) -> int:
        """Local devices a shard could span: the cards
        (``torch.cuda.device_count()``), or one for a run on the CPU or
        on a host without a card, capped at ``devices``."""
        cpu = device is not None and torch.device(device).type == "cpu"
        n = 1 if cpu else max(torch.cuda.device_count(), 1)
        return min(self.devices, n) if self.devices else n

    def resolved_devices(self, warn: bool = True,
                         device: DeviceLike = None) -> Optional[int]:
        """Shard width actually used: ``None`` when not sharding, and
        when ``shard=True`` finds a single device, in which case it warns
        and degrades to the unsharded path (the results are the same).
        Over more than one card it raises: not ported yet."""
        if not self.shard:
            return None
        n = self.num_devices(device)
        if n <= 1:
            if warn:
                warnings.warn(
                    "ExecPlan(shard=True) found a single local device; "
                    "degrading to the unsharded path (results are "
                    "identical).", UserWarning, stacklevel=2)
            return None
        raise NotImplementedError(
            f"ExecPlan(shard=True) over {n} cards: scenario sharding "
            f"over several cards is not ported yet (ROADMAP queue 1, "
            f"item 9)")


def mean_ci95(vals: np.ndarray) -> Tuple[float, float, float]:
    """(mean, sample std, normal-approx 95% CI half-width) over seeds.

    Uses the SAMPLE standard deviation (ddof=1).  A single scenario has
    no spread estimate: std 0, CI half-width nan."""
    b = len(vals)
    mean = float(np.mean(vals))
    if b <= 1:
        return mean, 0.0, float("nan")
    std = float(np.std(vals, ddof=1))
    return mean, std, 1.96 * std / np.sqrt(b)


@dataclass
class CampaignResult:
    """Stacked per-scenario results of one batched campaign.

    Scenario b is (trace ``trace_index[b]``, seed ``seed[b]``); arrays
    are aligned on that leading axis."""
    cfg: SimConfig
    trace_index: np.ndarray        # (B,) int — index into the trace list
    seed: np.ndarray               # (B,) int
    auroc_used: np.ndarray         # (B,) paper-reported AUROC
    final_auroc: np.ndarray        # (B,) global-model AUROC
    iso_auroc: np.ndarray          # (B,) isolated-mean AUROC (nan if n/a)
    iso_active: np.ndarray         # (B,) bool — FL fallback engaged
    loss_curves: np.ndarray        # (B, rounds) REPORTED loss: global,
    #                                but FL server-dead rounds carry the
    #                                isolated mean (Fig 4 semantics)
    iso_loss_curves: np.ndarray    # (B, rounds)
    rounds_to_loss: np.ndarray     # (B,) float, nan when never reached

    @property
    def num_scenarios(self) -> int:
        return len(self.auroc_used)

    def select(self, trace_index: int) -> np.ndarray:
        """auroc_used of every scenario using trace ``trace_index``."""
        return self.auroc_used[self.trace_index == trace_index]

    def summary(self) -> Dict[str, float]:
        """Mean / sample std / normal-approx 95% CI of the reported
        AUROC plus mean rounds-to-loss (over scenarios that reached the
        target)."""
        mean, std, half = mean_ci95(self.auroc_used)
        r2l = self.rounds_to_loss[np.isfinite(self.rounds_to_loss)]
        return {
            "num_scenarios": float(self.num_scenarios),
            "auroc_used_mean": mean,
            "auroc_used_std": std,
            "auroc_used_ci95_lo": mean - half,
            "auroc_used_ci95_hi": mean + half,
            "rounds_to_loss_mean": (float(np.mean(r2l)) if len(r2l)
                                    else float("nan")),
        }


@dataclass
class MultiCampaignResult:
    """Stacked per-scenario results of one batched multi-model campaign.

    Scenario b is (trace ``trace_index[b]``, seed ``seed[b]``)."""
    cfg: MultiModelConfig
    trace_index: np.ndarray        # (B,) int — index into the trace list
    seed: np.ndarray               # (B,) int
    best_auroc: np.ndarray         # (B,) the paper's * column
    multi_auroc: np.ndarray        # (B,) the paper's dagger column
    loss_curves: np.ndarray        # (B, rounds) per-sample-min test loss
    assignments: np.ndarray        # (B, N) final device -> model maps

    @property
    def num_scenarios(self) -> int:
        return len(self.best_auroc)

    def select(self, trace_index: int, column: str = "best") -> np.ndarray:
        """best/multi AUROC of every scenario using ``trace_index``."""
        vals = {"best": self.best_auroc, "multi": self.multi_auroc}[column]
        return vals[self.trace_index == trace_index]

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"num_scenarios": float(self.num_scenarios)}
        for column in ("best", "multi"):
            vals = {"best": self.best_auroc,
                    "multi": self.multi_auroc}[column]
            mean, std, half = mean_ci95(vals)
            out[f"{column}_auroc_mean"] = mean
            out[f"{column}_auroc_std"] = std
            out[f"{column}_auroc_ci95_lo"] = mean - half
            out[f"{column}_auroc_ci95_hi"] = mean + half
        return out


def _scenario_grid(num_traces: int, seeds: Sequence[int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Full cross product: trace-major, seed-minor."""
    seeds = np.asarray(list(seeds), np.int32)
    trace_idx = np.repeat(np.arange(num_traces, dtype=np.int32),
                          len(seeds))
    seed_arr = np.tile(seeds, num_traces)
    return trace_idx, seed_arr


def dropout_seed(seeds: Sequence[int], chunk: int = 0) -> int:
    """The seed of chunk ``chunk``'s dropout generator, from its
    scenarios' seeds (see the module docstring)."""
    h = 0
    for s in reversed([int(s) for s in seeds]):
        h = (h * _HASH_BASE + s) % _MOD
    return (h + chunk * _CHUNK_STRIDE) % _MOD


def _run_batched(run_chunk, mapped: Sequence[np.ndarray],
                 plan: Optional[ExecPlan]):
    """Run a scenario batch through ``run_chunk(c, *rows)`` with host-side
    chunking per ``plan``; returns the stacked outputs (a
    :class:`SimOutputs` or ``baselines.MultiOutputs``) as numpy arrays
    with the padding stripped.

    ``mapped`` holds host arrays sharing the scenario leading axis.  The
    last chunk is padded by repeating scenario 0 (any valid scenario
    works: its rows are stripped).  Each chunk's outputs come to the host
    in one copy, after its round loop, so device memory stays bounded by
    ``chunk_size`` however large the grid is."""
    plan = plan or ExecPlan()
    B = int(mapped[0].shape[0])
    chunk = min(plan.chunk_size or B, B)
    n_chunks = -(-B // chunk)
    b_pad = n_chunks * chunk
    if b_pad != B:
        sel = np.concatenate([np.arange(B), np.zeros(b_pad - B, np.int64)])
        mapped = [m[sel] for m in mapped]
    outs = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        outs.append(sim.outputs_to_host(run_chunk(c, *(m[sl]
                                                       for m in mapped))))
    if n_chunks == 1 and b_pad == B:
        return outs[0]
    return type(outs[0])(*(np.concatenate(xs, axis=0)[:B]
                           for xs in zip(*outs)))


#: the dtype of each round-loop operand, by the name ``_run_group`` /
#: ``_run_multi_group`` give it (``experiment._bucket_shapes`` predicts
#: their shapes from a plan)
OPERAND_DTYPES = {
    "params0": torch.float32, "models0": torch.float32,
    "model_valid": torch.float32, "dx": torch.float32,
    "counts": torch.float32, "valid": torch.float32, "tx": torch.float32,
    "cluster_ids": torch.int32, "heads": torch.int64,
    "head_valid": torch.float32, "epochs": torch.int32,
    "devices": torch.int32, "alive_after": torch.float32,
    "kinds": torch.int32, "probe": torch.float32, "perm": torch.int64,
    "reseed": torch.int64}


def operand_shapes(ops: Dict[str, Optional[torch.Tensor]]
                   ) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of a round loop's operands (``None`` ones left out)."""
    return {name: tuple(t.shape) for name, t in ops.items()
            if t is not None}


def _trace_of(ops) -> FailureTrace:
    return FailureTrace(ops["epochs"], ops["devices"], ops["alive_after"],
                        ops["kinds"])


def _single_round_loop(det, cfg, layout, ops, k, track_iso, seed):
    out, _, _ = sim._round_loop(
        det, cfg, layout, ops["params0"], ops["dx"], ops["counts"],
        ops["valid"], ops["tx"], ops["cluster_ids"], ops["heads"],
        ops["head_valid"], _trace_of(ops), k, track_iso=track_iso,
        score_history=False, dropout_seed=seed)
    return out


def _multi_round_loop(det, cfg, layout, ops, seed):
    out, _ = BL._multimodel_loop(
        det, cfg, layout, ops["models0"], ops["model_valid"], ops["dx"],
        ops["counts"], ops["valid"], ops["tx"], _trace_of(ops),
        ops.get("probe"), ops.get("perm"), ops.get("reseed"),
        dropout_seed=seed)
    return out


def spec_layout(det: D.DetectorModel) -> FlatLayout:
    """The flat layout of ``det``'s params (one tiny init on the CPU)."""
    return FlatLayout.of(det.init_params(torch.Generator().manual_seed(0),
                                         device="cpu"))


def zero_operands(shapes: Dict[str, tuple], dev: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """Zeros of a round loop's operand ``shapes`` on ``dev``."""
    return {name: torch.zeros(shape, dtype=OPERAND_DTYPES[name], device=dev)
            for name, shape in shapes.items()}


def one_round(det: D.DetectorModel, loop_cfg, layout: FlatLayout,
              ops: Dict[str, torch.Tensor], k: Optional[int] = None,
              track_iso: bool = False) -> None:
    """One round of a bucket's loop (``loop_cfg`` with ``rounds=1``, the
    final scores included) on the operands ``ops``; single-model buckets
    pass the padded cluster count ``k``.  Every kernel the bucket's
    rounds launch launches here at their shapes: ``ExecPlan(aot=True)``
    runs it on zeros on the card before the real rounds, and plancheck's
    dispatch pass on the meta device, where it executes nothing."""
    cfg = dataclasses.replace(loop_cfg, rounds=1)
    if "params0" in ops:
        _single_round_loop(det, cfg, layout, ops, k, track_iso, 0)
    else:
        _multi_round_loop(det, cfg, layout, ops, 0)


def clear_executable_caches() -> None:
    """Drop what this process holds of compiled work: the kernel
    libraries it resolved (ctypes cannot unmap them, so the next
    resolution reads them from the cache directory again: ``"disk"``),
    the scoring service's CUDA graphs and the counters of
    :func:`repro_torch.core.compilecache.xla_compile_stats`."""
    from repro_torch.kernels import _build
    from repro_torch.serving.anomaly import engine
    _build.clear()
    engine.clear_score_cache()
    compilecache.reset_xla_compile_stats()


@dataclass
class _Cell:
    """One cell's scenario rows, ready to stack with other cells'."""
    cfg: SimConfig
    trace_index: np.ndarray
    seed: np.ndarray
    traces: FailureTrace          # (B, M) host tensors
    cluster_ids: np.ndarray       # (B, N) int32
    heads: np.ndarray             # (B, k_pad) int64
    head_valid: np.ndarray        # (B, k_pad) float32


def _cell_rows(cfg: SimConfig, traces: Sequence[Failure],
               seeds: Sequence[int], k_pad: int, norm_cache: dict) -> _Cell:
    """Normalise one cell's traces against its topology on the host (once
    per distinct resolution: cells that pass the same list share it) and
    lay out its (trace x seed) grid, its padded cluster arrays repeated
    along it."""
    if len(traces) == 0 or len(seeds) == 0:
        raise ValueError("empty campaign: need >=1 trace and >=1 seed")
    topo = cfg.topology()
    key = (tuple(id(t) for t in traces), _single_trace_key(traces, topo))
    if key not in norm_cache:
        norm_cache[key] = [as_trace(t, topo, device="cpu") for t in traces]
    norm = norm_cache[key]
    trace_idx, seed_arr = _scenario_grid(len(norm), seeds)
    b = len(trace_idx)
    # repro's ``_padded_topology_arrays``, checked on the host
    cids, heads, hv = sim.topology_arrays(topo, k_pad)
    return _Cell(cfg, trace_idx, seed_arr,
                 stack_traces([norm[i] for i in trace_idx]),
                 np.broadcast_to(cids, (b,) + cids.shape),
                 np.broadcast_to(heads, (b,) + heads.shape),
                 np.broadcast_to(hv, (b,) + hv.shape))


def _single_trace_key(traces: Sequence[Failure], topo) -> tuple:
    """How a trace list resolves against a topology: pure
    :class:`FailureTrace` lists are topology-independent (one normalised
    list serves every sweep cell), legacy specs default their targets
    from the heads / cluster-0 layout."""
    if all(isinstance(t, FailureTrace) for t in traces):
        return ()
    return (tuple(topo.heads), tuple(topo.clusters[0]))


def _run_group(det: D.DetectorModel, data, cells: List[_Cell], loop_cfg,
               k: int, track_iso: bool, seeds: Sequence[int],
               params0: Optional[Sequence[Params]], target_loss,
               exec_plan: Optional[ExecPlan], dev: torch.device,
               on_chunk: Optional[Callable[[Dict[str, tuple]], Any]] = None
               ) -> List[CampaignResult]:
    """One round loop (per chunk) over the flattened (cell x trace x
    seed) axis of ``cells``, which share the data arrays, ``loop_cfg``'s
    training settings and the padded cluster count ``k``; the results
    sliced back per cell.  ``on_chunk`` gets the shapes of each chunk's
    loop operands (:func:`operand_shapes`)."""
    device_x, device_counts, test_x, test_y = data
    sim._use_f32_matmul()
    dx, counts, valid = sim._prepare_arrays(cells[0].cfg, device_x,
                                            device_counts, dev)
    for c in cells:
        if dx.shape[0] != c.cfg.topology().num_devices:
            raise ValueError(f"device data for {dx.shape[0]} devices, but "
                             f"{c.cfg.scheme} k={c.cfg.num_clusters} has "
                             f"{c.cfg.topology().num_devices}")
    tx = torch.as_tensor(np.asarray(test_x, np.float32), device=dev)

    # the inits, one row per distinct seed, on the device
    seed_list = [int(s) for s in seeds]
    if params0 is None:
        trees = [det.init_params(torch.Generator().manual_seed(s),
                                 device="cpu") for s in seed_list]
    else:
        trees = list(params0)
        if len(trees) != len(seed_list):
            raise ValueError(f"params0 has {len(trees)} trees for "
                             f"{len(seed_list)} seeds")
    layout = FlatLayout.of(trees[0])
    table = torch.stack([layout.flatten(t).to(dev) for t in trees])
    row_of = {s: i for i, s in enumerate(seed_list)}

    traces = concat_traces([c.traces for c in cells])
    seed_arr = np.concatenate([c.seed for c in cells])
    mapped = [traces.epochs.numpy(), traces.devices.numpy(),
              traces.alive_after.numpy(), traces.kinds.numpy(),
              np.array([row_of[int(s)] for s in seed_arr], np.int64),
              seed_arr.astype(np.int64),
              np.concatenate([c.cluster_ids for c in cells]),
              np.concatenate([c.heads for c in cells]),
              np.concatenate([c.head_valid for c in cells])]

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def run_chunk(c, ep, dv, alv, knd, rows, chunk_seeds, cids, heads, hv):
        ops = dict(params0=table[on_dev(rows)], dx=dx, counts=counts,
                   valid=valid, tx=tx, cluster_ids=on_dev(cids),
                   heads=on_dev(heads), head_valid=on_dev(hv),
                   epochs=on_dev(ep), devices=on_dev(dv),
                   alive_after=on_dev(alv), kinds=on_dev(knd))
        if on_chunk is not None:
            on_chunk(operand_shapes(ops))
        return _single_round_loop(det, loop_cfg, layout, ops, k, track_iso,
                                  dropout_seed(chunk_seeds, c))

    out = _run_batched(run_chunk, mapped, exec_plan)
    fields = _post_process_arrays(track_iso, out, test_y, target_loss)
    results, off = [], 0
    for c in cells:
        b = len(c.seed)
        results.append(CampaignResult(
            cfg=c.cfg, trace_index=c.trace_index, seed=c.seed,
            **{name: arr[off:off + b] for name, arr in fields.items()}))
        off += b
    return results


def run_campaign(model: ModelLike, device_x: np.ndarray,
                 device_counts: np.ndarray, test_x: np.ndarray,
                 test_y: np.ndarray, cfg: SimConfig,
                 traces: Sequence[Failure], seeds: Sequence[int],
                 target_loss: Optional[float] = None,
                 exec_plan: Optional[ExecPlan] = None,
                 pad_k: Optional[int] = None,
                 params0: Optional[Sequence[Params]] = None,
                 device: DeviceLike = None) -> CampaignResult:
    """Run every (trace x seed) scenario of one cell through one round
    loop (per chunk of ``exec_plan``).

    ``traces`` may mix legacy :class:`FailureSpec`s and
    :class:`FailureTrace`s; all are normalised against ``cfg``'s topology
    and stacked.  ``cfg.seed`` is ignored — seeds come from the grid.
    ``pad_k`` (int >= the cluster count) pads the cluster axis, as
    :func:`sweep_grid`'s per-cell path does (results are unchanged).
    "batch" centralises the data, and ``pad_k`` is ignored for it.
    ``params0``: see the module docstring.  A one-cell spec through
    :mod:`repro_torch.core.experiment`, per-cell dispatch."""
    from repro_torch.core import experiment as X
    spec = X.ExperimentSpec(
        data=_data_spec(X, model, device_x, device_counts, test_x, test_y),
        base=cfg,
        cells=(X.CellSpec(scheme=cfg.scheme, k=cfg.num_clusters, cfg=cfg,
                          traces=traces),),
        seeds=X.SeedSpec(tuple(seeds)), exec_plan=exec_plan,
        target_loss=target_loss, fuse=False,
        pad_k=(pad_k is not None), k_pad=pad_k)
    return X.run_experiment(spec, params0=params0, device=device).results[0]


def _data_spec(X, model, device_x, device_counts, test_x, test_y):
    return X.DataSpec(model=model, device_x=device_x,
                      device_counts=device_counts, test_x=test_x,
                      test_y=test_y)


def _post_process_arrays(track_iso: bool, out, test_y, target_loss
                         ) -> Dict[str, np.ndarray]:
    """Scenario-aligned result arrays of a stacked :class:`SimOutputs`
    batch on the host (ONE ``auroc_batch`` sweep over the whole batch,
    however many sweep cells were flattened into it) — everything
    :class:`CampaignResult` stores except the grid bookkeeping."""
    losses = np.asarray(out.losses)                    # (B, R)
    iso_losses = np.asarray(out.iso_losses)
    finals = np.asarray(out.final_scores)              # (B, T)
    iso_scores = np.asarray(out.iso_final_scores)      # (B, N, T')
    final_alive = np.asarray(out.final_alive)          # (B, N)
    dead_rounds = np.asarray(out.server_dead_rounds) > 0   # (B, R)
    server_dead = np.asarray(out.server_dead) > 0      # (B,)
    B = losses.shape[0]

    test_y = np.asarray(test_y)
    final_auroc = auroc_batch(finals, test_y)
    iso_auroc = np.full(B, np.nan)
    iso_active = np.zeros(B, bool)
    if track_iso:
        # Fig 4 semantics (matching run_simulation): server-dead rounds
        # report the isolated-mean loss, not the frozen global model's
        losses = np.where(dead_rounds, iso_losses, losses)
        iso_active = server_dead.copy()
        hit = np.flatnonzero(iso_active)
        if len(hit) and iso_scores.shape[-1]:
            n_dev = iso_scores.shape[1]
            per_dev = auroc_batch(
                iso_scores[hit].reshape(len(hit) * n_dev, -1),
                test_y).reshape(len(hit), n_dev)
            alive = (final_alive[hit] > 0)
            denom = alive.sum(axis=1)
            num = np.where(alive, per_dev, 0.0).sum(axis=1)
            iso_auroc[hit] = np.where(denom > 0,
                                      num / np.maximum(denom, 1),
                                      np.nan)
    auroc_used = np.where(iso_active, iso_auroc, final_auroc)

    r2l = np.full(B, np.nan)
    if target_loss is not None:
        reached = losses <= target_loss                # (B, R)
        any_hit = reached.any(axis=1)
        first = reached.argmax(axis=1) + 1.0
        r2l = np.where(any_hit, first, np.nan)

    return dict(auroc_used=auroc_used, final_auroc=final_auroc,
                iso_auroc=iso_auroc, iso_active=iso_active,
                loss_curves=losses, iso_loss_curves=iso_losses,
                rounds_to_loss=r2l)


def run_fused_campaigns(model: ModelLike, device_x: np.ndarray,
                        device_counts: np.ndarray, test_x: np.ndarray,
                        test_y: np.ndarray,
                        cells: Sequence[Tuple[SimConfig,
                                              Sequence[Failure]]],
                        seeds: Sequence[int],
                        target_loss: Optional[float] = None,
                        exec_plan: Optional[ExecPlan] = None,
                        k_pad: Optional[int] = None,
                        params0: Optional[Sequence[Params]] = None,
                        device: DeviceLike = None) -> List[CampaignResult]:
    """Many single-model campaign cells, fused into ONE round loop per
    group: cells whose configs agree on everything but (scheme, k) and
    share an iso-tracking kind.  ``cells`` pairs each :class:`SimConfig`
    with its trace list (lists may differ per cell and may be the same
    object, in which case stacking happens once).  Each group's cluster
    arrays are padded to ``k_pad`` (default: the group's max k) and
    stacked along the flattened (cell x trace x seed) axis.  Results
    align with ``cells``.  "batch" cells centralise the data (different
    array shapes) and are rejected — run them via :func:`run_campaign`."""
    if not cells:
        return []
    for cfg, _ in cells:
        if cfg.scheme == "batch":
            raise ValueError("'batch' cells centralise the data onto one "
                             "device (different array shapes); run them "
                             "via run_campaign")
    from repro_torch.core import experiment as X
    spec = X.ExperimentSpec(
        data=_data_spec(X, model, device_x, device_counts, test_x, test_y),
        base=cells[0][0],
        cells=tuple(X.CellSpec(scheme=cfg.scheme, k=cfg.num_clusters,
                               cfg=cfg, traces=traces)
                    for cfg, traces in cells),
        seeds=X.SeedSpec(tuple(seeds)), exec_plan=exec_plan,
        target_loss=target_loss, k_pad=k_pad)
    return X.run_experiment(spec, params0=params0, device=device).results


def sweep_grid(model: ModelLike, device_x: np.ndarray,
               device_counts: np.ndarray, test_x: np.ndarray,
               test_y: np.ndarray, base: SimConfig,
               scheme_ks: Sequence[Tuple[str, int]],
               traces: Sequence[Failure], seeds: Sequence[int],
               target_loss: Optional[float] = None,
               exec_plan: Optional[ExecPlan] = None,
               pad_k: bool = True, fuse: bool = True,
               params0: Optional[Sequence[Params]] = None,
               draws: Optional[Sequence[MultiDraws]] = None,
               device: DeviceLike = None) -> Dict[Tuple[str, int], Any]:
    """(scheme x k) grid of batched campaigns over the same traces and
    seeds, each cell's config ``base`` with its scheme and k.

    Single-model schemes read k as the cluster count.  With ``fuse`` (and
    ``pad_k``) all sbt/tolfl cells run in one round loop and all fl cells
    in another, their cluster arrays padded to the group's max k;
    ``fuse=False`` runs one loop per cell, padded to the per-kind max k,
    and ``pad_k=False`` unpadded.  Results are the same either way.
    "batch" cells always run alone.

    Multi-model baselines (:data:`MULTI_SCHEMES`) read k as the model
    count M, inherit the single-model cells' total local-step budget
    (``base.rounds * base.local_epochs`` rounds), ``base.lr`` and
    ``base.dropout``, and return :class:`MultiCampaignResult`; legacy
    specs in ``traces`` resolve to the baseline default targets.  With
    ``fuse`` (and ``pad_k``) the cells of one scheme run in one loop, the
    model axis padded to their max M; else one loop per cell.  ``params0``
    seeds the single-model cells, ``draws`` the multi-model ones."""
    from repro_torch.core import experiment as X
    spec = X.ExperimentSpec(
        data=_data_spec(X, model, device_x, device_counts, test_x, test_y),
        base=base,
        cells=tuple(X.CellSpec(scheme=s, k=k) for s, k in scheme_ks),
        traces=X.TraceSpec(traces=tuple(traces)),
        seeds=X.SeedSpec(tuple(seeds)), exec_plan=exec_plan,
        target_loss=target_loss, fuse=fuse, pad_k=pad_k)
    res = X.run_experiment(spec, params0=params0, draws=draws, device=device)
    return dict(zip(tuple(scheme_ks), res.results))


# ---------------------------------------------------------------------------
# Multi-model baselines
# ---------------------------------------------------------------------------
def _multi_metrics(finals: np.ndarray, test_y,
                   model_valid: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(best, multi) AUROC columns of stacked (B, M, T) final scores in
    TWO ``auroc_batch`` sweeps total, however many sweep cells were
    flattened into the batch.  ``model_valid`` (B, M) masks padded model
    slots (fused padded-M cells): they never win ``best`` and stay out
    of the per-sample-min ``multi`` score."""
    B, M = finals.shape[0], finals.shape[1]
    test_y = np.asarray(test_y)
    per_model = auroc_batch(finals.reshape(B * M, -1),
                            test_y).reshape(B, M)
    if model_valid is None:
        return per_model.max(axis=1), auroc_batch(finals.min(axis=1),
                                                  test_y)
    live = model_valid > 0
    best = np.where(live, per_model, -np.inf).max(axis=1)
    min_scores = np.where(live[:, :, None], finals, np.inf).min(axis=1)
    return best, auroc_batch(min_scores, test_y)


def _run_multi_group(det: D.DetectorModel, data,
                     cells: List[Tuple[MultiModelConfig, Sequence[Failure]]],
                     loop_cfg: MultiModelConfig, m: int,
                     seeds: Sequence[int],
                     draws: Optional[Sequence[MultiDraws]],
                     exec_plan: Optional[ExecPlan], dev: torch.device,
                     trace_cache: dict,
                     on_chunk: Optional[Callable[[Dict[str, tuple]],
                                                 Any]] = None
                     ) -> List[MultiCampaignResult]:
    """One round loop (per chunk) over the flattened (cell x trace x
    seed) axis of multi-model ``cells``, which share ``loop_cfg``'s
    settings, the model axis padded to ``m`` with a per-row
    ``model_valid``; the results sliced back per cell.  Cells that pass
    the same trace list share one normalised stack (``trace_cache``).
    ``on_chunk`` as in :func:`_run_group`."""
    device_x, device_counts, test_x, test_y = data
    if not seeds or not all(len(traces) for _, traces in cells):
        raise ValueError("empty campaign: need >=1 trace and >=1 seed")
    sim._use_f32_matmul()
    dx, counts, valid = BL.prepare_multimodel_arrays(device_x,
                                                     device_counts, dev)
    n = dx.shape[0]
    for cfg, _ in cells:
        if n != cfg.num_devices or m < cfg.num_models:
            raise ValueError(f"{cfg.scheme} with {cfg.num_models} models on "
                             f"{cfg.num_devices} devices in a loop of {m} "
                             f"models on device data for {n} devices")
    tx = torch.as_tensor(np.asarray(test_x, np.float32), device=dev)
    seed_list = [int(s) for s in seeds]
    tables = BL._draw_tables(det, loop_cfg.scheme, seed_list, draws, n, m,
                             dev)
    row_of = {s: i for i, s in enumerate(seed_list)}

    metas = []                    # (cfg, traces (b, M_ev), trace_idx, seed)
    for cfg, traces in cells:
        key = (tuple(id(t) for t in traces), cfg.num_devices)
        if key not in trace_cache:
            trace_idx, seed_arr = _scenario_grid(len(traces), seed_list)
            norm = [BL.as_multimodel_trace(t, cfg.num_devices, device="cpu")
                    for t in traces]
            trace_cache[key] = (stack_traces([norm[i] for i in trace_idx]),
                                trace_idx, seed_arr)
        metas.append((cfg, *trace_cache[key]))
    traces = concat_traces([t for _, t, _, _ in metas])
    seed_arr = np.concatenate([s for _, _, _, s in metas])
    model_valid = np.concatenate([
        np.broadcast_to((np.arange(m) < cfg.num_models).astype(np.float32),
                        (len(s), m)) for cfg, _, _, s in metas])
    mapped = [traces.epochs.numpy(), traces.devices.numpy(),
              traces.alive_after.numpy(), traces.kinds.numpy(),
              np.array([row_of[int(s)] for s in seed_arr], np.int64),
              seed_arr.astype(np.int64), model_valid]

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def run_chunk(c, ep, dv, alv, knd, rows, chunk_seeds, mv):
        inits, probe, perm, reseed = tables.rows(on_dev(rows))
        ops = dict(models0=inits, model_valid=on_dev(mv), dx=dx,
                   counts=counts, valid=valid, tx=tx, probe=probe,
                   perm=perm, reseed=reseed, epochs=on_dev(ep),
                   devices=on_dev(dv), alive_after=on_dev(alv),
                   kinds=on_dev(knd))
        if on_chunk is not None:
            on_chunk(operand_shapes(ops))
        return _multi_round_loop(det, loop_cfg, tables.layout, ops,
                                 dropout_seed(chunk_seeds, c))

    out = _run_batched(run_chunk, mapped, exec_plan)
    best, multi = _multi_metrics(out.final_scores, test_y, model_valid)
    results, off = [], 0
    for cfg, _, trace_idx, seeds_c in metas:
        sl = slice(off, off + len(seeds_c))
        results.append(MultiCampaignResult(
            cfg=cfg, trace_index=trace_idx, seed=seeds_c,
            best_auroc=best[sl], multi_auroc=multi[sl],
            loss_curves=out.losses[sl], assignments=out.assignments[sl]))
        off += len(seeds_c)
    return results


def run_multimodel_campaign(model: ModelLike, device_x: np.ndarray,
                            device_counts: np.ndarray, test_x: np.ndarray,
                            test_y: np.ndarray, cfg: MultiModelConfig,
                            traces: Sequence[Failure], seeds: Sequence[int],
                            exec_plan: Optional[ExecPlan] = None,
                            draws: Optional[Sequence[MultiDraws]] = None,
                            device: DeviceLike = None
                            ) -> MultiCampaignResult:
    """Every (trace x seed) scenario of a multi-model baseline through one
    round loop (per chunk of ``exec_plan``): the multi-model twin of
    :func:`run_campaign`.

    ``traces`` may mix legacy :class:`FailureSpec`s and
    :class:`FailureTrace`s; specs are normalised with the BASELINE default
    targets (``baselines.as_multimodel_trace``).  ``cfg.seed`` is ignored
    — seeds come from the grid; ``draws`` (one ``MultiDraws`` a seed) as
    in the module docstring."""
    from repro_torch.core import experiment as X
    spec = X.ExperimentSpec(
        data=_data_spec(X, model, device_x, device_counts, test_x, test_y),
        base=SimConfig(num_devices=cfg.num_devices),
        cells=(X.CellSpec(scheme=cfg.scheme, k=cfg.num_models, cfg=cfg,
                          traces=traces),),
        seeds=X.SeedSpec(tuple(seeds)), exec_plan=exec_plan, fuse=False)
    return X.run_experiment(spec, draws=draws, device=device).results[0]


def run_fused_multimodel_campaigns(
        model: ModelLike, device_x: np.ndarray, device_counts: np.ndarray,
        test_x: np.ndarray, test_y: np.ndarray,
        cells: Sequence[Tuple[MultiModelConfig, Sequence[Failure]]],
        seeds: Sequence[int], exec_plan: Optional[ExecPlan] = None,
        pad_m: Optional[int] = None,
        draws: Optional[Sequence[MultiDraws]] = None,
        device: DeviceLike = None) -> List[MultiCampaignResult]:
    """Many multi-model baseline cells, fused into ONE round loop per
    group: cells whose configs agree on everything but ``num_models``
    (so fedgroup / ifca / fesem cells never share a loop).  Each group's
    model axis is padded to ``pad_m`` (default: the group's max M) with a
    ``model_valid`` mask stacked along the flattened (cell x trace x
    seed) axis; padded model slots are exact no-ops, so per-cell results
    match :func:`run_multimodel_campaign`.  Results align with
    ``cells``."""
    if not cells:
        return []
    from repro_torch.core import experiment as X
    spec = X.ExperimentSpec(
        data=_data_spec(X, model, device_x, device_counts, test_x, test_y),
        base=SimConfig(num_devices=cells[0][0].num_devices),
        cells=tuple(X.CellSpec(scheme=cfg.scheme, k=cfg.num_models,
                               cfg=cfg, traces=traces)
                    for cfg, traces in cells),
        seeds=X.SeedSpec(tuple(seeds)), exec_plan=exec_plan, m_pad=pad_m)
    return X.run_experiment(spec, draws=draws, device=device).results
