"""One import surface for the port's experiment pipeline.

Port of ``repro.api``: everything a study needs — declare a spec, lower
it to a plan, execute it, and the legacy imperative entry points —
re-exported from one place::

    from repro_torch import api

    spec = api.ExperimentSpec(...)
    res = api.run_experiment(spec)          # == execute(plan(spec))

See :mod:`repro_torch.core.experiment` for the spec -> plan -> execute
contract, :mod:`repro_torch.core.campaign` for the execution mechanism
and :mod:`repro_torch.core.compilecache` for where the compiled kernel
libraries live.  :data:`NOT_PORTED` names what ``repro.api`` exports and
the port does not: nothing.
"""
from repro_torch.configs.autoencoder_paper import AutoencoderConfig
from repro_torch.core.baselines import (FaultyMultiModelConfig,
                                        MultiModelConfig, MultiModelResult,
                                        run_multimodel)
from repro_torch.core.campaign import (MULTI_SCHEMES, CampaignResult, ExecPlan,
                                       MultiCampaignResult,
                                       clear_executable_caches, mean_ci95,
                                       run_campaign, run_fused_campaigns,
                                       run_fused_multimodel_campaigns,
                                       run_multimodel_campaign, sweep_grid)
from repro_torch.core.compilecache import (disable_persistent_cache,
                                           enable_persistent_cache,
                                           persistent_cache_dir,
                                           xla_compile_stats)
from repro_torch.core.experiment import (SINGLE_SCHEMES, BucketCompileStats,
                                         BucketPlan, CellPlan, CellSpec,
                                         CompileReport, DataSpec,
                                         ExecutionPlan, ExperimentResult,
                                         ExperimentSpec, SeedSpec, TraceSpec,
                                         cell, execute, plan, run_experiment)
from repro_torch.core.failure import (MAX_EVENTS, NO_FAILURE, FailureEvent,
                                      FailureSpec, FailureTrace,
                                      sample_rate_grid, sample_traces,
                                      trace_faulty_scale)
from repro_torch.core.processes import (FAMILIES, ClusterCascadeProcess,
                                        FailureProcess, FaultyUpdateProcess,
                                        IidRateProcess, MarkovChurnProcess,
                                        ProcessGrid, StragglerProcess,
                                        family_process, process_seed)
from repro_torch.core.simulate import (FaultySimConfig, SimConfig, SimResult,
                                       run_simulation, trained_params)
from repro_torch.core.topology import Topology
from repro_torch.models.detector import (AutoencoderDetector, DetectorModel,
                                         SeqDetector, as_detector,
                                         detector_names, make_detector,
                                         register_detector)
from repro_torch.serving.anomaly import (AnomalyService, ModelBank,
                                         ScoredWindow, ServiceConfig,
                                         ServiceReport, train_model_bank)

#: ``repro.api`` names the port does not export: none left
NOT_PORTED: tuple = ()

__all__ = [
    # declarative pipeline
    "ExperimentSpec", "DataSpec", "CellSpec", "TraceSpec", "SeedSpec",
    "cell", "plan", "execute", "run_experiment", "ExecutionPlan",
    "CellPlan", "BucketPlan", "ExperimentResult",
    # execution policy + results
    "ExecPlan", "CampaignResult", "MultiCampaignResult", "mean_ci95",
    # compilation & caching
    "CompileReport", "BucketCompileStats", "clear_executable_caches",
    "enable_persistent_cache", "disable_persistent_cache",
    "persistent_cache_dir", "xla_compile_stats",
    # configs / schemes
    "AutoencoderConfig", "SimConfig", "MultiModelConfig", "Topology",
    "SINGLE_SCHEMES", "MULTI_SCHEMES",
    # detector bodies (pluggable model specs)
    "DetectorModel", "AutoencoderDetector", "SeqDetector", "as_detector",
    "make_detector", "register_detector", "detector_names",
    # failure model
    "FailureSpec", "FailureEvent", "FailureTrace", "NO_FAILURE",
    "MAX_EVENTS", "sample_traces", "sample_rate_grid",
    # generative failure processes (fault injection)
    "FailureProcess", "IidRateProcess", "MarkovChurnProcess",
    "ClusterCascadeProcess", "StragglerProcess", "FaultyUpdateProcess",
    "ProcessGrid", "FAMILIES", "family_process", "process_seed",
    "trace_faulty_scale", "FaultySimConfig", "FaultyMultiModelConfig",
    # serving: the live anomaly-scoring service under failure
    "AnomalyService", "ServiceConfig", "ServiceReport", "ScoredWindow",
    "ModelBank", "train_model_bank", "trained_params",
    # legacy imperative entry points (shims over the pipeline)
    "run_simulation", "SimResult", "run_multimodel", "MultiModelResult",
    "run_campaign", "run_multimodel_campaign", "sweep_grid",
    "run_fused_campaigns", "run_fused_multimodel_campaigns",
]
