"""Static completeness check of the score-graph cache key.

Port of ``repro.analysis.plancheck.cachekey``.  ``repro`` checks the key
of its campaign executables (``campaign._exe_key``); the port compiles
no campaign executable, and the cache whose key must be complete is the
scoring service's: ``engine.score_entry`` keeps one captured CUDA graph
a key (``engine._graph_key``).  A knob that changes the captured program
but not the key would replay one configuration's graph for another.  The
check is structural, so it fires the moment such a knob is added:

* every spec class that enters the key wholesale (the detector specs of
  :func:`repro_torch.models.detector.spec_classes`, the paper's
  ``AutoencoderConfig``) and every config class a plan groups buckets by
  (``SimConfig``, ``MultiModelConfig`` and their faulty twins) must stay
  a frozen, eq, hashable dataclass, so every field it ever grows is
  covered by construction;
* every ``ServiceConfig`` field must map to a key component
  (:data:`FIELD_COVERAGE`) or be allowlisted with a reason
  (:data:`ALLOWLIST`);
* ``engine._graph_key`` and ``engine._capture`` must agree on their
  parameters (:data:`KEY_COMPONENTS`): the key spans exactly the
  capture's degrees of freedom.

``tests/test_torch_plancheck.py`` runs the same classification as a
generated test, one case a ``ServiceConfig`` field.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.plancheck.findings import Finding, finding

#: the graph key's components (engine._graph_key's parameters)
KEY_COMPONENTS: Tuple[str, ...] = ("model", "row_params", "shape")

#: program-changing fields -> the key component that carries them
FIELD_COVERAGE: Dict[Tuple[str, str], str] = {
    # each bucket size is the B of its own graph's (B, W, D) shape
    ("ServiceConfig", "bucket_sizes"): "shape",
    # rows per traffic window: the W of the shape
    ("ServiceConfig", "window"): "shape",
}

#: fields that deliberately stay OUT of the key, each with its reason
ALLOWLIST: Dict[Tuple[str, str], str] = {}

_ENGINE = "src/repro_torch/serving/anomaly/engine.py"


def _field_findings(cls, file: str,
                    extra_fields: Sequence[str] = ()) -> List[Finding]:
    """Classify every field of ``cls``: covered, allowlisted, or a
    PC-KEY finding.  ``extra_fields`` lets tests simulate a knob being
    added without editing the dataclass."""
    out: List[Finding] = []
    names = [f.name for f in dataclasses.fields(cls)] + list(extra_fields)
    for name in names:
        verdict = classify_field(cls.__name__, name)
        if verdict is not None:
            continue
        out.append(finding(
            "PC-KEY", file, 0,
            f"{cls.__name__}.{name} is not mapped to a component of the "
            f"score-graph key and not allowlisted: if it changes the "
            f"captured program, two configurations will replay one graph",
            hint=("either thread it into engine._graph_key (and "
                  "FIELD_COVERAGE) or add it to "
                  "plancheck.cachekey.ALLOWLIST with a reason"),
            tag=f"{cls.__name__}.{name}"))
    return out


def classify_field(cls_name: str, field_name: str) -> Optional[str]:
    """'covered' | 'allowlisted' | None (= unaccounted) — the single
    source of truth the generated test enumerates."""
    slot = (cls_name, field_name)
    if slot in FIELD_COVERAGE:
        assert FIELD_COVERAGE[slot] in KEY_COMPONENTS, slot
        return "covered"
    if slot in ALLOWLIST:
        return "allowlisted"
    return None


def check_cache_keys(extra_service_fields: Sequence[str] = ()
                     ) -> List[Finding]:
    """The full PC-KEY pass (see the module docstring)."""
    from repro_torch.configs.autoencoder_paper import AutoencoderConfig
    from repro_torch.core.baselines import (FaultyMultiModelConfig,
                                            MultiModelConfig)
    from repro_torch.core.simulate import FaultySimConfig, SimConfig
    from repro_torch.models.detector import spec_classes
    from repro_torch.serving.anomaly import engine
    from repro_torch.serving.anomaly.service import ServiceConfig

    out: List[Finding] = []
    key_params = tuple(inspect.signature(engine._graph_key).parameters)
    capture_params = tuple(inspect.signature(engine._capture).parameters)
    if key_params != KEY_COMPONENTS:
        out.append(finding(
            "PC-KEY", _ENGINE, 0,
            f"engine._graph_key parameters {key_params} drifted from the "
            f"declared KEY_COMPONENTS {KEY_COMPONENTS}",
            hint="update plancheck.cachekey.KEY_COMPONENTS and classify "
                 "the new component's feeding fields",
            tag="_graph_key.signature"))
    if capture_params != key_params:
        out.append(finding(
            "PC-KEY", _ENGINE, 0,
            f"engine._capture parameters {capture_params} != _graph_key "
            f"parameters {key_params}: a degree of freedom of the capture "
            f"is outside the key",
            hint="every _capture parameter must be a _graph_key "
                 "parameter",
            tag="_capture.signature"))

    for cls in ((SimConfig, FaultySimConfig, MultiModelConfig,
                 FaultyMultiModelConfig, AutoencoderConfig)
                + spec_classes()):
        params = getattr(cls, "__dataclass_params__", None)
        if (params is None or not params.frozen or not params.eq
                or cls.__hash__ is None):
            out.append(finding(
                "PC-KEY", f"{cls.__module__}", 0,
                f"{cls.__name__} must stay a frozen, eq, hashable "
                f"dataclass: it enters a cache key wholesale, which is "
                f"what makes every future field covered by construction",
                tag=f"{cls.__name__}.containment"))

    out += _field_findings(ServiceConfig,
                           "src/repro_torch/serving/anomaly/service.py",
                           extra_service_fields)
    return out
