"""Finding / report / suppression layer shared by every plancheck pass.

Port of ``repro.analysis.plancheck.findings``.  A :class:`Finding` is one
rule violation with enough location to act on (``file:line``, rule id,
message, fix hint).  Findings can be silenced two ways, both reviewable
in the diff:

* **inline** — the offending line (or the line above it) carries a
  ``# plancheck: ignore[RULE-ID]`` comment (bare ``# plancheck: ignore``
  silences every rule on that line);
* **baseline** — a committed baseline file
  (``src/repro_torch/analysis/plancheck/baseline.toml``) lists
  ``[[suppress]]`` entries with a mandatory ``reason``, so deliberate
  findings are acknowledged without editing the flagged code.  The CLI
  fails only on findings NOT covered by the baseline.

The baseline format is a TOML subset (an array of ``[[suppress]]``
tables with string/int values) parsed by :func:`load_baseline` — via
``tomllib`` where available (Python >= 3.11), else a small built-in
parser for exactly the subset :func:`format_baseline` writes.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: rule ids -> one-line description (the authoritative registry; tests
#: assert every emitted finding names a registered rule).  ``repro``'s
#: ``PC-JAX-RETRACE`` and ``PC-JAX-CONST`` have no counterpart: eager code
#: is not traced, so there is no jit cache for a weak-typed scalar to fork
#: and no jaxpr to capture a dataset by value; an operand's data reaches
#: each call afresh.
RULES: Dict[str, str] = {
    # dispatch pass: one round of each bucket on the meta device
    "PC-TORCH-SYNC": (
        "host sync inside a round (.item(), a data-dependent shape such "
        "as nonzero or a boolean mask, a copy to the CPU): the host "
        "waits on the card every round"),
    "PC-TORCH-BUDGET": (
        "a round dispatches more aten ops than its named budget (see "
        "plancheck.budgets), or a count that grows with the scenario "
        "axis: the host's dispatch cost scales with the knob that grew "
        "it"),
    "PC-KEY": (
        "a knob that changes a captured score graph is missing from the "
        "graph cache key (engine._graph_key) and not explicitly "
        "allowlisted"),
    # AST lint over src/repro_torch
    "PC-AST-IMPORT": (
        "jax or repro imported inside repro_torch: the port runs "
        "without either"),
    "PC-AST-LOOPMETRIC": (
        "per-scenario metric computed in a Python loop: use the "
        "batched metric (training.metrics.auroc_batch) over the "
        "stacked scenario axis"),
    "PC-AST-GENERATOR": (
        "random draw with no generator= in a core module: it reads "
        "torch's global generator, so the result depends on what ran "
        "before it"),
    "PC-AST-NONDET": (
        "nondeterministic host call (time.*, stdlib random, legacy "
        "np.random.*) inside a nested function"),
}

_IGNORE_RE = re.compile(r"#\s*plancheck:\s*ignore(?:\[([A-Z0-9,\- ]+)\])?")


@dataclass(frozen=True)
class Finding:
    """One rule violation.  ``key()`` is the identity the baseline
    matches on — file + rule + a stable detail tag (NOT the line
    number, so unrelated edits above a baselined finding don't
    invalidate the baseline)."""
    rule: str
    file: str
    line: int
    message: str
    hint: str = ""
    tag: str = ""                # stable detail (symbol / bucket name)

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.tag)

    def describe(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        out = f"{loc}: {self.rule}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass(frozen=True)
class BucketOps:
    """The dispatch pass's reading of one bucket: the aten ops one round
    dispatched on ``device`` ("meta", or "cpu" where an op has no meta
    kernel: then ``no_meta_op`` names it) against its budget."""
    bucket: int
    budget: str
    ops: int
    max_ops: int
    device: str = "meta"
    no_meta_op: str = ""

    def describe(self) -> str:
        where = (self.device if not self.no_meta_op else
                 f"{self.device}: {self.no_meta_op} has no meta kernel")
        return (f"bucket {self.bucket}: {self.ops} aten ops a round, "
                f"budget {self.max_ops} ({self.budget}, {where})")


@dataclass
class Report:
    """All findings of one plancheck run, split against a baseline, and
    the dispatch pass's op counts."""
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    buckets: List[BucketOps] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings

    def describe(self) -> str:
        lines = [f"plancheck: {len(self.findings)} finding(s), "
                 f"{len(self.suppressed)} baselined"]
        lines.extend("  " + f.describe().replace("\n", "\n  ")
                     for f in self.findings)
        lines.extend("  " + b.describe() for b in self.buckets)
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(
            {"findings": [asdict(f) for f in self.findings],
             "suppressed": [asdict(f) for f in self.suppressed],
             "buckets": [asdict(b) for b in self.buckets]},
            indent=2, sort_keys=True)


def finding(rule: str, file: str, line: int, message: str,
            hint: str = "", tag: str = "") -> Finding:
    assert rule in RULES, f"unregistered rule id {rule!r}"
    return Finding(rule=rule, file=file, line=line, message=message,
                   hint=hint, tag=tag)


# ---------------------------------------------------------------------------
# Inline suppression
# ---------------------------------------------------------------------------
def inline_suppressions(source: str) -> Dict[int, Optional[set]]:
    """{line number: set of rule ids silenced there, or None = all}.

    A comment on line L silences findings on L; a comment on a line of
    its own also silences the NEXT line (decorator-style)."""
    out: Dict[int, Optional[set]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(text)
        if not m:
            continue
        rules = (None if m.group(1) is None else
                 {r.strip() for r in m.group(1).split(",") if r.strip()})
        own_line = bool(text[:m.start()].strip() == "")
        for ln in ((i, i + 1) if own_line else (i,)):
            prev = out.get(ln, set())
            if rules is None or prev is None:
                out[ln] = None
            else:
                out[ln] = prev | rules
    return out


def apply_inline(findings: Sequence[Finding], source: str
                 ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings of ONE file by its inline-ignore comments."""
    supp = inline_suppressions(source)
    kept, silenced = [], []
    for f in findings:
        rules = supp.get(f.line, set())
        if rules is None or (rules and f.rule in rules):
            silenced.append(f)
        else:
            kept.append(f)
    return kept, silenced


# ---------------------------------------------------------------------------
# Baseline file
# ---------------------------------------------------------------------------
_KV_RE = re.compile(r'^\s*([A-Za-z_]+)\s*=\s*(".*"|\d+)\s*$')


def _parse_baseline_text(text: str) -> List[Dict[str, object]]:
    """Minimal parser for the ``[[suppress]]`` TOML subset we write."""
    entries: List[Dict[str, object]] = []
    cur: Optional[Dict[str, object]] = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip() if not raw.lstrip(
            ).startswith("#") else ""
        if not line.strip():
            continue
        if line.strip() == "[[suppress]]":
            cur = {}
            entries.append(cur)
            continue
        m = _KV_RE.match(line)
        if m and cur is not None:
            v = m.group(2)
            cur[m.group(1)] = (int(v) if not v.startswith('"')
                               else json.loads(v))
        elif cur is None:
            raise ValueError(f"baseline: unexpected line {raw!r}")
    return entries


def load_baseline(path: str) -> List[Dict[str, object]]:
    """Parse a baseline file -> list of suppress entries.
    Missing file -> empty baseline.  Every entry must carry a
    ``reason`` — an unexplained suppression is itself an error."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return []
    try:
        import tomllib
        entries = tomllib.loads(raw.decode()).get("suppress", [])
    except ModuleNotFoundError:
        entries = _parse_baseline_text(raw.decode())
    for e in entries:
        if not str(e.get("reason", "")).strip():
            raise ValueError(
                f"baseline entry {e!r} has no reason: every suppression "
                f"must justify itself")
    return list(entries)


def _entry_matches(entry: Dict[str, object], f: Finding) -> bool:
    if entry.get("rule") not in (None, f.rule):
        return False
    if entry.get("file") not in (None, f.file):
        return False
    if entry.get("tag") not in (None, "", f.tag):
        return False
    return True


def apply_baseline(findings: Sequence[Finding],
                   baseline: Sequence[Dict[str, object]]
                   ) -> Tuple[List[Finding], List[Finding]]:
    """(new findings, baselined findings)."""
    kept, silenced = [], []
    for f in findings:
        if any(_entry_matches(e, f) for e in baseline):
            silenced.append(f)
        else:
            kept.append(f)
    return kept, silenced


def format_baseline(findings: Sequence[Finding],
                    reason: str = "TODO: justify") -> str:
    """Render findings as a baseline file body (``--write-baseline``)."""
    blocks = ["# plancheck suppression baseline.  Every entry MUST",
              "# carry a reason; delete entries as the findings are",
              "# fixed.  Matching is (rule, file, tag) — line numbers",
              "# deliberately don't participate.", ""]
    for f in findings:
        blocks.append("[[suppress]]")
        blocks.append(f'rule = "{f.rule}"')
        blocks.append(f'file = "{f.file}"')
        if f.tag:
            blocks.append(f'tag = "{f.tag}"')
        blocks.append(f'reason = "{reason}"')
        blocks.append("")
    return "\n".join(blocks)
