"""The AST lint over ``src/repro_torch``.

Port of ``repro.analysis.plancheck.astpass``, with the rules the port
holds itself to:

``PC-AST-IMPORT``
    ``jax`` or ``repro`` (not ``repro_torch``) imported anywhere in the
    package, at the top of a module or inside a function: the port runs
    on a machine that has neither.  ``repro``'s ``PC-AST-JIT`` guarded
    where executables are built; the port builds none.
``PC-AST-LOOPMETRIC``
    The scalar ``auroc`` / ``roc_curve`` called inside a Python loop or
    comprehension: per-scenario metrics belong in one ``auroc_batch``
    sweep.  Loops over a bounded per-device axis can be inline-ignored
    with a justification.
``PC-AST-GENERATOR``
    A ``torch.rand*`` / ``randn*`` / ``randint*`` / ``randperm`` /
    ``bernoulli`` / ``multinomial`` / ``normal`` draw with no
    ``generator=`` in a core module (:data:`CORE_PREFIXES`): it reads
    torch's global generator, which any earlier draw moves.  The port
    takes its draws from explicit generators or as operands; this
    replaces ``repro``'s ``PC-AST-KEYREUSE``, which tracks JAX's keys.
``PC-AST-NONDET``
    ``time.*``, stdlib ``random.*`` or legacy global-state
    ``np.random.*`` calls inside a NESTED function: in the port those are
    the round loops' and the services' closures, which must not read a
    clock or a global generator.  Module-level functions and methods
    (timers around a run, CLI mains) are exempt by construction.

Findings carry file:line + rule id + fix hint and honour inline
``# plancheck: ignore[RULE]`` comments (:mod:`.findings`).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.plancheck.findings import (Finding, apply_inline,
                                                     finding)

#: the module that DEFINES the metrics is exempt from PC-AST-LOOPMETRIC
METRIC_DEF_MODULES: Set[str] = {"training/metrics.py"}

#: scalar per-scenario metrics that must not run in Python loops
LOOP_METRIC_NAMES: Set[str] = {"auroc", "roc_curve"}

#: packages whose import the port forbids (``repro_torch`` is not one)
FORBIDDEN_IMPORTS: Tuple[str, ...] = ("jax", "repro")

#: subtrees (src/repro_torch-relative) held to PC-AST-GENERATOR: the
#: modules whose draws feed results
CORE_PREFIXES: Tuple[str, ...] = ("core/", "models/", "serving/",
                                  "training/", "data/", "kernels/")

#: torch draws that take a generator
TORCH_DRAWS: Set[str] = {"rand", "rand_like", "randn", "randn_like",
                         "randint", "randint_like", "randperm",
                         "bernoulli", "multinomial", "normal"}

#: legacy numpy global-RNG entry points (Generator methods are fine)
NP_RANDOM_LEGACY: Set[str] = {"rand", "randn", "random", "seed",
                              "randint", "choice", "shuffle",
                              "permutation", "uniform", "normal",
                              "random_sample"}


class _Imports(ast.NodeVisitor):
    """Module-alias table: local name -> dotted module it refers to."""

    def __init__(self):
        self.modules: Dict[str, str] = {}
        self.names: Dict[str, str] = {}      # from-imports: name -> fqn

    def visit_Import(self, node):
        for a in node.names:
            self.modules[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0])
            if a.asname and "." in a.name:
                self.modules[a.asname] = a.name

    def visit_ImportFrom(self, node):
        if node.module is None or node.level:
            return
        for a in node.names:
            fqn = f"{node.module}.{a.name}"
            self.names[a.asname or a.name] = fqn
            # `from numpy import random` makes `random` a module alias
            self.modules.setdefault(a.asname or a.name, fqn)


def _resolve(node: ast.AST, imp: _Imports) -> Optional[str]:
    """Dotted name of an expression, import-aware: Name('np') ->
    'numpy', Attribute(torch, 'rand') -> 'torch.rand'."""
    if isinstance(node, ast.Name):
        if node.id in imp.names:
            return imp.names[node.id]
        return imp.modules.get(node.id, node.id)
    if isinstance(node, ast.Attribute):
        base = _resolve(node.value, imp)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _call_name(node: ast.Call, imp: _Imports) -> Optional[str]:
    return _resolve(node.func, imp)


# ---------------------------------------------------------------------------
# per-file checker
# ---------------------------------------------------------------------------
def check_source(source: str, relpath: str,
                 apply_suppressions: bool = True
                 ) -> Tuple[List[Finding], List[Finding]]:
    """(findings, inline-suppressed findings) of one module."""
    tree = ast.parse(source, filename=relpath)
    imp = _Imports()
    imp.visit(tree)
    out: List[Finding] = []

    out += _check_imports(tree, relpath)
    if relpath not in METRIC_DEF_MODULES:
        out += _check_loop_metrics(tree, imp, relpath)
    if relpath.startswith(CORE_PREFIXES):
        out += _check_generators(tree, imp, relpath)
    out += _check_nondet(tree, imp, relpath)

    out.sort(key=lambda f: (f.line, f.rule))
    if not apply_suppressions:
        return out, []
    return apply_inline(out, source)


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN_IMPORTS


def _check_imports(tree, relpath) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            if _forbidden(mod):
                out.append(finding(
                    "PC-AST-IMPORT", relpath, node.lineno,
                    f"imports {mod}: the port runs without jax and "
                    f"without repro",
                    hint="keep a copy of what is needed inside "
                         "repro_torch (the tests alone import both "
                         "packages)",
                    tag=f"L{node.lineno}:{mod}"))
    return out


def _check_loop_metrics(tree, imp, relpath) -> List[Finding]:
    out = []
    loops = (ast.For, ast.While, ast.ListComp, ast.SetComp,
             ast.DictComp, ast.GeneratorExp)

    def walk(node, in_loop):
        for child in ast.iter_child_nodes(node):
            child_in_loop = in_loop or isinstance(child, loops)
            if isinstance(child, ast.Call) and child_in_loop:
                name = _call_name(child, imp) or ""
                leaf = name.rsplit(".", 1)[-1]
                if leaf in LOOP_METRIC_NAMES:
                    out.append(finding(
                        "PC-AST-LOOPMETRIC", relpath, child.lineno,
                        f"scalar metric '{leaf}' called inside a "
                        f"Python loop",
                        hint="stack the scores and make ONE "
                             "auroc_batch call over the batch axis "
                             "(repro_torch.training.metrics)",
                        tag=f"L{child.lineno}:{leaf}"))
            walk(child, child_in_loop)

    walk(tree, False)
    return out


def _check_generators(tree, imp, relpath) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node, imp) or ""
        if not name.startswith("torch."):
            continue
        fn = name[len("torch."):]
        if fn not in TORCH_DRAWS:
            continue
        if any(kw.arg == "generator" for kw in node.keywords):
            continue
        out.append(finding(
            "PC-AST-GENERATOR", relpath, node.lineno,
            f"{name}() draws from torch's global generator (no "
            f"generator=)",
            hint="pass an explicit torch.Generator seeded from the "
                 "scenario's seed, or take the draw as an operand",
            tag=f"L{node.lineno}:{name}"))
    return out


def _check_nondet(tree, imp, relpath) -> List[Finding]:
    out = []

    def fn_depth_walk(node, depth):
        for child in ast.iter_child_nodes(node):
            d = depth + isinstance(child, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
            if isinstance(child, ast.Call) and depth >= 2:
                name = _call_name(child, imp) or ""
                bad = None
                if (name.startswith("time.")
                        and imp.modules.get("time") == "time"):
                    bad = name
                elif (name.startswith("random.")
                        and imp.modules.get("random") == "random"):
                    bad = name
                elif (name.startswith("numpy.random.")
                        and name.rsplit(".", 1)[-1] in NP_RANDOM_LEGACY):
                    bad = name
                if bad:
                    out.append(finding(
                        "PC-AST-NONDET", relpath, child.lineno,
                        f"nondeterministic host call {bad}() inside a "
                        f"nested function (a round loop's or a "
                        f"service's closure)",
                        hint="thread explicit seeds and generators "
                             "through the arguments; host clocks and "
                             "global RNGs stay at module-function level",
                        tag=f"L{child.lineno}:{bad}"))
            fn_depth_walk(child, d)

    fn_depth_walk(tree, 0)
    return out


# ---------------------------------------------------------------------------
# repo driver
# ---------------------------------------------------------------------------
def check_repo(src_root: str,
               rel_prefix: str = "") -> Tuple[List[Finding],
                                              List[Finding]]:
    """Run the AST pass over every ``*.py`` under ``src_root`` (the
    ``src/repro_torch`` package); returns (findings, inline-suppressed).
    ``rel_prefix`` prepends to reported paths (e.g.
    ``src/repro_torch/``)."""
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__",))
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, src_root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            kept, silenced = check_source(source, rel)
            if rel_prefix:
                kept = [finding(f.rule, rel_prefix + f.file, f.line,
                                f.message, f.hint, f.tag)
                        for f in kept]
                silenced = [finding(f.rule, rel_prefix + f.file, f.line,
                                    f.message, f.hint, f.tag)
                            for f in silenced]
            findings.extend(kept)
            suppressed.extend(silenced)
    return findings, suppressed
