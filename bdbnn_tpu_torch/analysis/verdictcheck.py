"""``verdict-coherence``: compare's metric namespaces cannot drift — the
port's copy of ``bdbnn_tpu/analysis/verdictcheck.py``, over the port's
``obs/compare.py`` and its verdict producers.

The literal-drift class: ``obs/compare.py`` judges
each verdict family through string keys that must agree across FOUR
places — the ``METRIC_SPECS`` judgment table, the per-family
flattener (``_serve_metrics`` for serving SLO verdicts,
``_perf_metrics`` for roofline perf verdicts) that produces those
keys from a verdict, the verdict-PRODUCING sites that emit the
source fields the flattener reads, and the checked-in golden fixture
(``tests/fixtures/compare/expected_verdict.json``, the reference's,
read as data: the port's verdict keys are the reference's) that pins the
metric skeleton. A key renamed in any one of them silently turns a
CI gate into a no-op (the metric lands ``None`` on both sides and
``_judge`` skips it). For every ``(flattener, prefix, producers)``
row in ``FLATTENERS`` this checker cross-references all four:

1. every ``<prefix>*`` metric in ``METRIC_SPECS`` is produced by the
   flattener;
2. every key the flattener produces is judged in ``METRIC_SPECS``;
3. every produced ``<prefix>*`` key appears in the golden fixture's
   metric skeleton (when the fixture exists under the root);
4. every top-level verdict field the flattener reads
   (``verdict.get("...")``) appears as a string literal in at least
   one of that family's verdict-producing sites (when those files
   exist under the root).

All static: the flattener's produced-key set is recovered from its
AST — constant subscripts, the ``(field, name)`` table loops
(``_SERVE_METRIC_FIELDS`` / ``_PERF_METRIC_FIELDS``), and the
``f"serve_p99_ms_p{p}"`` per-priority loop over
``range(_SERVE_PRIORITY_CLASSES)`` are all evaluated from literals.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, List, Optional, Set, Tuple

from bdbnn_tpu_torch.analysis.core import Finding, relpath

CHECKER_ID = "verdict-coherence"

FLATTENER = "_serve_metrics"
SPECS_NAME = "METRIC_SPECS"
GOLDEN_FIXTURE = "tests/fixtures/compare/expected_verdict.json"
PRODUCER_FILES = (
    "bdbnn_tpu_torch/serve/loadgen.py",
    "bdbnn_tpu_torch/serve/http.py",
    # the fleet router's verdict assembly: the v6 fleet block and the
    # v7 fleet_attribution block (whose serve_fleet_* gates
    # _serve_metrics reads) are produced here
    "bdbnn_tpu_torch/serve/fleet.py",
    # the capacity observatory: the v8 capacity block's flat gates
    # (burn_rate_max / headroom_rps / demand_shed_ratio_max read by
    # _serve_metrics) are assembled here
    "bdbnn_tpu_torch/obs/capacity.py",
)

# every judged verdict family: (flattener function in compare.py,
# METRIC_SPECS key prefix owned by that family, producer files whose
# literals must cover every verdict field the flattener reads)
FLATTENERS = (
    (FLATTENER, "serve_", PRODUCER_FILES),
    ("_perf_metrics", "perf_", ("bdbnn_tpu_torch/obs/roofline.py",)),
)


def _module_literal(tree: ast.Module, name: str) -> Optional[Any]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name
            for t in node.targets
        ):
            try:
                return ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return None
        if (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == name
            and node.value is not None
        ):
            try:
                return ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return None
    return None


def _expand_joined(
    key: ast.JoinedStr, fn: ast.FunctionDef, tree: ast.Module
) -> List[str]:
    """``out[f"serve_p99_ms_p{p}"]`` inside ``for p in range(CONST)``:
    expand the pattern over the loop range. Unexpandable patterns
    return [] (and sub-check 2 will surface the mismatch loudly via
    the METRIC_SPECS side)."""
    if len(key.values) != 2:
        return []
    prefix, var = key.values
    if not (
        isinstance(prefix, ast.Constant)
        and isinstance(prefix.value, str)
        and isinstance(var, ast.FormattedValue)
        and isinstance(var.value, ast.Name)
    ):
        return []
    loop_var = var.value.id
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.For)
            and isinstance(node.target, ast.Name)
            and node.target.id == loop_var
            and isinstance(node.iter, ast.Call)
            and isinstance(node.iter.func, ast.Name)
            and node.iter.func.id == "range"
            and len(node.iter.args) == 1
        ):
            bound_node = node.iter.args[0]
            bound: Optional[int] = None
            if isinstance(bound_node, ast.Constant):
                bound = bound_node.value
            elif isinstance(bound_node, ast.Name):
                val = _module_literal(tree, bound_node.id)
                bound = val if isinstance(val, int) else None
            if isinstance(bound, int):
                return [f"{prefix.value}{i}" for i in range(bound)]
    return []


def _produced_keys(
    fn: ast.FunctionDef, tree: ast.Module
) -> Tuple[Set[str], Set[str]]:
    """``(produced keys, table source fields)``: every key
    ``_serve_metrics`` assigns into its ``out`` dict, plus the verdict
    fields read through the ``(field, name)`` table loop (whose
    ``verdict.get(field)`` is variable, not a literal)."""
    keys: Set[str] = set()
    table_fields: Set[str] = set()
    table_loops: Dict[str, str] = {}  # loop key var -> table name
    for node in ast.walk(fn):
        # for field, name in _SERVE_METRIC_FIELDS: out[name] = ...
        if (
            isinstance(node, ast.For)
            and isinstance(node.target, ast.Tuple)
            and len(node.target.elts) == 2
            and all(isinstance(e, ast.Name) for e in node.target.elts)
            and isinstance(node.iter, ast.Name)
        ):
            table_loops[node.target.elts[1].id] = node.iter.id
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id == "out"
            ):
                continue
            key = t.slice
            if isinstance(key, ast.Constant) and isinstance(
                key.value, str
            ):
                keys.add(key.value)
            elif isinstance(key, ast.JoinedStr):
                keys.update(_expand_joined(key, fn, tree))
            elif isinstance(key, ast.Name) and key.id in table_loops:
                table = _module_literal(tree, table_loops[key.id])
                if isinstance(table, (tuple, list)):
                    for row in table:
                        if (
                            isinstance(row, (tuple, list))
                            and len(row) == 2
                        ):
                            table_fields.add(str(row[0]))
                            keys.add(str(row[1]))
    return keys, table_fields


def _source_fields(fn: ast.FunctionDef) -> Set[str]:
    """Top-level verdict fields the flattener reads:
    ``verdict.get("...")`` literals."""
    fields: Set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "verdict"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            fields.add(node.args[0].value)
    return fields


def _json_keys(obj: Any, out: Set[str]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(str(k))
            _json_keys(v, out)
    elif isinstance(obj, list):
        for v in obj:
            _json_keys(v, out)


def _string_literals(tree: ast.Module) -> Set[str]:
    return {
        n.value
        for n in ast.walk(tree)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    }


def check_verdict_coherence(
    root: str, files: List[str]
) -> List[Finding]:
    findings: List[Finding] = []
    for path in files:
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            continue
        if SPECS_NAME not in src or not any(
            name in src for name, _, _ in FLATTENERS
        ):
            continue
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue  # reported by lock-discipline
        specs = _module_literal(tree, SPECS_NAME)
        if not isinstance(specs, (tuple, list)):
            continue
        rel = relpath(path, root)
        golden = os.path.join(root, GOLDEN_FIXTURE)
        golden_keys: Set[str] = set()
        golden_ok = os.path.isfile(golden)
        if golden_ok:
            try:
                with open(golden) as f:
                    doc = json.load(f)
                _json_keys(doc, golden_keys)
            except (OSError, ValueError):
                golden_ok = False
                findings.append(Finding(
                    GOLDEN_FIXTURE, 1, CHECKER_ID,
                    "golden fixture is unreadable / not valid JSON",
                ))
        for flattener, prefix, producer_files in FLATTENERS:
            fn = next(
                (
                    n for n in tree.body
                    if isinstance(n, ast.FunctionDef)
                    and n.name == flattener
                ),
                None,
            )
            if fn is None:
                continue
            judged = {
                str(row[0])
                for row in specs
                if isinstance(row, (tuple, list)) and row
                and str(row[0]).startswith(prefix)
            }
            produced, table_fields = _produced_keys(fn, tree)
            produced_own = {k for k in produced if k.startswith(prefix)}
            for name in sorted(judged - produced_own):
                findings.append(Finding(
                    rel, fn.lineno, CHECKER_ID,
                    f"{SPECS_NAME} judges {name!r} but {flattener} "
                    "never produces it (the gate silently skips)",
                ))
            for name in sorted(produced_own - judged):
                findings.append(Finding(
                    rel, fn.lineno, CHECKER_ID,
                    f"{flattener} produces {name!r} but {SPECS_NAME} "
                    "never judges it (unjudged verdict metric)",
                ))
            # golden-fixture skeleton (when checked in under this root)
            if golden_ok and golden_keys:
                for name in sorted(judged & produced_own):
                    if name not in golden_keys:
                        findings.append(Finding(
                            GOLDEN_FIXTURE, 1, CHECKER_ID,
                            f"metric {name!r} missing from the "
                            "golden verdict fixture's metric skeleton",
                        ))
            # verdict-producing sites carry every source field literal
            producers: List[Tuple[str, Set[str]]] = []
            for prod_rel in producer_files:
                p = os.path.join(root, prod_rel)
                if not os.path.isfile(p):
                    continue
                try:
                    with open(p) as f:
                        ptree = ast.parse(f.read(), filename=p)
                except (OSError, SyntaxError):
                    continue
                producers.append((prod_rel, _string_literals(ptree)))
            if producers:
                all_literals: Set[str] = set()
                for _, lits in producers:
                    all_literals |= lits
                for field in sorted(_source_fields(fn) | table_fields):
                    if field not in all_literals:
                        findings.append(Finding(
                            rel, fn.lineno, CHECKER_ID,
                            f"{flattener} reads verdict field "
                            f"{field!r} but no verdict-producing site "
                            f"({', '.join(p for p, _ in producers)}) "
                            "mentions that literal",
                        ))
    return sorted(findings)


__all__ = [
    "CHECKER_ID",
    "FLATTENERS",
    "GOLDEN_FIXTURE",
    "PRODUCER_FILES",
    "check_verdict_coherence",
]
