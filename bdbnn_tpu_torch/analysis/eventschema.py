"""``event-schema``: the events channel's registry cannot drift — the
port's copy of ``bdbnn_tpu/analysis/eventschema.py``. Three invariants:

1. **Registered kinds** — every ``<obj>.emit(...)`` / ``<obj>._emit(
   ...)`` call site passing a LITERAL string kind must pass one
   registered in ``KNOWN_KINDS``. The ``_emit`` attribute names the
   telemetry-relay wrappers (serve/pool.py, serve/canary.py) that
   forward ``(kind, **fields)`` to an injected ``on_event`` hook —
   their literal kinds must register exactly like direct emits, or the
   canary/shadow channel could drift unregistered.
2. **Documented kinds** — every ``KNOWN_KINDS`` entry must be
   documented as ``\\`\\`kind\\`\\``` in the registry module's
   docstring (obs/events.py's kind-by-kind table), so the registry and
   the docs cannot drift.
3. **Live kinds** — every ``KNOWN_KINDS`` entry must have at least one
   emit call site in the scan set: a kind nobody emits is dead
   registry weight (usually a renamed literal the registry kept).

The registry is located **statically**: the scanned file that assigns
``KNOWN_KINDS`` a set/frozenset literal is the registry module (the
port's ``bdbnn_tpu_torch/obs/events.py``; a fixture snippet can carry
its own). No import of the analyzed code happens.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from bdbnn_tpu_torch.analysis.core import Finding, relpath

CHECKER_ID = "event-schema"

_EMIT_ATTRS = ("emit", "_emit")


def emit_call_kinds(tree: ast.Module) -> List[Tuple[int, str]]:
    """(lineno, kind) for every emit/_emit call passing a literal
    string first argument. Non-literal first args are not the event
    channel (ProgressLog.emit's step index; **info-style relays are
    covered at the site that adds the literal kind)."""
    out = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _EMIT_ATTRS
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            out.append((node.lineno, node.args[0].value))
    return out


def find_registry(
    parsed: Dict[str, ast.Module]
) -> Optional[Tuple[str, Set[str], str, int]]:
    """Locate the KNOWN_KINDS registry in the scan set: returns
    ``(path, kinds, module_docstring, lineno)`` or None."""
    for path, tree in sorted(parsed.items()):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == "KNOWN_KINDS"
                for t in node.targets
            ):
                continue
            value = node.value
            if isinstance(value, ast.Call) and value.args:
                value = value.args[0]  # frozenset({...})
            try:
                kinds = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                continue
            if isinstance(kinds, (set, frozenset, list, tuple)):
                return (
                    path,
                    {str(k) for k in kinds},
                    ast.get_docstring(tree) or "",
                    node.lineno,
                )
    return None


def scan_events(
    root: str, files: List[str]
) -> Tuple[List[Finding], Set[str]]:
    """The full scan: returns ``(findings, found_kinds)`` so a test can
    also assert a floor on the kinds found."""
    findings: List[Finding] = []
    parsed: Dict[str, ast.Module] = {}
    for path in files:
        try:
            with open(path) as f:
                src = f.read()
        except OSError:
            continue
        try:
            parsed[path] = ast.parse(src, filename=path)
        except SyntaxError:
            continue  # reported by lock-discipline
    registry = find_registry(parsed)
    found: Set[str] = set()
    if registry is None:
        return findings, found
    reg_path, kinds, doc, reg_lineno = registry
    for path, tree in sorted(parsed.items()):
        rel = relpath(path, root)
        for lineno, kind in emit_call_kinds(tree):
            found.add(kind)
            if kind not in kinds:
                findings.append(Finding(
                    rel, lineno, CHECKER_ID,
                    f"emit({kind!r}) uses a kind not registered in "
                    "KNOWN_KINDS",
                ))
    reg_rel = relpath(reg_path, root)
    for kind in sorted(kinds):
        if f"``{kind}``" not in doc:
            findings.append(Finding(
                reg_rel, reg_lineno, CHECKER_ID,
                f"registered kind {kind!r} is not documented "
                "(``kind``) in the registry module docstring",
            ))
        if kind not in found:
            findings.append(Finding(
                reg_rel, reg_lineno, CHECKER_ID,
                f"registered kind {kind!r} has no emit call site in "
                "the scan set (dead registry entry?)",
            ))
    return sorted(findings), found


def check_event_schema(root: str, files: List[str]) -> List[Finding]:
    findings, _found = scan_events(root, files)
    return findings


__all__ = [
    "CHECKER_ID",
    "check_event_schema",
    "emit_call_kinds",
    "find_registry",
    "scan_events",
]
