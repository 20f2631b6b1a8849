"""Checker framework: findings, file discovery, baseline, report — the
port's copy of ``bdbnn_tpu/analysis/core.py``, over ``bdbnn_tpu_torch/``.

A **checker** is a function ``check(root, files) -> List[Finding]``
registered in :func:`_checkers`. ``root`` is the repo root the paths
are rendered relative to; ``files`` is the explicit ``.py`` scan set
(absolute paths). Checkers are pure AST/file analysis — no imports of
the analyzed code, no torch — so they run identically on the live tree,
on a doctored temp copy and on the seeded-bad fixture corpus under
``tests/fixtures/analysis/``.

A **finding** renders as ``file:line:checker-id:message`` — one line,
stable and diffable. The **suppression baseline**
(``bdbnn_tpu_torch/analysis/baseline.txt``; the root's
``analysis-baseline.txt`` is the reference analyzer's) holds records of findings
that are understood and accepted; the framework enforces the
baseline's own hygiene (checker id ``baseline``):

- every entry must be justified — immediately preceded by at least one
  ``# why: ...`` comment line;
- entries must be sorted and deduplicated;
- a **stale** entry (no current finding matches it) is itself a
  finding: suppressions must be garbage-collected with the code they
  excuse.

Suppression matching is on ``(file, checker-id, message)`` — the line
number in the record is **advisory** (it documents where the finding
sat when baselined): an edit above the site shifts every finding's
line, and a baseline that breaks on unrelated-line churn would be
resynced by hand on almost every PR. One entry consumes AT MOST ONE
matching finding (the one closest to the advisory line): the baseline
excuses one understood occurrence, so a brand-NEW site producing the
same message stays open and fails the gate.

The report dict is deterministic (no clocks, no absolute paths) and
strict-JSON after ``obs.events.jsonsafe`` — the same discipline every
other machine-readable artifact in this repo follows.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# the port's baseline, relative to the repo root: the default of
# run_check and of ``check --baseline``
BASELINE_PATH = "bdbnn_tpu_torch/analysis/baseline.txt"

# checker id every baseline-hygiene finding carries
BASELINE_CHECKER = "baseline"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One defect record: ``file:line:checker-id:message``. ``file``
    is repo-root-relative, posix-style, so records are stable across
    machines and usable as baseline entries verbatim."""

    file: str
    line: int
    checker: str
    message: str

    @property
    def record(self) -> str:
        return f"{self.file}:{self.line}:{self.checker}:{self.message}"

    @property
    def match_key(self) -> Tuple[str, str, str]:
        """Suppression identity: the line number is advisory."""
        return (self.file, self.checker, self.message)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "file": self.file,
            "line": self.line,
            "checker": self.checker,
            "message": self.message,
            "record": self.record,
        }


def relpath(path: str, root: str) -> str:
    return os.path.relpath(os.path.abspath(path), os.path.abspath(root)
                           ).replace(os.sep, "/")


def discover_files(root: str) -> List[str]:
    """The default scan set: every ``.py`` under the port's package."""
    return sorted(
        glob.glob(
            os.path.join(root, "bdbnn_tpu_torch", "**", "*.py"),
            recursive=True,
        )
    )


# -- baseline ----------------------------------------------------------------


def load_baseline(path: str) -> Tuple[List[Dict[str, Any]], List[Finding]]:
    """Parse a suppression baseline. Returns ``(entries, problems)``:
    ``entries`` are ``{record, line, justified}`` dicts; ``problems``
    are baseline-hygiene findings (unjustified / duplicate / unsorted
    entries). Staleness is judged by the caller, which knows the
    current finding set. A missing file is an empty baseline."""
    entries: List[Dict[str, Any]] = []
    problems: List[Finding] = []
    if not os.path.isfile(path):
        return entries, problems
    name = os.path.basename(path)
    pending_why = False
    with open(path) as f:
        for lineno, raw in enumerate(f, start=1):
            line = raw.strip()
            if not line:
                pending_why = False
                continue
            if line.startswith("#"):
                if line[1:].strip().lower().startswith("why:"):
                    pending_why = True
                continue
            entries.append(
                {"record": line, "line": lineno, "justified": pending_why}
            )
            pending_why = False
    def natural_key(record: str):
        # the analyzer's own report order: (file, NUMERIC line, rest) —
        # so records pasted from `check` output in order are sorted
        parts = record.split(":", 2)
        if len(parts) == 3 and parts[1].isdigit():
            return (parts[0], int(parts[1]), parts[2])
        return (record, 0, "")

    def dedup_key(record: str):
        # two entries differing only in the advisory line number are
        # the same suppression
        parts = record.split(":", 3)
        return (parts[0], parts[2], parts[3]) if len(parts) == 4 else record

    seen = set()
    prev = None
    for e in entries:
        if not e["justified"]:
            problems.append(Finding(
                name, e["line"], BASELINE_CHECKER,
                "suppression has no '# why:' justification comment "
                f"({e['record']})",
            ))
        if dedup_key(e["record"]) in seen:
            problems.append(Finding(
                name, e["line"], BASELINE_CHECKER,
                f"duplicate suppression ({e['record']})",
            ))
        seen.add(dedup_key(e["record"]))
        if prev is not None and natural_key(e["record"]) < natural_key(
            prev
        ):
            problems.append(Finding(
                name, e["line"], BASELINE_CHECKER,
                f"baseline not sorted ({e['record']} after {prev})",
            ))
        prev = e["record"]
    return entries, problems


# -- registry / driver -------------------------------------------------------


def _checkers() -> Dict[str, Callable[[str, List[str]], List[Finding]]]:
    # local imports: each checker module imports this one for Finding
    from bdbnn_tpu_torch.analysis.eventschema import check_event_schema
    from bdbnn_tpu_torch.analysis.forwardpure import check_forward_purity
    from bdbnn_tpu_torch.analysis.lockcheck import check_lock_discipline
    from bdbnn_tpu_torch.analysis.verdictcheck import check_verdict_coherence

    return {
        "lock-discipline": check_lock_discipline,
        "forward-purity": check_forward_purity,
        "event-schema": check_event_schema,
        "verdict-coherence": check_verdict_coherence,
    }


# derived from the registry, never hand-maintained: a checker added
# to _checkers() is automatically runnable from run_check's default
# selection and the CLI's --checker choices
CHECKER_IDS: Tuple[str, ...] = tuple(_checkers())


def run_check(
    root: str,
    *,
    checkers: Optional[Sequence[str]] = None,
    files: Optional[Sequence[str]] = None,
    baseline_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Run the selected checkers over ``files`` (default: the
    discovered package set under ``root``) and fold in the baseline.
    Returns the deterministic report dict; ``verdict`` is ``"clean"``
    exactly when there are no unsuppressed findings (the CLI maps
    anything else to exit 3)."""
    registry = _checkers()
    selected = list(checkers) if checkers else list(CHECKER_IDS)
    unknown = [c for c in selected if c not in registry]
    if unknown:
        raise ValueError(
            f"unknown checker(s) {unknown}; known: {sorted(registry)}"
        )
    scan = list(files) if files is not None else discover_files(root)

    all_findings: List[Finding] = []
    for cid in selected:
        all_findings.extend(registry[cid](root, scan))
    all_findings.sort()

    if baseline_path is None:
        baseline_path = os.path.join(root, BASELINE_PATH)
    entries, problems = load_baseline(baseline_path)
    def entry_parts(record: str):
        """((file, checker, message), advisory line) — None key for a
        record too malformed to split."""
        parts = record.split(":", 3)
        if len(parts) == 4:
            advisory = int(parts[1]) if parts[1].isdigit() else 0
            return (parts[0], parts[2], parts[3]), advisory
        return None, 0

    # one entry consumes AT MOST ONE matching finding — the one whose
    # line sits closest to the entry's advisory line. Line churn above
    # a baselined site keeps matching (the line is advisory), but a
    # brand-NEW site with the same message stays OPEN: the baseline
    # excuses one understood occurrence, never a class of them.
    by_key: Dict[Tuple[str, str, str], List[Finding]] = {}
    for f in all_findings:
        by_key.setdefault(f.match_key, []).append(f)
    consumed: set = set()
    known_checkers = set(registry)
    for e in entries:
        key, advisory = entry_parts(e["record"])
        entry_checker = key[1] if key else ""
        if entry_checker == BASELINE_CHECKER:
            # hygiene findings bypass the suppression set by design —
            # an entry naming the baseline checker suppresses nothing
            # and would otherwise linger as inert dead weight
            problems.append(Finding(
                os.path.basename(baseline_path), e["line"],
                BASELINE_CHECKER,
                "baseline-hygiene findings cannot be suppressed "
                f"({e['record']})",
            ))
            continue
        if key is None or entry_checker not in known_checkers:
            # a typo'd / malformed record can never match a finding —
            # it must not become a permanently inert suppression
            problems.append(Finding(
                os.path.basename(baseline_path), e["line"],
                BASELINE_CHECKER,
                f"suppression names unknown checker id "
                f"{entry_checker!r} ({e['record']})",
            ))
            continue
        # an entry belonging to a KNOWN checker that did not run this
        # pass (--checker filter) is out of scope — neither live nor
        # stale
        if entry_checker not in selected:
            continue
        candidates = [
            f for f in by_key.get(key, ())
            if id(f) not in consumed
        ]
        if not candidates:
            problems.append(Finding(
                os.path.basename(baseline_path), e["line"],
                BASELINE_CHECKER,
                f"stale suppression (no current finding matches "
                f"{e['record']}; the line is advisory — file, checker "
                "and message must match)",
            ))
            continue
        best = min(candidates, key=lambda f: (abs(f.line - advisory),
                                              f.line))
        consumed.add(id(best))
    suppressed = [f for f in all_findings if id(f) in consumed]
    open_findings = sorted(
        [f for f in all_findings if id(f) not in consumed]
        + problems
    )

    return {
        "root": ".",  # deterministic: never an absolute path
        "checkers": selected,
        "files_scanned": len(scan),
        "findings": [f.to_dict() for f in open_findings],
        "suppressed": [f.to_dict() for f in suppressed],
        "counts": {
            "findings": len(open_findings),
            "suppressed": len(suppressed),
            "by_checker": {
                cid: sum(1 for f in open_findings if f.checker == cid)
                for cid in sorted(set(
                    [f.checker for f in open_findings] + selected
                ))
            },
        },
        "verdict": "clean" if not open_findings else "findings",
    }


def render_report(report: Dict[str, Any]) -> str:
    """The human-readable rendering of one :func:`run_check` report."""
    lines = [
        "== Static analysis "
        f"({', '.join(report['checkers'])}; "
        f"{report['files_scanned']} files)"
    ]
    for f in report["findings"]:
        lines.append(f"  {f['record']}")
    if report["suppressed"]:
        lines.append(
            f"  ({report['counts']['suppressed']} finding(s) suppressed "
            f"by {BASELINE_PATH})"
        )
    lines.append(
        f"verdict: {report['verdict'].upper()} "
        f"({report['counts']['findings']} open finding(s))"
    )
    return "\n".join(lines)


__all__ = [
    "BASELINE_CHECKER",
    "BASELINE_PATH",
    "CHECKER_IDS",
    "Finding",
    "discover_files",
    "load_baseline",
    "relpath",
    "render_report",
    "run_check",
]
