"""``forward-purity``: a forward must stay free of host syncs and host
nondeterminism — the port's counterpart of the reference's ``jit-purity``
(``bdbnn_tpu/analysis/jitpure.py``).

The port has no ``jax.jit``; the contract that checker guards is, on the
port, the one that makes a forward capturable as a CUDA graph (one
replay of a warmed bucket) and lets a trace span add no
synchronisation: what a module's ``forward`` (and an autograd
function's ``forward`` and ``backward``) does must be device work
enqueued on its stream, the same every call. A host sync inside it
(``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, a
``synchronize()``) stalls the launch queue and cannot be captured;
``time.*`` / ``random.*`` / ``np.random.*`` make the work depend on the
host; ``print`` / ``logging`` run on the host every call.

The checker builds a conservative name-based call graph over the
**forward domain** (``nn/``, ``models/``, ``losses/``, ``train/step.py``,
``serve/engine.py``, ``obs/probes.py``, ``parallel/``):

- **roots** — ``forward`` of every ``nn.Module`` subclass (any base whose
  name contains ``Module``), ``forward`` and ``backward`` of every
  ``torch.autograd.Function`` subclass (a base named ``Function``), and
  the engine's forward function (:data:`ENGINE_FORWARD`, the method
  ``InferenceEngine`` runs every bucket through);
- **closure** — from each root, every call by name that resolves to a
  function defined in the domain is reachable (over-approximate on
  purpose, as the reference's: a false edge costs a look, a missed edge
  a missed host sync);
- **ban list** — inside reachable functions: ``time.*``, ``random.*``,
  ``np.random.*`` / ``numpy.random.*``, ``.item()``, ``print`` and
  ``logging.*`` (the reference's), and the torch spellings of its
  ``device_get``: ``.cpu()``, ``.numpy()``, ``.tolist()`` and
  ``.synchronize()`` (``torch.cuda.synchronize()``, an event's or a
  stream's).

A scan set with no file of the package (the seeded-bad fixtures) is all
domain.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from bdbnn_tpu_torch.analysis.core import Finding, relpath

CHECKER_ID = "forward-purity"

# default forward domain, relative to the repo root (prefix match)
FORWARD_DOMAIN = (
    "bdbnn_tpu_torch/nn/", "bdbnn_tpu_torch/models/",
    "bdbnn_tpu_torch/losses/", "bdbnn_tpu_torch/train/step.py",
    "bdbnn_tpu_torch/serve/engine.py", "bdbnn_tpu_torch/obs/probes.py",
    "bdbnn_tpu_torch/parallel/",
)

# the serving engine's forward (serve/engine.py InferenceEngine._forward)
ENGINE_FORWARD = "_forward"

# method calls that wait for the device or copy to the host: the torch
# spellings of the reference's device_get (no arguments: ``x.cpu()``;
# ``.synchronize()`` on any receiver)
_HOST_SYNC_METHODS = ("cpu", "numpy", "tolist")


def _called_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _base_name(base: ast.expr) -> str:
    if isinstance(base, ast.Attribute):
        return base.attr
    if isinstance(base, ast.Name):
        return base.id
    return ""


def _banned(node: ast.Call) -> Optional[str]:
    """The ban-list label for a call, or None."""
    func = node.func
    if isinstance(func, ast.Name):
        return "print()" if func.id == "print" else None
    if not isinstance(func, ast.Attribute):
        return None
    bare = not node.args and not node.keywords
    if func.attr == "item" and bare:
        return ".item() host sync"
    if func.attr in _HOST_SYNC_METHODS and bare:
        return f".{func.attr}() host copy"
    if func.attr == "synchronize":
        return ".synchronize() host sync"
    base = func.value
    if isinstance(base, ast.Name):
        if base.id == "time":
            return f"time.{func.attr}()"
        if base.id == "random":
            return f"random.{func.attr}()"
        if base.id == "logging":
            return f"logging.{func.attr}()"
    if (
        isinstance(base, ast.Attribute)
        and base.attr == "random"
        and isinstance(base.value, ast.Name)
        and base.value.id in ("np", "numpy")
    ):
        return f"{base.value.id}.random.{func.attr}()"
    return None


def analyze_forward_purity(
    root: str,
    files: List[str],
    *,
    domain: Tuple[str, ...] = FORWARD_DOMAIN,
) -> Tuple[List[Finding], Set[str], Set[str]]:
    """``(findings, roots, reachable)`` — the full analysis. The roots
    and reachable sets are exposed so a test can pin that the checker
    actually traversed the domain (a refactor that silently empties the
    root set must fail loudly, not pass vacuously)."""
    findings: List[Finding] = []
    # name -> (rel path, function node); name collisions keep every
    # candidate (over-approximation)
    index: Dict[str, List[Tuple[str, ast.AST]]] = {}
    roots: Set[str] = set()

    rel_of = {p: relpath(p, root) for p in files}
    any_pkg = any(r.startswith("bdbnn_tpu_torch/") for r in rel_of.values())
    if any_pkg:
        in_domain = [
            p for p in files
            if any(rel_of[p] == d or rel_of[p].startswith(d) for d in domain)
        ]
    else:
        in_domain = list(files)

    for path in in_domain:
        try:
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
        except OSError:
            continue
        except SyntaxError:
            continue  # lock-discipline reports unparseable files
        rel = rel_of[path]
        if rel.endswith("serve/engine.py"):
            roots.add(ENGINE_FORWARD)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                index.setdefault(node.name, []).append((rel, node))
            elif isinstance(node, ast.ClassDef):
                bases = {_base_name(b) for b in node.bases}
                methods = {
                    item.name for item in node.body
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
                if any("Module" in b for b in bases):
                    roots |= methods & {"forward"}
                if "Function" in bases:
                    roots |= methods & {"forward", "backward"}

    # closure over the name-based call graph
    reachable: Set[str] = set()
    frontier = [r for r in roots if r in index]
    while frontier:
        name = frontier.pop()
        if name in reachable:
            continue
        reachable.add(name)
        for _rel, fn in index[name]:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    callee = _called_name(sub.func)
                    if callee in index and callee not in reachable:
                        frontier.append(callee)

    # ban list inside every reachable function
    for name in sorted(reachable):
        for rel, fn in index[name]:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    label = _banned(sub)
                    if label:
                        findings.append(Finding(
                            rel, sub.lineno, CHECKER_ID,
                            f"{label} inside forward-reachable function "
                            f"{name!r} — host sync / nondeterminism in a "
                            "forward",
                        ))
    return sorted(set(findings)), roots, reachable


def check_forward_purity(
    root: str,
    files: List[str],
    *,
    domain: Tuple[str, ...] = FORWARD_DOMAIN,
) -> List[Finding]:
    findings, _roots, _reachable = analyze_forward_purity(
        root, files, domain=domain
    )
    return findings


__all__ = [
    "CHECKER_ID",
    "ENGINE_FORWARD",
    "FORWARD_DOMAIN",
    "analyze_forward_purity",
    "check_forward_purity",
]
