"""``lock-discipline``: guarded attributes mutate only under their lock —
the port's copy of ``bdbnn_tpu/analysis/lockcheck.py``.

The static twin of the races the reference's serving stack once caught
by hand (the restart-clobbers-SHIFTING clobber, the registry lock stolen
mid-critical-section, counter read-modify-writes off the lock). The
checker is **annotation-driven**: a threaded class declares which
attributes a lock guards, and the checker flags every write,
read-modify-write or container mutation of a guarded attribute that is
not enclosed in a ``with self.<lock>`` block.

Annotation spec (comments, so zero runtime cost):

- ``self.shed = 0  # guarded-by: _lock`` — trailing an attribute
  assignment: that attribute is guarded by ``self._lock``.
- ``# guarded-by: _lock: shed, completed, batches`` — a standalone
  comment anywhere in the class body: bulk declaration.
- ``def _pop_highest(self):  # requires-lock: _lock`` — trailing a
  ``def``: the method REQUIRES its caller to hold the lock. Inside it
  the lock counts as held; every call site outside a ``with`` of that
  lock is flagged — the "escape via helper method" class of race.

Semantics the checker understands:

- ``self._cv = threading.Condition(self._lock)`` aliases the condition
  to its lock: holding either is holding the lock.
- ``__init__`` is exempt (construction is single-threaded; no worker
  exists yet).
- Cross-object accesses (``r.state = STOPPED`` from the pool over a
  Replica) are checked against every annotated class in the same
  file: the access must sit under ``with r.<lock>`` for a lock that
  guards that attribute.
- Nested functions and lambdas get a FRESH held-lock context: a
  closure defined inside a ``with`` block runs later, without it.
- Plain reads are deliberately NOT flagged: advisory reads
  (``r.state == READY`` in the dispatcher) are racy-by-design and
  documented at their sites; the damage class is lost updates and torn
  read-modify-writes, which all require a write.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from typing import Dict, List, Optional, Set, Tuple

from bdbnn_tpu_torch.analysis.core import Finding, relpath

CHECKER_ID = "lock-discipline"

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)\s*(?::\s*(.+))?")
_REQUIRES_RE = re.compile(r"#\s*requires-lock:\s*([A-Za-z_]\w*)")

# container methods that mutate their receiver: calling one on a
# guarded attribute is a mutation of that attribute
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse", "rotate",
})

# free functions that mutate their FIRST argument in place
_MUTATING_FREE = frozenset({"heappush", "heappop", "heapify",
                            "heappushpop", "heapreplace"})


def _attr_of_line(code: str) -> Optional[str]:
    """The ``self.<attr>`` a trailing guarded-by comment annotates."""
    m = re.search(r"self\.([A-Za-z_]\w*)", code)
    return m.group(1) if m else None


class _ClassSpec:
    """One annotated class: {attr: lock}, {method: required lock},
    {condition alias: lock}."""

    def __init__(self, name: str):
        self.name = name
        self.guards: Dict[str, str] = {}
        self.requires: Dict[str, str] = {}
        self.aliases: Dict[str, str] = {}

    def canon(self, lock: str) -> str:
        return self.aliases.get(lock, lock)


def _comments(source: str) -> List[Tuple[int, int, str]]:
    """(lineno, col, text) for every REAL comment token — docstrings
    and string literals quoting an annotation example must not
    register guards, so the raw lines are never regex-scanned."""
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenError, IndentationError):
        pass  # ast.parse succeeded, so this should not happen
    return out


def _collect_specs(
    tree: ast.Module, source: str, path: str
) -> Tuple[Dict[str, _ClassSpec], List[Finding]]:
    """Parse annotations + Condition aliases into per-class specs.
    An annotation that binds to NOTHING (trailing guarded-by with no
    ``self.<attr>`` on the line, any form outside a class body, a
    requires-lock comment off a def signature) is itself a finding —
    silence would mean an attribute the author believes protected is
    entirely unchecked."""
    problems: List[Finding] = []
    lines = source.splitlines()
    classes = [
        node for node in ast.walk(tree) if isinstance(node, ast.ClassDef)
    ]

    def owner_of(lineno: int) -> Optional[ast.ClassDef]:
        best = None
        for c in classes:
            if c.lineno <= lineno <= (c.end_lineno or c.lineno):
                if best is None or c.lineno > best.lineno:
                    best = c  # innermost
        return best

    specs: Dict[str, _ClassSpec] = {}

    def spec_for(cls: ast.ClassDef) -> _ClassSpec:
        return specs.setdefault(cls.name, _ClassSpec(cls.name))

    for lineno, col, text in _comments(source):
        m = _GUARDED_RE.search(text)
        if m:
            cls = owner_of(lineno)
            if cls is None:
                problems.append(Finding(
                    path, lineno, CHECKER_ID,
                    "guarded-by annotation outside any class body "
                    "binds to nothing",
                ))
            else:
                spec = spec_for(cls)
                lock, bulk = m.group(1), m.group(2)
                if bulk:
                    for attr in re.split(r"[,\s]+", bulk.strip()):
                        if attr:
                            spec.guards[attr] = lock
                else:
                    attr = _attr_of_line(lines[lineno - 1][:col])
                    if attr:
                        spec.guards[attr] = lock
                    else:
                        problems.append(Finding(
                            path, lineno, CHECKER_ID,
                            "trailing guarded-by annotation with no "
                            "'self.<attr>' on its line binds to "
                            "nothing (use the bulk form for "
                            "multi-line assignments)",
                        ))
        m = _REQUIRES_RE.search(text)
        if m:
            cls = owner_of(lineno)
            bound = False
            if cls is not None:
                # the comment must sit on a def's signature lines
                for node in ast.walk(cls):
                    if isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ) and node.lineno <= lineno < node.body[0].lineno:
                        spec_for(cls).requires[node.name] = m.group(1)
                        bound = True
                        break
            if not bound:
                problems.append(Finding(
                    path, lineno, CHECKER_ID,
                    "requires-lock annotation not on a method's def "
                    "signature line binds to nothing",
                ))

    # Condition aliases: self.X = threading.Condition(self.Y)
    for cls in classes:
        if cls.name not in specs:
            continue
        spec = specs[cls.name]
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Assign) and node.targets):
                continue
            t = node.targets[0]
            v = node.value
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
                and isinstance(v, ast.Call)
                and isinstance(v.func, ast.Attribute)
                and v.func.attr == "Condition"
                and v.args
                and isinstance(v.args[0], ast.Attribute)
                and isinstance(v.args[0].value, ast.Name)
                and v.args[0].value.id == "self"
            ):
                spec.aliases[t.attr] = v.args[0].attr
    return specs, problems


def _receiver(node: ast.expr) -> Optional[str]:
    """``self`` / a bare local name receiver of an attribute access."""
    if isinstance(node, ast.Name):
        return node.id
    return None


class _MethodChecker(ast.NodeVisitor):
    """Walk one method body tracking held (receiver, lock) pairs."""

    def __init__(
        self,
        *,
        path: str,
        cls: _ClassSpec,
        all_specs: Dict[str, _ClassSpec],
        method: ast.AST,
        held: Set[Tuple[str, str]],
        findings: List[Finding],
    ):
        self.path = path
        self.cls = cls
        self.all_specs = all_specs
        self.method = method
        self.held = set(held)
        self.findings = findings

    # -- lock context --------------------------------------------------

    def _lock_of_withitem(
        self, item: ast.withitem
    ) -> Optional[Tuple[str, str]]:
        ctx = item.context_expr
        # with self._lock: / with r._lock:  (also .acquire-style calls
        # are not with-items; Condition objects alias to their lock)
        if isinstance(ctx, ast.Attribute):
            recv = _receiver(ctx.value)
            if recv is not None:
                return recv, ctx.attr
        return None

    def visit_With(self, node: ast.With) -> None:
        added = []
        for item in node.items:
            got = self._lock_of_withitem(item)
            if got is not None:
                recv, lock = got
                spec = self.cls if recv == "self" else None
                names = {lock}
                if spec is not None:
                    names.add(spec.canon(lock))
                else:
                    for s in self.all_specs.values():
                        names.add(s.canon(lock))
                for n in names:
                    pair = (recv, n)
                    if pair not in self.held:
                        self.held.add(pair)
                        added.append(pair)
        for stmt in node.body:
            self.visit(stmt)
        for pair in added:
            self.held.discard(pair)

    # nested scopes run later, without the enclosing lock
    def _fresh_scope(self, node: ast.AST) -> None:
        sub = _MethodChecker(
            path=self.path, cls=self.cls, all_specs=self.all_specs,
            method=node, held=set(), findings=self.findings,
        )
        for child in ast.iter_child_nodes(node):
            sub.visit(child)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._fresh_scope(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._fresh_scope(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._fresh_scope(node)

    # -- guarded-access core -------------------------------------------

    def _guard_for(
        self, recv: str, attr: str
    ) -> Optional[List[Tuple[str, str]]]:
        """Acceptable (receiver, lock) pairs for this access, or None
        when the attribute is not guarded for this receiver."""
        if recv == "self":
            lock = self.cls.guards.get(attr)
            if lock is None:
                return None
            return [("self", self.cls.canon(lock))]
        pairs = []
        for spec in self.all_specs.values():
            lock = spec.guards.get(attr)
            if lock is not None:
                pairs.append((recv, spec.canon(lock)))
        return pairs or None

    def _check_access(
        self, node: ast.Attribute, what: str
    ) -> None:
        recv = _receiver(node.value)
        if recv is None:
            return
        pairs = self._guard_for(recv, node.attr)
        if pairs is None:
            return
        if any(p in self.held for p in pairs):
            return
        lock = pairs[0][1]
        self.findings.append(Finding(
            self.path, node.lineno, CHECKER_ID,
            f"{what} of guarded attribute {recv}.{node.attr} outside "
            f"'with {recv}.{lock}'",
        ))

    def _target_attr(self, t: ast.expr) -> Optional[ast.Attribute]:
        """The Attribute an assignment target mutates: ``x.a = ...``,
        ``x.a[k] = ...`` and ``x.a[k][j] = ...`` all mutate ``x.a``."""
        return self._mutated_attr(t)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            targets = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for tt in targets:
                attr = self._target_attr(tt)
                if attr is not None:
                    self._check_access(attr, "write")
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        attr = self._target_attr(node.target)
        if attr is not None:
            self._check_access(attr, "write")
        if node.value is not None:
            self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = self._target_attr(node.target)
        if attr is not None:
            self._check_access(attr, "read-modify-write")
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            attr = self._target_attr(t)
            if attr is not None:
                self._check_access(attr, "delete")

    def _mutated_attr(self, node: ast.expr) -> Optional[ast.Attribute]:
        """The guarded attribute a mutation reaches: ``self._q`` (a
        direct Attribute) or ``self._qs[p]`` / ``self._counts[t][k]``
        (any depth of Subscripts off the Attribute — mutating a nested
        element mutates the guarded container)."""
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute):
            return node
        return None

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            # mutation through a container method: self._q.append(x)
            # and self._qs[p].append(x) (subscripted element of a
            # guarded container)
            if func.attr in _MUTATORS:
                attr = self._mutated_attr(func.value)
                if attr is not None:
                    self._check_access(attr, f"{func.attr}() mutation")
            # escape via a helper that requires the lock:
            # self._pop_highest() outside 'with self._lock'
            recv = _receiver(func.value)
            if recv is not None:
                self._check_requires(recv, func.attr, node.lineno)
        # mutation through a free function: heapq.heappush(self._tail[p],
        # ...) mutates its first argument in place
        fname = (
            func.attr if isinstance(func, ast.Attribute)
            else func.id if isinstance(func, ast.Name) else None
        )
        if fname in _MUTATING_FREE and node.args:
            attr = self._mutated_attr(node.args[0])
            if attr is not None:
                self._check_access(attr, f"{fname}() mutation")
        self.generic_visit(node)

    def _check_requires(
        self, recv: str, method: str, lineno: int
    ) -> None:
        """Like :meth:`_guard_for`: collect EVERY candidate lock a
        same-named method may require across the file's classes and
        accept any held one — first-spec-wins would false-positive a
        call holding the correct lock when two classes share a method
        name with different locks."""
        specs = (
            [self.cls] if recv == "self" else list(self.all_specs.values())
        )
        locks = [
            spec.canon(spec.requires[method])
            for spec in specs
            if method in spec.requires
        ]
        if not locks:
            return
        if any((recv, lock) in self.held for lock in locks):
            return
        self.findings.append(Finding(
            self.path, lineno, CHECKER_ID,
            f"call to {recv}.{method}() which requires "
            f"{locks[0]}, outside 'with {recv}.{locks[0]}'",
        ))


def _check_function(
    path: str,
    node: ast.AST,
    spec: _ClassSpec,
    all_specs: Dict[str, _ClassSpec],
    findings: List[Finding],
) -> None:
    held: Set[Tuple[str, str]] = set()
    req = spec.requires.get(getattr(node, "name", ""))
    if req is not None:
        held.add(("self", spec.canon(req)))
    checker = _MethodChecker(
        path=path, cls=spec, all_specs=all_specs, method=node,
        held=held, findings=findings,
    )
    for child in node.body:
        checker.visit(child)


def _check_class(
    path: str,
    cls_node: ast.ClassDef,
    spec: _ClassSpec,
    all_specs: Dict[str, _ClassSpec],
    findings: List[Finding],
) -> None:
    for node in cls_node.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name == "__init__":
            continue  # construction is single-threaded by contract
        _check_function(path, node, spec, all_specs, findings)


def check_lock_discipline(root: str, files: List[str]) -> List[Finding]:
    """Run the lock-discipline checker over every annotated class in
    ``files``. Files with no ``guarded-by`` annotations cost one regex
    scan and are skipped."""
    findings: List[Finding] = []
    for path in files:
        try:
            with open(path) as f:
                source = f.read()
        except OSError:
            continue
        # EVERY file is parsed, annotated or not: lock-discipline is
        # the one checker that reports unparseable files (the others
        # skip SyntaxError citing this), and a syntax error anywhere
        # would otherwise make the whole analyzer silently vacuous for
        # that file
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            findings.append(Finding(
                relpath(path, root), e.lineno or 0, CHECKER_ID,
                f"unparseable file: {e.msg}",
            ))
            continue
        if "guarded-by:" not in source and "requires-lock:" not in source:
            # fast path: no annotation marker of either kind anywhere
            continue
        rel = relpath(path, root)
        specs, problems = _collect_specs(tree, source, rel)
        findings.extend(problems)
        if not specs:
            continue
        # EVERY class and module-level function in an annotated file is
        # walked: cross-object accesses (a pool mutating r.restarts)
        # live outside the class that declared the guard
        empty = _ClassSpec("")
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                _check_class(
                    rel, node, specs.get(node.name, empty), specs,
                    findings,
                )
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(rel, node, empty, specs, findings)
    return sorted(findings)


__all__ = ["CHECKER_ID", "check_lock_discipline"]
