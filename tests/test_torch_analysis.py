"""The port's static analyzer (``bdbnn_tpu_torch/analysis/``, ``cli
check``) against the JAX package's (``bdbnn_tpu/analysis/``).

- the reference's seeded-bad corpus: the port's ``lock-discipline``,
  ``event-schema`` and ``verdict-coherence`` give exactly the reference
  checkers' records, and each fixture fires exactly its own checker;
- the two packages' generic checkers agree on both trees;
- baseline hygiene (unjustified, duplicate, unsorted, stale, unknown
  checker, a ``baseline`` entry) gives the reference's findings;
- inline torch fixtures: a ``forward`` that calls ``.item()`` fires
  exactly ``forward-purity``, a copy of the port's ``compare.py`` with a
  judged key dropped exactly ``verdict-coherence``;
- the self-run gate: ``cli check`` exits 0 on the port's tree, with every
  baseline entry justified and live, and 3 on a seeded-bad copy; the
  checkers actually traverse the tree;
- the repair the analyzer found: the runner factory's forward count is a
  guarded attribute of a class the checker sees.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from bdbnn_tpu.analysis import core as ref_core
from bdbnn_tpu.analysis.eventschema import check_event_schema as ref_event_schema
from bdbnn_tpu.analysis.lockcheck import check_lock_discipline as ref_lock
from bdbnn_tpu.analysis.verdictcheck import check_verdict_coherence as ref_verdict
from bdbnn_tpu_torch.analysis import (
    BASELINE_PATH,
    CHECKER_IDS,
    load_baseline,
    render_report,
    run_check,
)
from bdbnn_tpu_torch.analysis.core import discover_files
from bdbnn_tpu_torch.analysis.eventschema import check_event_schema, scan_events
from bdbnn_tpu_torch.analysis.forwardpure import analyze_forward_purity, check_forward_purity
from bdbnn_tpu_torch.analysis.lockcheck import check_lock_discipline
from bdbnn_tpu_torch.analysis.verdictcheck import check_verdict_coherence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
PORT_FILES = discover_files(REPO)


def _write(tmp_path, name, source):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return str(p)


def _records(findings):
    return [f.record for f in findings]


# -- the reference's corpus --------------------------------------------------

CORPUS = [
    ("bad_lock_discipline.py", "lock-discipline", check_lock_discipline, ref_lock),
    ("bad_event_schema.py", "event-schema", check_event_schema, ref_event_schema),
    ("bad_verdict_coherence.py", "verdict-coherence", check_verdict_coherence, ref_verdict),
]


@pytest.mark.parametrize("name,checker,port_fn,ref_fn", CORPUS, ids=[c[1] for c in CORPUS])
def test_fixture_records_are_the_references(name, checker, port_fn, ref_fn):
    files = [os.path.join(FIXTURES, name)]
    got = port_fn(FIXTURES, files)
    assert _records(got) == _records(ref_fn(FIXTURES, files))
    assert len(got) == 1
    rep = run_check(FIXTURES, files=files,
                    baseline_path=os.path.join(FIXTURES, "no-baseline"))
    assert [f["checker"] for f in rep["findings"]] == [checker]


@pytest.mark.parametrize("tree", ["bdbnn_tpu_torch", "bdbnn_tpu"])
def test_generic_checkers_agree_with_the_references_on_both_trees(tree):
    files = PORT_FILES if tree == "bdbnn_tpu_torch" else ref_core.discover_files(REPO)
    assert _records(check_lock_discipline(REPO, files)) == _records(ref_lock(REPO, files))
    assert _records(check_event_schema(REPO, files)) == _records(ref_event_schema(REPO, files))


# -- baseline hygiene --------------------------------------------------------

RECORD = "mod.py:8:lock-discipline:write of guarded attribute self.n outside 'with self._lock'"
BASELINES = {
    "justified": f"# why: deliberate\n{RECORD}\n",
    "unjustified": f"{RECORD}\n",
    "stale": "# why: excuse for nothing\ngone.py:1:lock-discipline:ancient history\n",
    "duplicate": f"# why: once\n{RECORD}\n# why: again\n{RECORD.replace(':8:', ':9:')}\n",
    "unsorted": "# why: b\nb.py:1:lock-discipline:m\n# why: a\na.py:1:lock-discipline:m\n",
    "numeric order": "# why: 1\np.py:181:lock-discipline:a\n# why: 2\np.py:1283:lock-discipline:b\n",
    "unknown checker": "# why: typo\npool.py:181:lock-dicipline:write of guarded attribute\n",
    "baseline entry": "# why: silence\nx.txt:5:baseline:stale suppression (x)\n",
}
BAD_MOD = """
    import threading
    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0  # guarded-by: _lock
        def bad(self):
            self.n = 5
"""


@pytest.mark.parametrize("case", sorted(BASELINES))
def test_baseline_hygiene_is_the_references(tmp_path, case):
    mod = _write(tmp_path, "mod.py", BAD_MOD)
    base = _write(tmp_path, "baseline.txt", BASELINES[case])
    port = run_check(str(tmp_path), checkers=["lock-discipline"], files=[mod],
                     baseline_path=base)
    ref = ref_core.run_check(str(tmp_path), checkers=["lock-discipline"], files=[mod],
                             baseline_path=base)
    assert port == ref
    (entries, problems), (ref_entries, ref_problems) = (load_baseline(base),
                                                        ref_core.load_baseline(base))
    assert entries == ref_entries
    assert [f.to_dict() for f in problems] == [f.to_dict() for f in ref_problems]
    if case == "justified":
        assert port["verdict"] == "clean" and port["counts"]["suppressed"] == 1


# -- inline torch fixtures ---------------------------------------------------


def test_a_forward_that_calls_item_fires_exactly_forward_purity(tmp_path):
    path = _write(tmp_path, "net.py", """
        import torch
        from torch import nn

        def scale_of(x):
            return x.abs().mean().item()

        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 4)

            def forward(self, x):
                return self.fc(x) * scale_of(x)

        def host_report(net, x):
            return net(x).cpu().numpy().tolist()
    """)
    rep = run_check(str(tmp_path), files=[path], baseline_path=str(tmp_path / "none"))
    assert [f["checker"] for f in rep["findings"]] == ["forward-purity"]
    (f,) = rep["findings"]
    assert f["line"] == 6 and ".item() host sync" in f["message"]
    assert "'scale_of'" in f["message"]


@pytest.mark.parametrize("call,label", [
    ("torch.cuda.synchronize()", ".synchronize() host sync"),
    ("x.cpu()", ".cpu() host copy"),
    ("x.tolist()", ".tolist() host copy"),
    ("print(x)", "print()"),
    ("time.perf_counter()", "time.perf_counter()"),
    ("np.random.rand()", "np.random.rand()"),
])
def test_each_banned_call_in_an_autograd_backward_fires(tmp_path, call, label):
    path = _write(tmp_path, "fn.py", f"""
        import time
        import numpy as np
        import torch

        class Sign(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return torch.where(x >= 0, 1.0, -1.0)

            @staticmethod
            def backward(ctx, x):
                {call}
                return x
    """)
    (f,) = check_forward_purity(str(tmp_path), [path])
    assert f.line == 13 and f.message.startswith(label)


def test_a_compare_copy_with_a_key_dropped_fires_exactly_verdict_coherence(tmp_path):
    src = open(os.path.join(REPO, "bdbnn_tpu_torch", "obs", "compare.py")).read()
    row = '    ("serve_p99_ms", "lower", "rel"),\n'
    assert src.count(row) == 1
    path = _write(tmp_path, "compare.py", src.replace(row, ""))
    rep = run_check(str(tmp_path), files=[path], baseline_path=str(tmp_path / "none"))
    assert [f["checker"] for f in rep["findings"]] == ["verdict-coherence"]
    assert "produces 'serve_p99_ms' but METRIC_SPECS never judges it" in (
        rep["findings"][0]["message"])


# -- the self-run gate -------------------------------------------------------


def test_the_port_is_clean_with_a_justified_live_baseline():
    rep = run_check(REPO)
    assert rep["verdict"] == "clean", "\n".join(f["record"] for f in rep["findings"])
    assert rep["checkers"] == list(CHECKER_IDS)
    assert rep["files_scanned"] == len(PORT_FILES) > 60
    entries, problems = load_baseline(os.path.join(REPO, BASELINE_PATH))
    assert problems == [] and entries and all(e["justified"] for e in entries)
    assert rep["counts"]["suppressed"] == len(entries)
    assert rep == run_check(REPO)
    assert json.loads(json.dumps(rep), parse_constant=pytest.fail) == rep
    assert "CLEAN" in render_report(rep)


def test_the_checkers_traverse_the_port():
    """Vacuity floors: the forward roots, the compare flattener and the
    event registry are all found."""
    _f, roots, reachable = analyze_forward_purity(REPO, PORT_FILES)
    assert {"forward", "backward", "_forward"} <= roots
    assert {"binary_conv2d", "binary_conv2d_dgrad", "binary_conv2d_wgrad",
            "weight_binarize", "kurtosis_grouped", "popcount_binary_conv",
            "packed_dense_weight"} <= reachable
    _f, found = scan_events(REPO, PORT_FILES)
    assert {"search", "trial", "analysis", "perf", "fleet", "run_start"} <= found
    import ast

    from bdbnn_tpu_torch.analysis.verdictcheck import SPECS_NAME, _module_literal, _produced_keys

    tree = ast.parse(open(os.path.join(REPO, "bdbnn_tpu_torch/obs/compare.py")).read())
    specs = _module_literal(tree, SPECS_NAME)
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    serve, fields = _produced_keys(fns["_serve_metrics"], tree)
    perf, _ = _produced_keys(fns["_perf_metrics"], tree)
    assert len(specs) >= 30 and len(serve) >= 15 and len(perf) >= 3
    assert {"p99_ms", "throughput_rps", "shed_rate"} <= fields


def _check(*args, root=REPO):
    return subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", "check", *args],
                          cwd=root, capture_output=True, text=True, timeout=120)


def test_cli_check_exits_0_on_the_tree_and_3_on_a_seeded_bad_copy(tmp_path):
    r = _check("--json")
    assert r.returncode == 0, r.stdout[-3000:]
    assert json.loads(r.stdout)["verdict"] == "clean"
    # a copy of the package with an unguarded write of a guarded attribute
    # and an unregistered event kind
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(REPO, "bdbnn_tpu_torch"), root / "bdbnn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.cu", "*.cuh"))
    batching = root / "bdbnn_tpu_torch" / "serve" / "batching.py"
    batching.write_text(batching.read_text() + textwrap.dedent("""

        def _racy(batcher):
            batcher.shed += 1
            batcher.events.emit("rogue_kind")
    """))
    run_dir = tmp_path / "run"
    r = _check("--root", str(root), "--events-into", str(run_dir))
    assert r.returncode == 3, r.stdout[-3000:]
    assert "lock-discipline:read-modify-write of guarded attribute batcher.shed" in r.stdout
    assert "event-schema:emit('rogue_kind')" in r.stdout
    (ev,) = [json.loads(line) for line in open(run_dir / "events.jsonl")]
    assert ev["kind"] == "analysis" and ev["verdict"] == "findings" and ev["findings"] == 2
    # a stale entry in a baseline is a finding too
    base = tmp_path / "baseline.txt"
    base.write_text("# why: nothing\nbdbnn_tpu_torch/x.py:1:lock-discipline:gone\n")
    r = _check("--checker", "lock-discipline", "--baseline", str(base))
    assert r.returncode == 3 and "stale suppression" in r.stdout


# -- the repair --------------------------------------------------------------


def test_the_runner_factorys_forward_count_is_checked_and_counts(tmp_path):
    """The factory's forward counter was a closure list annotated
    ``guarded-by`` outside any class, which binds to nothing; it is now
    ``_ForwardCount.n`` under ``_lock``: the checker sees a write off the
    lock, and the count adds up."""
    from bdbnn_tpu_torch.serve import pool

    src = open(os.path.join(REPO, "bdbnn_tpu_torch/serve/pool.py")).read()
    assert "guarded-by: fw_lock" not in src
    path = _write(tmp_path, "pool_copy.py", src + textwrap.dedent("""

        def _reset(fw):
            fw.n = 0
    """))
    got = [f.message for f in check_lock_discipline(str(tmp_path), [path])
           if "fw.n" in f.message or "binds to nothing" in f.message]
    assert got == ["write of guarded attribute fw.n outside 'with fw._lock'"]
    fw = pool._ForwardCount()
    for n in (3, 4):
        fw.add(n)
    assert fw.value() == 7
