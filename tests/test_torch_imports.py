"""The port stands alone: no module of ``bdbnn_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``flax`` or anything of
``bdbnn_tpu`` (an AST scan of every import statement, top level or
nested), every module imports with those packages absent, and a spawned
image-folder decode worker imports none of them (nor torch)."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "bdbnn_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "bdbnn_tpu_torch")):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return out


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_flax_or_reference_import(path):
    bad = [(root, line) for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_every_port_module_imports_without_jax():
    """Import each module in a fresh interpreter where importing jax,
    flax or bdbnn_tpu fails."""
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_training_slice_modules_are_scanned():
    """The scans above cover the training slice's modules and kernels,
    the teacher–student slice's (KD losses, teacher loading, the
    bottleneck teacher), the run dir's (checkpoints, resilience,
    logging, meters, manifest, events, step-phase timing) and data
    parallelism's (``parallel``)."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("train/loop.py", "train/step.py", "train/optim.py", "train/state.py",
                "train/config.py", "train/ede.py", "losses/kurtosis.py", "losses/kd.py",
                "obs/probes.py", "nn/kernels/kurtosis.py", "nn/kernels/binary_conv.py",
                "data/pipeline.py", "cli.py", "models/torch_import.py", "models/resnet.py",
                "models/registry.py", "utils/__init__.py", "utils/checkpoint.py",
                "utils/logging_utils.py", "utils/meters.py", "train/resilience.py",
                "obs/manifest.py", "obs/events.py", "obs/timing.py", "serve/export.py",
                "data/pipeline.py", "data/datasets.py", "parallel/__init__.py",
                "parallel/mesh.py"):
        assert os.path.join("bdbnn_tpu_torch", mod) in rel
    for src in ("binary_conv_dgrad.cu", "binary_conv_wgrad.cu", "kurtosis.cu"):
        assert os.path.isfile(os.path.join(REPO, "bdbnn_tpu_torch", "csrc", src))


def test_serving_stack_modules_are_scanned():
    """The scans above cover the serve-bench slice's modules: the
    micro-batcher, the replica pool, the load generator and its config,
    the request tracer, and the engine and mesh they extend."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("serve/batching.py", "serve/pool.py", "serve/loadgen.py", "serve/config.py",
                "serve/engine.py", "serve/__init__.py", "obs/rtrace.py", "parallel/mesh.py"):
        assert os.path.join("bdbnn_tpu_torch", mod) in rel


def test_http_slice_modules_are_scanned():
    """The scans above cover the serve-http slice's modules: the front
    end, admission control, the artifact registry, the capacity plane and
    the detector discipline it builds on."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("serve/http.py", "serve/admission.py", "serve/registry.py", "obs/capacity.py",
                "obs/health.py", "serve/loadgen.py", "serve/config.py", "cli.py"):
        assert os.path.join("bdbnn_tpu_torch", mod) in rel


def test_health_slice_modules_are_scanned():
    """The scans above cover the health slice's modules: the training
    monitor, the memory watermarks, the profiler windows, the canary
    monitor and the pool's rollouts."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("obs/health.py", "obs/memory.py", "obs/trace.py", "serve/canary.py",
                "serve/pool.py", "train/loop.py", "train/config.py"):
        assert os.path.join("bdbnn_tpu_torch", mod) in rel


def test_fleet_slice_modules_are_scanned():
    """The scans above cover the fleet slice's modules: the router, the
    fleet tracer and stats windows, the fleet capacity merge, the
    ``fleet`` event kind and ``ServeFleetConfig``."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("serve/fleet.py", "obs/rtrace.py", "obs/capacity.py", "obs/events.py",
                "serve/config.py", "serve/__init__.py", "cli.py"):
        assert os.path.join("bdbnn_tpu_torch", mod) in rel


def test_the_fleet_router_loads_no_jax_no_reference_and_no_torch():
    """Importing ``bdbnn_tpu_torch.serve.fleet`` and the CLI in a fresh
    interpreter loads no module of jax, flax or the JAX package, nor
    torch or numpy: the router is a byte proxy that holds no device (and
    so starts in a fraction of a second), and ``serve-fleet --help``
    works."""
    code = (
        "import sys\n"
        "import bdbnn_tpu_torch.serve.fleet as f\n"
        "from bdbnn_tpu_torch.cli import COMMANDS\n"
        "assert COMMANDS['serve-fleet'].__name__ == 'serve_fleet_main'\n"
        "from bdbnn_tpu_torch.serve.config import ServeFleetConfig\n"
        "from bdbnn_tpu_torch.obs.manifest import RunManifest\n"
        "assert RunManifest.capture({}, 'cpu').backend == 'cpu'\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('torch', 'numpy')!r})\n"
        "print(bad, f.FleetRouter.__module__)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "[] bdbnn_tpu_torch.serve.fleet"
    r = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", "serve-fleet", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "--hosts" in r.stdout and "--swap-at" in r.stdout


@pytest.mark.parametrize("package", ["bdbnn_tpu_torch.obs", "bdbnn_tpu_torch.serve"])
def test_package_names_resolve_on_first_use(package):
    """``obs`` and ``serve`` import their public names on first use: each
    name of ``__all__`` resolves to the object its module defines, and an
    unknown name raises ``AttributeError``."""
    import importlib

    pkg = importlib.import_module(package)
    for name in pkg.__all__:
        obj = getattr(pkg, name)
        assert getattr(importlib.import_module(pkg._EXPORTS[name]), name) is obj
    with pytest.raises(AttributeError, match="no attribute"):
        getattr(pkg, "not_a_name")


def test_a_spawned_decode_worker_imports_no_jax_and_no_torch(tmp_path):
    """A worker of ``MPImageFolderPipeline`` after it built a batch: the
    modules it holds include the port's pipeline and PIL, and nothing of
    JAX, the JAX package or torch."""
    import numpy as np
    from PIL import Image

    from bdbnn_tpu_torch.data import ImageFolder, MPImageFolderPipeline

    os.makedirs(tmp_path / "c0")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "c0" / "a.png")
    pipe = MPImageFolderPipeline(ImageFolder(str(tmp_path)), 1, train=False, image_size=4,
                                 num_workers=1)
    try:
        (x, _), = list(pipe.epoch(0))
        assert x.shape == (1, 4, 4, 3)
        mods = pipe._get_pool().apply(eval, ("sorted(__import__('sys').modules)",))
    finally:
        pipe.close()
    assert "bdbnn_tpu_torch.data.pipeline" in mods and "PIL.Image" in mods
    roots = {m.split(".")[0] for m in mods}
    assert not roots & set(FORBIDDEN + ("torch",)), sorted(roots & set(FORBIDDEN + ("torch",)))


def test_observatory_modules_are_scanned():
    """The scans above cover the observatory slice's modules: the trace
    parser and spans, the roofline, the three run-dir readers and the
    ``perf`` config."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("obs/trace.py", "obs/roofline.py", "obs/summarize.py", "obs/watch.py",
                "obs/compare.py", "obs/events.py", "serve/config.py", "cli.py"):
        assert os.path.join("bdbnn_tpu_torch", mod) in rel


def test_the_readers_load_no_torch_and_no_numpy():
    """``summarize``, ``watch`` and ``compare`` (and the trace parser and the
    roofline module they read through) load no module of torch or numpy,
    nor of jax, flax or the JAX package: reading a run never initialises
    CUDA. Their CLI commands run in such a process too."""
    code = (
        "import sys\n"
        "import bdbnn_tpu_torch.obs.summarize, bdbnn_tpu_torch.obs.watch\n"
        "import bdbnn_tpu_torch.obs.compare, bdbnn_tpu_torch.obs.trace\n"
        "import bdbnn_tpu_torch.obs.roofline\n"
        "from bdbnn_tpu_torch.cli import main\n"
        "for cmd in ('summarize', 'watch', 'compare', 'perf'):\n"
        "    try:\n"
        "        main([cmd, '--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, cmd\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('torch', 'numpy')!r})\n"
        "print(bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_search_and_analysis_modules_are_scanned():
    """The scans above cover the recipe-search and static-analysis
    slice's modules: the harness, its config, the analyzer and its four
    checkers, and the torch-free family table."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("search/__init__.py", "search/harness.py", "search/config.py",
                "analysis/__init__.py", "analysis/core.py", "analysis/lockcheck.py",
                "analysis/forwardpure.py", "analysis/eventschema.py",
                "analysis/verdictcheck.py", "nn/families.py", "nn/__init__.py", "cli.py"):
        assert os.path.join("bdbnn_tpu_torch", mod) in rel


def test_search_and_check_load_no_torch_and_no_numpy():
    """``search --help``, the harness and ``check`` run in a process that
    loads no module of torch or numpy, nor of jax, flax or the JAX
    package: the harness owns no device (its trials do) and the analyzer
    reads files only."""
    code = (
        "import sys\n"
        "from bdbnn_tpu_torch.cli import COMMANDS, main\n"
        "import bdbnn_tpu_torch.search.harness\n"
        "try:\n"
        "    main(['search', '--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "assert main(['check']) == 0\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('torch', 'numpy')!r})\n"
        "print(bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_nn_names_resolve_on_first_use():
    """``nn`` imports its names on first use: each name of ``__all__``
    resolves to the object its module defines (a submodule's own name to
    the submodule), the family table without torch, and an unknown name
    raises ``AttributeError``."""
    import importlib

    code = ("import sys\n"
            "from bdbnn_tpu_torch.nn import FAMILY_NAMES, parse_binarizer\n"
            "assert parse_binarizer('proximal:delta1=0.25')[1]['delta1'] == 0.25\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stderr[-3000:]
    pkg = importlib.import_module("bdbnn_tpu_torch.nn")
    for name in pkg.__all__:
        obj = getattr(pkg, name)
        mod = importlib.import_module(pkg._EXPORTS[name])
        assert obj is (mod if pkg._EXPORTS[name] == f"bdbnn_tpu_torch.nn.{name}"
                       else getattr(mod, name))
    from bdbnn_tpu_torch.nn import binarize

    assert binarize.parse_binarizer is pkg.parse_binarizer
    with pytest.raises(AttributeError, match="no attribute"):
        getattr(pkg, "not_a_name")


def test_bench_scripts_and_entry_are_scanned():
    """The scans above cover the bench scripts' slice: ``entry()``, the
    four scripts, the launch counters and the timers they share with
    ``chip_smoke.py``, and the trace helpers they read."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in ("entry.py", "scripts/__init__.py", "scripts/bench.py", "scripts/profile_step.py",
                "scripts/bench_kernels.py", "scripts/bench_pipeline.py", "obs/launches.py",
                "obs/timing.py", "obs/trace.py"):
        assert os.path.join("bdbnn_tpu_torch", mod) in rel


def test_bench_help_loads_no_jax_no_reference_and_no_torch():
    """``python -m bdbnn_tpu_torch.scripts.bench --help`` exits 0 with the
    reference's flags, in a process that loads nothing of jax, flax or
    the JAX package, nor torch: the parent probes and relays, and only
    its worker subprocess holds the card."""
    code = (
        "import sys, runpy\n"
        "sys.argv = ['bench', '--help']\n"
        "try:\n"
        "    runpy.run_module('bdbnn_tpu_torch.scripts.bench', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('torch',)!r})\n"
        "print(bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.strip().splitlines()
    assert out[-1] == "[]"
    for flag in ("--worker", "--batch", "--iters", "--attempts", "--timeout", "--probe-timeout",
                 "--profile-dir", "--no-compare"):
        assert flag in r.stdout, flag


def test_importing_chip_smoke_loads_no_torch_and_no_numpy():
    """``import chip_smoke`` loads nothing of torch or numpy (nor jax, flax
    or the JAX package): the processes the script spawns re-import it (a
    decode worker of ``MPImageFolderPipeline`` re-imports the main module;
    the search harness runs as ``import chip_smoke; counted_search()``), and
    a torch import in each of them costs seconds of the host's cores and
    breaks the harness's no-torch gate."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "assert callable(chip_smoke.cuda_ms) and callable(chip_smoke.reset_counts)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('torch', 'numpy')!r})\n"
        "print(bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
