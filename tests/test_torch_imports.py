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
