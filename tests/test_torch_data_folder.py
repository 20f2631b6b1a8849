"""ImageNet from an image folder in the port, held to the JAX package on
the CPU, on one seeded JPEG tree (``chip_smoke.write_image_folder`` at a
small scale: three classes, extreme aspects, one truncated train file;
the val split gains a nested dir, mixed-case extensions and non-image
files). Bitwise unless a test says otherwise:

- ``ImageFolder``'s ``samples`` and ``class_to_idx``;
- ``random_resized_crop`` (the fallback branch included, and the rng left
  in the same state), ``resize_short`` and ``center_crop`` over a grid of
  sizes;
- ``ImageFolderPipeline`` and ``MPImageFolderPipeline``, train and eval,
  with and without ``device_normalize``, epochs 0 and 1 and a mid-epoch
  ``start_step``, each against its own JAX twin (the two backends key
  their draws differently, in both packages), and the worker pipeline at
  ``-j 1`` against ``-j 2``; eval batches equal across backends;
- the truncated file: the same ``data_error`` dicts as the reference's,
  for both backends;
- the backend choice against the reference's ``build_datasets``
  (``tfdata`` raises ``RuntimeError``; ``-j 0`` gives threads);
- ``prep_images`` on uint8 against numpy ``normalize``;
- the CLI trains the flagship ``resnet18`` on a tiny folder on the CPU
  (``--device-normalize``, worker processes), records one ``data_error``
  event, and ``cli predict`` over its export matches its eval top-1;
- the health monitor's warning (ROADMAP C1), and the reference's
  ``predict`` feeding raw uint8 to its engine under ``--device-normalize``
  (ROADMAP C, not a port fault), which the port's ``predict`` does not.
"""

import json
import multiprocessing
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from bdbnn_tpu.configs.config import RunConfig as JRunConfig
from bdbnn_tpu.data import datasets as jds
from bdbnn_tpu.data import pipeline as jp
from bdbnn_tpu.serve import engine as jengine
from bdbnn_tpu.train import loop as jloop
from bdbnn_tpu_torch import cli
from bdbnn_tpu_torch.data import datasets as tds
from bdbnn_tpu_torch.data import pipeline as tp
from bdbnn_tpu_torch.models import registry as treg
from bdbnn_tpu_torch.obs.events import read_events
from bdbnn_tpu_torch.serve import export as texport
from bdbnn_tpu_torch.train import loop as tloop
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.step import prep_images

SIZE, BATCH = 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_tree(root, train, val):
    """The seeded tree, with the val split's extra layout cases: a nested
    dir, ``.JPG`` and ``.Jpeg``, and files that are not images."""
    info = chip_smoke.write_image_folder(str(root), classes=3, train=train, val=val, scale=0.16,
                                         extreme_every=8, threads=2)
    v = os.path.join(str(root), "val")
    os.makedirs(os.path.join(v, "c01", "nested"))
    os.rename(os.path.join(v, "c01", "00004.jpg"), os.path.join(v, "c01", "nested", "00004.JPG"))
    os.rename(os.path.join(v, "c02", "00005.jpg"), os.path.join(v, "c02", "00005.Jpeg"))
    for name in ("c00/notes.txt", "c00/README", "LICENSE"):
        with open(os.path.join(v, name), "w") as f:
            f.write("not an image\n")
    return info


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    return {"root": str(root), **_write_tree(root, train=25, val=6)}


def _folders(tree, split):
    path = os.path.join(tree["root"], split)
    return tds.ImageFolder(path), jds.ImageFolder(path)


@pytest.mark.parametrize("split", ["train", "val"])
def test_image_folder_matches_the_reference(tree, split):
    port, ref = _folders(tree, split)
    assert port.samples == ref.samples and port.class_to_idx == ref.class_to_idx
    assert port.class_to_idx == {"c00": 0, "c01": 1, "c02": 2}
    names = [os.path.relpath(p, tree["root"]) for p, _ in port.samples]
    if split == "val":
        assert names == ["val/c00/00000.jpg", "val/c00/00003.jpg", "val/c01/00001.jpg",
                         "val/c01/nested/00004.JPG", "val/c02/00002.jpg", "val/c02/00005.Jpeg"]
    else:
        assert len(names) == 25 and tree["truncated"] == port.samples[tree["index"]][0]
    x, label = port.load(0)
    assert x.mode == "RGB" and label == 0


GRID = [(80, 60), (60, 80), (500, 375), (375, 500), (224, 224), (1200, 80), (80, 1200),
        (31, 17), (7, 300)]


@pytest.mark.parametrize("wh", GRID, ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_transforms_match_the_reference(wh):
    w, h = wh
    field = np.random.default_rng(w * 7 + h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    im = Image.fromarray(field)
    for size in (32, 224):
        for seed in range(4):
            rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
            got = np.asarray(tp.random_resized_crop(im, rp, size))
            want = np.asarray(jp.random_resized_crop(im, rj, size))
            assert got.shape == (size, size, 3) and np.array_equal(got, want)
            assert rp.bit_generator.state == rj.bit_generator.state
        got = np.asarray(tp.center_crop(tp.resize_short(im, 256), size))
        want = np.asarray(jp.center_crop(jp.resize_short(im, 256), size))
        assert np.array_equal(got, want)
    if max(w, h) / min(w, h) >= 15:
        # every try misses: the fallback, a center crop of the short side
        got = np.asarray(tp.random_resized_crop(im, np.random.default_rng(0), 32))
        assert np.array_equal(got, np.asarray(tp.center_crop(tp.resize_short(im, 32), 32)))


def _pipe(pkg, cls, folder, train, **kw):
    return getattr(pkg, cls)(folder, BATCH, train=train, image_size=SIZE, seed=0, **kw)


@pytest.fixture(scope="module")
def pipes(tree):
    """Each (backend, split) pipeline of both packages, the worker pools
    made once and closed at the end; ``device_normalize`` is toggled per
    test."""
    out = {}
    for split, train in (("train", True), ("val", False)):
        port_folder, ref_folder = _folders(tree, split)
        out["threads", split] = (
            _pipe(tp, "ImageFolderPipeline", port_folder, train, num_threads=2),
            _pipe(jp, "ImageFolderPipeline", ref_folder, train, num_threads=2))
        out["mp", split] = (_pipe(tp, "MPImageFolderPipeline", port_folder, train, num_workers=1),
                            _pipe(jp, "MPImageFolderPipeline", ref_folder, train, num_workers=1))
    out["mp2", "train"] = (_pipe(tp, "MPImageFolderPipeline", _folders(tree, "train")[0], True,
                                 num_workers=2), None)
    yield out
    for pair in out.values():
        for p in pair:
            if hasattr(p, "close"):
                p.close()


def _batches(pipe, epoch, start_step=0, device_normalize=False):
    pipe.device_normalize = device_normalize
    return list(pipe.epoch(epoch, start_step))


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and np.array_equal(gx, wx) and np.array_equal(gy, wy)


@pytest.mark.parametrize("device_normalize", [False, True], ids=["host_norm", "uint8"])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("backend", ["threads", "mp"])
def test_pipeline_matches_its_reference_twin(pipes, backend, split, device_normalize):
    port, ref = pipes[backend, split]
    for epoch in (0, 1):
        got = _batches(port, epoch, device_normalize=device_normalize)
        _assert_same(got, _batches(ref, epoch, device_normalize=device_normalize))
        assert got[0][0].dtype == (np.uint8 if device_normalize else np.float32)
        assert [len(y) for _, y in got] == ([BATCH] * 6 if split == "train" else [4, 2])
        # the resume cursor: batches k... of the uninterrupted epoch
        tail = _batches(port, epoch, start_step=1, device_normalize=device_normalize)
        _assert_same(tail, got[1:])
        _assert_same(tail, _batches(ref, epoch, start_step=1, device_normalize=device_normalize))


def test_worker_count_and_backend_invariants(pipes):
    """The worker pipeline's batches do not depend on ``-j``; eval batches
    (no draws) are equal across backends; train batches differ across
    backends, in both packages (their draws are keyed differently)."""
    for epoch in (0, 1):
        _assert_same(_batches(pipes["mp2", "train"][0], epoch),
                     _batches(pipes["mp", "train"][0], epoch))
    _assert_same(_batches(pipes["threads", "val"][0], 0), _batches(pipes["mp", "val"][0], 0))
    for i in (0, 1):
        a = _batches(pipes["threads", "train"][i], 0, device_normalize=True)
        b = _batches(pipes["mp", "train"][i], 0, device_normalize=True)
        assert all(np.array_equal(ya, yb) for (_, ya), (_, yb) in zip(a, b))
        assert not np.array_equal(a[0][0], b[0][0])


@pytest.mark.parametrize("backend", ["threads", "mp"])
def test_truncated_file_costs_one_data_error_like_the_reference(pipes, tree, backend):
    port, ref = pipes[backend, "train"]
    got, want = [], []
    port.on_data_error, ref.on_data_error = got.append, want.append
    try:
        _batches(port, 0)
        _batches(ref, 0)
    finally:
        port.on_data_error = ref.on_data_error = None
    assert got == want and len(got) == 1
    (err,) = got
    n = len(port.folder)
    assert (err["index"], err["substitute"], err["path"]) == \
        (tree["index"], (tree["index"] + 1) % n, tree["truncated"])
    assert err["error"].startswith("OSError: ")


def test_a_folder_where_nothing_decodes_raises(tmp_path):
    os.makedirs(tmp_path / "c0")
    for i in range(2):
        (tmp_path / "c0" / f"{i}.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    pipe = tp.ImageFolderPipeline(tds.ImageFolder(str(tmp_path)), 2, train=False, image_size=8)
    with pytest.raises(OSError):
        next(pipe.epoch(0))


CHOICES = [("auto", None, "MPImageFolderPipeline", 4), ("auto", 0, "ImageFolderPipeline", None),
           ("mp", 0, "ImageFolderPipeline", None), ("mp", 2, "MPImageFolderPipeline", 2),
           ("threads", 3, "ImageFolderPipeline", None), ("auto", -1, "ImageFolderPipeline", None)]


@pytest.fixture
def reference_without_tensorflow(monkeypatch):
    """The reference's backend choice where TensorFlow does not import
    (the GPU machine; the port never uses TensorFlow)."""
    monkeypatch.setattr(jloop, "tfdata_available", lambda: False)


@pytest.mark.parametrize("backend,workers,cls,num_workers", CHOICES)
@pytest.mark.usefixtures("reference_without_tensorflow")
def test_backend_choice_matches_the_reference(tree, backend, workers, cls, num_workers):
    kw = dict(data=tree["root"], dataset="imagenet", batch_size=BATCH, seed=0,
              input_backend=backend, workers=workers)
    _, port, size = tloop.build_datasets(RunConfig(**kw).validate(), val_only=True)
    _, ref, _ = jloop.build_datasets(JRunConfig(**kw), val_only=True)
    assert size == 224 and type(port).__name__ == type(ref).__name__ == cls
    assert getattr(port, "num_workers", None) == getattr(ref, "num_workers", None) == num_workers
    assert port.batch_size == BATCH and not port.train and port.folder.samples == ref.folder.samples
    train, val, _ = tloop.build_datasets(RunConfig(**kw))
    assert train.train and len(train.folder) == 25 and len(val.folder) == 6


@pytest.mark.usefixtures("reference_without_tensorflow")
def test_backend_refusals(tree, tmp_path):
    kw = dict(data=tree["root"], dataset="imagenet")
    for cfg in (RunConfig(**kw, input_backend="tfdata"),
                RunConfig(dataset="cifar10", synthetic=True, input_backend="tfdata")):
        with pytest.raises(RuntimeError, match="TensorFlow"):
            cfg.validate()
    with pytest.raises(RuntimeError, match="TensorFlow"):
        tloop.build_datasets(RunConfig(**kw, input_backend="tfdata"))
    with pytest.raises(RuntimeError, match="tensorflow"):
        jloop.build_datasets(JRunConfig(**kw, input_backend="tfdata"))
    with pytest.raises(ValueError, match="input_backend"):
        RunConfig(**kw, input_backend="grain").validate()
    missing = dict(dataset="imagenet", data=str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="imagenet data not found under .*--synthetic"):
        tloop.build_datasets(RunConfig(**missing))
    with pytest.raises(FileNotFoundError, match="imagenet data not found under .*--synthetic"):
        jloop.build_datasets(JRunConfig(**missing))
    with pytest.raises(ValueError, match="--device-normalize"):
        RunConfig(dataset="imagenet", synthetic=True, device_normalize=True).validate()


@pytest.mark.parametrize("consts", ["imagenet", "cifar"])
def test_prep_images_on_uint8_is_the_host_normalize(consts):
    mean, std = ((tds.IMAGENET_MEAN, tds.IMAGENET_STD) if consts == "imagenet"
                 else (tds.CIFAR_MEAN, tds.CIFAR_STD))
    x = np.random.default_rng(0).integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    x[0, 0, :, 0] = np.arange(16)
    x[0, 1:, 0, :] = 255
    got = prep_images(torch.from_numpy(x), (tuple(map(float, mean)), tuple(map(float, std))))
    want = tp.normalize(x, mean, std)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, jp.normalize(x, mean, std))


# -- the CLI on a folder ---------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The flagship trained by the CLI on a tiny folder (9 train files, one
    truncated: 2 steps at -b 4; 6 val files), ``--device-normalize``,
    worker processes (``-j 1``), on the CPU."""
    root = tmp_path_factory.mktemp("cli_tree")
    info = _write_tree(root, train=9, val=6)
    logs = tmp_path_factory.mktemp("cli_logs")
    before = multiprocessing.active_children()
    rc = cli.main([str(root), "--dataset", "imagenet", "-a", "resnet18", "-b", "4",
                   "--epochs", "1", "--device-normalize", "-j", "1", "--seed", "0",
                   "-p", "1", "--device", "cpu", "--log_path", str(logs)])
    (run_dir,) = {r for r, _, fs in os.walk(logs) for f in fs if f == "events.jsonl"}
    return {"rc": rc, "root": str(root), "run_dir": run_dir,
            "left": [c for c in multiprocessing.active_children() if c not in before], **info}


def _health_warnings(run_dir):
    with open(os.path.join(run_dir, "log.txt")) as f:
        return [line for line in f if "health monitor" in line]


def test_cli_trains_on_a_folder_with_one_data_error(cli_run):
    assert cli_run["rc"] == 0
    assert cli_run["left"] == []  # fit closed both worker pools
    (err,) = read_events(cli_run["run_dir"], "data_error")
    assert (err["epoch"], err["index"], err["path"]) == \
        (0, cli_run["index"], cli_run["truncated"])
    assert err["substitute"] == (cli_run["index"] + 1) % 9
    intervals = read_events(cli_run["run_dir"], "train_interval")
    assert [i["step"] for i in intervals] == [0, 1]
    assert all(np.isfinite(i["loss"]) for i in intervals)
    (ev,) = read_events(cli_run["run_dir"], "eval")
    assert ev["count"] == 6
    assert len(_health_warnings(cli_run["run_dir"])) == 1


def test_cli_predict_over_the_export_matches_the_eval(cli_run, tmp_path, capsys):
    art = str(tmp_path / "art")
    assert cli.main(["export", cli_run["run_dir"], "-o", art]) == 0
    capsys.readouterr()
    before = multiprocessing.active_children()
    assert cli.main(["predict", art, cli_run["root"], "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    (ev,) = read_events(cli_run["run_dir"], "eval")
    assert out["count"] == 6 and out["device"] == "cpu"
    assert round(out["top1"], 4) == ev["acc1"]
    assert [c for c in multiprocessing.active_children() if c not in before] == []


def test_health_warning_only_when_the_monitor_is_asked_for(tmp_path):
    """ROADMAP C1: the monitor is on by default and not ported; ``fit``
    says so once, and not under ``--no-health``."""
    kw = dict(dataset="cifar10", arch="resnet8_tiny", synthetic=True, batch_size=8, epochs=1,
              synthetic_train_size=8, synthetic_val_size=8, device="cpu")
    for health in (True, False):
        root = tmp_path / str(health)
        tloop.fit(RunConfig(**kw, health=health, log_path=str(root)))
        (run_dir,) = {r for r, _, fs in os.walk(root) for f in fs if f == "log.txt"}
        said = _health_warnings(run_dir)
        assert len(said) == (1 if health else 0)
        assert not health or ("WARNING" in said[0] and "Later' item 7" in said[0])


def test_reference_predict_feeds_raw_uint8_under_device_normalize(tree, tmp_path):
    """ROADMAP C, not a port fault: the reference's ``predict`` rebuilds the
    val split with the run's config, ``device_normalize`` included, so its
    pipeline yields uint8, and its engine casts that to float32 without
    normalizing it (``bdbnn_tpu/serve/engine.py:395``). The port's
    ``predict`` normalizes on the host."""
    kw = dict(data=tree["root"], dataset="imagenet", batch_size=BATCH, seed=0,
              input_backend="threads", device_normalize=True)
    _, ref_val, _ = jloop.build_datasets(JRunConfig(**kw), val_only=True)
    raw, _ = next(ref_val.epoch(0))
    assert raw.dtype == np.uint8
    art = str(tmp_path / "art")
    g = torch.Generator().manual_seed(0)
    texport.write_artifact(treg.create_model("resnet8_tiny", "cifar10", generator=g).to_flax(),
                           art, arch="resnet8_tiny", dataset="cifar10")
    engine = jengine.InferenceEngine(art, buckets=(BATCH,))
    small = raw[:, :32, :32]
    assert np.array_equal(engine.predict_logits(small),
                          engine.predict_logits(small.astype(np.float32)))
    port_art = {"dataset": "imagenet", "image_size": 224, "num_classes": 1000,
                "provenance": {"config": {**kw, "arch": "resnet18", "synthetic": False}}}
    x, _ = next(cli.build_val_pipeline(port_art, data="", synthetic=False).epoch(0))
    assert x.dtype == np.float32
    assert np.array_equal(x, tp.normalize(raw, tds.IMAGENET_MEAN, tds.IMAGENET_STD))


def test_write_image_folder_is_seeded(tree, tmp_path):
    again = _write_tree(tmp_path, train=25, val=6)
    assert again["index"] == tree["index"] and again["bytes"] == tree["bytes"]
    for split in ("train", "val"):
        a, b = (tds.ImageFolder(os.path.join(r, split)) for r in (tree["root"], str(tmp_path)))
        for (pa, la), (pb, lb) in zip(a.samples, b.samples):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert la == lb and fa.read() == fb.read()
