"""The port's data-parallel primitives (``bdbnn_tpu_torch/parallel``) and
per-rank input shards, on the CPU:

- the mesh record and ``topology`` carry the JAX package's keys, and a
  mesh of one issues no collective (``coordinate_flags`` and
  ``broadcast_host_int`` are the identity without a process group);
- two spawned ranks over gloo: ``coordinate_flags`` is the elementwise
  MAX, ``sum_host_values`` the SUM and ``broadcast_host_int`` rank 0's
  value on both ranks; the topology is ``{processes: 2, devices: 2,
  mesh: {data: 2, model: 1}}``;
- ``--distributed-init`` outside torchrun's environment, and a rank whose
  peer never joins, fail instead of training as one process;
  ``--model-parallel`` N in a world N does not divide raises the
  reference's ``ValueError``;
- per-rank shards: ``host_shard_indices`` bitwise the JAX package's for
  each (seed, epoch, host_id, num_hosts); the ranks' step-k batches
  together are step k's slice of the global permutation; the synthetic
  pipeline's per-batch transform generator is keyed by the rank
  ``(seed, epoch, host_id, 1, batch)``, bitwise the JAX pipeline's batches
  at host 1 of 2; both image-folder pipelines bitwise the JAX package's
  twins at host 1 of 2; ``eval_steps`` is the largest shard's count;
  ``build_datasets`` gives each rank ``batch_size // W`` rows and refuses
  a W that does not divide the batch;
- ``global_sums`` adds counts over the ranks and averages the loss means
  (the identity in one process).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from bdbnn_tpu.data import pipeline as jpipe
from bdbnn_tpu.data.datasets import ArrayDataset as JArrayDataset
from bdbnn_tpu.data.datasets import ImageFolder as JImageFolder
from bdbnn_tpu.parallel import make_mesh as jmake_mesh
from bdbnn_tpu.parallel import topology as jtopology
from bdbnn_tpu_torch.data import pipeline as tpipe
from bdbnn_tpu_torch.data.datasets import ArrayDataset, ImageFolder
from bdbnn_tpu_torch.parallel import (
    Mesh,
    broadcast_host_int,
    coordinate_flags,
    initialize_distributed,
    make_mesh,
    resharded,
    sum_host_values,
    topology,
)
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.loop import build_datasets, global_sums

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mesh_and_topology_keys_are_the_references():
    import jax

    for n in (1, 2, 8):
        ref = jtopology(jmake_mesh(jax.devices()[:n]))
        got = topology(Mesh(data=n))
        assert set(got) == set(ref) and got["mesh"] == ref["mesh"]
        assert got == {"processes": n, "devices": n, "mesh": {"data": n, "model": 1}}
        assert Mesh(data=n).shape == dict(jmake_mesh(jax.devices()[:n]).shape)


def test_a_mesh_of_one_issues_no_collective():
    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert mesh == Mesh() and not mesh.collective and mesh.primary
    flags = [15.0, 0.0, 1.0]
    np.testing.assert_array_equal(coordinate_flags(flags, mesh), flags)
    np.testing.assert_array_equal(sum_host_values(flags, mesh), flags)
    assert broadcast_host_int(1234567890123, mesh) == 1234567890123
    assert topology(mesh) == {"processes": 1, "devices": 1, "mesh": {"data": 1, "model": 1}}


def test_resharded_compares_as_the_reference():
    one, two = topology(Mesh()), topology(Mesh(data=2))
    assert resharded(two, one) is True and resharded(one, two) is True
    assert resharded(one, one) is False and resharded(None, one) is None
    # a writer that recorded no mesh (the port before the mesh key) is
    # compared on processes and devices alone
    assert resharded({"processes": 1, "devices": 1}, one) is False


def test_two_ranks_agree_on_flags_sums_and_rank_zeros_value():
    flags = [[0.0, 1.0, 3.0], [15.0, 0.0, 2.0]]
    sums = [{"loss": 2.0, "loss_ce": 1.5, "loss_sum": 8.0, "count": 4.0, "top1": 1.0,
             "grad_norm": 0.25},
            {"loss": 4.0, "loss_ce": 2.5, "loss_sum": 16.0, "count": 4.0, "top1": 3.0,
             "grad_norm": 0.25}]
    res = chip_smoke.spawn_ranks("primitives", 2, "cpu", "gloo",
                                 dict(flags=flags, values=[111, 222], sums=sums), timeout_s=120)
    for r, got in enumerate(res):
        assert got["rank"] == r
        assert got["shape"] == {"data": 2, "model": 1}
        assert got["topology"] == {"processes": 2, "devices": 2, "mesh": {"data": 2, "model": 1}}
        assert got["max"] == [15.0, 1.0, 3.0]
        assert got["sum"] == [15.0, 1.0, 5.0]
        assert got["broadcast"] == 111
        # drained metric sums: counts add up, the loss means average, the
        # replicated grad norm stays
        assert got["global_sums"] == {"loss": 3.0, "loss_ce": 2.0, "loss_sum": 24.0,
                                      "count": 8.0, "top1": 4.0, "grad_norm": 0.25}


def test_model_parallel_names_its_roadmap_item():
    """Tensor parallelism is ported (ROADMAP A item 1, Later 9, done): a
    config asks for it freely, and a world the ``model`` axis does not
    divide raises the reference's ``ValueError`` — one process without a
    group is a world of 1."""
    assert RunConfig(model_parallel=2).validate().model_parallel == 2
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        make_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="must be >= 1"):
        RunConfig(model_parallel=0).validate()
    assert make_mesh(model_parallel=1) == Mesh()


def test_distributed_init_never_falls_back_to_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    # rank 0 of 2 whose peer never joins: the rendezvous times out and the
    # process fails (in a subprocess: a failed group leaves no state here)
    code = (
        "import os, sys\n"
        "os.environ.update(RANK='0', WORLD_SIZE='2', MASTER_ADDR='127.0.0.1', "
        f"MASTER_PORT='{chip_smoke.free_port()}')\n"
        "from bdbnn_tpu_torch.parallel import initialize_distributed\n"
        "try:\n"
        "    initialize_distributed(device='cpu', timeout_s=2)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__)\n"
        "    sys.exit(3)\n"
        "print('joined')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=90)
    assert r.returncode == 3 and "raised" in r.stdout, (r.stdout, r.stderr[-2000:])


@pytest.mark.parametrize("n,epoch,seed,num_hosts", [(37, 0, 0, 2), (64, 3, 5, 2), (50, 1, 2, 4)])
def test_host_shard_indices_match_the_reference(n, epoch, seed, num_hosts):
    shards = []
    for host in range(num_hosts):
        for drop in (None, 4):
            got = tpipe.host_shard_indices(n, epoch, seed=seed, host_id=host, num_hosts=num_hosts,
                                           drop_remainder_to=drop)
            ref = jpipe.host_shard_indices(n, epoch, seed=seed, host_id=host, num_hosts=num_hosts,
                                           drop_remainder_to=drop)
            np.testing.assert_array_equal(got, ref)
        shards.append(tpipe.host_shard_indices(n, epoch, seed=seed, host_id=host,
                                               num_hosts=num_hosts, drop_remainder_to=4))
    # step k of every rank together is step k's slice of the permutation
    order = np.random.default_rng((seed, epoch)).permutation(n)
    b = 4
    for k in range(min(len(s) for s in shards) // b):
        together = np.sort(np.concatenate([s[k * b:(k + 1) * b] for s in shards]))
        np.testing.assert_array_equal(together, np.sort(order[k * b * num_hosts:(k + 1) * b * num_hosts]))


def _dataset(n=22, hw=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, hw, hw, 3)).astype(np.uint8),
            rng.integers(0, 10, size=(n,)).astype(np.int64))


@pytest.mark.parametrize("train", [True, False])
def test_rank_pipelines_match_the_reference_at_host_one_of_two(train):
    images, labels = _dataset()

    def tf(im, rng):  # a custom transform: the per-batch generator's draws
        return im.astype(np.float32) + rng.normal(size=im.shape).astype(np.float32)

    for kw in (dict(transform=tf), dict()):
        for host in (0, 1):
            ours = tpipe.Pipeline(ArrayDataset(images, labels), 4, train=train, seed=3,
                                  host_id=host, num_hosts=2, **kw)
            ref = jpipe.Pipeline(JArrayDataset(images, labels), 4, train=train, seed=3,
                                 host_id=host, num_hosts=2, **kw)
            assert ours.steps_per_epoch() == ref.steps_per_epoch()
            assert ours.eval_steps() == ref.eval_steps() == 3
            assert ours.image_shape == ref.image_shape
            for epoch in (0, 1):
                got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
                assert len(got) == len(want) > 0
                for (x, y), (rx, ry) in zip(got, want):
                    np.testing.assert_array_equal(x, rx)
                    np.testing.assert_array_equal(y, ry)
    # the per-batch generator is keyed by the rank: host 1's first batch
    # is not host 0's draws on other rows
    a = tpipe.Pipeline(ArrayDataset(images, labels), 4, train=train, transform=tf, seed=3,
                       host_id=1, num_hosts=2)
    keyed = np.random.default_rng((3, 0, 1, 1, 0))
    x, _ = next(iter(a.epoch(0)))
    idx = tpipe.host_shard_indices(len(images), 0, seed=3, shuffle=train, host_id=1, num_hosts=2,
                                   drop_remainder_to=4 if train else None)[:4]
    np.testing.assert_array_equal(x, tf(images[idx], keyed))


def test_folder_pipelines_match_the_reference_at_host_one_of_two(tmp_path):
    chip_smoke.write_image_folder(str(tmp_path), classes=2, train=10, val=5, scale=0.1)
    threads = (tpipe.ImageFolderPipeline, jpipe.ImageFolderPipeline, dict(num_threads=2))
    procs = (tpipe.MPImageFolderPipeline, jpipe.MPImageFolderPipeline, dict(num_workers=1))
    # the worker processes' batches, on the train split (eval has no draws)
    for split, train, cls, jcls, extra in (("train", True, *threads), ("val", False, *threads),
                                           ("train", True, *procs)):
        ours = cls(ImageFolder(str(tmp_path / split)), 2, train=train, seed=4, host_id=1,
                   num_hosts=2, image_size=16, device_normalize=True, **extra)
        ref = jcls(JImageFolder(str(tmp_path / split)), 2, train=train, seed=4, host_id=1,
                   num_hosts=2, image_size=16, device_normalize=True, **extra)
        try:
            assert ours.steps_per_epoch() == ref.steps_per_epoch()
            assert ours.eval_steps() == ref.eval_steps()
            assert ours.image_shape == ref.image_shape == (16, 16, 3)
            got, want = list(ours.epoch(1)), list(ref.epoch(1))
            assert len(got) == len(want) > 0
            for (x, y), (rx, ry) in zip(got, want):
                np.testing.assert_array_equal(x, rx)
                np.testing.assert_array_equal(y, ry)
        finally:
            for p in (ours, ref):
                if hasattr(p, "close"):
                    p.close()


def test_build_datasets_feeds_each_rank_its_share():
    cfg = RunConfig(dataset="cifar10", synthetic=True, batch_size=8, synthetic_train_size=32,
                    synthetic_val_size=9, seed=1, device="cpu").validate()
    seen = []
    for rank in range(2):
        train, val, size = build_datasets(cfg, mesh=Mesh(data=2, rank=rank))
        assert size == 32 and train.batch_size == val.batch_size == 4
        assert (train.host_id, train.num_hosts) == (rank, 2)
        assert train.steps_per_epoch() == 4 and val.eval_steps() == 2
        seen.append(sum(len(y) for _, y in val.epoch(0)))
    assert sum(seen) == 9 and seen == [5, 4]
    with pytest.raises(ValueError, match="3 ranks must divide"):
        build_datasets(cfg, mesh=Mesh(data=3, rank=0))
    sums = {"loss": 2.0, "loss_sum": 8.0, "count": 4.0}
    assert global_sums(sums, Mesh()) is sums
