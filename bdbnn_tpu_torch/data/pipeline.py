"""Batched input pipelines — the port's copy of the ArrayDataset half of
``bdbnn_tpu/data/pipeline.py`` (numpy only): normalization, the
splitmix64-keyed CIFAR train augmentation (RandomCrop(32, pad 4) +
HFlip with per-sample draws keyed by (seed, epoch, global index)),
``host_shard_indices`` and ``Pipeline`` for both splits. The train
shuffle and the augment keys are the reference's, so both packages see
bitwise-identical batches for the same (seed, epoch). The ImageFolder
pipelines (ImageNet on disk) are not ported yet."""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from bdbnn_tpu_torch.data.datasets import CIFAR_MEAN, CIFAR_STD, ArrayDataset


def normalize(images_u8: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """uint8 HWC → float32 normalized (↔ ToTensor + Normalize)."""
    x = images_u8.astype(np.float32) / 255.0
    return (x - mean) / std


def cifar_eval_transform(images: np.ndarray) -> np.ndarray:
    return normalize(images, CIFAR_MEAN, CIFAR_STD)


def _pad_crop(images: np.ndarray, ys: np.ndarray, xs: np.ndarray, pad: int) -> np.ndarray:
    """Zero-pad then crop each sample at its (ys, xs) offset."""
    n, h, w, c = images.shape
    padded = np.zeros((n, h + 2 * pad, w + 2 * pad, c), images.dtype)
    padded[:, pad : pad + h, pad : pad + w] = images
    out = np.empty_like(images)
    for i in range(n):
        out[i] = padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
    return out


def _splitmix64(z: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # wraps mod 2^64 by design
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def sample_augment_keys(seed: int, epoch: int, sample_indices: np.ndarray) -> np.ndarray:
    """[n] uint64 per-sample augment keys mixed from (pipeline seed,
    epoch, global dataset index) — invariant to host count and batch
    assignment."""
    with np.errstate(over="ignore"):
        z = (
            np.asarray(sample_indices).astype(np.uint64)
            + np.uint64(seed & 0xFFFFFFFF) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(epoch) * np.uint64(0xD1342543DE82EF95)
        )
    return _splitmix64(z)


def keyed_crop_flip(images: np.ndarray, keys: np.ndarray, pad: int = 4) -> np.ndarray:
    """RandomCrop(H, padding=pad) + HFlip with per-sample draws derived
    from ``keys`` (one uint64 per sample)."""
    with np.errstate(over="ignore"):
        span = np.uint64(2 * pad + 1)
        ys = (_splitmix64(keys ^ np.uint64(0xA5A5A5A5A5A5A5A5)) % span).astype(np.int64)
        xs = (_splitmix64(keys ^ np.uint64(0xC3C3C3C3C3C3C3C3)) % span).astype(np.int64)
        flips = (_splitmix64(keys ^ np.uint64(0x0F0F0F0F0F0F0F0F)) & np.uint64(1)).astype(bool)
    out = _pad_crop(images, ys, xs, pad)
    out[flips] = out[flips, :, ::-1]
    return out


def cifar_train_augment_keyed(images: np.ndarray, keys: np.ndarray) -> np.ndarray:
    return normalize(keyed_crop_flip(images, keys), CIFAR_MEAN, CIFAR_STD)


def cifar_train_augment_u8_keyed(images: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Geometric augment only, staying uint8 (device-normalize path)."""
    return keyed_crop_flip(images, keys)


def host_shard_indices(
    n: int,
    epoch: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    host_id: int = 0,
    num_hosts: int = 1,
    drop_remainder_to: Optional[int] = None,
) -> np.ndarray:
    """Disjoint per-host index slice of a deterministic global
    permutation of (seed, epoch): every host computes the same
    permutation and takes the host_id-strided elements."""
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng((seed, epoch)).permutation(n)
    mine = order[host_id::num_hosts]
    if drop_remainder_to is not None:
        mine = mine[: (len(mine) // drop_remainder_to) * drop_remainder_to]
    return mine


class Pipeline:
    """Epoch-based batched iterator over an ArrayDataset.

    Train pipelines shuffle per epoch and drop the remainder; the default
    train transform is the keyed CIFAR augmentation. A custom
    ``transform(images_u8, rng) -> float32`` gets a per-batch Generator
    keyed by (seed, epoch, 0, 1, batch) — the reference's keying on host
    0, so a transform sees the same draws in both packages. ``prefetch``
    > 0 runs the transform on a background thread. One host only: the
    port has no multi-host training yet (ROADMAP A "Later", DDP)."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        train: bool = False,
        transform=None,
        seed: int = 0,
        prefetch: int = 0,
        device_normalize: bool = False,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.train = train
        self._keyed = None
        if transform is None:
            if train:
                self._keyed = (
                    cifar_train_augment_u8_keyed if device_normalize else cifar_train_augment_keyed
                )
            elif device_normalize:
                transform = lambda images, rng: images
            else:
                transform = lambda images, rng: cifar_eval_transform(images)
        self.transform = transform
        self.seed = seed
        self.prefetch = prefetch

    def steps_per_epoch(self) -> int:
        if self.train:
            return len(self.ds) // self.batch_size
        return math.ceil(len(self.ds) / self.batch_size)

    def _epoch_batches(self, epoch: int, start_step: int = 0):
        idx = host_shard_indices(
            len(self.ds), epoch, seed=self.seed, shuffle=self.train,
            drop_remainder_to=self.batch_size if self.train else None,
        )
        # every draw is keyed by (seed, epoch, sample or batch index), so
        # starting at batch ``start_step`` skips the earlier batches
        # without replaying their draws
        for bi in range(start_step, (len(idx) + self.batch_size - 1) // self.batch_size):
            sel = idx[bi * self.batch_size : (bi + 1) * self.batch_size]
            if self._keyed is not None:
                keys = sample_augment_keys(self.seed, epoch, sel)
                yield self._keyed(self.ds.images[sel], keys), self.ds.labels[sel]
                continue
            rng = np.random.default_rng((self.seed, epoch, 0, 1, bi))
            yield self.transform(self.ds.images[sel], rng), self.ds.labels[sel]

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The batches of ``epoch`` from batch ``start_step`` on (the
        mid-epoch resume cursor: a checkpoint taken after step k-1
        resumes with ``start_step=k`` and sees exactly the batches an
        uninterrupted run would have seen)."""
        if self.prefetch <= 0:
            yield from self._epoch_batches(epoch, start_step)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failure = []
        stop = threading.Event()

        def worker():
            try:
                for item in self._epoch_batches(epoch, start_step):
                    q.put(item)
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised in the consumer below
                failure.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        done = False
        try:
            while not done:
                item = q.get()
                done = item is sentinel
                if not done:
                    yield item
        finally:
            # a consumer that stops early (a preempted epoch) releases the
            # worker: it returns after its current batch, and the drain
            # frees its puts
            stop.set()
            while not done:
                done = q.get() is sentinel
        if failure:
            raise failure[0]
