"""Batched input pipelines — the port's copy of ``bdbnn_tpu/data/
pipeline.py`` (numpy, and PIL for the image folders): normalization, the
splitmix64-keyed CIFAR train augmentation (RandomCrop(32, pad 4) +
HFlip with per-sample draws keyed by (seed, epoch, global index)),
``host_shard_indices`` and ``Pipeline`` for both splits; and ImageNet
from an image folder: the PIL transforms (RandomResizedCrop,
Resize(256) + CenterCrop), :class:`ImageFolderPipeline` (a thread pool
decodes each batch) and :class:`MPImageFolderPipeline` (spawned worker
processes decode whole batches ahead of the consumer). The shuffles and
the augment draws are the reference's, so each pipeline yields batches
bitwise equal to its JAX-package twin's for the same (seed, epoch). The
two folder backends key their draws differently, as the reference's do
(a splitmix64 key a sample for threads, a ``SeedSequence`` of (seed,
epoch, index) for worker processes): their train batches differ from
each other, their eval batches (no draws) do not. The tf.data backend
needs TensorFlow and is not ported.

In a data-parallel job each pipeline feeds one rank (``host_id`` of
``num_hosts``) its ``host_id``-strided share of the global permutation at
the per-rank batch size; the keyed per-sample draws are the same on any
number of ranks, and ``eval_steps()`` is the count of eval batches every
rank runs (a rank whose shard ran out feeds fully masked batches)."""

from __future__ import annotations

import itertools
import math
import multiprocessing
import queue
import threading
from collections import deque
from typing import Iterator, Optional, Tuple

import numpy as np

from bdbnn_tpu_torch.data.datasets import (
    CIFAR_MEAN,
    CIFAR_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    ArrayDataset,
    ImageFolder,
)


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
    keyed by (seed, epoch, host_id, 1, batch) — the reference's keying, so
    a transform sees the same draws in both packages. ``prefetch`` > 0
    runs the transform on a background thread. ``host_id`` /
    ``num_hosts``: the rank's share of a data-parallel job (module
    docstring)."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        train: bool = False,
        transform=None,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
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
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch

    def steps_per_epoch(self) -> int:
        per_host = len(self.ds) // self.num_hosts
        if self.train:
            return per_host // self.batch_size
        return math.ceil(per_host / self.batch_size)

    def eval_steps(self) -> int:
        """The eval batches EVERY rank runs: those of the largest shard."""
        return math.ceil(math.ceil(len(self.ds) / self.num_hosts) / self.batch_size)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.ds.images.shape[1:])

    def _epoch_batches(self, epoch: int, start_step: int = 0):
        idx = host_shard_indices(
            len(self.ds), epoch, seed=self.seed, shuffle=self.train, host_id=self.host_id,
            num_hosts=self.num_hosts, drop_remainder_to=self.batch_size if self.train else None,
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
            rng = np.random.default_rng((self.seed, epoch, self.host_id, 1, bi))
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


# ---------------------------------------------------------------------------
# ImageNet from an image folder
# ---------------------------------------------------------------------------


def random_resized_crop(im, rng: np.random.Generator, size: int = 224,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop on a PIL image: 10 tries at a crop of
    random area and log-uniform aspect, then a center crop of the short
    side resized to ``size``."""
    from PIL import Image

    w, h = im.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return im.crop((x0, y0, x0 + cw, y0 + ch)).resize((size, size), Image.BILINEAR)
    return center_crop(resize_short(im, size), size)


def resize_short(im, size: int):
    """Bilinear resize so the short side is ``size``."""
    from PIL import Image

    w, h = im.size
    if w < h:
        return im.resize((size, int(round(h * size / w))), Image.BILINEAR)
    return im.resize((int(round(w * size / h)), size), Image.BILINEAR)


def center_crop(im, size: int):
    w, h = im.size
    x0 = (w - size) // 2
    y0 = (h - size) // 2
    return im.crop((x0, y0, x0 + size, y0 + size))


# decode attempts of a sample before a neighbour is substituted; what PIL
# raises for a truncated file (OSError) or a malformed one (ValueError,
# SyntaxError for broken PNG headers)
LOAD_RETRIES = 2
DECODE_ERRORS = (OSError, ValueError, SyntaxError)


def _decode_one(folder: ImageFolder, index: int, rng: np.random.Generator, train: bool,
                size: int) -> Tuple[np.ndarray, int]:
    """Decode and transform one sample: RandomResizedCrop + HFlip for
    train, Resize(256) + CenterCrop for eval; uint8 HWC."""
    im, label = folder.load(index)
    if train:
        arr = np.asarray(random_resized_crop(im, rng, size), np.uint8)
        if rng.random() < 0.5:
            arr = arr[:, ::-1]
    else:
        arr = np.asarray(center_crop(resize_short(im, 256), size), np.uint8)
    return arr, label


def _load_one(folder: ImageFolder, index: int, rng: np.random.Generator, train: bool, size: int):
    """(image, label, data error or None) of sample ``index``. A sample
    that fails ``LOAD_RETRIES + 1`` decodes is replaced by the next
    decodable index (mod N), drawn with the failed sample's ``rng`` so the
    stream stays deterministic, and the error dict says so: one bad
    image costs one ``data_error`` event, not the run. Raises when
    nothing in the folder decodes."""
    last_err = None
    for _ in range(LOAD_RETRIES + 1):
        try:
            return (*_decode_one(folder, index, rng, train, size), None)
        except DECODE_ERRORS as e:
            last_err = e
    n = len(folder)
    for offset in range(1, n):
        sub = (index + offset) % n
        try:
            arr, label = _decode_one(folder, sub, rng, train, size)
        except DECODE_ERRORS:
            continue
        return arr, label, {
            "index": int(index),
            "substitute": int(sub),
            "path": folder.samples[index][0],
            "error": f"{type(last_err).__name__}: {last_err}"[:200],
        }
    raise last_err


class ImageFolderPipeline:
    """ImageNet-style pipeline over an :class:`ImageFolder`: shuffled
    (train) or ordered (eval) batches, each decoded by a pool of
    ``num_threads`` threads when the consumer asks for it, uint8 with
    ``device_normalize`` (the train step normalizes on the card) and
    normalized float32 otherwise. Train draws are keyed per sample by
    (seed, epoch, index) (``sample_augment_keys``), so ``epoch(e, k)``
    starts at batch k without replaying the draws before it.

    ``on_data_error(info)`` receives each substitution (``_load_one``) on
    the consumer's thread, after the batch that held it: the train loop
    points it at the ``data_error`` event. ``host_id`` / ``num_hosts``:
    the rank's share of a data-parallel job (module docstring)."""

    def __init__(self, folder: ImageFolder, batch_size: int, *, train: bool = True,
                 image_size: int = 224, seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 num_threads: int = 8, device_normalize: bool = False):
        self.folder = folder
        self.batch_size = batch_size
        self.train = train
        self.image_size = image_size
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.num_threads = num_threads
        self.device_normalize = device_normalize
        self.on_data_error = None

    def steps_per_epoch(self) -> int:
        per_host = len(self.folder) // self.num_hosts
        if self.train:
            return per_host // self.batch_size
        return math.ceil(per_host / self.batch_size)

    def eval_steps(self) -> int:
        """The eval batches EVERY rank runs: those of the largest shard."""
        return math.ceil(math.ceil(len(self.folder) / self.num_hosts) / self.batch_size)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.image_size, self.image_size, 3)

    def _indices(self, epoch: int) -> np.ndarray:
        return host_shard_indices(len(self.folder), epoch, seed=self.seed, shuffle=self.train,
                                  host_id=self.host_id, num_hosts=self.num_hosts,
                                  drop_remainder_to=self.batch_size if self.train else None)

    def _finish(self, images_u8: np.ndarray, labels: np.ndarray,
                errors) -> Tuple[np.ndarray, np.ndarray]:
        """Relay a batch's data errors on the consumer's thread (the event
        channel has one writer) and normalize unless the card does."""
        if self.on_data_error is not None:
            for info in errors:
                self.on_data_error(info)
        if self.device_normalize:
            return images_u8, labels
        return normalize(images_u8, IMAGENET_MEAN, IMAGENET_STD), labels

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor

        idx = self._indices(epoch)
        keys = sample_augment_keys(self.seed, epoch, idx)
        load = lambda a: _load_one(self.folder, int(a[0]), np.random.default_rng(int(a[1])),
                                   self.train, self.image_size)
        with ThreadPoolExecutor(self.num_threads) as pool:
            for start in range(start_step * self.batch_size, len(idx), self.batch_size):
                sl = slice(start, start + self.batch_size)
                results = list(pool.map(load, zip(idx[sl], keys[sl])))
                yield self._finish(np.stack([r[0] for r in results]),
                                   np.array([r[1] for r in results], np.int64),
                                   [r[2] for r in results if r[2] is not None])


# a worker process's folder and transform, set once by the pool's
# initializer (the folder's path table is pickled once a worker, not once
# a task)
_MP_FOLDER: Optional[ImageFolder] = None
_MP_TRAIN = True
_MP_IMAGE_SIZE = 224
_MP_SEED = 0


def _mp_init(folder: ImageFolder, train: bool, image_size: int, seed: int) -> None:
    global _MP_FOLDER, _MP_TRAIN, _MP_IMAGE_SIZE, _MP_SEED
    _MP_FOLDER, _MP_TRAIN, _MP_IMAGE_SIZE, _MP_SEED = folder, train, image_size, seed


def _mp_build_batch(task):
    """Decode and transform one whole batch in a worker process: ``task``
    is (epoch, indices); returns (uint8 NHWC, labels, data errors). Each
    sample's draws come from ``SeedSequence((seed, epoch, index))``, so
    the batch is the same for any worker count or assignment."""
    epoch, indices = task
    size = _MP_IMAGE_SIZE
    images = np.empty((len(indices), size, size, 3), np.uint8)
    labels = np.empty((len(indices),), np.int64)
    errors = []
    for j, i in enumerate(indices):
        rng = np.random.default_rng(np.random.SeedSequence(entropy=(_MP_SEED, epoch, int(i))))
        images[j], labels[j], err = _load_one(_MP_FOLDER, int(i), rng, _MP_TRAIN, size)
        if err is not None:
            errors.append(err)
    return images, labels, errors


class MPImageFolderPipeline(ImageFolderPipeline):
    """:class:`ImageFolderPipeline` with ``num_workers`` worker PROCESSES,
    each decoding whole batches (a torch DataLoader worker's granularity)
    ahead of the consumer, off the interpreter lock of the process that
    trains.

    - Workers are spawned, not forked: the parent runs CUDA and threads,
      and a forked child can deadlock on a lock whose owner it lacks. A
      worker imports the port's data modules (numpy and PIL, no torch)
      and gets the folder once, from the pool's initializer. The pool is
      made at the first epoch and kept for later ones; ``close()``
      terminates it (the train loop closes it on every exit).
    - At most ``prefetch_batches`` batches are in flight (default twice
      the workers), so the workers run ahead of the consumer with back
      pressure; results are taken in order, each within
      ``RESULT_TIMEOUT_S`` (a killed worker raises instead of hanging).
    - Workers return uint8 (a quarter of float32's bytes over the pipe)
      and their data errors with each batch; the parent normalizes unless
      the card does.
    - A consumer that stops early (a preempted epoch) leaves its pending
      batches to the pool, whose daemon workers do not keep the process
      alive."""

    RESULT_TIMEOUT_S = 600.0

    def __init__(self, folder: ImageFolder, batch_size: int, *, train: bool = True,
                 image_size: int = 224, seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 num_workers: int = 8, prefetch_batches: Optional[int] = None,
                 device_normalize: bool = False):
        super().__init__(folder, batch_size, train=train, image_size=image_size, seed=seed,
                         host_id=host_id, num_hosts=num_hosts,
                         device_normalize=device_normalize)
        self.num_workers = max(int(num_workers), 1)
        self.prefetch_batches = (prefetch_batches if prefetch_batches is not None
                                 else 2 * self.num_workers)
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(self.num_workers, initializer=_mp_init,
                                  initargs=(self.folder, self.train, self.image_size, self.seed))
        return self._pool

    def close(self) -> None:
        """Terminate the worker processes and wait for them."""
        if self._pool is not None:
            pool, self._pool = self._pool, None
            pool.terminate()
            pool.join()

    def __del__(self):  # a pipeline dropped without close()
        try:
            self.close()
        except Exception:
            pass

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._indices(epoch)
        tasks = ((epoch, idx[s : s + self.batch_size].tolist())
                 for s in range(start_step * self.batch_size, len(idx), self.batch_size))
        pool = self._get_pool()
        window: deque = deque(pool.apply_async(_mp_build_batch, (t,))
                              for t in itertools.islice(tasks, self.prefetch_batches))
        while window:
            try:
                images_u8, labels, errors = window.popleft().get(timeout=self.RESULT_TIMEOUT_S)
            except multiprocessing.TimeoutError:
                self.close()
                raise RuntimeError(
                    f"input worker produced no batch for {self.RESULT_TIMEOUT_S:.0f}s — a "
                    "decode worker likely died (killed for memory?); pool terminated"
                ) from None
            nxt = next(tasks, None)
            if nxt is not None:
                window.append(pool.apply_async(_mp_build_batch, (nxt,)))
            yield self._finish(images_u8, labels, errors)
