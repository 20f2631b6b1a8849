"""The eval half of ``bdbnn_tpu/data/pipeline.py`` (numpy only):
normalization and an in-order batched iterator over an ArrayDataset.
Training augmentation and per-host sharding arrive with the training
slice."""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np

from bdbnn_tpu_torch.data.datasets import CIFAR_MEAN, CIFAR_STD, ArrayDataset


def normalize(images_u8: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """uint8 HWC → float32 normalized (↔ ToTensor + Normalize)."""
    x = images_u8.astype(np.float32) / 255.0
    return (x - mean) / std


def cifar_eval_transform(images: np.ndarray) -> np.ndarray:
    return normalize(images, CIFAR_MEAN, CIFAR_STD)


class Pipeline:
    """In-order eval batches over an ArrayDataset. ``transform(images_u8,
    rng) -> float32`` runs per batch (default: CIFAR normalization); the
    per-batch ``rng`` is keyed like the reference's, so a transform sees
    the same draws in both packages."""

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        *,
        train: bool = False,
        transform=None,
        seed: int = 0,
    ):
        if train:
            raise NotImplementedError(
                "training pipelines arrive with the training slice; this "
                "slice ports the eval half"
            )
        self.ds = dataset
        self.batch_size = batch_size
        self.train = False
        self.transform = transform or (lambda images, rng: cifar_eval_transform(images))
        self.seed = seed

    def steps_per_epoch(self) -> int:
        return math.ceil(len(self.ds) / self.batch_size)

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Batches of ``epoch`` in dataset order."""
        for bi in range(self.steps_per_epoch()):
            sel = np.arange(bi * self.batch_size, min((bi + 1) * self.batch_size, len(self.ds)))
            rng = np.random.default_rng((self.seed, epoch, 0, 1, bi))
            yield self.transform(self.ds.images[sel], rng), self.ds.labels[sel]
