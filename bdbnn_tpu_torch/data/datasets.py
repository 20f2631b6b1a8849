"""Dataset sources: CIFAR-10/100 binary batches, ImageFolder and
synthetic images — the port's own copy of ``bdbnn_tpu/data/datasets.py``
(numpy, and PIL imported when an image is decoded).

All sources return uint8 HWC images + int64 labels; normalization
happens in :mod:`bdbnn_tpu_torch.data.pipeline`.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ArrayDataset:
    """In-memory uint8 images (N, H, W, C) + int64 labels (N,)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"images must be uint8 NHWC, got {images.dtype} {images.shape}")
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = images
        self.labels = labels.astype(np.int64)

    def __len__(self) -> int:
        return len(self.images)


def synthetic_dataset(
    num_examples: int = 512,
    image_size: int = 32,
    num_classes: int = 10,
    seed: int = 0,
) -> ArrayDataset:
    """Deterministic random images/labels (the same draws as the
    reference's ``synthetic_dataset`` for the same arguments)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(
        0, 256, size=(num_examples, image_size, image_size, 3), dtype=np.uint8
    )
    labels = rng.integers(0, num_classes, size=(num_examples,))
    return ArrayDataset(images, labels)


def _load_cifar_pickle(path: str):
    # the standard CIFAR python batches are pickles; read only files
    # the caller points at as a dataset
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def load_cifar10(data_root: str, split: str = "train") -> ArrayDataset:
    """Standard ``cifar-10-batches-py`` layout or an npz fallback."""
    npz = _try_npz(data_root, split)
    if npz is not None:
        return npz
    base = os.path.join(data_root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = data_root
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    )
    imgs: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for fn in files:
        d = _load_cifar_pickle(os.path.join(base, fn))
        imgs.append(np.asarray(d[b"data"], np.uint8))
        labels.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(x), np.concatenate(labels))


def load_cifar100(data_root: str, split: str = "train") -> ArrayDataset:
    npz = _try_npz(data_root, split)
    if npz is not None:
        return npz
    base = os.path.join(data_root, "cifar-100-python")
    if not os.path.isdir(base):
        base = data_root
    d = _load_cifar_pickle(os.path.join(base, "train" if split == "train" else "test"))
    x = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(x), np.asarray(d[b"fine_labels"], np.int64))


def _try_npz(data_root: str, split: str) -> Optional[ArrayDataset]:
    for name in ("data.npz", f"{split}.npz"):
        p = os.path.join(data_root, name)
        if os.path.isfile(p):
            z = np.load(p)
            if f"x_{split}" in z:
                return ArrayDataset(z[f"x_{split}"].astype(np.uint8), z[f"y_{split}"])
            if "images" in z:
                return ArrayDataset(z["images"].astype(np.uint8), z["labels"])
    return None


class ImageFolder:
    """Class-per-subdirectory image tree (ImageNet's ``train/`` and
    ``val/`` layout), decoded lazily with PIL. Sorted class names give the
    label indices, torchvision's convention, so label spaces agree with
    torch-trained teachers; each class dir is walked recursively in
    sorted order, and a file counts when its extension, in any case, is
    one of ``EXTS``."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str):
        self.root = root
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class subdirectories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            for dirpath, _, filenames in sorted(os.walk(os.path.join(root, c))):
                for fn in sorted(filenames):
                    if fn.lower().endswith(self.EXTS):
                        self.samples.append((os.path.join(dirpath, fn), self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int):
        """(RGB PIL image, label) of sample ``index``."""
        from PIL import Image

        path, label = self.samples[index]
        with Image.open(path) as im:
            return im.convert("RGB"), label
