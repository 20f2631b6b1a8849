"""Input-pipeline throughput alone (no model): images/s of the
ImageNet-style decode and augment feed — the port's counterpart of the
reference's ``bench_pipeline.py``.

Times the thread pipeline (``ImageFolderPipeline``, threads 1, 2, 4)
against the worker-process pipeline (``MPImageFolderPipeline``, processes
1, 2, 4, 8) with the reference's ``measure`` on a generated JPEG folder
(:func:`make_jpeg_folder`, byte for byte the reference's) or, through
:func:`run`, on any image folder. A worker count's window is at least two
batches a worker (:func:`window`): the pool hands each worker one whole
batch and keeps 2 × workers in flight, so a shorter window after the warm
batch times the rest of the first wave, decoded beside the warm one, and
not the pool's steady rate (the reference times ``--batches`` for every
count). The reference's tf.data row is
``tfdata_error``: that engine is not ported (``train/config.py``
``TFDATA_UNPORTED``). ``workers_to_saturate_device`` divides the card's
own step rate (``--device-img-per-sec``, e.g. the bench line's
``device_images_per_sec``) by one worker process's rate; without it both
are null.

Usage::

    python -m bdbnn_tpu_torch.scripts.bench_pipeline [--out PIPELINE.json]
        [--device-img-per-sec R]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np

THREADS = (1, 2, 4)
PROCESSES = (1, 2, 4, 8)


def make_jpeg_folder(root: str, n_images: int = 384, hw: int = 256) -> str:
    """Synthetic JPEG ImageFolder with a photograph's decode cost (smooth
    low-frequency content plus noise), the reference's bytes for the same
    arguments. Returns its ``train`` dir."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls in range(2):
        d = os.path.join(root, "train", f"class{cls}")
        os.makedirs(d, exist_ok=True)
        for i in range(n_images // 2):
            base = rng.normal(size=(hw // 8, hw // 8, 3))
            up = np.kron(base, np.ones((8, 8, 1)))
            img = np.clip((up * 40 + 128 + rng.normal(scale=12, size=up.shape)), 0, 255
                          ).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{i:05d}.jpg"), quality=90)
    return os.path.join(root, "train")


def measure(pipe, n_batches: int) -> float:
    """Images/s over ``n_batches`` batches after one warm batch (the
    pool's start and first decode stay out of the timing)."""
    it = pipe.epoch(0)
    next(it)
    t0 = time.perf_counter()
    n = 0
    for _ in range(n_batches):
        batch = next(it, None)
        if batch is None:  # the folder is too small for the window
            break
        n += len(batch[1])
    dt = time.perf_counter() - t0
    it.close()
    if hasattr(pipe, "close"):
        pipe.close()
    return n / dt


def window(n_batches: int, workers: int) -> int:
    """The batches timed for ``workers`` worker processes: ``n_batches``,
    and at least 2 × ``workers``. The warm batch comes back with the
    first wave's other ``workers`` − 1, decoded beside it; the window's
    last batch is the first of the third wave, so the window spans two
    waves of decode. A thread pipeline decodes one batch at a time, so
    its window is ``n_batches``."""
    return max(int(n_batches), 2 * int(workers))


def run(folder, batch: int, n_batches: int,
        device_img_per_sec: Optional[float] = None) -> Dict[str, Any]:
    """Threads against worker processes on ``folder`` (an ``ImageFolder``):
    the reference's result keys. Each worker-process count times
    :func:`window` batches."""
    from bdbnn_tpu_torch.data import ImageFolderPipeline, MPImageFolderPipeline
    from bdbnn_tpu_torch.train.config import TFDATA_UNPORTED

    ncpu = multiprocessing.cpu_count()
    out: Dict[str, Any] = {
        "what": ("input-pipeline-only throughput (no model): JPEG decode + "
                 "RandomResizedCrop(224) + hflip + normalize, ImageNet-style"),
        "host_cpu_count": ncpu,
        "batch_size": batch,
        "threads_img_per_sec": {},
        "processes_img_per_sec": {},
        "device_img_per_sec_target": device_img_per_sec,
    }
    for workers in THREADS:
        rate = measure(ImageFolderPipeline(folder, batch, train=True, num_threads=workers),
                       n_batches)
        out["threads_img_per_sec"][str(workers)] = round(rate, 1)
        print(f"threads={workers}: {rate:8.1f} img/s", flush=True)
    for workers in PROCESSES:
        rate = measure(MPImageFolderPipeline(folder, batch, train=True, num_workers=workers),
                       window(n_batches, workers))
        out["processes_img_per_sec"][str(workers)] = round(rate, 1)
        print(f"processes={workers}: {rate:8.1f} img/s", flush=True)
    out["tfdata_error"] = TFDATA_UNPORTED
    per_worker = out["processes_img_per_sec"].get("1")
    out["per_worker_img_per_sec"] = per_worker
    out["workers_to_saturate_device"] = (
        int(np.ceil(device_img_per_sec / max(per_worker, 1e-9)))
        if device_img_per_sec and per_worker else None)
    out["note"] = (
        f"{ncpu} CPU core(s) on this host; rates are this host's. The process pipeline "
        "exists because the thread pipeline's Python is bound by the interpreter lock; "
        "workers_to_saturate_device is the card's step rate over one worker process's rate "
        "(null without --device-img-per-sec)."
    )
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="also write the result JSON here")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--images", type=int, default=384)
    ap.add_argument("--device-img-per-sec", type=float, default=None,
                    help="the card's step rate the workers must feed (the bench line's "
                         "device_images_per_sec)")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)

    from bdbnn_tpu_torch.data import ImageFolder

    with tempfile.TemporaryDirectory() as tmp:
        folder = ImageFolder(make_jpeg_folder(tmp, n_images=args.images))
        out = run(folder, args.batch, args.batches, device_img_per_sec=args.device_img_per_sec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
