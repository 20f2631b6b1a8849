"""Batched inference over a frozen export artifact — counterpart of
``bdbnn_tpu/serve/engine.py``.

Requests arrive at any batch size; the engine serves them through a
small ladder of **batch-size buckets**: a batch of n rows is padded up
to the smallest bucket >= n (oversize batches are chunked through the
largest bucket), and the padding rows are sliced off the logits.
``warmup()`` runs every bucket once — which also builds the CUDA kernels
on first use — so no request pays a build.

The model is the registry model the artifact names, in eval mode, on
one device. Two residency modes for the binary convs:

- **dense** (default) — ``float_weight = sign * alpha`` reconstructed on
  the host at load and resident on the card;
- **packed** (``packed=True``) — only the 1-bit ``np.packbits`` sign and
  the f32 alpha stay resident; each forward decodes them transiently
  (K3). ``packed_impl="popcount"`` runs the XNOR-popcount conv (K4)
  instead of K1.

The three modes give bitwise-equal logits: the decode is exact, and K1
and K4 compute the same exact integer dots with the same epilogue.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (the plain PyTorch versions); there is no fallback.
TF32 is turned off where the engine is built: the stem conv and the
classifier are full f32 in the reference, and a TF32 stem would flip
signs in the first binary conv's input.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bdbnn_tpu_torch import resolve_device

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 32)


def percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending sequence; None when
    empty (copy of the reference's ``serve.loadgen.percentile``)."""
    import math

    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    if not sorted_vals:
        return None
    rank = max(int(math.ceil(q / 100.0 * len(sorted_vals))), 1)
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def _pct(vals: Sequence[float], q: float, digits: int = 3) -> Optional[float]:
    v = percentile(vals, q)
    return None if v is None else round(v, digits)


class InferenceEngine:
    """Frozen-artifact inference with warmed batch buckets."""

    def __init__(
        self,
        artifact_dir: str,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        warm: bool = True,
        device: Optional[Any] = None,
        packed: bool = False,
        packed_impl: str = "unpack",
    ):
        from bdbnn_tpu_torch.bridge import flax_to_state_dict
        from bdbnn_tpu_torch.models.registry import create_model
        from bdbnn_tpu_torch.nn.packed import PACKED_IMPLS
        from bdbnn_tpu_torch.serve.export import (
            load_artifact_packed,
            load_artifact_variables,
            read_artifact,
        )

        if not buckets or any(int(b) <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        if packed_impl not in PACKED_IMPLS:
            raise ValueError(
                f"packed_impl must be one of {PACKED_IMPLS}, got {packed_impl!r}"
            )
        self.device = resolve_device(device)
        # full f32 for the stem conv and the classifier, as the reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        self.artifact_dir = artifact_dir
        self.artifact = read_artifact(artifact_dir)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        self.image_size = int(self.artifact["image_size"])
        self.num_classes = int(self.artifact["num_classes"])
        self.arch = self.artifact["arch"]
        self.dataset = self.artifact["dataset"]
        self.packed = bool(packed)
        self.packed_impl = packed_impl
        model_cfg = self.artifact.get("model", {})
        if model_cfg.get("dtype", "float32") == "bfloat16":
            raise NotImplementedError(
                "bfloat16 artifacts are served by a later slice of the port "
                "(bf16 kernels); this slice serves float32 artifacts"
            )
        self._model = create_model(
            self.arch,
            self.dataset,
            twoblock=bool(model_cfg.get("twoblock", False)),
            packed=self.packed,
        )
        if self.packed:
            host_vars, self._packed_spec = load_artifact_packed(artifact_dir)
        else:
            host_vars, self._packed_spec = load_artifact_variables(artifact_dir), None
        self._model.load_state_dict(flax_to_state_dict(host_vars), strict=True)
        self._model.to(self.device).eval().requires_grad_(False)
        self._warm: set = set()
        self.compile_seconds: Dict[int, float] = {}
        self._step_ms_window: Any = deque(maxlen=512)
        if warm:
            self.warmup()

    # -- buckets ---------------------------------------------------------

    @property
    def warmed(self) -> bool:
        """True once every bucket has run once (kernels built)."""
        return all(b in self._warm for b in self.buckets)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        from bdbnn_tpu_torch.nn.packed import packed_impl as _packed_impl_ctx

        with torch.inference_mode(), _packed_impl_ctx(self.packed_impl):
            return self._model(x)

    def _zeros(self, b: int) -> torch.Tensor:
        return torch.zeros(
            (b, self.image_size, self.image_size, 3), dtype=torch.float32, device=self.device
        )

    def warmup(self) -> Dict[int, float]:
        """Run every bucket once; returns per-bucket first-run seconds
        (on the card the first includes the kernels' build)."""
        for b in self.buckets:
            if b in self._warm:
                continue
            t0 = time.perf_counter()
            self._forward(self._zeros(b))
            self._sync()
            self.compile_seconds[b] = round(time.perf_counter() - t0, 3)
            self._warm.add(b)
        return dict(self.compile_seconds)

    def time_step(self, bucket: Optional[int] = None, iters: int = 10) -> float:
        """Mean ms per forward on ``bucket`` (default: the largest): CUDA
        events around ``iters`` forwards on the card, the host clock on
        the CPU. One unmeasured call first."""
        b = self.buckets[-1] if bucket is None else int(bucket)
        n = max(int(iters), 1)
        x = self._zeros(b)
        self._forward(x)
        self._sync()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                self._forward(x)
            end.record()
            end.synchronize()
            return round(start.elapsed_time(end) / n, 3)
        t0 = time.perf_counter()
        for _ in range(n):
            self._forward(x)
        return round((time.perf_counter() - t0) * 1000.0 / n, 3)

    def step_stats(self) -> Dict[str, Any]:
        """Percentiles of the host wall per ``predict_logits`` call."""
        window = sorted(self._step_ms_window)
        return {
            "calls": len(window),
            "p50_ms": _pct(window, 50.0),
            "p99_ms": _pct(window, 99.0),
        }

    # -- inference -------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def predict_logits(self, images: np.ndarray) -> np.ndarray:
        """Logits for ``images`` (n, H, W, 3) float32, any n >= 1: one
        loop over largest-bucket chunks, each padded up to its own
        bucket and sliced back."""
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[None]
        n = len(images)
        if n == 0:
            return np.zeros((0, self.num_classes), np.float32)
        t0 = time.perf_counter()
        big = self.buckets[-1]
        out = []
        for i in range(0, n, big):
            chunk = images[i : i + big]
            m = len(chunk)
            b = self._bucket_for(m)
            if m < b:
                pad = np.zeros((b - m, *chunk.shape[1:]), np.float32)
                chunk = np.concatenate([chunk, pad])
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            logits = self._forward(x)
            # the copy to the host waits for the card
            out.append(logits[:m].cpu().numpy())
        self._step_ms_window.append((time.perf_counter() - t0) * 1000.0)
        return out[0] if len(out) == 1 else np.concatenate(out)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Top-1 class indices for ``images``."""
        return np.argmax(self.predict_logits(images), axis=-1)


def max_abs_logit_drift(a, b) -> Optional[float]:
    """Max absolute element-wise difference between two engines' results
    for the same payloads; None when the shapes cannot be aligned (an
    incomparable pair is "no measurement", never drift 0.0)."""
    try:
        ra = [np.asarray(x, np.float64) for x in list(a)]
        rb = [np.asarray(x, np.float64) for x in list(b)]
    except (TypeError, ValueError):
        return None
    if len(ra) != len(rb) or any(xa.shape != xb.shape for xa, xb in zip(ra, rb)):
        return None
    if not ra:
        return 0.0
    return float(max(float(np.max(np.abs(xa - xb))) for xa, xb in zip(ra, rb)))


def evaluate_split(engine: InferenceEngine, pipe) -> Dict[str, Any]:
    """Top-1 over every example of a pipeline's split, with the
    training loop's ``100 * correct / count`` arithmetic."""
    correct = 0
    count = 0
    batches = 0
    for x, y in pipe.epoch(0):
        pred = engine.predict(np.asarray(x))
        correct += int(np.sum(pred == np.asarray(y)))
        count += len(pred)
        batches += 1
    return {
        "top1": 100.0 * correct / max(count, 1),
        "correct": correct,
        "count": count,
        "batches": batches,
    }


__all__ = [
    "DEFAULT_BUCKETS",
    "InferenceEngine",
    "evaluate_split",
    "max_abs_logit_drift",
]
