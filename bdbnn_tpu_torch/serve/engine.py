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

The packed impl is bound to the model's binary convs once, when the
engine is built (the reference binds it into each compiled bucket), so
two engines of two impls serve side by side on two threads.

The three modes give bitwise-equal logits: the decode is exact, and K1
and K4 compute the same exact integer dots with the same epilogue. An
artifact that records ``dtype=bfloat16`` builds a bf16 model (the bf16
modes of K2 and K1, f32 logits) and serves in dense and packed/unpack;
packed/popcount refuses it, as the reference does.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (the plain PyTorch versions); there is no fallback.
Every forward runs under ``torch.cuda.device(engine.device)``: a
serving pool calls an engine from a worker thread, and a thread's
current CUDA device (where the kernels launch) is its own.

:meth:`InferenceEngine.residency` reports the bytes the engine keeps
resident on its device against the other weight mode's, and the
per-bucket activation working set of every conv (the reference's layer
names and dtype); ``forwards`` counts the engine's forwards.
:meth:`InferenceEngine.trace_step` runs a bucket's forwards inside a
profiler window for the roofline (``perf``, obs/roofline.py).
TF32 is turned off where the engine is built: the stem conv and the
classifier are full f32 in the reference, and a TF32 stem would flip
signs in the first binary conv's input.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bdbnn_tpu_torch import resolve_device
from bdbnn_tpu_torch.serve.loadgen import _pct, percentile

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 32)


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
        if self.device.type == "cuda" and self.device.index is None:
            # pinned to a card by index: a serving worker thread's current
            # device is its own, and the forward binds this one
            self.device = torch.device("cuda", torch.cuda.current_device())
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
        model_dtype = model_cfg.get("dtype", "float32")
        if self.packed and packed_impl == "popcount" and model_dtype == "bfloat16":
            # the reference's refusal: bf16 conv accumulation rounds past
            # 256 terms, the popcount dot is exact integers
            raise ValueError(
                "packed_impl='popcount' needs a float32 artifact; this "
                "one records dtype=bfloat16 — use packed_impl='unpack'"
            )
        self._model = create_model(
            self.arch,
            self.dataset,
            dtype=model_dtype,
            twoblock=bool(model_cfg.get("twoblock", False)),
            packed=self.packed,
        )
        if self.packed:
            host_vars, self._packed_spec = load_artifact_packed(artifact_dir)
        else:
            host_vars, self._packed_spec = load_artifact_variables(artifact_dir), None
        self._model.load_state_dict(flax_to_state_dict(host_vars), strict=True)
        self._model.to(self.device).eval().requires_grad_(False)
        from bdbnn_tpu_torch.nn.layers import _BinaryConvBase

        for mod in self._model.modules():
            if isinstance(mod, _BinaryConvBase):
                mod.packed_impl = packed_impl
        self._act_bpe = 2 if model_dtype == "bfloat16" else 4
        # per image: {layer name: (input elements, output elements)},
        # read off the first warmup forward (see _record_activations)
        self._act_per_image: Optional[Dict[str, Tuple[int, int]]] = None
        self._warm: set = set()
        self.compile_seconds: Dict[int, float] = {}
        self._step_ms_window: Any = deque(maxlen=512)
        self._forwards_lock = threading.Lock()
        self.forwards = 0  # guarded-by: _forwards_lock
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
        with self._forwards_lock:
            self.forwards += 1
        with torch.inference_mode():
            if self.device.type != "cuda":
                return self._model(x)
            with torch.cuda.device(self.device):
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
            if self._act_per_image is None:
                self._act_per_image = self._record_activations(self._zeros(b))
            else:
                self._forward(self._zeros(b))
            self._sync()
            self.compile_seconds[b] = round(time.perf_counter() - t0, 3)
            self._warm.add(b)
        return dict(self.compile_seconds)

    # -- residency accounting --------------------------------------------

    def _record_activations(self, x: torch.Tensor) -> Dict[str, Tuple[int, int]]:
        """One forward of ``x`` with hooks on every conv: each conv's
        input and output elements per image, by the reference's layer
        name (the module path). The classifier is not called as a
        module in bf16, so its row comes from its width."""
        from bdbnn_tpu_torch.nn.layers import FloatConv, _BinaryConvBase

        n = int(x.shape[0])
        rows: Dict[str, Tuple[int, int]] = {}
        hooks = []

        def hook(name):
            def record(mod, args, out):
                rows.setdefault(name, (args[0].numel() // n, out.numel() // n))

            return record

        for name, mod in self._model.named_modules():
            if isinstance(mod, (FloatConv, _BinaryConvBase)):
                hooks.append(mod.register_forward_hook(hook(name)))
        try:
            self._forward(x)
        finally:
            for h in hooks:
                h.remove()
        for name, mod in self._model.named_modules():
            if isinstance(mod, torch.nn.Linear):
                rows[name] = (mod.in_features, mod.out_features)
        return rows

    def _activation_working_set(self) -> Dict[str, Any]:
        """Per-bucket activation working set: the bytes in and out of
        every conv and the classifier at each bucket's batch size, in
        the artifact's dtype (the reference's ``model_layer_table``
        rows, measured here on the first warmup forward)."""
        out: Dict[str, Any] = {}
        for b in self.buckets:
            per_conv = {
                name: {"in": i * b * self._act_bpe, "out": o * b * self._act_bpe}
                for name, (i, o) in self._act_per_image.items()
            }
            out[str(b)] = {
                "bytes_in": sum(v["in"] for v in per_conv.values()),
                "bytes_out": sum(v["out"] for v in per_conv.values()),
                "per_conv": per_conv,
            }
        return out

    def residency(self) -> Dict[str, Any]:
        """Resident weight memory: the bytes of every parameter and
        buffer the engine's model keeps on its device, the bytes the
        other weight mode would keep for the same artifact, their ratio,
        and the per-bucket activation working set (``activations``). A
        cold engine is warmed first (the activations are measured on
        its first forward)."""
        from bdbnn_tpu_torch.nn.packed import dense_weight_bytes, packed_weight_bytes

        if self._act_per_image is None:
            self.warmup()
        tensors = [*self._model.parameters(), *self._model.buffers()]
        resident = int(sum(t.numel() * t.element_size() for t in tensors))
        activations = self._activation_working_set()
        if self.packed:
            dense_equiv = int(self._packed_spec["dense_equiv_bytes"])
            return {
                "packed": True,
                "resident_bytes": resident,
                "dense_equiv_bytes": dense_equiv,
                "packed_equiv_bytes": resident,
                "ratio": round(dense_equiv / max(resident, 1), 3),
                "activations": activations,
            }
        # what the packed mode would keep: each binary conv's dense f32
        # tensor swapped for packbits sign + alpha
        packed_equiv = resident
        for t in self.artifact.get("tensors", []):
            if t["kind"] == "binary":
                packed_equiv += packed_weight_bytes(t["shape"]) - dense_weight_bytes(t["shape"])
        return {
            "packed": False,
            "resident_bytes": resident,
            "dense_equiv_bytes": resident,
            "packed_equiv_bytes": packed_equiv,
            "ratio": round(resident / max(packed_equiv, 1), 3),
            "activations": activations,
        }

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

    def trace_step(self, trace_dir: str, bucket: Optional[int] = None,
                   iters: int = 10) -> Dict[str, Any]:
        """The reference's ``trace_step``: one unmeasured forward outside
        the window, then a profiler window (:class:`TraceCapture`, with its
        absorbing burst on a card; the spans record inside it) around
        ``iters`` forwards, each synchronised, timed on the host clock.
        Returns the mean wall per forward beside the trace dir, so the
        roofline reconciles the trace's device time against the wall it
        was captured under; the trace lands under
        ``<trace_dir>/plugins/profile/<stamp>/``."""
        from bdbnn_tpu_torch.obs.trace import TraceCapture

        b = self.buckets[-1] if bucket is None else int(bucket)
        n = max(int(iters), 1)
        x = self._zeros(b)
        self._forward(x)
        self._sync()
        cap = TraceCapture(trace_dir, [(0, 0, n)], device=self.device)
        cap.maybe_start(0, 0)
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                self._forward(x)
                self._sync()
            wall_ms = (time.perf_counter() - t0) * 1000.0 / n
        finally:
            cap.stop_if_active()
        return {"bucket": b, "iters": n, "wall_ms": round(wall_ms, 3), "trace_dir": trace_dir}

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
    "percentile",
]
