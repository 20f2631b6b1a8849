"""Semantic trace attribution over ``torch.profiler`` traces — the port's
copy of ``bdbnn_tpu/obs/trace.py``: the span taxonomy, the parser and the
capture windows.

1. **Span taxonomy.** The port opens the reference's spans
   (:data:`DEVICE_SPANS`) with :func:`span` at the sites that own the
   math (``nn/layers.py``, ``nn/binarize.py``,
   ``nn/kernels/binary_conv.py``, ``models/resnet.py``, ``losses/``,
   ``train/step.py``), and each conv and dense module opens one more named
   by its flax scope path (``layer1_0/conv1``, ``fc``), the path the
   reference's XLA op metadata carries. A span is a
   ``torch.profiler.record_function`` range while a capture window is open
   (:class:`TraceCapture`, ``InferenceEngine.trace_step``) and a free
   ``nullcontext`` otherwise: it adds no launch and no synchronisation.
   Host phases (:data:`HOST_PHASES`) are annotated by the train loop.

2. **Parser** (:func:`attribute_trace`, :func:`attribute_trace_layers`):
   stdlib-only aggregation of a Chrome trace into per-category device
   ms/step and per-layer ms/step. A kineto trace carries no scope path on
   its device events, so the join is made on the host side:

   - the device ops are the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
     events (the GPU's stream lines); with no GPU activity (the CPU), the
     ``cpu_op`` events, each by its self time (its duration less that of
     the ``cpu_op`` events it encloses on its thread): counting
     ``aten::conv2d`` and the ``aten::convolution`` under it whole would
     count every category twice, and counting leaves alone would drop an
     ``aten::mm`` that calls a small helper op;
   - a device op is joined to its launch (``cudaLaunchKernel``,
     ``cudaMemcpyAsync`` ...) by ``args.correlation``; the ``user_annotation``
     ranges that enclose the launch on its thread, outer to inner, make the
     op's scope path (a CPU op is its own launch);
   - a backward op runs on the autograd engine's thread, outside every
     forward span: the ``autograd::engine::evaluate_function`` op around it
     carries its forward op's ``Sequence number``, and the ranges that
     enclosed that forward op are prepended to the path (XLA keeps a
     transpose's ``named_scope`` the same way);
   - the category is the innermost :data:`DEVICE_SPANS` segment of the
     path, the layer the longest layer scope that occurs in it.

   Host-phase ranges enclose whole steps and are never device spans.
   ``step_total_ms`` is the device-op sum per step (a kineto trace has no
   module-level event). The reference's ``hlo_op_scopes`` and
   ``hlo_module_name`` (the compiled-HLO join its CPU traces need) have no
   counterpart here: the launch join works on every backend.
   The reference's root-script helpers have counterparts:
   :func:`step_device_ms` (``jit_step_ms``) reads each step from a
   ``record_function`` range on the host, whose device ops are those
   launched while it was open, and gives the median device extent of a
   step (first op start to last op end, what XLA's module event spans)
   beside each step's busy sum; :func:`kernel_breakdown`
   (``hlo_breakdown``) groups the device ops by name.

3. **Capture windows** (:class:`TraceCapture`) start and stop the profiler
   at arbitrary ``EPOCH:STEP[:NSTEPS]`` points (``--profile-at``,
   ``--profile-dir``, the health monitor's auto-forensics), record host
   and device activity, and write one gzipped Chrome trace where
   :func:`find_trace_file` looks:
   ``<trace_dir>/plugins/profile/<stamp>/<host>.<pid>.trace.json.gz``.
   On a card a window opens in two steps: the device activities are
   enabled, a burst of :data:`ABSORB_LAUNCHES` tiny kernels runs and is
   waited for, and only then does the capture start. A fresh profiler
   session can lose a prefix of its first device records (on an H100 up
   to about 30 kernels in 3 to 4 windows of 10, ``chip_smoke.py
   --trace-prefix``); the burst takes that loss outside the trace.
   ``_stop`` clears :attr:`TraceCapture.active` before it stops the
   profiler, so a raise between start and stop leads to exactly one stop.

``torch`` is imported inside the capture methods only: ``summarize`` and
``compare`` read traces without loading it.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
import socket
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

# Device-side span taxonomy (the reference's names): each is a span at the
# site that owns the math; a device op is charged to the INNERMOST one on
# its scope path.
DEVICE_SPANS: Tuple[str, ...] = (
    "binarize",       # K2 weight sign + alpha, K3's unpack (nn/layers.py)
    "binary_conv",    # K1 / K4 forward, K5 + K6 backward (nn/layers.py, nn/kernels)
    "bn_act",         # BatchNorm + residual add + activation (models/resnet.py)
    "kurtosis_loss",  # K7, the bimodal regularizer (losses/kurtosis.py)
    "kd_logit_loss",  # KD distribution loss over logits (losses/kd.py)
    "kd_weight_loss", # KD layer weight KL (losses/kd.py)
    "ede_grad",       # EDE estimator backward transform (nn/binarize.py)
    "optimizer",      # the optimizer update (train/step.py)
    "probes",         # binarization health probes (train/step.py)
)

# Host-side phases, annotated by the train loop while a window is open.
HOST_PHASES: Tuple[str, ...] = ("data_wait", "dispatch")

# Dense (not sparse) bf16 tensor-core peaks in TFLOP/s, keyed on
# torch.cuda.get_device_name() (the manifest's device_kind). Source:
# NVIDIA H100 Tensor Core GPU datasheet. No TPU row: a JAX run read by
# the port's tools gets mfu null.
BF16_PEAK_TFLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989.4,  # SXM5
    "NVIDIA H100 PCIe": 756.0,
}

# tiny kernels launched between enabling the device activities and
# opening the capture window (see the module docstring); 0 turns it off
ABSORB_LAUNCHES = 256

TraceSource = Union[str, Sequence[Dict[str, Any]]]

# capture windows open in this process: spans record only while > 0
_open_windows = 0
_NULL = nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a capture
    window is open, else a free nullcontext."""
    if not _open_windows:
        return _NULL
    import torch

    return torch.profiler.record_function(name)


def spans_recording() -> bool:
    """True while a capture window is open (spans record)."""
    return _open_windows > 0


# ---------------------------------------------------------------------------
# capture-window spec
# ---------------------------------------------------------------------------


def parse_profile_at(spec: str, default_steps: int = 5) -> Tuple[int, int, int]:
    """``"EPOCH:STEP[:NSTEPS]"`` → ``(epoch, start_step, n_steps)``."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"bad --profile-at spec {spec!r}: want EPOCH:STEP[:NSTEPS]")
    try:
        nums = [int(p) for p in parts]
    except ValueError as e:
        raise ValueError(f"bad --profile-at spec {spec!r}: {e}") from None
    epoch, step = nums[0], nums[1]
    n_steps = nums[2] if len(nums) == 3 else default_steps
    if epoch < 0 or step < 0 or n_steps < 1:
        raise ValueError(
            f"bad --profile-at spec {spec!r}: epoch/step must be >= 0 and NSTEPS >= 1"
        )
    return epoch, step, n_steps


# ---------------------------------------------------------------------------
# trace parsing (stdlib only)
# ---------------------------------------------------------------------------


def find_trace_file(root: str) -> Optional[str]:
    """Newest ``*.trace.json.gz`` under ``root``."""
    hits = sorted(glob.glob(os.path.join(root, "**", "*.trace.json.gz"), recursive=True))
    return hits[-1] if hits else None


def load_trace_events(source: TraceSource) -> List[Dict[str, Any]]:
    """Trace events from a path (``.json.gz`` or plain ``.json``) or an
    already-loaded event list (passthrough)."""
    if not isinstance(source, str):
        return list(source)
    opener = gzip.open if source.endswith(".gz") else open
    with opener(source, "rt") as f:
        tr = json.load(f)
    return tr.get("traceEvents", [])


# kineto categories of the work a GPU executes
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_EVALUATE = "autograd::engine::evaluate_function"
_TRAILING_IDX = re.compile(r"[.\d]+$")


def _end(e: Dict[str, Any]) -> float:
    return float(e.get("ts", 0)) + float(e.get("dur", 0))


def _enclosing(ranges: List[Dict[str, Any]], points: List[Tuple[float, int]]) -> Dict[int, list]:
    """For each ``(ts, key)`` point, the ranges of ``ranges`` (one thread's,
    sorted by start, longer first) that enclose ``ts``, outer to inner: one
    sweep with a stack of the ranges still open."""
    out: Dict[int, list] = {}
    stack: List[Dict[str, Any]] = []
    i = 0
    for ts, key in sorted(points, key=lambda p: p[0]):
        while i < len(ranges) and float(ranges[i].get("ts", 0)) <= ts:
            stack.append(ranges[i])
            i += 1
        stack = [r for r in stack if _end(r) >= ts]
        out[key] = list(stack)
    return out


def _self_times(cpu_ops: List[Dict[str, Any]]) -> List[Tuple[Dict[str, Any], float]]:
    """Each ``cpu_op`` event with its self time in µs: its duration less
    its direct children's (the ``cpu_op`` events it encloses on its
    thread), so an op nested in another counts once."""
    by_thread: Dict[Any, List[Dict[str, Any]]] = {}
    for e in cpu_ops:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out: List[Tuple[Dict[str, Any], float]] = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e.get("ts", 0)), -float(e.get("dur", 0))))
        # (event, its children's µs so far)
        stack: List[List[Any]] = []

        def close(top):
            out.append((top[0], max(float(top[0].get("dur", 0)) - top[1], 0.0)))

        for e in evs:
            while stack and _end(stack[-1][0]) < float(e.get("ts", 0)):
                close(stack.pop())
            if stack:
                stack[-1][1] += float(e.get("dur", 0))
            stack.append([e, 0.0])
        while stack:
            close(stack.pop())
    return out


def scoped_device_ops(source: TraceSource) -> List[Dict[str, Any]]:
    """Every device op of a trace with its scope path: a list of
    ``{"name", "dur_us", "path", "flops", "start_us", "end_us",
    "launch_us"}``, ``path`` the enclosing ``user_annotation`` names
    joined by ``/`` (outer to inner, the forward's ranges first for a
    backward op; see the module docstring), ``start_us``/``end_us`` the
    op's own span and ``launch_us`` its launch's start on the host (a CPU
    op's own). A device op whose launch the trace lacks gets an empty path
    and ``launch_us`` None."""
    events = [e for e in load_trace_events(source) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    annotations = [e for e in events if e.get("cat") == "user_annotation"]

    # each device op's launch: its runtime call by correlation id, or
    # itself for a CPU op
    if device:
        launch_by_corr = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch_by_corr.setdefault(c, e)
        ops = [(e, launch_by_corr.get((e.get("args") or {}).get("correlation")),
                float(e.get("dur", 0))) for e in device]
    else:
        ops = [(e, e, self_us) for e, self_us in _self_times(cpu_ops) if self_us > 0]

    evaluates = [e for e in cpu_ops if str(e.get("name", "")).startswith(_EVALUATE)
                 and "Sequence number" in (e.get("args") or {})]
    # the forward op of each sequence number (backward nodes carry a
    # nonzero ``Fwd thread id``), latest first
    forwards: Dict[Any, List[Dict[str, Any]]] = {}
    for e in cpu_ops:
        a = e.get("args") or {}
        if ("Sequence number" in a and not a.get("Fwd thread id")
                and not str(e.get("name", "")).startswith(_EVALUATE)):
            forwards.setdefault(a["Sequence number"], []).append(e)
    for evs in forwards.values():
        evs.sort(key=lambda e: -float(e.get("ts", 0)))

    ranges_by_thread: Dict[Any, List[Dict[str, Any]]] = {}
    for e in annotations + evaluates:
        ranges_by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for rs in ranges_by_thread.values():
        rs.sort(key=lambda e: (float(e.get("ts", 0)), -float(e.get("dur", 0))))

    # the anchors whose enclosing ranges are needed: each launch, and the
    # forward op of each backward
    anchors: Dict[int, Dict[str, Any]] = {}
    for _, launch, _ in ops:
        if launch is not None:
            anchors[id(launch)] = launch
    for evs in forwards.values():
        for e in evs:
            anchors[id(e)] = e
    points: Dict[Any, List[Tuple[float, int]]] = {}
    for key, e in anchors.items():
        points.setdefault((e.get("pid"), e.get("tid")), []).append((float(e.get("ts", 0)), key))
    enclosing: Dict[int, list] = {}
    for thread, pts in points.items():
        enclosing.update(_enclosing(ranges_by_thread.get(thread, []), pts))

    def names(anchor, depth=0) -> List[str]:
        stack = enclosing.get(id(anchor), [])
        out: List[str] = []
        for r in stack:
            if r.get("cat") == "user_annotation":
                out.append(str(r.get("name", "")))
        # the innermost autograd node around the anchor: its forward's
        # ranges go first
        node = next((r for r in reversed(stack) if r.get("cat") == "cpu_op"), None)
        if node is not None and depth < 2:
            seq = (node.get("args") or {}).get("Sequence number")
            fwd = next((f for f in forwards.get(seq, [])
                        if float(f.get("ts", 0)) <= float(node.get("ts", 0))), None)
            if fwd is not None:
                out = names(fwd, depth + 1) + out
        return out

    return [
        {
            "name": str(e.get("name", "")),
            "dur_us": dur_us,
            "path": "/".join(names(launch)) if launch is not None else "",
            "flops": (e.get("args") or {}).get("flops"),
            "start_us": float(e.get("ts", 0)),
            "end_us": _end(e),
            "launch_us": float(launch.get("ts", 0)) if launch is not None else None,
        }
        for e, launch, dur_us in ops
    ]


def lost_device_records(source: TraceSource) -> int:
    """The launches, copies and sets of a trace (its ``cuda_runtime`` and
    ``cuda_driver`` calls by those names) whose device record, by
    correlation id, the trace lacks: a profiler session can drop some (see
    :data:`ABSORB_LAUNCHES`), and a window that did understates its device
    time. 0 for a trace without GPU activity."""
    events = [e for e in load_trace_events(source) if e.get("ph") == "X"]
    on_device = {(e.get("args") or {}).get("correlation") for e in events
                 if e.get("cat") in DEVICE_CATS}
    return sum(
        1 for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver")
        and any(w in str(e.get("name", "")) for w in ("Launch", "Memcpy", "Memset"))
        and (e.get("args") or {}).get("correlation") not in on_device
    )


def _span_of(path: str, spans: Sequence[str]) -> Optional[str]:
    """Innermost segment of ``path`` that is one of ``spans`` (after
    stripping a trailing ``.N`` disambiguator), or None."""
    for seg in reversed([s for s in path.split("/") if s]):
        if seg in spans:
            return seg
        base = _TRAILING_IDX.sub("", seg)
        if base in spans:
            return base
    return None


def attribute_trace(
    source: TraceSource,
    n_steps: int,
    *,
    flops_per_step: Optional[float] = None,
    peak_tflops: Optional[float] = None,
    step_prefix: str = "jit_",
) -> Dict[str, Any]:
    """Aggregate a trace into semantic per-category device ms/step (the
    reference's result keys):

    - each device op is charged to the innermost :data:`DEVICE_SPANS`
      span on its scope path; the rest pools under ``"unattributed"``;
    - ``step_total_ms`` is the device-op sum per step (a kineto trace has
      no module-level event; ``step_prefix`` is the reference's parameter
      and matches nothing here);
    - ``user_annotation`` ranges named exactly a :data:`HOST_PHASES`
      phase land in ``host_phases_ms_per_step``;
    - MFU = flops_per_step / device-second / peak; ``flops_per_step``
      falls back to per-op ``flops`` metadata summed from the trace.
    """
    del step_prefix
    events = load_trace_events(source)
    steps = max(int(n_steps or 0), 1)
    categories = {s: 0.0 for s in DEVICE_SPANS}
    unattributed = 0.0
    op_total = 0.0
    trace_flops = 0.0
    for op in scoped_device_ops(events):
        dur_ms = op["dur_us"] / 1e3
        if isinstance(op["flops"], (int, float)):
            trace_flops += float(op["flops"])
        cat = _span_of(op["path"], DEVICE_SPANS)
        if cat is not None:
            categories[cat] += dur_ms
        else:
            unattributed += dur_ms
        op_total += dur_ms
    host = {p: 0.0 for p in HOST_PHASES}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in host:
            host[e["name"]] += float(e.get("dur", 0)) / 1e3

    step_total = op_total / steps or None
    if flops_per_step is None and trace_flops > 0:
        flops_per_step = trace_flops / steps
    mfu = None
    if step_total and flops_per_step and peak_tflops:
        mfu = round(flops_per_step / (step_total / 1e3) / (peak_tflops * 1e12), 4)
    out_cats = {k: round(v / steps, 3) for k, v in categories.items() if v > 0.0}
    if unattributed > 0.0:
        out_cats["unattributed"] = round(unattributed / steps, 3)
    return {
        "n_steps": steps,
        "categories_ms_per_step": dict(sorted(out_cats.items(), key=lambda kv: -kv[1])),
        "step_total_ms": round(step_total, 3) if step_total else None,
        "host_phases_ms_per_step": {k: round(v / steps, 3) for k, v in host.items() if v > 0.0},
        "flops_per_step": flops_per_step,
        "peak_tflops": peak_tflops,
        "mfu": mfu,
    }


def kernel_breakdown(
    source: TraceSource, n_steps: int, top: int = 10
) -> Tuple[Dict[str, float], Optional[float]]:
    """Device ms/step by op name (the reference's ``hlo_breakdown``
    shape): the device ops grouped by name with a trailing ``.N`` / digit
    suffix stripped, the ``top`` largest groups and the rest pooled under
    ``"other"``; plus the device-op total per step (None for a trace with
    no device op)."""
    steps = max(int(n_steps or 0), 1)
    groups: Dict[str, float] = {}
    total = 0.0
    for op in scoped_device_ops(source):
        dur_ms = op["dur_us"] / 1e3
        base = _TRAILING_IDX.sub("", op["name"])
        groups[base] = groups.get(base, 0.0) + dur_ms
        total += dur_ms
    per_step = {k: round(v / steps, 3)
                for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}
    out = dict(list(per_step.items())[:top])
    rest = sum(list(per_step.values())[top:])
    if rest:
        out["other"] = round(rest, 3)
    return out, (total / steps if total else None)


def step_device_ms(source: TraceSource, prefix: str = "train_step") -> Optional[Dict[str, Any]]:
    """Device time of each step of a trace whose steps ran inside
    ``record_function`` ranges named ``prefix*`` (the reference's
    ``jit_step_ms``, whose module events a kineto trace lacks): a device
    op belongs to the step whose range was open when it was launched, the
    launch found by correlation id (:func:`scoped_device_ops`; a backward
    launched from the autograd thread while the step's host thread waits
    in it counts too). Returns None without such a range, else
    ``{"ms": the median step extent, "busy_median_ms", "extent_ms": [...],
    "busy_ms": [...], "n_steps"}``: a step's extent runs from its first
    op's start to its last op's end, what an XLA module event spans, and
    its busy sum adds its ops' durations, so extent − busy is the device's
    idle time inside the step (while the host, the profiler's cost
    included, falls behind the card). A median is the upper one of an
    even count, as the reference takes it."""
    events = load_trace_events(source)
    ranges = sorted((float(e.get("ts", 0)), _end(e)) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith(prefix))
    if not ranges:
        return None
    starts = [r[0] for r in ranges]
    first = [None] * len(ranges)
    last = [None] * len(ranges)
    busy = [0.0] * len(ranges)
    for op in scoped_device_ops(events):
        t = op["launch_us"]
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > ranges[i][1]:
            continue
        first[i] = op["start_us"] if first[i] is None else min(first[i], op["start_us"])
        last[i] = op["end_us"] if last[i] is None else max(last[i], op["end_us"])
        busy[i] += op["dur_us"]
    held = [i for i in range(len(ranges)) if first[i] is not None]
    if not held:
        return None
    extent = [(last[i] - first[i]) / 1e3 for i in held]
    busy_ms = [busy[i] / 1e3 for i in held]
    mid = len(held) // 2
    return {"ms": sorted(extent)[mid], "busy_median_ms": sorted(busy_ms)[mid],
            "extent_ms": extent, "busy_ms": busy_ms, "n_steps": len(held)}


# ---------------------------------------------------------------------------
# per-layer attribution (obs/roofline.py's measured side)
# ---------------------------------------------------------------------------


def _match_needle(segs: List[str], needle_segs: List[str]) -> bool:
    """True if ``needle_segs`` occurs as a consecutive run in ``segs``,
    each segment exactly or after stripping a trailing ``.N``."""
    n = len(needle_segs)
    for i in range(len(segs) - n + 1):
        if all(segs[i + j] == needle_segs[j]
               or _TRAILING_IDX.sub("", segs[i + j]) == needle_segs[j] for j in range(n)):
            return True
    return False


def layer_needles(layers: Dict[str, str]) -> List[Tuple[str, List[str]]]:
    """``(name, scope segments)`` of each layer, the longest scope first
    (then by name): the stem ``conv1`` can never swallow
    ``layer1_0/conv1``'s ops."""
    ordered = sorted(layers.items(), key=lambda kv: (-len([s for s in kv[1].split("/") if s]), kv[0]))
    return [(name, [s for s in scope.split("/") if s]) for name, scope in ordered]


def layer_of(path: str, needles: List[Tuple[str, List[str]]]) -> Optional[str]:
    """The layer (of :func:`layer_needles`) whose scope occurs in ``path``."""
    segs = [s for s in path.split("/") if s]
    return next((name for name, nsegs in needles if _match_needle(segs, nsegs)), None)


def attribute_trace_layers(
    source: TraceSource,
    n_steps: int,
    *,
    layers: Dict[str, str],
) -> Dict[str, Any]:
    """Per-LAYER device ms/step — the measured half of the roofline.

    ``layers`` maps display names to module scope paths (e.g.
    ``{"layer1_0.conv1": "layer1_0/conv1"}``, from
    :func:`bdbnn_tpu_torch.obs.roofline.model_layer_table`). Each device op
    is charged to the layer whose scope segments occur consecutively in its
    scope path, longest scope first; ops in no layer (BN, residual adds,
    pools, input copies) pool under ``"unattributed"``; ``total_ms`` is the
    full device-op time per step, reconciled against the engine's wall."""
    steps = max(int(n_steps or 0), 1)
    needles = layer_needles(layers)
    per_layer = {name: 0.0 for name in layers}
    unattributed = 0.0
    total = 0.0
    for op in scoped_device_ops(source):
        dur_ms = op["dur_us"] / 1e3
        hit = layer_of(op["path"], needles)
        if hit is not None:
            per_layer[hit] += dur_ms
        else:
            unattributed += dur_ms
        total += dur_ms
    return {
        "n_steps": steps,
        "layers": {k: round(v / steps, 4) for k, v in per_layer.items() if v > 0.0},
        "unattributed": round(unattributed / steps, 4),
        "total_ms": round(total / steps, 4),
    }


# ---------------------------------------------------------------------------
# capture windows (torch imported lazily)
# ---------------------------------------------------------------------------


class TraceCapture:
    """Profiler windows at arbitrary ``(epoch, step)`` points.

    ``_stop`` clears :attr:`active` before it stops the profiler, so a
    raise between start and stop leads to exactly one stop: the loop's
    ``finally`` calls :meth:`stop_if_active`, a no-op once a normal-path
    :meth:`maybe_stop` has run, and a failure inside the stop itself
    cannot re-enter it. While a window is open the spans record."""

    def __init__(self, trace_dir: str, windows: Sequence[Tuple[int, int, int]],
                 device=None) -> None:
        self.trace_dir = trace_dir
        # the training device: a CUDA one takes the absorbing burst
        self.device = device
        self._pending = sorted(windows)
        # user-requested (--profile-at) specs; unfired() reports only
        # these: a forensics window left pending (the run ended before
        # its start) is not a user error worth a warning
        self._static = set(self._pending)
        self.active: Optional[Dict[str, int]] = None
        self._prof = None

    def schedule(self, epoch: int, start_step: int, n_steps: int) -> None:
        """Add a window mid-run (auto-forensics: an alert schedules the
        next ``n_steps`` steps). Callers must target a step the loop
        will run (``start_step < steps_per_epoch``): a window opening on
        the loop's final ``maybe_start`` would trace nothing."""
        self._pending.append((int(epoch), int(start_step), max(int(n_steps), 1)))
        self._pending.sort()

    def maybe_start(self, epoch: int, step: int) -> bool:
        """Open the window scheduled at this epoch with start step
        ``<= step``, if any (``<=`` tolerates a caller that skips step
        indices). A window whose epoch is never visited or whose start
        is beyond the epoch's length cannot fire: :meth:`unfired`
        reports those."""
        global _open_windows
        if self.active is not None:
            return False
        for i, (e, s, n) in enumerate(self._pending):
            if e == epoch and step >= s:
                import torch

                del self._pending[i]
                os.makedirs(self.trace_dir, exist_ok=True)
                prof = torch.profiler.profile(
                    activities=sorted(torch.profiler.supported_activities(), key=str))
                prof.prepare_trace()
                if ABSORB_LAUNCHES and self.device is not None and self.device.type == "cuda":
                    _absorb_lost_prefix(torch, self.device)
                prof.start_trace()
                self._prof = prof
                self.active = {"epoch": epoch, "start_step": step, "steps": n}
                _open_windows += 1
                return True
        return False

    def unfired(self) -> List[Tuple[int, int, int]]:
        """User-requested windows still pending (dynamic forensics
        windows excluded)."""
        return [w for w in self._pending if w in self._static]

    def maybe_stop(self, epoch: int, step: int, fence=None):
        """Close the window once its step budget is traced. Returns the
        window info dict when a stop happened, else None."""
        if self.active is None:
            return None
        if step >= self.active["start_step"] + self.active["steps"] - 1:
            return self._stop(fence)
        return None

    def stop_if_active(self, fence=None, last_step: Optional[int] = None):
        """Failure / epoch-end path: flush an open window exactly once.
        ``last_step`` trims the window's reported step count when the
        epoch ended short of the budget."""
        if self.active is None:
            return None
        if last_step is not None:
            traced = max(last_step - self.active["start_step"] + 1, 1)
            self.active["steps"] = min(self.active["steps"], traced)
        return self._stop(fence)

    def annotate(self, name: str):
        """``torch.profiler.record_function(name)`` while a window is
        open (host phase attribution), else a free nullcontext."""
        if self.active is None:
            return nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def _trace_path(self) -> str:
        """``<trace_dir>/plugins/profile/<stamp>/<host>.<pid>.trace.json.gz``:
        the ranks of a job share a trace dir and a host, and may stop a
        window within one second; a second window of one process within
        one second takes the next ``<stamp>_<n>`` dir."""
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        name = f"{socket.gethostname()}.{os.getpid()}.trace.json.gz"
        n = 0
        while True:
            d = os.path.join(self.trace_dir, "plugins", "profile",
                             f"{stamp}_{n}" if n else stamp)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, name)
            if not os.path.exists(path):
                return path
            n += 1

    def _stop(self, fence) -> Dict[str, Any]:
        global _open_windows
        info = dict(self.active)
        prof, self._prof = self._prof, None
        # clear FIRST: if fence() or the stop raises, no later
        # finally-path call may stop a second time
        self.active = None
        try:
            if fence is not None:
                fence()  # the queued device work lands in the trace
        finally:
            _open_windows = max(_open_windows - 1, 0)
            if prof is not None:
                prof.stop()
        if prof is not None:
            prof.export_chrome_trace(self._trace_path())
        info["trace_dir"] = self.trace_dir
        return info


def _absorb_lost_prefix(torch, device) -> None:
    """ABSORB_LAUNCHES one-element adds on ``device``, waited for: the
    records a fresh profiler session may lose are these."""
    z = torch.zeros(1, device=device)
    for _ in range(ABSORB_LAUNCHES):
        z.add_(1)
    torch.cuda.synchronize(device)


__all__ = [
    "ABSORB_LAUNCHES",
    "BF16_PEAK_TFLOPS",
    "DEVICE_CATS",
    "DEVICE_SPANS",
    "HOST_PHASES",
    "TraceCapture",
    "attribute_trace",
    "attribute_trace_layers",
    "find_trace_file",
    "kernel_breakdown",
    "layer_needles",
    "layer_of",
    "load_trace_events",
    "lost_device_records",
    "parse_profile_at",
    "scoped_device_ops",
    "span",
    "spans_recording",
    "step_device_ms",
]
