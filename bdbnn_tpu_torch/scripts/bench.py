"""Train-step throughput of the flagship on the card, as one JSON line —
the port's counterpart of the reference's ``bench.py``.

Prints ONE JSON line, ``{"metric", "value", "unit", "vs_baseline", ...}``
with the reference's keys: ``value`` is images/s/card of the full BD-BNN
training step (forward, backward, Adam, the 19-layer kurtosis loss) of
binary ResNet-18 react at 224² in bf16, BASELINE config 3, on a batch
already on the card (no input pipeline): the step ``train/step.py``
``make_train_step`` builds, whose binary convs run K2 → K1 forward and
K5 + K6 backward in their bf16 modes and whose kurtosis runs K7.

Measurement:

- **Fenced windows.** 3 warm steps, then 5 windows of ``--iters`` chained
  steps; each window ends with ``loss.item()`` (the card's queue drains
  before the host reads the loss); ``value`` is the median window's rate.
- **FLOPs and MFU.** ``flops_per_step`` is 3 × the forward FLOPs of every
  conv and dense layer less the stem's input gradient, counted from
  ``obs/roofline.py`` ``model_layer_table`` (``flops_source`` says so:
  PyTorch has no compiled step to ask); ``mfu`` pairs it with the fenced
  rate against the card's dense bf16 peak (``obs/trace.py``
  ``BF16_PEAK_TFLOPS``); ``timing_suspect`` is set when ``mfu`` > 1.
- **Profile.** Unless ``--profile-dir ''``, a 5-step ``TraceCapture``
  window (with its absorbing burst on a card) is taken, again when its
  trace lost device records (up to three windows, as ``perf`` takes
  them), each step inside a ``train_step`` range (``obs/trace.py``
  ``step_device_ms``). ``device_ms_per_step`` is the median busy sum of a
  step, the device time of its kernels, copies and sets, and
  ``device_images_per_sec`` / ``device_mfu`` follow from it;
  ``device_extent_ms_per_step`` is the median extent, first op start to
  last op end. The extent is not the step's device time here: inside the
  window the profiler's host cost for each op makes the host fall behind
  the card, which then waits (on an H100, 115–162 ms of extent against a
  62 ms fenced step and 57 ms busy at -b 128 in bf16).
- ``--compare`` (the default) adds ``f32_images_per_sec_per_chip`` and
  ``bf16_speedup_vs_f32``.

The measurement runs in a worker subprocess with a timeout; the worker
prints a cumulative line after each stage and, before its last, a
``{"launches": ...}`` line with each kernel wrapper's launches and the
steps of each stage, which the parent relays; the parent prints the
worker's last result line. ``n_chips`` is 1: the step runs on one card.
A ``bench_result`` event with the line's fields lands in
``<profile-dir>/events.jsonl``.

No fallback: on the CPU the worker runs only under ``--device cpu``; the
probe before each attempt passes only when a fresh process sees a CUDA
device; and when every attempt failed the parent prints the contract
keys with ``value`` 0.0, ``vs_baseline`` 0.0 and ``error`` and exits 1.

``vs_baseline`` divides by a pinned estimate of the reference's per-GPU
rate for this step, 900 images/s (the reference publishes none; override
with ``BDBNN_BENCH_BASELINE``).

Run on the card::

    python -m bdbnn_tpu_torch.scripts.bench [--batch 128] [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Tuple

from bdbnn_tpu_torch.obs.trace import BF16_PEAK_TFLOPS

BASELINE_IMAGES_PER_SEC_PER_CHIP = float(os.environ.get("BDBNN_BENCH_BASELINE", "900.0"))
METRIC = "train_step_images_per_sec_per_chip"
UNIT = "images/sec/chip"
# steps traced by profile_device; per-step numbers from the trace divide by it
PROFILE_TRACE_STEPS = 5
# windows taken at most when a trace lost device records
PROFILE_ATTEMPTS = 3
WARM_STEPS = 3
WINDOWS = 5
# the host range each traced step runs in (step_device_ms's prefix)
STEP_RANGE = "train_step"
# the port's one implementation: the hand-written kernels
CONV_IMPL = "kernels"
DEFAULT_PROFILE_DIR = os.path.join("perf_log", "bench")
FLOPS_SOURCE = (
    "3 x the forward FLOPs of every conv and dense layer, less the stem's input gradient, "
    "counted from obs/roofline.py model_layer_table on the meta device"
)
# the directory that holds the package: the worker runs ``-m`` from any cwd
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def train_flops_per_step(arch: str, dataset: str, batch: int,
                         image_size: Optional[int] = None) -> int:
    """FLOPs of one train step: the forward's conv and dense FLOPs three
    times (forward, input gradient, weight gradient), less the stem's
    input gradient, which nothing needs."""
    from bdbnn_tpu_torch.obs.roofline import model_layer_table

    rows = model_layer_table(arch, dataset, batch, image_size=image_size)
    return 3 * sum(r["flops"] for r in rows) - rows[0]["flops"]


def bench_step_config(kurt_paths):
    """BASELINE config 3's step: λ = 1 kurtosis toward 1.8 ('avg') on
    ``kurt_paths``, the conv weights after the stem."""
    from bdbnn_tpu_torch.train.state import StepConfig

    paths = tuple(kurt_paths)
    return StepConfig(w_kurtosis=True, kurt_paths=paths, kurt_targets=(1.8,) * len(paths),
                      kurtosis_mode="avg", w_lambda_kurtosis=1.0)


def build_step(dtype: str, batch: int, *, arch: str = "resnet18", dataset: str = "imagenet",
               image_size: int = 224, device="cuda"):
    """The flagship train step and its inputs (the reference's
    ``_build_step``): ``(step, state, (x, y), tk, gate)``. The model's
    weights come from ``torch.Generator().manual_seed(0)``, x from
    ``default_rng(0).normal`` and the labels from ``default_rng(1)
    .integers(0, classes)``, both on ``device``; Adam-linear at lr 1e-3
    over 90 epochs of 1,000 steps; ``tk`` (1, 1) and the kurtosis gate 1.
    The binarizer family is the reference's default, ste."""
    import numpy as np
    import torch

    from bdbnn_tpu_torch import resolve_device
    from bdbnn_tpu_torch.models import conv_weight_paths, create_model
    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.train.loop import shape_tree
    from bdbnn_tpu_torch.train.optim import make_optimizer
    from bdbnn_tpu_torch.train.state import TrainState
    from bdbnn_tpu_torch.train.step import make_train_step

    dev = resolve_device(device)
    set_active_family(resolve_family())
    model = create_model(arch, dataset, dtype=dtype,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, image_size, image_size, 3)).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.fc.out_features, size=(batch,))).to(dev)
    cfg = bench_step_config(conv_weight_paths(shape_tree(model))[1:])
    opt = make_optimizer(model, dataset="imagenet", lr=1e-3, epochs=90, steps_per_epoch=1000)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg)
    return step, state, (x, y), (1.0, 1.0), 1.0


def measure(step, state, batch_xy, tk, gate, iters: int, windows: int = WINDOWS):
    """Median images/s over ``windows`` fenced windows of ``iters``
    chained steps, after WARM_STEPS warm steps: each window ends with the
    loss read on the host. Returns (rate, state)."""
    n = int(batch_xy[0].shape[0])
    m = None
    for _ in range(WARM_STEPS):
        state, m = step(state, batch_xy, tk, gate)
    loss = float(m["loss"])
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = step(state, batch_xy, tk, gate)
        loss = float(m["loss"])
        rates.append(iters * n / (time.perf_counter() - t0))
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss in bench: {loss}")
    rates.sort()
    return rates[len(rates) // 2], state


def profile_device(step, state, batch_xy, tk, gate, trace_dir: str,
                   steps: int = PROFILE_TRACE_STEPS) -> Dict[str, Any]:
    """A ``steps``-step profiler window (``TraceCapture``, the absorbing
    burst on a card), each step inside a ``train_step`` range; a window
    whose trace lost device records is taken again, up to
    PROFILE_ATTEMPTS. Returns ``{"state", "trace", "events", "windows",
    "lost_records", "device", "launches"}`` (``events`` the trace's,
    loaded once): ``device`` is
    :func:`~bdbnn_tpu_torch.obs.trace.step_device_ms` of the kept trace,
    ``launches`` the kernel wrappers' launches in its window."""
    from bdbnn_tpu_torch.obs.launches import launch_counts
    from bdbnn_tpu_torch.obs.trace import (
        TraceCapture,
        find_trace_file,
        load_trace_events,
        lost_device_records,
        span,
        step_device_ms,
    )

    device = batch_xy[0].device
    trace, events, lost, windows, launches = None, [], 0, 0, {}
    for windows in range(1, PROFILE_ATTEMPTS + 1):
        before = launch_counts()
        cap = TraceCapture(trace_dir, [(0, 0, steps)], device=device)
        cap.maybe_start(0, 0)
        try:
            for _ in range(steps):
                with span(STEP_RANGE):
                    state, m = step(state, batch_xy, tk, gate)
            float(m["loss"])  # the window's device work has landed
        finally:
            cap.stop_if_active()
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        trace = find_trace_file(trace_dir)  # the newest: this window's
        if trace is None:
            raise RuntimeError(f"bench: the profiler window wrote no trace under {trace_dir}")
        events = load_trace_events(trace)
        lost = lost_device_records(events)
        if not lost:
            break
    return {"state": state, "trace": trace, "events": events, "windows": windows,
            "lost_records": lost, "device": step_device_ms(events, STEP_RANGE),
            "launches": launches}


def device_rates(batch: int, busy_ms: float, flops: float,
                 peak: Optional[float]) -> Tuple[float, Optional[float]]:
    """``(device_images_per_sec, device_mfu)`` of a step whose device busy
    time is ``busy_ms`` (``device_mfu`` None without a peak)."""
    rate = batch / (busy_ms / 1e3)
    mfu = round(flops * rate / batch / (peak * 1e12), 4) if peak else None
    return round(rate, 2), mfu


def _device_info(device) -> Dict[str, Any]:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(device)}
    return {"platform": device.type, "device_kind": device.type}


def _stage_launches(start: Dict[str, int], steps: int) -> Dict[str, int]:
    """The steps of one stage of the worker's run and each kernel's
    launches since ``start`` (a ``launch_counts()`` taken as it began)."""
    from bdbnn_tpu_torch.obs.launches import launch_counts

    now = launch_counts()
    return {"steps": int(steps), **{k: now[k] - start[k] for k in now}}


def worker_main(args, **build_kw) -> None:
    """The staged measurement (the module docstring); ``build_kw`` goes to
    :func:`build_step` (a test's small model on the CPU)."""
    import torch

    from bdbnn_tpu_torch import resolve_device
    from bdbnn_tpu_torch.obs.launches import launch_counts

    dev = resolve_device(args.device)
    build_kw = {"device": dev, **build_kw}
    info = _device_info(dev)
    peak = BF16_PEAK_TFLOPS.get(info["device_kind"])
    _log(f"device {dev}: {info['device_kind']}")

    # bench rounds land in <profile_dir>/events.jsonl; a writer failure
    # (a read-only dir) must not break the measurement
    events = None
    if args.profile_dir:
        try:
            from bdbnn_tpu_torch.obs.events import EventWriter

            events = EventWriter(args.profile_dir)
        except OSError as e:
            _log(f"event channel disabled: {e}")

    arch = build_kw.get("arch", "resnet18")
    dataset = build_kw.get("dataset", "imagenet")
    flops = float(train_flops_per_step(arch, dataset, args.batch,
                                       build_kw.get("image_size", 224)))
    rates: Dict[str, float] = {}
    extras: Dict[str, Any] = {
        "batch": args.batch,
        "n_chips": 1,
        **info,
        "bf16_peak_tflops": peak,
        "fencing": "loss read on the host per window, median of windows",
        "flops_per_step": flops,
        "gflops_per_image": round(flops / args.batch / 1e9, 3),
        "flops_source": FLOPS_SOURCE,
    }

    def emit() -> None:
        out = {
            "metric": METRIC,
            "value": round(rates[CONV_IMPL], 2),
            "unit": UNIT,
            "vs_baseline": round(rates[CONV_IMPL] / BASELINE_IMAGES_PER_SEC_PER_CHIP, 3),
            "dtype": "bfloat16",
            "conv_impl": CONV_IMPL,
            "impl_rates": {k: round(v, 2) for k, v in rates.items()},
            **extras,
        }
        if peak:
            achieved = flops / args.batch * rates[CONV_IMPL]
            out["achieved_tflops"] = round(achieved / 1e12, 2)
            out["mfu"] = round(achieved / (peak * 1e12), 4)
            out["timing_suspect"] = bool(out["mfu"] > 1.0)
        print(json.dumps(out), flush=True)
        if events is not None:
            events.emit("bench_result", **out)

    launches: Dict[str, Dict[str, int]] = {}
    start = launch_counts()
    _log("building the bf16 step")
    step, state, batch_xy, tk, gate = build_step("bfloat16", args.batch, **build_kw)
    rate, state = measure(step, state, batch_xy, tk, gate, args.iters)
    rates[CONV_IMPL] = rate
    _log(f"bf16: {rate:.1f} images/s (fenced)")
    emit()

    if args.profile_dir:
        prof = profile_device(step, state, batch_xy, tk, gate,
                              os.path.join(args.profile_dir, "trace"))
        state, dev_ms = prof["state"], prof["device"]
        _log(f"profile: {prof['windows']} window(s), the kept one lost "
             f"{prof['lost_records']} device records; {prof['trace']}")
        if dev_ms:
            busy = dev_ms["busy_median_ms"]
            extras["device_ms_per_step"] = round(busy, 3)
            extras["device_extent_ms_per_step"] = round(dev_ms["ms"], 3)
            rate, mfu = device_rates(args.batch, busy, flops, peak)
            extras["device_images_per_sec"] = rate
            if mfu is not None:
                extras["device_mfu"] = mfu
        extras["profile_trace"] = prof["trace"]
        emit()
    launches["bf16"] = _stage_launches(start, state.step)
    del step, state, batch_xy
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if args.compare:
        start = launch_counts()
        _log("building the f32 step")
        step, state, batch_xy, tk, gate = build_step("float32", args.batch, **build_kw)
        f32, state = measure(step, state, batch_xy, tk, gate, args.iters)
        launches["f32"] = _stage_launches(start, state.step)
        extras["f32_images_per_sec_per_chip"] = round(f32, 2)
        extras["bf16_speedup_vs_f32"] = round(rates[CONV_IMPL] / f32, 3)
        _log(f"f32: {f32:.1f} images/s (fenced)")
    print(json.dumps({"launches": launches}), flush=True)
    emit()
    if events is not None:
        events.close()


def _probe_backend(timeout_s: float, device: str):
    """(ok, failure detail): can a fresh process see the device and run
    one small computation on it within ``timeout_s``? A CUDA device, unless
    ``device`` asks for the CPU."""
    code = (
        "import torch;"
        f"d = torch.device({device!r});"
        "d.type == 'cuda' and not torch.cuda.is_available() and "
        "exit('no CUDA device');"
        "x = torch.ones((128, 128), device=d);"
        "print('PROBE_OK', float(x.sum()), "
        "torch.cuda.get_device_name(d) if d.type == 'cuda' else d.type)"
    )
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"no reachable device within {timeout_s:.0f}s (hang)"
    if "PROBE_OK" in (proc.stdout or ""):
        return True, ""
    return False, (f"probe exited rc={proc.returncode}: "
                   + (proc.stderr or proc.stdout or "")[-300:].strip())


def _json_lines(text: str):
    """The lines of ``text`` that are JSON objects, oldest first."""
    out = []
    for line in (text or "").splitlines():
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            out.append(line)
    return out


def _relay(stdout: str) -> bool:
    """Print the worker's launches line and its last result line; False
    when it printed no result line."""
    lines = _json_lines(stdout)
    results = [ln for ln in lines if not ln.startswith('{"launches"')]
    if not results:
        return False
    for ln in lines:
        if ln.startswith('{"launches"'):
            print(ln)
    print(results[-1], flush=True)
    return True


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--attempts", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=540.0)
    ap.add_argument("--probe-timeout", type=float, default=150.0,
                    help="seconds the probe before each attempt may take (0 = no probe)")
    ap.add_argument("--profile-dir",
                    default=os.environ.get("BDBNN_BENCH_PROFILE_DIR", DEFAULT_PROFILE_DIR),
                    help="take a profiler window and write its trace and events.jsonl here "
                         "('' = skip); the trace backs device_ms_per_step / device_mfu")
    ap.add_argument("--no-compare", dest="compare", action="store_false",
                    help="skip the f32 comparison run")
    # accepted and ignored, as the reference accepts it
    ap.add_argument("--no-int8", dest="try_int8", action="store_false", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda",
                    help="the worker's device; only 'cpu' runs it without a card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        worker_main(args)
        return 0

    err_tail = ""
    for attempt in range(args.attempts):
        if args.probe_timeout > 0:
            ok, detail = _probe_backend(args.probe_timeout, args.device)
            if not ok:
                err_tail = f"attempt {attempt + 1}: backend probe failed: {detail}"
                print(f"[bench] {err_tail}", file=sys.stderr)
                if attempt < args.attempts - 1:
                    time.sleep(min(120.0, 30.0 * (attempt + 1)))
                continue
        cmd = [sys.executable, "-m", "bdbnn_tpu_torch.scripts.bench", "--worker",
               "--batch", str(args.batch), "--iters", str(args.iters),
               "--profile-dir", os.path.abspath(args.profile_dir) if args.profile_dir else "",
               "--device", args.device]
        if not args.compare:
            cmd.append("--no-compare")
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)}
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                                  env=env)
        except subprocess.TimeoutExpired as e:
            # a cumulative line per stage: a timeout mid-stage still
            # leaves a usable last line
            partial = e.stdout or b""
            if isinstance(partial, bytes):
                partial = partial.decode(errors="replace")
            if _relay(partial):
                return 0
            err_tail = f"attempt {attempt + 1}: timeout after {args.timeout}s"
            print(f"[bench] {err_tail}", file=sys.stderr)
            if attempt < args.attempts - 1:
                time.sleep(min(30.0, 5.0 * (attempt + 1)))
            continue
        sys.stderr.write(proc.stderr or "")
        if _relay(proc.stdout):
            return 0
        err_tail = (proc.stderr or proc.stdout or "")[-800:]
        print(f"[bench] attempt {attempt + 1} failed rc={proc.returncode}", file=sys.stderr)
        if attempt < args.attempts - 1:
            time.sleep(min(30.0, 5.0 * (attempt + 1)))

    print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0,
                      "error": f"all {args.attempts} attempts failed: {err_tail}"}), flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
