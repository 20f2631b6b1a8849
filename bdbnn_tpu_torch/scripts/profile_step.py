"""A profile of the flagship train step on the card into ``PROFILE.json``
— the port's counterpart of the reference's ``profile_r05.py``.

Reuses the bench's step (BASELINE config 3: binary ResNet-18 react at
224², bf16, forward, backward, Adam and the 19-layer kurtosis), its
fenced measurement and its profiler window (``scripts/bench.py``), then
reads the window's trace three ways:

- ``device_ms_per_step_median``: a step's median device busy time
  (``obs/trace.py`` ``step_device_ms``; ``device_step_busy_ms`` each
  step's, ``device_extent_ms_per_step_median`` the median extent, which
  the profiler's host cost stretches: ``scripts/bench.py`` says why), and
  ``device_images_per_sec`` / ``device_mfu`` from it;
- ``device_time_breakdown_ms_per_step``: device ms a step by kernel name,
  the ten largest and ``other`` (``kernel_breakdown``);
- ``device_attribution_ms_per_step`` / ``device_attribution_mfu``: by
  the reference's span categories (``attribute_trace``), whose device-op
  sum a step is ``device_track_total_ms_per_step``.

The by-name groups cover every device op of the window, the steps' busy
sums only those launched inside a step's range: the two agree when no
device work runs outside the steps and the join lost none.

Beside them the host-fenced rate (``host_fenced_*``) and the kernel
wrappers' launches in the window. Writes ``PROFILE.json`` and a copy of
the trace (``train_step_trace.json.gz``) under ``--out-dir``, prints the
JSON and returns it from :func:`main`.

Run on the card::

    python -m bdbnn_tpu_torch.scripts.profile_step [--batch 128] [--iters 20]
        [--windows 5]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import sys
from typing import Any, Dict

from bdbnn_tpu_torch.scripts import bench

DEFAULT_OUT_DIR = os.path.join("perf_log", "profile")
TRACE_COPY = "train_step_trace.json.gz"


def main(argv=None, **build_kw) -> Dict[str, Any]:
    """Measure, profile and write ``PROFILE.json``; returns its dict.
    ``build_kw`` goes to :func:`bench.build_step` (a test's small model on
    the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--windows", type=int, default=bench.WINDOWS,
                    help="fenced windows of --iters steps before the profile")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="the device; only 'cpu' runs it without a card")
    args = ap.parse_args(argv)

    import torch

    from bdbnn_tpu_torch import resolve_device
    from bdbnn_tpu_torch.obs.trace import BF16_PEAK_TFLOPS, attribute_trace, kernel_breakdown

    device = resolve_device(args.device)
    info = bench._device_info(device)
    print(f"[profile] device: {info['device_kind']} ({info['platform']})", file=sys.stderr)
    build_kw = {"device": device, **build_kw}
    flops = float(bench.train_flops_per_step(build_kw.get("arch", "resnet18"),
                                             build_kw.get("dataset", "imagenet"), args.batch,
                                             build_kw.get("image_size", 224)))
    step, state, batch_xy, tk, gate = bench.build_step("bfloat16", args.batch, **build_kw)
    host_rate, state = bench.measure(step, state, batch_xy, tk, gate, args.iters, args.windows)
    prof = bench.profile_device(step, state, batch_xy, tk, gate,
                                os.path.join(args.out_dir, "trace"))
    trace, events, dev = prof["trace"], prof["events"], prof["device"] or {}
    steps = bench.PROFILE_TRACE_STEPS
    peak = BF16_PEAK_TFLOPS.get(info["device_kind"])
    breakdown, _ = kernel_breakdown(events, steps)
    attribution = attribute_trace(events, steps, flops_per_step=flops, peak_tflops=peak)
    dev_ms, extent = dev.get("busy_median_ms"), dev.get("ms")
    dev_rate, dev_mfu = bench.device_rates(args.batch, dev_ms, flops, peak) if dev_ms else (
        None, None)
    out = {
        "what": (
            "torch.profiler trace of 5 steps of the flagship bench workload: full BD-BNN train "
            "step (fwd + bwd + Adam + 19-layer kurtosis), binary ResNet-18 react @ 224x224, "
            f"bf16, batch {args.batch}, the hand-written kernels (K1, K2, K5, K6 bf16 modes, K7)"
        ),
        "captured": datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%MZ")
        + f" on {info['device_kind']} ({info['platform']})",
        "device_kind": info["device_kind"],
        "bf16_peak_tflops": peak,
        "trace_file": os.path.basename(trace),
        "flops_per_step": flops,
        "flops_source": bench.FLOPS_SOURCE,
        "gflops_per_image": round(flops / args.batch / 1e9, 3),
        "device_ms_per_step_median": round(dev_ms, 3) if dev_ms else None,
        "device_extent_ms_per_step_median": round(extent, 3) if extent else None,
        "device_step_busy_ms": [round(v, 3) for v in dev.get("busy_ms", [])],
        "device_images_per_sec": dev_rate,
        "device_mfu": dev_mfu,
        "host_fenced_median_img_per_sec": round(host_rate, 1),
        "host_fenced_ms_per_step": round(args.batch / host_rate * 1e3, 3),
        "host_fenced_mfu": (round(flops * host_rate / args.batch / (peak * 1e12), 4)
                            if peak else None),
        "device_time_breakdown_ms_per_step": breakdown,
        "device_attribution_ms_per_step": attribution["categories_ms_per_step"],
        "device_attribution_mfu": attribution["mfu"],
        "device_track_total_ms_per_step": attribution["step_total_ms"],
        "profile_windows": prof["windows"],
        "lost_device_records": prof["lost_records"],
        "launches_in_window": prof["launches"],
    }
    del step, state, batch_xy, events, prof
    if device.type == "cuda":
        torch.cuda.empty_cache()
    os.makedirs(args.out_dir, exist_ok=True)
    shutil.copy(trace, os.path.join(args.out_dir, TRACE_COPY))
    out_path = os.path.join(args.out_dir, "PROFILE.json")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    print(f"[profile] wrote {out_path}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
