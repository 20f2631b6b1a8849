"""Microbenchmark of the binary conv, per layer shape — the port's
counterpart of the reference's ``bench_kernels.py``.

Times ``binary_conv2d_mxu`` (``nn/kernels/binary_conv.py``: the weight's
int8 sign layout, then K1) in f32 (``dot_f32``) and in K1's bf16 mode
(``dot_bf16``) at every binary conv shape of ImageNet binary ResNet-18
(the reference's ``SHAPES``; the stem and the classifier stay float),
each the median of 5 fenced windows (a window ends with one element read
on the host). A ``dot_bf16`` result more than 1.0 from ``dot_f32`` is an
error row, as in the reference. Each row also carries, on a card,

- ``k1_graph_ms``: K1 alone, the weight already in its int8 layout, as
  CUDA-graph replay (device time alone);
- ``conv2d_ms``: ``F.conv2d`` on the same ±1 operands, a yardstick only:
  f32 with TF32 off beside ``dot_f32``, bf16 channels_last beside
  ``dot_bf16``.

Run on the card::

    python -m bdbnn_tpu_torch.scripts.bench_kernels [--batch 64] [--out KERNELS.json]
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List

import numpy as np

# (name, H, W, C, O, k, stride): the binary convs of ImageNet binary
# ResNet-18 (the reference's list)
SHAPES = [
    ("layer1 3x3", 56, 56, 64, 64, 3, 1),
    ("layer2_ds 3x3/2", 56, 56, 64, 128, 3, 2),
    ("layer2 3x3", 28, 28, 128, 128, 3, 1),
    ("layer3_ds 3x3/2", 28, 28, 128, 256, 3, 2),
    ("layer3 3x3", 14, 14, 256, 256, 3, 1),
    ("layer4_ds 3x3/2", 14, 14, 256, 512, 3, 2),
    ("layer4 3x3", 7, 7, 512, 512, 3, 1),
]
# the largest |dot_bf16 - dot_f32| a row may show: bf16's rounding of
# alpha·dot stays well under 1
BF16_MAX_ABS_ERR = 1.0


def _fenced_ms(fn, iters: int, windows: int = 5) -> float:
    """Median ms per call over ``windows`` windows of ``iters`` calls, each
    ending with one element of the last result read on the host."""
    window_ms = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn()
        float(y[0, 0, 0, 0])
        window_ms.append(1e3 * (time.perf_counter() - t0) / iters)
    window_ms.sort()
    return window_ms[len(window_ms) // 2]


def _yardsticks(xb, wb, alpha, s: int, bf16: bool) -> Dict[str, float]:
    """K1 alone by graph replay and ``F.conv2d`` on the same operands."""
    import torch
    import torch.nn.functional as F

    from bdbnn_tpu_torch.nn.kernels import binary_conv2d
    from bdbnn_tpu_torch.nn.kernels.binary_conv import sign_int8_from_hwio
    from bdbnn_tpu_torch.obs.timing import cuda_ms, graph_ms

    dt = torch.bfloat16 if bf16 else torch.float32
    x, a = xb.to(dt).contiguous(), alpha.to(dt).contiguous()
    ws = sign_int8_from_hwio(wb)
    xc = x.permute(0, 3, 1, 2)
    wc = wb.to(dt).permute(3, 2, 0, 1)
    if bf16:
        xc = xc.contiguous(memory_format=torch.channels_last)
        wc = wc.contiguous(memory_format=torch.channels_last)
    else:
        xc, wc = xc.contiguous(), wc.contiguous()
    pad = wb.shape[0] // 2
    return {"k1_graph_ms": round(graph_ms(lambda: binary_conv2d(x, ws, a, strides=(s, s))), 4),
            "conv2d_ms": round(cuda_ms(lambda: F.conv2d(xc, wc, stride=s, padding=pad), 20), 4)}


def main(batch: int = 64, iters: int = 20, out_path: str = "",
         device="cuda") -> Dict[str, Any]:
    """Time every shape and impl, print a line a row and the summary, and
    return the summary (written to ``out_path`` too when it is given)."""
    import torch

    from bdbnn_tpu_torch import resolve_device
    from bdbnn_tpu_torch.nn.kernels import binary_conv2d_mxu

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    results: List[Dict[str, Any]] = []
    try:
        for name, h, w, c, o, k, s in SHAPES:
            xb = torch.from_numpy(np.sign(rng.normal(size=(batch, h, w, c)) + 1e-9)
                                  .astype(np.float32)).to(dev)
            wb = torch.from_numpy(np.sign(rng.normal(size=(k, k, c, o)) + 1e-9)
                                  .astype(np.float32)).to(dev)
            alpha = torch.from_numpy(rng.uniform(0.1, 1.0, size=(o,)).astype(np.float32)).to(dev)
            xh, wh = xb.to(torch.bfloat16), wb.to(torch.bfloat16)
            impls = {
                "dot_f32": lambda: binary_conv2d_mxu(xb, wb, alpha, strides=(s, s)),
                "dot_bf16": lambda: binary_conv2d_mxu(xh, wh, alpha, strides=(s, s)),
            }
            ref = None
            for impl_name, fn in impls.items():
                try:
                    y = fn()
                    if cuda:
                        torch.cuda.synchronize(dev)
                except RuntimeError as e:  # record and move on
                    results.append({"shape": name, "impl": impl_name, "error": str(e)[:200]})
                    continue
                if ref is None:
                    ref = y.float()
                else:
                    err = float((y.float() - ref).abs().max())
                    if err > BF16_MAX_ABS_ERR:
                        results.append({"shape": name, "impl": impl_name,
                                        "error": f"mismatch vs f32 ref: {err}"})
                        continue
                ms = _fenced_ms(fn, iters)
                rec = {"shape": name, "impl": impl_name,
                       "images_per_sec": round(batch * 1e3 / ms, 1), "ms_per_call": round(ms, 3),
                       "k1_graph_ms": None, "conv2d_ms": None}
                if cuda:
                    rec.update(_yardsticks(xb, wb, alpha, s, impl_name == "dot_bf16"))
                results.append(rec)
                print(json.dumps(rec), flush=True)
            del xb, wb, xh, wh, ref
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    totals: Dict[str, float] = {}
    for r in results:
        if "ms_per_call" in r:
            totals[r["impl"]] = totals.get(r["impl"], 0.0) + r["ms_per_call"]
    summary = {
        "summary": "total ms across resnet18 binary convs",
        "totals_ms": {k: round(v, 3) for k, v in totals.items()},
        "winner": min(totals, key=totals.get) if totals else None,
        "platform": "gpu" if cuda else dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "batch": batch,
        "fencing": "one element read on the host per window, median of 5 windows",
        "yardsticks": ("k1_graph_ms: K1 alone on the int8 weight layout, CUDA-graph replay; "
                       "conv2d_ms: F.conv2d on the same ±1 operands, f32 with TF32 off "
                       "(dot_f32 rows) or bf16 channels_last (dot_bf16 rows)"),
        "results": results,
    }
    print(json.dumps(summary), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="", help="also write the summary JSON here")
    ap.add_argument("--device", default="cuda",
                    help="the device; only 'cpu' runs the plain versions without a card")
    a = ap.parse_args()
    main(batch=a.batch, iters=a.iters, out_path=a.out, device=a.device)
