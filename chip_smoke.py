"""Chip smoke test of the PyTorch/CUDA port (``bdbnn_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — requires CUDA; prints ``nvidia-smi`` name and power limit;
2. build   — builds every kernel from ``bdbnn_tpu_torch/csrc`` with nvcc
             (one process per source, all at once) and prints seconds;
3. kernels — holds K1 (fused sign + binary conv), K2 (weight sign +
             alpha), K3 (packbits decode) and K4 (XNOR-popcount conv)
             against their plain PyTorch versions on the card at four of
             the flagship's conv shapes (batch 32): bitwise for K1, K3,
             K4 and K2's sign, relative 1e-6 for K2's alpha. Times each
             with CUDA events after a warm-up, beside its plain version,
             ``F.conv2d`` on the same ±1 operands (K1/K4, TF32 off, a
             yardstick only) and the least time the card could take;
4. main    — builds the full-width ImageNet ``resnet18`` (react) from a
             seeded ``torch.Generator`` with non-trivial BN statistics,
             act_shifts and RPReLU vectors, writes an export artifact,
             and serves it through ``InferenceEngine`` on the card in
             dense, packed/unpack and packed/popcount modes at n = 1, 8,
             32 and 33. Logits must be finite, bitwise equal across the
             three modes, and close to the same artifact served on the
             CPU (plain versions); every kernel's launch count over that
             run must be what 19 binary convs a forward require. Then
             ``python -m bdbnn_tpu_torch.cli predict`` must exit 0;
             ``time_step`` is printed per bucket and mode, and a
             torch.profiler breakdown of one bucket-32 forward;
5. output  — one ``{"kernels": [...]}`` line, then as the last line
             ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 peaks (NVIDIA data sheets, dense): int8 tensor TOP/s, f32
# (non-tensor) TFLOP/s, HBM TB/s — keyed by the form factor nvidia-smi
# names; the SXM part is the default.
PEAKS = {
    "SXM": {"int8_tops": 1979.0, "f32_tflops": 67.0, "hbm_tbs": 3.35},
    "PCIe": {"int8_tops": 1513.0, "f32_tflops": 51.0, "hbm_tbs": 2.0},
}

BATCH = 32
# (name, H=W of the conv input, C, O, k, stride)
SHAPES = [
    ("layer1 3x3 s1 64->64 @56", 56, 64, 64, 3, 1),
    ("layer2_0.conv1 3x3 s2 64->128 @56", 56, 64, 128, 3, 2),
    ("layer2_0.downsample 1x1 64->128 @28", 28, 64, 128, 1, 1),
    ("layer4 3x3 s1 512->512 @7", 7, 512, 512, 3, 1),
]
N_BINARY_CONVS = 19
# card vs CPU engine on exact-stem inputs: everything up to the global
# average pool is then bitwise equal, and the pool's and the classifier's
# float32 sums (other orders on the two devices) move the logits by a
# few ulps — 1e-5 of the largest |logit| bounds that with a wide margin
CPU_LOGIT_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str):
    key = "PCIe" if "pcie" in name.lower() else "SXM"
    return key, PEAKS[key]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_peak: float, pk) -> tuple:
    """(least ms, what bounds it): bytes over HBM rate vs ops over peak."""
    t_bytes = bytes_moved / (pk["hbm_tbs"] * 1e12) * 1e3
    t_ops = ops / (ops_peak * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(pk):
    """Hold every kernel against its plain version at flagship shapes;
    returns per-kernel records (without ``launches``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bdbnn_tpu_torch.nn import packed as P
    from bdbnn_tpu_torch.nn.kernels import (
        binary_conv2d,
        binary_conv2d_plain,
        weight_binarize,
        weight_binarize_plain,
    )
    from bdbnn_tpu_torch.nn.kernels.binary_conv import binarize_input

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    recs = {k: {"shapes": []} for k in ("K1", "K2", "K3", "K4")}
    ok = True
    for name, hw, c, o, k, s in SHAPES:
        pad = k // 2
        ho = (hw + 2 * pad - k) // s + 1
        m = BATCH * ho * ho
        kk = k * k * c
        x = torch.randn((BATCH, hw, hw, c), generator=g, device=dev)
        shift = 0.1 * torch.randn((c,), generator=g, device=dev)
        w = 0.05 * torch.randn((k, k, c, o), generator=g, device=dev)
        st = (s, s)

        # K2
        sign, alpha = weight_binarize(w)
        psign, palpha = weight_binarize_plain(w)
        torch.cuda.synchronize()
        k2_sign_ok = torch.equal(sign, psign)
        k2_err = float((alpha - palpha).abs().max())
        k2_ok = k2_sign_ok and bool(torch.allclose(alpha, palpha, rtol=1e-6, atol=0))
        # K3
        packed = torch.from_numpy(np.packbits((w >= 0).cpu().numpy().reshape(-1))).to(dev)
        dense = P.packed_dense_weight(packed, alpha, (k, k, c, o))
        pdense = P.packed_dense_weight_plain(packed, alpha, (k, k, c, o))
        torch.cuda.synchronize()
        k3_ok = torch.equal(dense, pdense)
        # K1 / K4
        y1 = binary_conv2d(x, sign, alpha, shift=shift, strides=st)
        py = binary_conv2d_plain(x, sign, alpha, shift=shift, strides=st)
        y4 = P.popcount_binary_conv(x, sign, alpha, shift=shift, strides=st)
        py4 = P.popcount_binary_conv_plain(x, sign, alpha, shift=shift, strides=st)
        torch.cuda.synchronize()
        k1_err = float((y1 - py).abs().max())
        k4_err = max(float((y4 - py4).abs().max()), float((y4 - y1).abs().max()))
        k1_ok = torch.equal(y1, py)
        k4_ok = torch.equal(y4, py4) and torch.equal(y4, y1)
        # library yardstick: F.conv2d on the same ±1 operands, TF32 off
        xb = binarize_input(x, shift).permute(0, 3, 1, 2)
        wf = sign.permute(0, 3, 1, 2).to(torch.float32).contiguous(memory_format=torch.channels_last)
        lib_fn = lambda: F.conv2d(xb, wf, stride=st, padding=pad)
        lib_y = lib_fn().permute(0, 2, 3, 1) * alpha
        torch.cuda.synchronize()
        lib_err = float((lib_y - y1).abs().max())

        lib_ms = cuda_ms(lib_fn, 20)
        t = {
            "K1": (cuda_ms(lambda: binary_conv2d(x, sign, alpha, shift=shift, strides=st), 20),
                   cuda_ms(lambda: binary_conv2d_plain(x, sign, alpha, shift=shift, strides=st), 5),
                   lib_ms),
            "K4": (cuda_ms(lambda: P.popcount_binary_conv(x, sign, alpha, shift=shift, strides=st), 20),
                   cuda_ms(lambda: P.popcount_binary_conv_plain(x, sign, alpha, shift=shift, strides=st), 2, 1),
                   lib_ms),
            "K2": (cuda_ms(lambda: weight_binarize(w), 50),
                   cuda_ms(lambda: weight_binarize_plain(w), 20), None),
            "K3": (cuda_ms(lambda: P.packed_dense_weight(packed, alpha, (k, k, c, o)), 50),
                   cuda_ms(lambda: P.packed_dense_weight_plain(packed, alpha, (k, k, c, o)), 20), None),
        }
        conv_bytes = BATCH * hw * hw * c * 4 + o * kk + o * 4 + c * 4 + m * o * 4
        conv_bound = bound(conv_bytes, 2.0 * m * o * kk, pk["int8_tops"], pk)
        nw = kk * o
        bounds = {
            "K1": conv_bound,
            "K4": conv_bound,
            "K2": bound(nw * 4 + nw + o * 4, 3.0 * nw, pk["f32_tflops"], pk),
            "K3": bound((nw + 7) // 8 + o * 4 + nw * 4, 1.0 * nw, pk["f32_tflops"], pk),
        }
        errs = {"K1": k1_err, "K2": k2_err, "K3": float((dense - pdense).abs().max()),
                "K4": k4_err}
        oks = {"K1": k1_ok, "K2": k2_ok, "K3": k3_ok, "K4": k4_ok}
        for kname in ("K1", "K2", "K3", "K4"):
            ms, plain_ms, lib_ms = t[kname]
            recs[kname]["shapes"].append({
                "shape": name, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
                "max_abs_err": errs[kname], "ok": bool(oks[kname]),
            })
            log(f"[kernels] {kname} {name}: ok={oks[kname]} max_abs_err={errs[kname]} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                f"bound_ms={bounds[kname][0]:.4f} ({bounds[kname][1]})")
            ok = ok and bool(oks[kname])
        log(f"[kernels] F.conv2d yardstick vs K1 {name}: max_abs_err={lib_err}")
        del x, y1, py, y4, py4, xb, lib_y
        torch.cuda.empty_cache()
    return recs, ok


def make_flagship_artifact(out_dir: str):
    """Full-width ImageNet resnet18 (react) from a seeded generator, with
    non-trivial BN statistics, act_shifts and RPReLU vectors. The stem
    conv's weights are rounded to multiples of 2^-10: on images with
    entries in {-1, 0, 1} its sums are then exact in float32 in any
    order, so the card and the CPU feed the first sign bit-identical
    values (see phase_main)."""
    import torch

    from bdbnn_tpu_torch.models import create_model
    from bdbnn_tpu_torch.nn.layers import BatchNorm, BinaryConvReact, RPReLU
    from bdbnn_tpu_torch.serve.export import write_artifact

    g = torch.Generator().manual_seed(0)
    model = create_model("resnet18", "imagenet", generator=g)
    with torch.no_grad():
        model.conv1.weight.copy_(torch.round(model.conv1.weight * 1024.0) / 1024.0)
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.weight.numel()
                mod.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
                mod.bias.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
            elif isinstance(mod, BinaryConvReact):
                mod.act_shift.copy_(0.1 * torch.randn(mod.act_shift.numel(), generator=g))
            elif isinstance(mod, RPReLU):
                n = mod.slope.numel()
                mod.gamma.copy_(0.1 * torch.randn(n, generator=g))
                mod.zeta.copy_(0.1 * torch.randn(n, generator=g))
                mod.slope.copy_(0.1 + 0.3 * torch.rand(n, generator=g))
    write_artifact(model.to_flax(), out_dir, arch="resnet18", dataset="imagenet")


def wrappers():
    from bdbnn_tpu_torch.nn import packed as P
    from bdbnn_tpu_torch.nn.kernels import binary_conv2d, weight_binarize

    return {
        "K1": binary_conv2d,
        "K2": weight_binarize,
        "K3": P.packed_dense_weight,
        "K4": P.popcount_binary_conv,
    }


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def phase_main(art: str):
    """Serve the flagship in three modes; returns (launch counts, ok)."""
    import numpy as np

    from bdbnn_tpu_torch.serve.engine import InferenceEngine, max_abs_logit_drift

    ok = True
    modes = {
        "dense": {},
        "unpack": {"packed": True, "packed_impl": "unpack"},
        "popcount": {"packed": True, "packed_impl": "popcount"},
    }
    t0 = time.perf_counter()
    engines = {k: InferenceEngine(art, buckets=(1, 8, 32), device="cuda", **kw)
               for k, kw in modes.items()}
    log(f"[main] three engines built and warmed in {time.perf_counter() - t0:.2f}s "
        f"(first-run seconds: {[e.compile_seconds for e in engines.values()]})")
    rng = np.random.default_rng(0)
    sizes = (1, 8, 32, 33)
    images = {n: rng.normal(size=(n, 224, 224, 3)).astype(np.float32) for n in sizes}
    # forwards per mode: bucket 1, 8, 32, and 33 = 32 + 1
    forwards = 5
    reset_counts()
    out = {m: {n: engines[m].predict_logits(images[n]) for n in sizes} for m in modes}
    counts = {k: fn.launches for k, fn in wrappers().items()}
    want = {
        "K1": 2 * forwards * N_BINARY_CONVS,
        "K2": 3 * forwards * N_BINARY_CONVS,
        "K3": 2 * forwards * N_BINARY_CONVS,
        "K4": forwards * N_BINARY_CONVS,
    }
    log(f"[main] launches {counts} (expected {want})")
    if counts != want:
        log("[main] FAIL: launch counts differ from 19 binary convs a forward")
        ok = False
    for n in sizes:
        d = out["dense"][n]
        if d.shape != (n, 1000) or not np.all(np.isfinite(d)):
            log(f"[main] FAIL: n={n} logits shape {d.shape} or not finite")
            ok = False
        for m in ("unpack", "popcount"):
            if not np.array_equal(out[m][n].view(np.uint32), d.view(np.uint32)):
                log(f"[main] FAIL: n={n} {m} logits differ from dense by "
                    f"{max_abs_logit_drift(out[m][n], d)}")
                ok = False
    log(f"[main] logits finite, shape (n, 1000), bitwise equal across dense/unpack/popcount: {ok}")

    # the same artifact on the CPU (plain versions). Gate: images in
    # {-1, 0, 1}, so the stem is exact on both devices (see
    # make_flagship_artifact) and any sign that differs is a fault. For
    # information: the normal images, where last-ulp differences of the
    # stem conv can flip a pre-sign value that sits at its threshold,
    # and the binary layers carry the flip on.
    t0 = time.perf_counter()
    cpu = InferenceEngine(art, buckets=(1, 8, 32), device="cpu")
    tern = {n: rng.integers(-1, 2, size=(n, 224, 224, 3)).astype(np.float32) for n in sizes}
    drift, scale, top1_equal = 0.0, 0.0, True
    for n in sizes:
        c = cpu.predict_logits(tern[n])
        d = engines["dense"].predict_logits(tern[n])
        drift = max(drift, float(np.max(np.abs(c - d))))
        scale = max(scale, float(np.max(np.abs(c))))
        top1_equal = top1_equal and bool(np.array_equal(c.argmax(-1), d.argmax(-1)))
    rel = drift / max(scale, 1e-30)
    log(f"[main] CPU engine (plain versions) vs card, exact-stem images: "
        f"max_abs_logit_drift={drift} max|logit|={scale} relative={rel} "
        f"(tol {CPU_LOGIT_TOL}) top1_equal={top1_equal}")
    if not (rel <= CPU_LOGIT_TOL and top1_equal):
        log("[main] FAIL: card and CPU engines disagree")
        ok = False
    rows, moved, same_top1 = 0, 0, 0
    for n in sizes:
        c = cpu.predict_logits(images[n])
        d = out["dense"][n]
        row_rel = np.max(np.abs(c - d), axis=-1) / np.max(np.abs(c), axis=-1)
        rows += n
        moved += int(np.sum(row_rel > CPU_LOGIT_TOL))
        same_top1 += int(np.sum(c.argmax(-1) == d.argmax(-1)))
    log(f"[main] CPU vs card, normal images (information): {moved}/{rows} rows beyond "
        f"{CPU_LOGIT_TOL} relative, top-1 equal on {same_top1}/{rows} "
        f"({time.perf_counter() - t0:.1f}s on the CPU)")

    for m, e in engines.items():
        steps = {b: e.time_step(bucket=b, iters=10) for b in e.buckets}
        log(f"[main] time_step ms {m}: {steps}")
    for m in ("dense", "popcount"):
        profile_forward(engines[m], m, 32)
    return counts, ok


def profile_forward(engine, mode: str, bucket: int, iters: int = 5) -> None:
    """Where one forward's time goes: device time by kernel name
    (torch.profiler, CUPTI) against the host wall of the same window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros((bucket, 224, 224, 3), device="cuda")
    engine._forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine._forward(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    per_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3 / iters
    busy = sum(per_kernel.values())
    if busy == 0:
        log(f"[profile] {mode} bucket {bucket}: the profiler saw no device time (not measured)")
        return
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {mode} bucket {bucket}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"host wall per forward (busy share {busy / wall_ms:.3f})")
    for name, ms in top:
        log(f"[profile]   {ms:8.4f} ms  {name[:100]}")


def phase_cli(art: str) -> bool:
    cmd = [sys.executable, "-m", "bdbnn_tpu_torch.cli", "predict", art,
           "--synthetic", "--synthetic-val-size", "64"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    log(f"[cli] {' '.join(cmd[1:])} -> exit {r.returncode} in {time.perf_counter() - t0:.1f}s")
    if r.returncode != 0:
        log(r.stdout[-2000:] + r.stderr[-4000:])
        return False
    res = json.loads(r.stdout)
    log(f"[cli] top1={res['top1']} count={res['count']} device={res['device']}")
    return res["count"] == 64 and res["device"].startswith("cuda")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false — this needs a CUDA card")
        return 1
    from bdbnn_tpu_torch.nn.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(smi_line)
    kind = torch.cuda.get_device_name(0)
    form, pk = peaks_for(smi_line)
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"peaks used for bounds: H100 {form} {pk}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {secs} wall {time.perf_counter() - t0:.2f}s into {_build.BUILD_DIR}")

    recs, ok_k = phase_kernels(pk)
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "resnet18_react")
        t0 = time.perf_counter()
        make_flagship_artifact(art)
        log(f"[main] wrote flagship artifact in {time.perf_counter() - t0:.1f}s")
        counts, ok_m = phase_main(art)
        ok_c = phase_cli(art)

    sources = {"K1": "bdbnn_tpu_torch/csrc/binary_conv.cu",
               "K2": "bdbnn_tpu_torch/csrc/weight_binarize.cu",
               "K3": "bdbnn_tpu_torch/csrc/packed.cu",
               "K4": "bdbnn_tpu_torch/csrc/packed.cu"}
    names = {"K1": "binary_conv2d (fused sign + binary conv fwd)",
             "K2": "weight_binarize (weight sign + alpha)",
             "K3": "packed_dense_weight (packbits decode)",
             "K4": "popcount_binary_conv (XNOR-popcount conv fwd)"}
    replaces = {"K1": "bdbnn_tpu/nn/kernels/binary_conv.py:92",
                "K2": "bdbnn_tpu/nn/binarize.py:466",
                "K3": "bdbnn_tpu/nn/packed.py:131",
                "K4": "bdbnn_tpu/nn/packed.py:161"}
    kernels = []
    for k in ("K1", "K2", "K3", "K4"):
        sh = recs[k]["shapes"]
        lib = [s["library_ms"] for s in sh]
        main_bound = max(sh, key=lambda s: s["bound_ms"])
        kernels.append({
            "name": f"{k} {names[k]}",
            "route": "cuda",
            "source": sources[k],
            "replaces": replaces[k],
            "launches": counts.get(k, 0),
            "max_abs_err": max(s["max_abs_err"] for s in sh),
            # sums over the four flagship shapes (batch 32) in "shapes"
            "ms": sum(s["ms"] for s in sh),
            "plain_ms": sum(s["plain_ms"] for s in sh),
            "bound_ms": sum(s["bound_ms"] for s in sh),
            "bound_by": main_bound["bound_by"],
            "library_ms": None if any(v is None for v in lib) else sum(lib),
            "shapes": sh,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    if not (ok_k and ok_m and ok_c):
        log(f"chip_smoke: FAILED (kernels={ok_k} main={ok_m} cli={ok_c})")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
