"""Chip smoke test of the PyTorch/CUDA port (``bdbnn_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — requires CUDA; prints ``nvidia-smi`` name and power limit;
2. build   — builds every kernel from ``bdbnn_tpu_torch/csrc`` with nvcc
             (one process per source, all at once), prints seconds and the
             tensor-core instructions in K1's and K4's SASS;
3. kernels — holds K1 (fused sign + binary conv) and K4 (XNOR-popcount
             conv) against their plain PyTorch versions on the card at the
             flagship's ten distinct binary conv shapes at batch 32, and
             K1 also at -b 256, bitwise (and K4 against K1); then K2
             (weight sign + alpha) and K3 (packbits decode) at the same
             ten weights: bitwise for K3 and K2's sign, relative 1e-6 for
             K2's alpha, both bitwise across two runs. Times each with
             CUDA events after a warm-up, eager and as CUDA-graph replay
             (device time alone), beside its plain version, ``F.conv2d``
             on the same ±1 operands (K1/K4, f32 with TF32 off, a
             yardstick only; bf16 channels_last logged beside it) and the
             least time the card could take; K2 and K3 also over one
             forward's 19 weights in one graph;
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
             torch.profiler breakdown of one bucket-32 forward in each mode;
5. train_kernels — holds K5 (binary conv dgrad with the sign
             estimator's slope), K6 (binary conv wgrad with the STE mask)
             and K7 (grouped kurtosis regularizer and gradient) against
             their plain versions on the card at the shapes training gives
             them: K5/K6 at batch 256 and each of the flagship's ten
             distinct binary conv shapes (approx slope; ste, ede and prox
             at layer1), held to the float64 sum within 4·2^-24·Σ|terms|·
             |slope| + 2^-24·|exact| (the summation bound; the last term is
             the slope multiply's rounding) and to the plain version within
             8·2^-24·Σ|terms|·|slope| + 2^-24·|plain| (its im2col/col2im
             sums carry their own error of a few 2^-24·Σ|terms|), K5 and K6
             bitwise between two runs; K5 also on same-sign terms (|g|,
             all +1 signs) at layer4 3x3 s1 512->512, where no bias of the
             sum can cancel, to the same two bounds (against the plain
             version where it is itself within its float64 bound, see
             phase_k5_same_sign); K6 likewise at layer1 3x3 s1 64->64
             @56, where each sum runs over up to 802,816 positions
             (phase_k6_same_sign); K7 over the 19
             flagship tensors to rtol 1e-5 (bitwise across two runs, and
             its loss and kurt the same bits without the gradient). Times each beside its plain
             version, the least time the card could take, and
             torch.nn.grad.conv2d_input / conv2d_weight on the same ±1
             operands (TF32 off, a yardstick); K7 also as its device
             passes alone and as the whole call, each one CUDA graph.
             K5's and K6's bounds are at the bf16 tensor rate (6·MACs:
             three bf16 pieces of g·alpha), their f32 figure (2·MACs at
             67 TFLOP/s) is logged beside it;
6. train   — the training main path: ``fit`` on the full-width ImageNet
             resnet18 (react) flagship, synthetic 224² images, -b 256,
             --w-kurtosis --diffkurt, Adam, 5 steps and the eval pass, its
             metrics drained every 10 steps. Every step's loss must be
             finite and launch K1, K2, K5 and K6 19 times each and K7
             twice (the loss, and the binarization probes' grouped
             forward); each step is timed with CUDA events (step 0 is the
             warm-up). Then one step at batch 8 on the card and on the CPU
             (plain versions) from the same weights and batch: the loss
             terms, every gradient, every updated parameter and the batch
             statistics must agree (tolerances at phase_train_parity);
7. train-cede — ``fit`` on CIFAR resnet20 under --ede for 2 steps, so K5's
             EDE slope runs on the main path on the card;
8. train-cli — ``python -m bdbnn_tpu_torch.cli`` trains the flagship for 2
             steps as a subprocess and must exit 0;
9. profile — a train step of the flagship at -b 256 timed alone with CUDA
             events (images/s) and broken down by kernel with
             torch.profiler; the host input pipeline's transform and
             pinned copy of one batch are timed alone after [train];
10. train-stoch — the stochastic family in training: ``fit`` on ImageNet
             resnet18_step2 (the flagship's 19 binary convs, no act_shift,
             hardtanh) at -b 256 under --binarizer stochastic --w-kurtosis
             --diffkurt, Adam, 3 steps and the eval pass, with the same
             exact per-step launch counts as [train]; one step at batch 8
             on the card against the CPU on the same draws (MarginDraws,
             replayed), held as [train] holds its step; one -b 256 step
             replayed from the same state and (seed, step), bitwise; K1
             with the draw bitwise against its plain version and K6 with
             it within its summation bound at layer1 3x3, layer2_0.conv1
             s2 and layer4 3x3; a profile of the step naming torch.rand's
             share;
11. output — one ``{"kernels": [...]}`` line (K1-K7; ``launches_by_path``
             gives serve, train and train-stoch), then as the last line
             ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --weight-kernels`` runs phases 1-3 for K2, K3 and
K7 alone and prints their records as one JSON line: run from two trees in
turns, it compares their weight kernels on one card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 peaks (NVIDIA data sheets, dense): int8 and bf16 tensor TOP/s and
# TFLOP/s, f32 (non-tensor) TFLOP/s, HBM TB/s — keyed by the form factor
# nvidia-smi names; the SXM part is the default.
PEAKS = {
    "SXM": {"int8_tops": 1979.0, "bf16_tflops": 989.0, "f32_tflops": 67.0, "f64_tflops": 34.0,
            "hbm_tbs": 3.35},
    "PCIe": {"int8_tops": 1513.0, "bf16_tflops": 756.0, "f32_tflops": 51.0, "f64_tflops": 26.0,
             "hbm_tbs": 2.0},
}

# the largest serving bucket, where K1-K4 are held and timed
BATCH = 32
N_BINARY_CONVS = 19
# the flagship's distinct binary conv shapes and how many of its 19
# binary convs have each: (name, H=W of the conv input, C, O, k, stride,
# count); the 1x1 downsamples run on the avg-pooled input
FLAGSHIP_CONVS = [
    ("layer1 3x3 s1 64->64 @56", 56, 64, 64, 3, 1, 4),
    ("layer2_0.conv1 3x3 s2 64->128 @56", 56, 64, 128, 3, 2, 1),
    ("layer2_0.downsample 1x1 64->128 @28", 28, 64, 128, 1, 1, 1),
    ("layer2 3x3 s1 128->128 @28", 28, 128, 128, 3, 1, 3),
    ("layer3_0.conv1 3x3 s2 128->256 @28", 28, 128, 256, 3, 2, 1),
    ("layer3_0.downsample 1x1 128->256 @14", 14, 128, 256, 1, 1, 1),
    ("layer3 3x3 s1 256->256 @14", 14, 256, 256, 3, 1, 3),
    ("layer4_0.conv1 3x3 s2 256->512 @14", 14, 256, 512, 3, 2, 1),
    ("layer4_0.downsample 1x1 256->512 @7", 7, 256, 512, 1, 1, 1),
    ("layer4 3x3 s1 512->512 @7", 7, 512, 512, 3, 1, 3),
]
assert sum(cv[-1] for cv in FLAGSHIP_CONVS) == N_BINARY_CONVS
TRAIN_BATCH = 256
TRAIN_STEPS = 5
# the flagship recipe the train phases run (BASELINE config 3); metrics
# are drained every 10 steps, so fit's steps do not wait for the card
TRAIN_ARGS = dict(dataset="imagenet", arch="resnet18", synthetic=True, epochs=1, lr=1e-3,
                  w_kurtosis=True, diffkurt=True, seed=0, print_freq=10)
# card vs CPU plain train step at batch 8 (see phase_train_parity): the
# loss terms to this relative tolerance; each gradient to GRAD_TOL of
# its tensor's largest |entry| (the BN backward cancels heavily), as the
# CPU parity tests hold the port to the reference
TRAIN_LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
U = 2.0**-24
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


def graph_ms(fn, calls: int = 10) -> float:
    """Mean device ms per call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed, so no host time between launches counts."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, 5, 1) / calls
    del graph
    return ms


def bound(bytes_moved: float, ops: float, ops_peak: float, pk) -> tuple:
    """(least ms, what bounds it): bytes over HBM rate vs ops over peak."""
    t_bytes = bytes_moved / (pk["hbm_tbs"] * 1e12) * 1e3
    t_ops = ops / (ops_peak * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _conv_operands(g, batch, hw, c, o, k):
    import torch

    dev = torch.device("cuda")
    x = torch.randn((batch, hw, hw, c), generator=g, device=dev)
    shift = 0.1 * torch.randn((c,), generator=g, device=dev)
    w = 0.05 * torch.randn((k, k, c, o), generator=g, device=dev)
    return x, shift, w


def _conv_row(name, batch, count, ms, plain_ms, lib_ms, bnd, err, ok, **extra):
    return {"shape": f"{name} b{batch}", "count": count, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "max_abs_err": err,
            "ok": bool(ok), **extra}


def _log_row(kname, r) -> None:
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    more = "".join(f" {k}={r[k]:.4f}" for k in ("graph_ms", "library_graph_ms", "bf16_cudnn_ms")
                   if k in r)
    log(f"[kernels] {kname} {r['shape']} (x{r['count']} a pass): ok={r['ok']} "
        f"max_abs_err={r['max_abs_err']} kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"library_ms={lib} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}){more}")


def phase_kernels(pk):
    """Hold K1-K4 against their plain versions at the flagship's ten
    distinct binary conv shapes: K1-K4 at batch 32 (the largest serving
    bucket), K1 also at -b 256 (the training batch). Bitwise for K1, K3,
    K4 (against the plain version, and K4 against K1) and K2's sign,
    relative 1e-6 for K2's alpha. Times each with CUDA events beside its
    plain version, the least time the card could take and, for K1/K4,
    ``F.conv2d`` f32 on the same ±1 operands (TF32 off: the library
    yardstick) and, logged beside it, ``F.conv2d`` in bf16 channels_last
    (cuDNN on the tensor cores; another function, as bf16 rounds the
    output). K1, K4 and ``F.conv2d`` f32 are also timed as device time
    alone (:func:`graph_ms`), beside the eager time a caller sees.
    Returns per-kernel records (without ``launches``): K1's ``shapes`` at
    -b 256 and ``forward_shapes`` at batch 32."""
    import torch
    import torch.nn.functional as F

    from bdbnn_tpu_torch.nn import packed as P
    from bdbnn_tpu_torch.nn.kernels import binary_conv2d, binary_conv2d_plain, weight_binarize
    from bdbnn_tpu_torch.nn.kernels.binary_conv import binarize_input

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    recs = {k: {"shapes": []} for k in ("K1", "K4")}
    recs["K1"]["forward_shapes"] = []
    ok = True
    for name, hw, c, o, k, s, count in FLAGSHIP_CONVS:
        pad = k // 2
        ho = (hw + 2 * pad - k) // s + 1
        kk = k * k * c
        st = (s, s)
        for batch in (TRAIN_BATCH, BATCH):
            m = batch * ho * ho
            x, shift, w = _conv_operands(g, batch, hw, c, o, k)
            sign, alpha = weight_binarize(w)
            conv = lambda: binary_conv2d(x, sign, alpha, shift=shift, strides=st)
            plain = lambda: binary_conv2d_plain(x, sign, alpha, shift=shift, strides=st)
            y1, py = conv(), plain()
            # library yardsticks on the same ±1 operands: f32 (TF32 off),
            # and bf16 channels_last, what cuDNN reaches on the tensor cores
            xb = binarize_input(x, shift).permute(0, 3, 1, 2)
            wf = sign.permute(0, 3, 1, 2).to(torch.float32).contiguous(
                memory_format=torch.channels_last)
            xh, wh = xb.to(torch.bfloat16), wf.to(torch.bfloat16)
            lib_fn = lambda: F.conv2d(xb, wf, stride=st, padding=pad)
            lib_y = lib_fn().permute(0, 2, 3, 1) * alpha
            torch.cuda.synchronize()
            k1_ok = torch.equal(y1, py)
            log(f"[kernels] F.conv2d f32 yardstick vs K1 {name} b{batch}: "
                f"max_abs_err={float((lib_y - y1).abs().max())}")
            lib_ms = cuda_ms(lib_fn, 20)
            conv_bytes = batch * hw * hw * c * 4 + o * kk + o * 4 + c * 4 + m * o * 4
            conv_bound = bound(conv_bytes, 2.0 * m * o * kk, pk["int8_tops"], pk)
            # the eager time a caller sees, and the device time alone (graph)
            lib_graph = graph_ms(lib_fn)
            r1 = _conv_row(name, batch, count, cuda_ms(conv, 20), cuda_ms(plain, 5), lib_ms,
                           conv_bound, float((y1 - py).abs().max()), k1_ok,
                           graph_ms=graph_ms(conv), library_graph_ms=lib_graph,
                           bf16_cudnn_ms=cuda_ms(lambda: F.conv2d(xh, wh, stride=st,
                                                                  padding=pad), 20))
            recs["K1"]["shapes" if batch == TRAIN_BATCH else "forward_shapes"].append(r1)
            _log_row("K1", r1)
            ok = ok and k1_ok
            if batch == BATCH:
                # K4 serves only; K2's and K3's work does not depend on the batch
                pop = lambda: P.popcount_binary_conv(x, sign, alpha, shift=shift, strides=st)
                pop_plain = lambda: P.popcount_binary_conv_plain(x, sign, alpha, shift=shift,
                                                                 strides=st)
                y4, py4 = pop(), pop_plain()
                torch.cuda.synchronize()
                k4_ok = torch.equal(y4, py4) and torch.equal(y4, y1)
                k4_err = max(float((y4 - py4).abs().max()), float((y4 - y1).abs().max()))
                r4 = _conv_row(name, batch, count, cuda_ms(pop, 20), cuda_ms(pop_plain, 2, 1),
                               lib_ms, conv_bound, k4_err, k4_ok, graph_ms=graph_ms(pop),
                               library_graph_ms=lib_graph, bf16_cudnn_ms=r1["bf16_cudnn_ms"])
                recs["K4"]["shapes"].append(r4)
                _log_row("K4", r4)
                ok = ok and k4_ok
                del y4, py4
            del x, y1, py, xb, wf, xh, wh, lib_y
            torch.cuda.empty_cache()
    _log_forward_sum(recs, "K4")
    return recs, ok


def _log_forward_sum(recs, kname) -> None:
    sh = recs[kname]["shapes"]
    log(f"[kernels] {kname} summed over one batch-32 forward's 19 convs: "
        f"eager {sum(r['count'] * r['ms'] for r in sh):.4f} ms, "
        f"graph {sum(r['count'] * r['graph_ms'] for r in sh):.4f} ms, "
        f"bound {sum(r['count'] * r['bound_ms'] for r in sh):.4f} ms")


def phase_weight_kernels(pk):
    """Hold K2 (weight sign + alpha) and K3 (packbits decode) against their
    plain versions at the flagship's ten distinct binary conv weights:
    K2's sign and K3's output bitwise, K2's alpha to a relative 1e-6 and
    bitwise across two runs. Times each eager, as CUDA-graph replay
    (device time alone) and over one forward's 19 weights in one graph
    (:func:`forward_weight_graphs`). Returns per-kernel records (without
    ``launches``) and ok."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    recs = {k: {"shapes": []} for k in ("K2", "K3")}
    ok = True
    for name, _, c, o, k, _, count in FLAGSHIP_CONVS:
        w = 0.05 * torch.randn((k, k, c, o), generator=g, device="cuda")
        ok = _check_weight_kernels(recs, pk, name, count, w) and ok
    for kname in recs:
        _log_forward_sum(recs, kname)
    forward_weight_graphs(recs)
    return recs, ok


def _check_weight_kernels(recs, pk, name, count, w) -> bool:
    """K2 and K3 at one conv's weight against their plain versions;
    appends their records."""
    import numpy as np
    import torch

    from bdbnn_tpu_torch.nn import packed as P
    from bdbnn_tpu_torch.nn.kernels import weight_binarize, weight_binarize_plain

    shape = tuple(int(d) for d in w.shape)
    sign, alpha = weight_binarize(w)
    sign2, alpha2 = weight_binarize(w)
    psign, palpha = weight_binarize_plain(w)
    packed = torch.from_numpy(np.packbits((w >= 0).cpu().numpy().reshape(-1))).to(w.device)
    dense = P.packed_dense_weight(packed, alpha, shape)
    pdense = P.packed_dense_weight_plain(packed, alpha, shape)
    torch.cuda.synchronize()
    k2_ok = (torch.equal(sign, psign) and bool(torch.allclose(alpha, palpha, rtol=1e-6, atol=0))
             and torch.equal(sign, sign2) and torch.equal(alpha, alpha2))
    k3_ok = torch.equal(dense, pdense)
    nw, o = w.numel(), shape[-1]
    k2 = lambda: weight_binarize(w)
    k3 = lambda: P.packed_dense_weight(packed, alpha, shape)
    rows = {
        "K2": _conv_row(name, BATCH, count, cuda_ms(k2, 50),
                        cuda_ms(lambda: weight_binarize_plain(w), 20), None,
                        bound(nw * 4 + nw + o * 4, 3.0 * nw, pk["f32_tflops"], pk),
                        float((alpha - palpha).abs().max()), k2_ok, graph_ms=graph_ms(k2)),
        "K3": _conv_row(name, BATCH, count, cuda_ms(k3, 50),
                        cuda_ms(lambda: P.packed_dense_weight_plain(packed, alpha, shape), 20),
                        None, bound((nw + 7) // 8 + o * 4 + nw * 4, 1.0 * nw, pk["f32_tflops"], pk),
                        float((dense - pdense).abs().max()), k3_ok, graph_ms=graph_ms(k3)),
    }
    for kname, r in rows.items():
        recs[kname]["shapes"].append(r)
        _log_row(kname, r)
    return k2_ok and k3_ok


def forward_weight_graphs(recs) -> None:
    """K2 and K3 as one batch-32 forward runs them: the 19 binary convs'
    own weights (one per conv, 44.6 MB of f32 in all, so most of each is
    read from device memory, not from L2), each kernel's 19 calls in
    forward order captured in one CUDA graph and replayed. Records the
    device ms of one forward's calls as ``forward_graph_ms``."""
    import numpy as np
    import torch

    from bdbnn_tpu_torch.nn import packed as P
    from bdbnn_tpu_torch.nn.kernels import weight_binarize

    g = torch.Generator(device="cuda").manual_seed(4)
    ws = [0.05 * torch.randn((k, k, c, o), generator=g, device="cuda")
          for _, _, c, o, k, _, count in FLAGSHIP_CONVS for _ in range(count)]
    alphas = [w.abs().mean(dim=(0, 1, 2)) for w in ws]
    packs = [torch.from_numpy(np.packbits((w >= 0).cpu().numpy().reshape(-1))).cuda() for w in ws]
    shapes = [tuple(w.shape) for w in ws]
    fns = {
        "K2": lambda: [weight_binarize(w) for w in ws],
        "K3": lambda: [P.packed_dense_weight(p, a, sh) for p, a, sh in zip(packs, alphas, shapes)],
    }
    for kname, fn in fns.items():
        ms = graph_ms(fn, calls=3)
        recs[kname]["forward_graph_ms"] = ms
        log(f"[kernels] {kname} one batch-32 forward's {len(ws)} calls on the convs' own weights, "
            f"in one CUDA graph: {ms:.4f} ms")
    del ws, alphas, packs
    torch.cuda.empty_cache()


def log_mma_instructions() -> None:
    """Which tensor-core instructions the built K1 and K4 libraries hold
    (``cuobjdump -sass`` beside ``nvcc``), for the log."""
    import collections
    import re

    from bdbnn_tpu_torch.nn.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in ("binary_conv", "packed"):
        if not os.path.exists(tool):
            log(f"[build] {name}: no cuobjdump beside nvcc, instructions not read")
            continue
        sass = subprocess.run([tool, "-sass", _build.library_path(name)], capture_output=True,
                              text=True, timeout=120).stdout
        ops = collections.Counter(re.findall(r"\b([BIH]MMA\.[A-Z0-9.]+)", sass))
        log(f"[build] {name}: tensor-core instructions in its SASS {dict(ops)}")


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
    from bdbnn_tpu_torch.nn.kernels import (
        binary_conv2d,
        binary_conv2d_dgrad,
        binary_conv2d_wgrad,
        kurtosis_grouped,
        weight_binarize,
    )

    return {
        "K1": binary_conv2d,
        "K2": weight_binarize,
        "K3": P.packed_dense_weight,
        "K4": P.popcount_binary_conv,
        "K5": binary_conv2d_dgrad,
        "K6": binary_conv2d_wgrad,
        "K7": kurtosis_grouped,
    }


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


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
    counts = read_counts()
    want = {
        "K1": 2 * forwards * N_BINARY_CONVS,
        "K2": 3 * forwards * N_BINARY_CONVS,
        "K3": 2 * forwards * N_BINARY_CONVS,
        "K4": forwards * N_BINARY_CONVS,
        "K5": 0, "K6": 0, "K7": 0,
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
    for m in modes:
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


def dgrad_exact(gy, x, wsign, alpha, s, pad):
    """K5's conv-transpose sum without the slope, exact to float64 (every
    product g·alpha·(±1) is exact, float64 sums them with 29 bits to
    spare at these lengths): what the summation bound is held to."""
    import torch

    n, h, w, c = x.shape
    o, kh, kw, _ = wsign.shape
    ho, wo = gy.shape[1], gy.shape[2]
    ga = (gy * alpha).double()  # the f32 product first, as the kernel forms it
    cols = (ga.reshape(-1, o) @ wsign.reshape(o, -1).double()).reshape(n, ho, wo, kh, kw, c)
    xp = torch.zeros((n, h + 2 * pad, w + 2 * pad, c), dtype=torch.float64, device=x.device)
    for i in range(kh):
        for j in range(kw):
            xp[:, i : i + s * (ho - 1) + 1 : s, j : j + s * (wo - 1) + 1 : s, :] += cols[:, :, :, i, j, :]
    return xp[:, pad : pad + h, pad : pad + w, :]


def wgrad_exact(gy, x, w, alpha, shift, s, pad, u=None):
    """K6 exact to float64 (the same argument as :func:`dgrad_exact`);
    with the draw ``u``, of the sampled signs."""
    from bdbnn_tpu_torch.nn.kernels.binary_conv import binarize_input, im2col_nhwc

    kh, kw, c, o = w.shape
    patches = im2col_nhwc(binarize_input(x, shift, u), kh, kw, s, pad).reshape(-1, kh * kw * c)
    dws = patches.double().t() @ (gy * alpha).double().reshape(-1, o)
    return dws.reshape(kh, kw, c, o) * (w.abs() <= 1.0).double()


def _ratio(err, base, scale) -> float:
    """The largest (err - u|base|) / scale: how many u·Σ|terms| an error
    takes beyond the final rounding."""
    return float(((err - U * base.abs()).clamp(min=0) / scale.clamp(min=1e-30)).max())


def phase_train_kernels(pk):
    """Hold K5, K6 and K7 against their plain versions at the shapes the
    training main path gives them: K5/K6 at batch 256 and every distinct
    binary conv shape of the flagship, K7 over its 19 hooked tensors.
    Returns per-kernel records (without ``launches``) and ok."""
    import torch
    from torch.nn import grad as tgrad

    from bdbnn_tpu_torch.nn.kernels import (
        binary_conv2d_dgrad,
        binary_conv2d_dgrad_plain,
        binary_conv2d_wgrad,
        binary_conv2d_wgrad_plain,
        weight_binarize,
    )
    from bdbnn_tpu_torch.nn.kernels.binary_conv import binarize_input, estimator_slope

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    recs = {k: {"shapes": []} for k in ("K5", "K6")}
    ok = True
    approx = ("approx", 0.0, 0.0)
    b = TRAIN_BATCH
    for si, (name, hw, c, o, k, s, count) in enumerate(FLAGSHIP_CONVS):
        pad = k // 2
        ho = (hw + 2 * pad - k) // s + 1
        st = (s, s)
        x = torch.randn((b, hw, hw, c), generator=g, device=dev)
        shift = 0.1 * torch.randn((c,), generator=g, device=dev)
        w = 0.5 * torch.randn((k, k, c, o), generator=g, device=dev)  # some |W| > 1
        gy = torch.randn((b, ho, ho, o), generator=g, device=dev)
        wsign, alpha = weight_binarize(w)
        ests = [approx] + ([("ste", 0.0, 0.0), ("ede", 0.7, 1.5), ("prox", 0.8, 0.0)] if si == 0 else [])
        exact = dgrad_exact(gy, x, wsign, alpha, s, pad)
        terms = binary_conv2d_dgrad_plain(gy.abs(), x, torch.ones_like(wsign), alpha.abs(),
                                          shift=shift, strides=st)
        k5_err, k5_ok = 0.0, True
        for est in ests:
            dx = binary_conv2d_dgrad(gy, x, wsign, alpha, shift=shift, strides=st, estimator=est)
            if est is approx:
                dx2 = binary_conv2d_dgrad(gy, x, wsign, alpha, shift=shift, strides=st,
                                          estimator=est)
                same = torch.equal(dx, dx2)
                log(f"[train_kernels] K5 {name} b{b}: bitwise across two runs {same}")
                k5_ok = k5_ok and same
                del dx2
            pdx = binary_conv2d_dgrad_plain(gy, x, wsign, alpha, shift=shift, strides=st, estimator=est)
            slope = estimator_slope(x - shift, est)
            ex = exact * slope.double()
            scale = U * terms * slope.abs()
            err, err_ex = (dx - pdx).abs(), (dx.double() - ex).abs()
            this_ok = (bool((err <= 8 * scale + U * pdx.abs() + 1e-30).all())
                       and bool((err_ex <= 4 * scale + U * ex.abs() + 1e-30).all()))
            log(f"[train_kernels] K5 {name} b{b} {est[0]}: within bound {this_ok} "
                f"max_abs_err={float(err.max())} (err - u|ref|)/(u·Σ|terms|·|slope|) max: "
                f"kernel vs plain {_ratio(err, pdx, scale):.3f} (bound 8), kernel vs exact "
                f"{_ratio(err_ex, ex, scale.double()):.3f} (bound 4), plain vs exact "
                f"{_ratio((pdx.double() - ex).abs(), ex, scale.double()):.3f}")
            k5_err = max(k5_err, float(err.max()))
            k5_ok = k5_ok and this_ok
            del dx, pdx, slope, ex, scale, err, err_ex
        del exact, terms
        dw = binary_conv2d_wgrad(gy, x, w, alpha, shift=shift, strides=st)
        dw2 = binary_conv2d_wgrad(gy, x, w, alpha, shift=shift, strides=st)
        pdw = binary_conv2d_wgrad_plain(gy, x, w, alpha, shift=shift, strides=st)
        ex6 = wgrad_exact(gy, x, w, alpha, shift, s, pad)
        wscale = U * binary_conv2d_wgrad_plain(gy.abs(), torch.ones_like(x), torch.zeros_like(w),
                                               alpha.abs(), strides=st)
        err6, err6_ex = (dw - pdw).abs(), (dw.double() - ex6).abs()
        k6_err = float(err6.max())
        k6_ok = (bool((err6 <= 8 * wscale + U * pdw.abs() + 1e-30).all())
                 and bool((err6_ex <= 4 * wscale + U * ex6.abs() + 1e-30).all())
                 and torch.equal(dw, dw2))
        log(f"[train_kernels] K6 {name} b{b}: within bound and bitwise across two runs {k6_ok} "
            f"max_abs_err={k6_err} (err - u|ref|)/(u·Σ|terms|) max: kernel vs plain "
            f"{_ratio(err6, pdw, wscale):.3f} (bound 8), kernel vs exact "
            f"{_ratio(err6_ex, ex6, wscale.double()):.3f} (bound 4), plain vs exact "
            f"{_ratio((pdw.double() - ex6).abs(), ex6, wscale.double()):.3f}")
        del dw2, pdw, ex6, wscale, err6, err6_ex
        # library yardsticks on the same ±1 operands (TF32 off)
        ga = (gy * alpha).permute(0, 3, 1, 2).contiguous()
        wf = wsign.permute(0, 3, 1, 2).to(torch.float32).contiguous()
        xb = binarize_input(x, shift).permute(0, 3, 1, 2).contiguous()
        in_size = (b, c, hw, hw)
        lib5 = lambda: tgrad.conv2d_input(in_size, wf, ga, stride=s, padding=pad)
        lib6 = lambda: tgrad.conv2d_weight(xb, wf.shape, ga, stride=s, padding=pad)
        t = {
            "K5": (cuda_ms(lambda: binary_conv2d_dgrad(gy, x, wsign, alpha, shift=shift, strides=st,
                                                       estimator=approx), 10),
                   cuda_ms(lambda: binary_conv2d_dgrad_plain(gy, x, wsign, alpha, shift=shift,
                                                             strides=st, estimator=approx), 3),
                   cuda_ms(lib5, 10)),
            "K6": (cuda_ms(lambda: binary_conv2d_wgrad(gy, x, w, alpha, shift=shift, strides=st), 10),
                   cuda_ms(lambda: binary_conv2d_wgrad_plain(gy, x, w, alpha, shift=shift, strides=st), 3),
                   cuda_ms(lib6, 10)),
        }
        macs = b * ho * ho * o * k * k * c
        b5 = gy.numel() * 4 + 2 * x.numel() * 4 + wsign.numel() + (o + c) * 4
        b6 = gy.numel() * 4 + x.numel() * 4 + 2 * w.numel() * 4 + (o + c) * 4
        # both on the bf16 tensor cores: 6·MACs (three bf16 pieces of
        # g·alpha) or bytes; the f32 figure (2·MACs at 67 TFLOP/s) beside
        bounds = {"K5": bound(b5, 6.0 * macs, pk["bf16_tflops"], pk),
                  "K6": bound(b6, 6.0 * macs, pk["bf16_tflops"], pk)}
        f32_bounds = {"K5": bound(b5, 2.0 * macs, pk["f32_tflops"], pk),
                      "K6": bound(b6, 2.0 * macs, pk["f32_tflops"], pk)}
        for kname, err, kok in (("K5", k5_err, k5_ok), ("K6", k6_err, k6_ok)):
            ms, plain_ms, lib_ms = t[kname]
            f32b = f32_bounds[kname]
            recs[kname]["shapes"].append({
                "shape": f"{name} b{b}", "count": count, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
                "bound_f32_ms": f32b[0], "max_abs_err": err, "ok": bool(kok),
            })
            log(f"[train_kernels] {kname} {name} b{b} (x{count} a step): kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={bounds[kname][0]:.4f} ({bounds[kname][1]}) "
                f"f32 bound_ms={f32b[0]:.4f} ({f32b[1]})")
            ok = ok and bool(kok)
        del x, gy, dw, ga, xb, wf
        torch.cuda.empty_cache()
    ok = phase_k5_same_sign(g) and ok
    ok = phase_k6_same_sign(g) and ok

    k7, k7_ok = phase_k7(pk)
    recs["K7"] = k7
    return recs, ok and k7_ok


def phase_k7(pk):
    """K7 over the flagship's 19 hooked latent weights (he-normal init)
    against its plain version (rtol 1e-5, bitwise across two runs, and
    without the gradient the same loss and kurt bits); timed eager, as its
    device passes alone (:func:`k7_device_ms`) and as the whole call
    captured in a CUDA graph. Returns its record (without ``launches``)
    and ok."""
    import torch

    from bdbnn_tpu_torch.losses.kurtosis import DIFFKURT_TARGETS_IMAGENET
    from bdbnn_tpu_torch.models import create_model
    from bdbnn_tpu_torch.nn.kernels import kurtosis_grouped, kurtosis_grouped_plain

    dev = torch.device("cuda")
    model = create_model("resnet18", "imagenet", generator=torch.Generator().manual_seed(0)).to(dev)
    ws = [p.detach() for n, p in model.named_parameters() if n.endswith("float_weight")]
    targets = DIFFKURT_TARGETS_IMAGENET
    n_el = sum(t.numel() for t in ws)
    loss, kurt, grads = kurtosis_grouped(ws, targets, "avg")
    loss2, kurt2, grads2 = kurtosis_grouped(ws, targets, "avg")
    bare = kurtosis_grouped(ws, targets, "avg", with_grad=False)
    ploss, pkurt, pgrads = kurtosis_grouped_plain(ws, targets, "avg")
    torch.cuda.synchronize()
    gerr = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads, pgrads))
    k7_ok = (
        len(ws) == N_BINARY_CONVS
        and bool(torch.allclose(loss, ploss, rtol=1e-5, atol=0))
        and bool(torch.allclose(kurt, pkurt, rtol=1e-5, atol=0))
        and gerr <= 1e-5
        and torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
        and torch.equal(bare[0], loss) and torch.equal(bare[1], kurt)
    )
    k7_err = max(float((loss - ploss).abs()), float((kurt - pkurt).abs().max()),
                 max(float((a - b).abs().max()) for a, b in zip(grads, pgrads)))
    ms = cuda_ms(lambda: kurtosis_grouped(ws, targets, "avg"), 50)
    dev_ms = k7_device_ms(ws, targets)
    call_graph_ms = graph_ms(lambda: kurtosis_grouped(ws, targets, "avg"))
    bare_ms = cuda_ms(lambda: kurtosis_grouped(ws, targets, "avg", with_grad=False), 50)
    plain_ms = cuda_ms(lambda: kurtosis_grouped_plain(ws, targets, "avg"), 5)
    b7 = bound(2 * 4 * n_el, 17.0 * n_el, pk["f64_tflops"], pk)
    # the centered two-pass form's own floor: two reads for the mean and
    # the moments, then a read and a write for the gradient
    floor_ms = 4 * 4 * n_el / (pk["hbm_tbs"] * 1e12) * 1e3
    rec = {"shapes": [{
        "shape": f"19 flagship tensors, {n_el} elements", "count": 1, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": b7[0], "bound_by": b7[1], "max_abs_err": k7_err,
        "ok": bool(k7_ok), "graph_ms": dev_ms, "call_graph_ms": call_graph_ms,
        "no_grad_ms": bare_ms,
    }]}
    log(f"[train_kernels] K7 19 tensors ({n_el} elements): ok={k7_ok} loss={float(loss)} "
        f"plain={float(ploss)} max grad err (of the tensor's largest)={gerr} kernel_ms={ms:.4f} "
        f"(device passes alone, graph: {dev_ms:.4f}; the whole call as a graph: "
        f"{call_graph_ms:.4f}; without the gradient, eager: {bare_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} bound_ms={b7[0]:.4f} ({b7[1]}; two-pass floor {floor_ms:.4f})")
    del model, ws, grads, grads2, pgrads
    torch.cuda.empty_cache()
    return rec, bool(k7_ok)


def k7_device_ms(ws, targets) -> float:
    """K7's device time alone: its three grid passes over ``ws`` (mode
    avg, with the gradient) captured in one CUDA graph, its output and
    scratch allocated once outside it; the C entry is called as the
    wrapper calls it, with no count."""
    import torch

    from bdbnn_tpu_torch.nn.kernels import _build
    from bdbnn_tpu_torch.nn.kernels import kurtosis as KM

    dev = ws[0].device
    lib = _build.library("kurtosis")
    plan = KM._plan(ws, targets, "avg")
    partial = torch.empty((5 * plan.blocks,), dtype=torch.float64, device=dev)
    out = torch.empty((plan.out_len,), dtype=torch.float32, device=dev)

    def launch():
        err = lib.bdbnn_kurtosis_grouped(plan.table_ptr, KM.MODES["avg"], 1,
                                         partial.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
        _build.check(lib, err, "kurtosis_grouped")

    return graph_ms(launch)


def phase_k5_same_sign(gen) -> bool:
    """K5 on same-sign terms at the flagship's widest shape (layer4 3x3 s1
    512->512 @7, -b 256): |g|, every sign +1, slope 1. Each output is a
    sum of 4,608 positive terms, so a bias of the summation (the MMA's
    truncation, or round-to-nearest drift onto a growing total) cannot
    cancel. Held to the float64 sum within the flagship check's bound
    (4·u·Σ|terms| + u|exact|), and to the plain version within its bound
    (8·u·Σ|terms| + u|plain|) wherever the plain version is itself within
    4·u·Σ|terms| + u|exact| of the float64 sum: its f32 matrix product sums
    512 positive terms in one chain and can drift beyond that, and then no
    kernel, however exact, is within 8 of it. Those elements are counted
    and logged with the ratio over all elements."""
    import torch

    from bdbnn_tpu_torch.nn.kernels import binary_conv2d_dgrad, binary_conv2d_dgrad_plain

    dev = torch.device("cuda")
    b, hw, c, o = TRAIN_BATCH, 7, 512, 512
    x = torch.randn((b, hw, hw, c), generator=gen, device=dev)
    gy = torch.randn((b, hw, hw, o), generator=gen, device=dev).abs()
    alpha = 0.05 + torch.rand((o,), generator=gen, device=dev)
    wsign = torch.ones((o, 3, 3, c), dtype=torch.int8, device=dev)
    dx = binary_conv2d_dgrad(gy, x, wsign, alpha)
    pdx = binary_conv2d_dgrad_plain(gy, x, wsign, alpha)
    exact = dgrad_exact(gy, x, wsign, alpha, 1, 1)
    ok = _hold_same_sign(f"K5 same-sign probe layer4 3x3 s1 512->512 @7 b{b}", dx, pdx, exact)
    del x, gy, dx, pdx, exact
    torch.cuda.empty_cache()
    return ok


def phase_k6_same_sign(gen) -> bool:
    """K6 on same-sign terms at the flagship's longest reduction (layer1
    3x3 s1 64->64 @56, -b 256): |g|, x >= 0 so every activation sign is
    +1 (0 in the padding), alpha > 0 and W = 0 (no STE mask). Each dW
    entry is a sum of up to 802,816 positive terms, so a bias of the
    summation cannot cancel. Held as phase_k5_same_sign holds K5; one f32
    chain of the plain version drifts far beyond its own bound here."""
    import torch

    from bdbnn_tpu_torch.nn.kernels import binary_conv2d_wgrad, binary_conv2d_wgrad_plain

    dev = torch.device("cuda")
    b, hw, c, o = TRAIN_BATCH, 56, 64, 64
    x = torch.randn((b, hw, hw, c), generator=gen, device=dev).abs()
    gy = torch.randn((b, hw, hw, o), generator=gen, device=dev).abs()
    alpha = 0.05 + torch.rand((o,), generator=gen, device=dev)
    w = torch.zeros((3, 3, c, o), device=dev)
    dw = binary_conv2d_wgrad(gy, x, w, alpha)
    pdw = binary_conv2d_wgrad_plain(gy, x, w, alpha)
    exact = wgrad_exact(gy, x, w, alpha, None, 1, 1)
    ok = _hold_same_sign(f"K6 same-sign probe layer1 3x3 s1 64->64 @56 b{b}", dw, pdw, exact)
    del x, gy, dw, pdw, exact
    torch.cuda.empty_cache()
    return ok


def _hold_same_sign(label: str, got, plain, exact) -> bool:
    """A same-sign probe's check: every term is positive, so Σ|terms| is
    the float64 sum itself. ``got`` within 4·u·Σ|terms| + u|exact| of it,
    and within 8·u·Σ|terms| + u|plain| of ``plain`` wherever ``plain`` is
    within 4·u·Σ|terms| + u|exact| of it; logs the ratios and the count of
    elements where the plain version is beyond its own bound."""
    scale = U * exact
    err, err_ex = (got - plain).abs(), (got.double() - exact).abs()
    plain_in = (plain.double() - exact).abs() <= 4 * scale + U * exact.abs() + 1e-30
    ok = (bool((err <= 8 * scale.float() + U * plain.abs() + 1e-30)[plain_in].all())
          and bool((err_ex <= 4 * scale + U * exact.abs() + 1e-30).all()))
    log(f"[train_kernels] {label} (|g|, signs +1): "
        f"within bound {ok}; the plain version is beyond its own float64 bound at "
        f"{int((~plain_in).sum())} of {plain_in.numel()} elements; (err - u|ref|)/(u·Σ|terms|) "
        f"max: kernel vs plain {_ratio(err[plain_in], plain[plain_in], scale.float()[plain_in]):.3f} "
        f"where the plain is within its bound (bound 8), {_ratio(err, plain, scale.float()):.3f} "
        f"over all, kernel vs exact "
        f"{_ratio(err_ex, exact, scale):.3f} (bound 4), plain vs exact "
        f"{_ratio((plain.double() - exact).abs(), exact, scale):.3f}; mean (kernel - exact)/"
        f"(u·Σ|terms|) {float(((got.double() - exact) / scale).mean()):.3f}")
    return ok


def train_config(**kw):
    from bdbnn_tpu_torch.train.config import RunConfig

    return RunConfig(**{**TRAIN_ARGS, **kw})


def phase_train():
    """The training main path: ``fit`` on the flagship at -b 256. Returns
    (launch counts of the run, step records, ok)."""
    return run_fit("[train]", "resnet18", TRAIN_STEPS)


def run_fit(tag: str, arch: str, steps: int, **cfg_kw):
    """``fit`` on ``arch`` (ImageNet, the BASELINE config 3 recipe) at -b
    256 for ``steps`` steps and the eval pass, counts set to 0 just before
    and read just after. Every loss must be finite and every step launch
    K1, K2, K5 and K6 once a binary conv and K7 twice (the loss, and the
    binarization probes' grouped forward). Returns (launch counts of the
    run, step records, ok)."""
    import torch

    from bdbnn_tpu_torch.train.loop import fit

    cfg = train_config(arch=arch, batch_size=TRAIN_BATCH, synthetic_train_size=steps * TRAIN_BATCH,
                       synthetic_val_size=TRAIN_BATCH, device="cuda", **cfg_kw)
    events, per_step, losses = [], [], []
    prev = {}

    def on_step(epoch, step, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        now = read_counts()
        per_step.append({k: now[k] - prev.get(k, 0) for k in now})
        prev.update(now)
        losses.append(m["loss"])

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = fit(cfg, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = read_counts()
    torch.cuda.synchronize()
    loss_vals = [float(v) for v in losses]
    step_ms = [events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))]
    want = {"K1": N_BINARY_CONVS, "K2": N_BINARY_CONVS, "K3": 0, "K4": 0,
            "K5": N_BINARY_CONVS, "K6": N_BINARY_CONVS, "K7": 2}
    ok = (len(loss_vals) == steps and all(math.isfinite(v) for v in loss_vals)
          and all(c == want for c in per_step))
    mean_ms = sum(step_ms) / max(len(step_ms), 1)
    log(f"{tag} fit {arch} imagenet -b {TRAIN_BATCH} {cfg_kw}: {steps} steps + eval in "
        f"{wall:.1f}s -> {res}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{tag} losses {loss_vals}")
    log(f"{tag} launches per step {per_step} (expected {want} each: K7 once for the loss "
        f"and once for the binarization probes); whole run {counts}")
    log(f"{tag} step ms after the warm-up step (CUDA events, fit's loop with its host "
        f"input pipeline): {step_ms}; mean {mean_ms:.2f} ms = "
        f"{TRAIN_BATCH / mean_ms * 1e3:.1f} images/s")
    if not ok:
        log(f"{tag} FAIL: a loss is not finite or a step's launch counts differ")
    return counts, {"step_ms": step_ms, "losses": loss_vals}, ok


def time_host_input(batches: int = 3) -> None:
    """The host's share of fit's input at -b 256, alone: ms per batch of
    the numpy transform (the prefetch thread's work) and of the pinned
    copy to the card (the train loop's work)."""
    import torch

    from bdbnn_tpu_torch.train.loop import build_datasets, to_device

    cfg = train_config(batch_size=TRAIN_BATCH, synthetic_train_size=batches * TRAIN_BATCH,
                       synthetic_val_size=TRAIN_BATCH, device="cuda").validate()
    pipe, _, _ = build_datasets(cfg)
    pipe.prefetch = 0
    it = pipe.epoch(0)
    dev = torch.device("cuda")
    transform_ms, copy_ms = [], []
    for _ in range(batches):
        t0 = time.perf_counter()
        x, y = next(it)
        t1 = time.perf_counter()
        batch = (to_device(x, dev), to_device(y, dev))
        torch.cuda.synchronize()
        del batch
        transform_ms.append((t1 - t0) * 1e3)
        copy_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"[train] host input per -b {TRAIN_BATCH} batch, alone: transform ms {transform_ms} "
        f"(one thread), pin + copy ms {copy_ms}")


class MarginDraws:
    """Uniform draws from a numpy seed, in forward order, each kept 1e-4
    from its threshold ``hard_sigmoid(x)`` of the activation it is drawn
    for, so that last-ulp differences between two devices' activations
    cannot flip a sample; records them for :class:`ReplayDraws`."""

    MARGIN = 1e-4

    def __init__(self, seed: int):
        import numpy as np

        self.rng = np.random.default_rng(seed)
        self.drawn = []

    def __call__(self, x):
        import numpy as np
        import torch

        from bdbnn_tpu_torch.nn.binarize import hard_sigmoid

        p = hard_sigmoid(x.detach()).cpu().numpy()
        u = self.rng.uniform(size=tuple(x.shape)).astype(np.float32)
        m = self.MARGIN
        u = np.where(np.abs(u - p) < m, np.where(p + m < 1.0, p + m, p - m), u).astype(np.float32)
        if float(np.min(np.abs(u - p))) <= 0.9 * m:
            raise AssertionError("a draw lies within 0.9 of the margin of its threshold")
        self.drawn.append(u)
        return torch.from_numpy(u).to(x.device)


class ReplayDraws:
    """The draws a :class:`MarginDraws` recorded, in the same order, on
    the activation's device."""

    def __init__(self, drawn):
        self.queue = list(drawn)

    def __call__(self, x):
        import torch

        u = self.queue.pop(0)
        if tuple(u.shape) != tuple(x.shape):
            raise ValueError(f"replayed draw {u.shape} for an activation {tuple(x.shape)}")
        return torch.from_numpy(u).to(x.device)


def phase_train_parity(tag: str = "[train]", arch: str = "resnet18", **cfg_kw) -> bool:
    """One train step on the card against the CPU plain step at batch 8,
    from identical weights and batch (under the stochastic family, the
    same draws: :class:`MarginDraws` on the card, replayed on the CPU).
    Held: the loss terms (rtol
    TRAIN_LOSS_RTOL); every parameter's gradient (GRAD_TOL of its
    tensor's largest |entry|), which K5, K6, the dshift sum, K7's
    gradient and the estimator routing all reach; every updated
    parameter: Adam's first update is lr·g/(|g| + eps), so an entry
    whose decayed gradient is under 1e-3 of its tensor's largest can turn
    summation noise into an update of up to 2·lr and is held only to
    that, the others to 2e-3·lr; the batch statistics to rtol 1e-5 with
    1e-4 of the tensor's largest |entry|."""
    import numpy as np
    import torch

    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.train.loop import build_datasets, build_training, epoch_schedule
    from bdbnn_tpu_torch.train.step import make_train_step

    cfg = train_config(arch=arch, batch_size=8, synthetic_train_size=8, synthetic_val_size=8,
                       device="cpu", **cfg_kw).validate()
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    pipe, _, _ = build_datasets(cfg)
    x, y = next(iter(pipe.epoch(0)))
    tk, gate = epoch_schedule(family, cfg, 0)
    out = {}
    t0 = time.perf_counter()
    recorded = MarginDraws(seed=23)
    for side, dev in (("card", "cuda"), ("cpu", "cpu")):
        state, step_cfg = build_training(cfg, torch.device(dev), 1, 224)
        model, opt = state.model, state.optimizer
        old = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        wd = {id(p): grp["weight_decay"] for grp in opt.param_groups for p in grp["params"]}
        source = recorded if side == "card" else ReplayDraws(recorded.drawn)
        step = make_train_step(model, opt, step_cfg, draws=lambda _step: source)
        batch = (torch.from_numpy(np.array(x)).to(dev), torch.from_numpy(np.array(y)).to(dev))
        _, m = step(state, batch, tk, gate)
        out[side] = {
            "m": {k: float(m[k]) for k in ("loss", "loss_ce", "loss_kurt")},
            "draws": len(recorded.drawn) if side == "card" else len(source.queue),
            "grad": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "wd": {n: wd[id(p)] for n, p in model.named_parameters()},
            "old": old,
            "new": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "lr": opt.param_groups[0]["lr"],
        }
        del state, step, model, opt
    card, cpu = out["card"], out["cpu"]
    fails = []
    if family.stochastic and not (card["draws"] == N_BINARY_CONVS and cpu["draws"] == 0):
        fails.append(f"the card drew {card['draws']} times, the CPU left {cpu['draws']} draws")
    rel = {k: abs(card["m"][k] - cpu["m"][k]) / abs(cpu["m"][k]) for k in cpu["m"]}
    fails += [f"{k} relative {v}" for k, v in rel.items() if not v <= TRAIN_LOSS_RTOL]
    fails += [f"{k} starts from other weights" for k in cpu["old"]
              if not torch.equal(card["old"][k], cpu["old"][k])]
    lr = cpu["lr"]
    worst_g = worst_p = worst_bn = 0.0
    kept = total = 0
    for name, v in cpu["new"].items():
        got, old = card["new"][name], cpu["old"][name]
        if name.endswith(("running_mean", "running_var")):
            atol = 1e-4 * float(v.abs().max())
            err = float(((got - v).abs() - 1e-5 * v.abs()).max())
            worst_bn = max(worst_bn, err / max(atol, 1e-30))
            if not err <= atol:
                fails.append(f"{name} differs by {err} beyond rtol 1e-5 (atol {atol})")
            continue
        g_ref = cpu["grad"][name]
        gmax = max(float(g_ref.abs().max()), 1e-30)
        gerr = float((card["grad"][name] - g_ref).abs().max()) / gmax
        worst_g = max(worst_g, gerr)
        if not gerr <= GRAD_TOL:
            fails.append(f"{name} gradient differs by {gerr} of its largest |entry|")
        g_eff = g_ref + cpu["wd"][name] * old
        keep = g_eff.abs() >= 1e-3 * float(g_eff.abs().max())
        kept += int(keep.sum())
        total += keep.numel()
        derr = (got - old) - (v - old)
        perr = float(derr[keep].abs().max()) / lr if bool(keep.any()) else 0.0
        worst_p = max(worst_p, perr)
        if not (perr <= 2e-3 and float(derr.abs().max()) <= 2.0 * lr * (1 + 1e-6)):
            fails.append(f"{name} update differs by {perr}·lr")
    ok = not fails
    log(f"{tag} one step at batch 8, card {card['m']} vs CPU plain {cpu['m']}: relative {rel} "
        f"(tol {TRAIN_LOSS_RTOL}); worst gradient error {worst_g} of the tensor's largest "
        f"(tol {GRAD_TOL}, {len(cpu['grad'])} tensors); worst update error {worst_p}·lr on "
        f"{kept}/{total} entries (tol 2e-3·lr); worst batch-stat error {worst_bn} of its "
        f"tolerance; ok={ok} ({time.perf_counter() - t0:.1f}s)")
    for f in fails[:20]:
        log(f"{tag} FAIL: {f}")
    return ok


def phase_train_cede() -> bool:
    """Two steps of CIFAR resnet20 under --ede through ``fit``."""
    from bdbnn_tpu_torch.train.config import RunConfig
    from bdbnn_tpu_torch.train.loop import fit

    losses = []
    cfg = RunConfig(dataset="cifar10", arch="resnet20", synthetic=True, batch_size=128, epochs=1,
                    ede=True, synthetic_train_size=256, synthetic_val_size=128, seed=0,
                    print_freq=1, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    res = fit(cfg, on_step=lambda e, i, m: losses.append(float(m["loss"])))
    counts = read_counts()
    ok = (len(losses) == 2 and all(math.isfinite(v) for v in losses)
          and counts["K5"] > 0 and counts["K6"] > 0)
    log(f"[train-cede] fit resnet20 cifar10 --ede -b 128: losses {losses} -> {res} "
        f"launches {counts} in {time.perf_counter() - t0:.1f}s ok={ok}")
    return ok


def phase_train_cli() -> bool:
    cmd = [sys.executable, "-m", "bdbnn_tpu_torch.cli", "--dataset", "imagenet", "-a", "resnet18",
           "--synthetic", "-b", "256", "--epochs", "1", "--w-kurtosis", "--diffkurt",
           "--synthetic-train-size", "512", "--synthetic-val-size", "256", "--seed", "0"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    log(f"[train-cli] {' '.join(cmd[1:])} -> exit {r.returncode} in {time.perf_counter() - t0:.1f}s")
    if r.returncode != 0:
        log(r.stdout[-2000:] + r.stderr[-4000:])
        return False
    res = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"[train-cli] result {res}; last log lines: {r.stderr.strip().splitlines()[-3:]}")
    return set(res) == {"best_acc1", "best_epoch"}


def profile_train_step(iters: int = 3, tag: str = "flagship", **cfg_kw) -> dict:
    """A train step of the flagship (or ``cfg_kw``'s model) at -b 256
    alone: CUDA-event time per step on a batch already on the card, then
    device time by kernel, with ``torch.rand``'s share (the stochastic
    family's draws) named."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.train.loop import build_training, epoch_schedule
    from bdbnn_tpu_torch.train.step import make_train_step

    cfg = train_config(batch_size=TRAIN_BATCH, device="cuda", **cfg_kw).validate()
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    state, step_cfg = build_training(cfg, torch.device("cuda"), 10, 224)
    step = make_train_step(state.model, state.optimizer, step_cfg)
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = (torch.randn((TRAIN_BATCH, 224, 224, 3), generator=g, device="cuda"),
             torch.randint(0, 1000, (TRAIN_BATCH,), generator=g, device="cuda"))
    tk, gate = epoch_schedule(family, cfg, 0)
    ms = cuda_ms(lambda: step(state, batch, tk, gate), iters, warmup=2)
    log(f"[profile] {tag} train step -b {TRAIN_BATCH}, batch on the card: {ms:.2f} ms "
        f"= {TRAIN_BATCH / ms * 1e3:.1f} images/s (CUDA events, {iters} steps after 2 warm-up)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, batch, tk, gate)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    per_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3 / 2
    busy = sum(per_kernel.values())
    # torch.rand's kernel: the uniform distribution's elementwise kernel
    rand_ms = sum(v for k, v in per_kernel.items()
                  if "uniform" in k.lower() or "distribution_elementwise" in k)
    if busy == 0:
        log(f"[profile] {tag} train step: the profiler saw no device time (not measured)")
    else:
        log(f"[profile] {tag} train step -b {TRAIN_BATCH}: device busy {busy:.3f} ms of "
            f"{wall_ms:.3f} ms host wall per step (busy share {busy / wall_ms:.3f}); torch.rand "
            f"(the stochastic draws) {rand_ms:.3f} ms")
        for name, kms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
            log(f"[profile]   {kms:8.4f} ms  {name[:100]}")
    del state, step, batch
    torch.cuda.empty_cache()
    return {"step_ms": ms, "busy_ms": busy, "wall_ms": wall_ms, "rand_ms": rand_ms}


# the stochastic family's main path: resnet18_step2 (BinaryConv, no
# act_shift, hardtanh: the flagship's 19 binary convs at its ten shapes)
# under the BASELINE config 3 recipe; its kernels held at three shapes
STOCH_ARGS = dict(arch="resnet18_step2", binarizer="stochastic")
STOCH_STEPS = 3
STOCH_SHAPES = ("layer1 3x3 s1 64->64 @56", "layer2_0.conv1 3x3 s2 64->128 @56",
                "layer4 3x3 s1 512->512 @7")


def phase_train_stoch(pk):
    """[train-stoch]: the stochastic family in training. ``fit`` on
    ImageNet resnet18_step2 at -b 256 under --binarizer stochastic
    --w-kurtosis --diffkurt (Adam), 3 steps and the eval pass, with exact
    per-step launch counts; one step at batch 8 on the card against the
    CPU on the same draws; one step replayed from the same state and
    (seed, step), bitwise; K1 with the draw bitwise against its plain
    version and K6 with it within the summation bound, at three shapes;
    a profile of the step with torch.rand's share. Returns (launch counts
    of the fit run, ok)."""
    tag = "[train-stoch]"
    arch = STOCH_ARGS["arch"]
    kw = {k: v for k, v in STOCH_ARGS.items() if k != "arch"}
    counts, _, ok_fit = run_fit(tag, arch, STOCH_STEPS, **kw)
    ok_par = phase_train_parity(tag, arch, **kw)
    ok_rep = stoch_replay(tag)
    ok_k = stoch_kernels(tag, pk)
    profile_train_step(tag=f"{arch} --binarizer stochastic", **STOCH_ARGS)
    log(f"{tag} fit {ok_fit}, card vs CPU {ok_par}, bitwise replay {ok_rep}, kernels {ok_k}")
    return counts, ok_fit and ok_par and ok_rep and ok_k


def stoch_replay(tag: str) -> bool:
    """One stochastic train step at -b 256 run twice from the same state
    and (seed, step), its draws from the step's own generator: the loss,
    every gradient, every updated parameter and batch statistic bitwise
    equal (cuDNN held to its deterministic algorithms for the stem)."""
    import copy

    import torch

    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.train.loop import build_training, epoch_schedule
    from bdbnn_tpu_torch.train.step import make_train_step

    cfg = train_config(batch_size=TRAIN_BATCH, device="cuda", **STOCH_ARGS).validate()
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    state, step_cfg = build_training(cfg, torch.device("cuda"), 10, 224)
    model, opt = state.model, state.optimizer
    step = make_train_step(model, opt, step_cfg)
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = (torch.randn((TRAIN_BATCH, 224, 224, 3), generator=g, device="cuda"),
             torch.randint(0, 1000, (TRAIN_BATCH,), generator=g, device="cuda"))
    tk, gate = epoch_schedule(family, cfg, 0)
    model_sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt_sd = copy.deepcopy(opt.state_dict())
    runs = []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            model.load_state_dict(model_sd)
            opt.load_state_dict(opt_sd)
            state.step = 0
            _, m = step(state, batch, tk, gate)
            runs.append({"loss": m["loss"].clone(),
                         **{"grad " + n: p.grad.clone() for n, p in model.named_parameters()},
                         **{k: v.clone() for k, v in model.state_dict().items()}})
    finally:
        torch.backends.cudnn.deterministic = prev
    torch.cuda.synchronize()
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    ok = not differ and len(runs[0]) > 100
    log(f"{tag} one step at -b {TRAIN_BATCH} twice from the same state and (seed, step): "
        f"{len(runs[0])} tensors, bitwise equal {ok}; differing: {differ[:10]}")
    del state, step, model, opt, batch, runs, model_sd, opt_sd
    torch.cuda.empty_cache()
    return ok


def stoch_kernels(tag: str, pk) -> bool:
    """K1 with the draw u bitwise against its plain version, and K6 with
    it held as phase_train_kernels holds K6 (the float64 sum of the
    sampled signs, the plain version, bitwise across two runs), at -b 256
    and three shapes; the hard sign's dW must lie beyond that bound. Logs
    K1's time with and without u."""
    import torch

    from bdbnn_tpu_torch.nn.kernels import (
        binary_conv2d,
        binary_conv2d_plain,
        binary_conv2d_wgrad,
        binary_conv2d_wgrad_plain,
        weight_binarize,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    b, ok = TRAIN_BATCH, True
    for name, hw, c, o, k, s, _ in FLAGSHIP_CONVS:
        if name not in STOCH_SHAPES:
            continue
        pad, st = k // 2, (s, s)
        ho = (hw + 2 * pad - k) // s + 1
        x = torch.randn((b, hw, hw, c), generator=g, device=dev)
        u = torch.rand((b, hw, hw, c), generator=g, device=dev)
        w = 0.5 * torch.randn((k, k, c, o), generator=g, device=dev)
        gy = torch.randn((b, ho, ho, o), generator=g, device=dev)
        wsign, alpha = weight_binarize(w)
        y = binary_conv2d(x, wsign, alpha, strides=st, u=u)
        py = binary_conv2d_plain(x, wsign, alpha, strides=st, u=u)
        k1_ok = torch.equal(y, py)
        k1_ms = cuda_ms(lambda: binary_conv2d(x, wsign, alpha, strides=st, u=u), 10)
        hard_ms = cuda_ms(lambda: binary_conv2d(x, wsign, alpha, strides=st), 10)
        del y, py
        dw = binary_conv2d_wgrad(gy, x, w, alpha, strides=st, u=u)
        dw2 = binary_conv2d_wgrad(gy, x, w, alpha, strides=st, u=u)
        pdw = binary_conv2d_wgrad_plain(gy, x, w, alpha, strides=st, u=u)
        hard = binary_conv2d_wgrad_plain(gy, x, w, alpha, strides=st)
        ex6 = wgrad_exact(gy, x, w, alpha, None, s, pad, u=u)
        wscale = U * binary_conv2d_wgrad_plain(gy.abs(), torch.ones_like(x), torch.zeros_like(w),
                                               alpha.abs(), strides=st)
        err6, err6_ex = (dw - pdw).abs(), (dw.double() - ex6).abs()
        bound8 = 8 * wscale + U * pdw.abs() + 1e-30
        k6_ok = (bool((err6 <= bound8).all())
                 and bool((err6_ex <= 4 * wscale + U * ex6.abs() + 1e-30).all())
                 and torch.equal(dw, dw2) and bool(((hard - pdw).abs() > 100 * bound8).any()))
        k6_ms = cuda_ms(lambda: binary_conv2d_wgrad(gy, x, w, alpha, strides=st, u=u), 10)
        log(f"{tag} {name} b{b}: K1 with u bitwise vs plain {k1_ok} ({k1_ms:.4f} ms; without u "
            f"{hard_ms:.4f}); K6 with u within bound, bitwise across two runs, the hard sign "
            f"beyond it: {k6_ok} max_abs_err={float(err6.max())} (err - u|ref|)/(u·Σ|terms|) max: "
            f"kernel vs plain {_ratio(err6, pdw, wscale):.3f} (bound 8), kernel vs exact "
            f"{_ratio(err6_ex, ex6, wscale.double()):.3f} (bound 4) ({k6_ms:.4f} ms)")
        ok = ok and k1_ok and k6_ok
        del x, u, w, gy, dw, dw2, pdw, hard, ex6, wscale, err6, err6_ex, bound8
        torch.cuda.empty_cache()
    return ok


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weight-kernels", action="store_true",
                    help="only build the kernels and hold and time K2, K3 and K7 (phases 1-3 "
                         "for them), then print their records as one JSON line; for comparing "
                         "two trees' weight kernels in one run")
    args = ap.parse_args(argv)

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
    log_mma_instructions()

    if args.weight_kernels:
        wrecs, ok_w = phase_weight_kernels(pk)
        wrecs["K7"], ok_k7 = phase_k7(pk)
        print(json.dumps({"weight_kernels": wrecs, "device": kind, "nvidia_smi": smi_line}),
              flush=True)
        return 0 if ok_w and ok_k7 else 1
    recs, ok_k = phase_kernels(pk)
    wrecs, ok_w = phase_weight_kernels(pk)
    recs.update(wrecs)
    trecs, ok_tk = phase_train_kernels(pk)
    recs.update(trecs)
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "resnet18_react")
        t0 = time.perf_counter()
        make_flagship_artifact(art)
        log(f"[main] wrote flagship artifact in {time.perf_counter() - t0:.1f}s")
        counts, ok_m = phase_main(art)
        ok_c = phase_cli(art)
    train_counts, _, ok_t = phase_train()
    time_host_input()
    ok_tp = phase_train_parity()
    ok_te = phase_train_cede()
    ok_tc = phase_train_cli()
    profile_train_step()
    stoch_counts, ok_ts = phase_train_stoch(pk)

    sources = {"K1": "bdbnn_tpu_torch/csrc/binary_conv.cu",
               "K2": "bdbnn_tpu_torch/csrc/weight_binarize.cu",
               "K3": "bdbnn_tpu_torch/csrc/packed.cu",
               "K4": "bdbnn_tpu_torch/csrc/packed.cu",
               "K5": "bdbnn_tpu_torch/csrc/binary_conv_dgrad.cu",
               "K6": "bdbnn_tpu_torch/csrc/binary_conv_wgrad.cu",
               "K7": "bdbnn_tpu_torch/csrc/kurtosis.cu"}
    names = {"K1": "binary_conv2d (fused sign + binary conv fwd)",
             "K2": "weight_binarize (weight sign + alpha)",
             "K3": "packed_dense_weight (packbits decode)",
             "K4": "popcount_binary_conv (XNOR-popcount conv fwd)",
             "K5": "binary_conv2d_dgrad (binary conv input grad + sign estimator slope)",
             "K6": "binary_conv2d_wgrad (binary conv weight grad + STE mask)",
             "K7": "kurtosis_grouped (grouped kurtosis regularizer + grad)"}
    replaces = {"K1": "bdbnn_tpu/nn/kernels/binary_conv.py:92",
                "K2": "bdbnn_tpu/nn/binarize.py:466",
                "K3": "bdbnn_tpu/nn/packed.py:131",
                "K4": "bdbnn_tpu/nn/packed.py:161",
                "K5": "bdbnn_tpu/nn/kernels/binary_conv.py:107",
                "K6": "bdbnn_tpu/nn/kernels/binary_conv.py:107",
                "K7": "bdbnn_tpu/losses/kurtosis.py:51"}
    # each kernel's launches on the main path it belongs to: serving for
    # K1-K4, training for K5-K7 (K1 and K2 run on both; both are listed),
    # and on the stochastic family's training path (K1, K2, K5-K7)
    by_path = {k: {"serve": counts.get(k, 0), "train": train_counts.get(k, 0),
                   "train-stoch": stoch_counts.get(k, 0)} for k in sources}
    used = {k: by_path[k]["serve" if k in ("K1", "K2", "K3", "K4") else "train"] for k in sources}
    ok_used = all(v > 0 for v in used.values()) and all(
        by_path[k][path] > 0 for k in ("K1", "K2", "K5", "K6", "K7")
        for path in ("train", "train-stoch"))
    if not ok_used:
        log(f"chip_smoke: a kernel was not launched on its main path: {by_path}")
    kernels = []
    step = "one train step at -b 256: the sum over the 19 binary convs (ms × convs of each shape)"
    fwd = ("one batch-32 forward: the sum over the 19 binary convs (ms × convs of each shape); "
           "graph_ms the same sum of CUDA-graph-replayed device times")
    wgraph = "; forward_graph_ms the 19 calls on the convs' own weights in one CUDA graph"
    ms_of = {"K1": step + "; forward_b32 holds the batch-32 forward's sums",
             "K2": fwd + wgraph, "K3": fwd + wgraph, "K4": fwd, "K5": step, "K6": step,
             "K7": "one call over the 19 hooked tensors; graph_ms its three device passes alone, "
                   "call_graph_ms the whole call as a CUDA graph"}

    def sums(sh):
        lib = [s["library_ms"] for s in sh]
        total = lambda key: sum(s.get("count", 1) * s[key] for s in sh)
        out = {"ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
               "bound_by": max(sh, key=lambda s: s["bound_ms"])["bound_by"],
               "library_ms": None if any(v is None for v in lib) else total("library_ms")}
        if all("graph_ms" in s for s in sh):
            out["graph_ms"] = total("graph_ms")
        return out

    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7"):
        sh = recs[k]["shapes"]
        rec = {
            "name": f"{k} {names[k]}",
            "route": "cuda",
            "source": sources[k],
            "replaces": replaces[k],
            "launches": used[k],
            "launches_by_path": by_path[k],
            "max_abs_err": max(s["max_abs_err"] for s in sh + recs[k].get("forward_shapes", [])),
            "ms_of": ms_of[k],
            **sums(sh),
            "shapes": sh,
        }
        if "forward_graph_ms" in recs[k]:
            rec["forward_graph_ms"] = recs[k]["forward_graph_ms"]
        if "forward_shapes" in recs[k]:
            rec["forward_b32"] = {**sums(recs[k]["forward_shapes"]),
                                  "shapes": recs[k]["forward_shapes"]}
        kernels.append(rec)
    print(json.dumps({"kernels": kernels}), flush=True)
    oks = {"kernels": ok_k, "weight_kernels": ok_w, "main": ok_m, "cli": ok_c,
           "train_kernels": ok_tk, "train": ok_t, "train_parity": ok_tp, "train_cede": ok_te,
           "train_cli": ok_tc, "train_stoch": ok_ts, "launched": ok_used}
    if not all(oks.values()):
        log(f"chip_smoke: FAILED {oks}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
