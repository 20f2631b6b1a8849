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
12. train-ts — the teacher–student step: teacher ``.pth.tar`` files in
             torchvision's key layout from seeded float models
             (write_teacher_checkpoint); ``fit`` on BASELINE config 4 in f32
             (ImageNet resnet34 --react student, resnet34_float teacher,
             --w-kurtosis) at -b 256 through --resume_teacher, 3 steps and
             the eval pass: exactly 35 launches of K1, K2, K5, K6 and 2 of K7
             a step (the teacher launches none), the teacher bitwise as
             loaded afterwards, peak device memory; one TS step at batch 8
             on the card against the CPU (as [train] holds its step, with
             loss_kl and loss_kl_c; the CPU's binary convs and RPReLUs take
             the card's inputs, InputReplay, since resnet34's batch-8 step
             otherwise crosses a few thresholds by rounding and diverges);
             the four-term loss on resnet18 with a
             resnet18_float teacher (2 steps and the batch-8 step); a
             resnet50_float teacher over resnet18 --react (2 steps); the CLI
             trains 2 TS steps; a profile of path 1's step (images/s, busy
             share, the K-kernels' shares) and its teacher forward and KD
             loss terms timed alone;
13. train-resume — checkpoints, preemption and resume of the flagship
             recipe, 2 epochs × 4 steps at -b 256 with --save-every-steps
             2, cuDNN deterministic: (a) run A uninterrupted (its K1, K2,
             K5, K6, K7 launches); (b) run B through ``cli.main``
             SIGTERMed after its checkpoint of epoch 1 step 2: exit 75,
             preempt and checkpoint events, the committed state bitwise
             the saved one; (c) B resumed: restore schedule fields bitwise
             the checkpoint event's, every later loss and the final model,
             optimizer state and step bitwise A's; (d) the CLI in a
             subprocess SIGKILLed after its first mid-epoch checkpoint,
             resumed, held as (c); (e) A's checkpoint loaded on the CPU,
             bitwise the card's state; (f) a resnet18_float run dir as the
             teacher of a resnet18 --react student, bitwise after fit; (g)
             A exported and served in three modes at bucket 32 (bitwise
             across modes, within CPU_LOGIT_TOL of the CPU engine), its
             recorded accuracy A's; (h) each checkpoint's seconds and
             bytes, the restore seconds, the step time around the saves;
14. train-folder — ImageNet from an image folder: a seeded tree of
             ImageNet-shaped JPEGs (write_image_folder: 16 classes, 1,537
             train files with one truncated, 512 val, about 100 kB each);
             on the card's host, the worker-process pipeline bitwise at -j 1
             and -j W, eval batches bitwise across the two backends, each
             backend's ``start_step`` tail bitwise, one substitution for the
             truncated file; ``prep_images`` on the card bitwise the host
             normalize; ``fit`` on the flagship recipe with
             --device-normalize under --input-backend mp -j W (2 epochs of
             6 steps, each with the eval of 512) and threads (2 steps),
             with exact launch counts, a ``data_error`` event for the
             truncated file and no worker left; the run
             exported and ``cli predict`` over the val split, its engine
             held to the checkpoint's training eval forward on the same
             images; decode, batch, transfer, copy, step and device-step
             times and the device's idle share beside the card's name and
             power limit;
15. train-bf16 — bf16 compute and remat (MIGRATION.md recipes 3-5 run
             --dtype bfloat16): (a) K1, K2, K5 and K6 in their bf16 modes at
             the flagship's ten conv shapes at -b 256 against their plain
             bf16 versions (K1 and K2's sign bitwise, K2's alpha within one
             bf16 rounding, K5 and K6 within the float64-sum bound plus one
             bf16 rounding), each timed beside cuDNN's bf16 conv2d /
             conv2d_input / conv2d_weight on the same ±1 operands; (b)
             ``fit`` on the flagship recipe with --dtype bfloat16, 3 steps
             and the eval pass, 19 bf16-mode launches each of K1, K2, K5, K6
             and 2 of K7 a step, one batch-8 step on the card against the
             CPU with InputReplay (BF16_PARITY), the device step beside
             f32's; (c) the same with --remat: K1 and K2 at 38 a step, the
             BN running statistics bitwise (b)'s, step time and peak memory
             against the runs without remat in f32 and bf16; (d) BASELINE
             config 4 in bf16 (resnet34 --react, a seeded resnet34_float
             teacher file), 3 steps with exact launch counts, the step, the
             teacher's share of it and peak memory; (e) (b)'s run exported
             and served in dense and packed/unpack at bucket 32 (bitwise
             across modes, within two bf16 ulps of the CPU engine on
             one-channel exact-stem images), packed/popcount refused;
16. train-ddp — data parallelism (phase_train_ddp): (a) two ranks on the
             one card over gloo (NCCL refuses two ranks on one GPU), each
             a spawned process with 128 images a step of the flagship
             recipe at -b 256, through ``fit``: 3 steps, a checkpoint every
             2 and the eval pass, exact launch counts on each rank, both
             ranks' parameters, Adam state and BN running statistics
             bitwise equal, the eval ``count`` the whole val split, each
             rank's step and the gloo all-reduces' share of it; (b) (a)'s
             first step against one process fed the ranks' batches
             concatenated in rank order (loss, every gradient, the sign
             crossings counted); (c) one rank over NCCL bitwise the run
             without a process group, and what wrapping the student costs a
             step; (d) (a)'s mid-epoch checkpoint resumed on one process,
             ``resharded`` and bitwise;
17. output — one ``{"kernels": [...]}`` line (K1-K7 and the bf16 modes K1
             bf16, K2 bf16, K5 bf16, K6 bf16; ``launches_by_path`` gives
             serve, train, train-stoch, train-ts, train-resume, train-folder,
             train-bf16 and train-ddp, and for a bf16 mode train-bf16,
             train-bf16-remat, train-bf16-ts and serve-bf16), then as the
             last line ``{"ok": true, "device": {...}}``.

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


def torchvision_state_dict(state_dict, prefix: str = "module."):
    """A port float model's ``state_dict`` in torchvision's key layout, the
    inverse of ``bdbnn_tpu_torch.models.torch_import.translate_key``:
    ``layerS_B`` → ``layerS.B``, ``downsample_conv``/``downsample_bn`` →
    ``downsample.0``/``.1``, DataParallel's ``module.`` prefix, and a
    ``num_batches_tracked`` counter beside each BatchNorm's statistics."""
    import re

    import torch

    out = {}
    for key, t in state_dict.items():
        k = re.sub(r"^layer(\d+)_(\d+)\.", r"layer\1.\2.", key)
        k = k.replace("downsample_conv.", "downsample.0.").replace("downsample_bn.", "downsample.1.")
        out[prefix + k] = t.detach().cpu().clone()
        if k.endswith(".running_var"):
            out[prefix + k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(90)
    return out


def write_teacher_checkpoint(path: str, arch: str = "resnet34_float", dataset: str = "imagenet",
                             seed: int = 0):
    """A float teacher from a seeded generator, with non-trivial BN
    weights and running statistics, saved as a reference-format
    ``.pth.tar`` (``{"state_dict": ..., "epoch": ...}``) in torchvision's
    key layout. The last BN of each residual branch is scaled by 0.5, so
    that the residual sums do not grow through the depth and the
    teacher's softmax is neither uniform nor saturated. Returns the model
    (CPU, eval mode)."""
    import torch

    from bdbnn_tpu_torch.models import create_model
    from bdbnn_tpu_torch.models.resnet import BiBasicBlock, FloatBottleneck
    from bdbnn_tpu_torch.nn.layers import BatchNorm

    g = torch.Generator().manual_seed(seed)
    model = create_model(arch, dataset, generator=g)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.weight.numel()
                mod.weight.copy_(0.5 + 0.5 * torch.rand(n, generator=g))
                mod.bias.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=g))
        for mod in model.modules():
            if isinstance(mod, (BiBasicBlock, FloatBottleneck)):
                (mod.bn3 if isinstance(mod, FloatBottleneck) else mod.bn2).weight.mul_(0.5)
    torch.save({"state_dict": torchvision_state_dict(model.state_dict()), "epoch": 90}, path)
    return model.eval()


def write_image_folder(root: str, classes: int = 16, train: int = 1537, val: int = 512,
                       seed: int = 0, scale: float = 1.0, extreme_every: int = 128,
                       threads: int = 8) -> dict:
    """A seeded ImageNet-shaped JPEG tree ``root/{train,val}/cKK/NNNNN.jpg``
    (image i of a split in class i % classes), written with PIL at quality
    90. Sizes lie around ImageNet's usual 500×375 (× ``scale``), half of
    them portrait; every ``extreme_every``-th image is 1200×80 or 80×1200
    (× ``scale``), an aspect RandomResizedCrop's 10 tries almost never
    fit, so its center-crop fallback runs. Content is a bicubic upsampling
    of a random field with one value a 6×6 patch, plus uniform noise of
    ±20: at 500×375 about 100 KB a file, so sizes and decode cost resemble
    a photo's (pure noise would compress far worse). The
    train file that seed ``seed``'s epoch-0 order puts second is then cut
    to half its bytes: a truncated JPEG. Returns the truncated file's
    path and index, the file count, bytes on disk and seconds."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from bdbnn_tpu_torch.data import ImageFolder, host_shard_indices

    t0 = time.perf_counter()

    def one(job):
        split, i = job
        rng = np.random.default_rng((seed, 0 if split == "train" else 1, i))
        if extreme_every and i % extreme_every == extreme_every - 1:
            w, h = (1200, 80) if (i // extreme_every) % 2 else (80, 1200)
        else:
            w, h = (int(v * rng.uniform(0.8, 1.2)) for v in (500, 375))
            if rng.random() < 0.5:
                w, h = h, w
        w, h = max(int(w * scale), 1), max(int(h * scale), 1)
        field = rng.integers(0, 256, (max(h // 6, 2), max(w // 6, 2), 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(field).resize((w, h), Image.BICUBIC), np.int16)
        img = img + rng.integers(-20, 21, img.shape, dtype=np.int16)
        path = os.path.join(root, split, f"c{i % classes:02d}", f"{i:05d}.jpg")
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=90)
        return os.path.getsize(path)

    jobs = [("train", i) for i in range(train)] + [("val", i) for i in range(val)]
    for split in ("train", "val"):
        for c in range(classes):
            os.makedirs(os.path.join(root, split, f"c{c:02d}"), exist_ok=True)
    with ThreadPoolExecutor(threads) as pool:
        sizes = list(pool.map(one, jobs))
    folder = ImageFolder(os.path.join(root, "train"))
    index = int(host_shard_indices(len(folder), 0, seed=seed)[1])
    path = folder.samples[index][0]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    return {"truncated": path, "index": index, "files": len(jobs), "bytes": sum(sizes),
            "seconds": time.perf_counter() - t0}


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
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


# the kernels with a bf16 mode; each wrapper counts the mode's launches
# apart (``launches_bf16``) beside all of its launches (``launches``)
BF16_KERNELS = ("K1", "K2", "K5", "K6")


def read_bf16_counts() -> dict:
    w = wrappers()
    return {f"{k} bf16": w[k].launches_bf16 for k in BF16_KERNELS}


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


def fresh_log_root() -> str:
    """A new empty directory for one run's ``log_path`` (its run dir is
    ``<root>/<kurtosis target>/<stamp>``, one-second stamps: two runs
    under one root in one second would share it), under one per-process
    directory removed at exit."""
    import atexit
    import shutil

    if not _LOG_ROOTS:
        _LOG_ROOTS.append(tempfile.mkdtemp(prefix="chip_smoke_runs-"))
        atexit.register(shutil.rmtree, _LOG_ROOTS[0], True)
    return tempfile.mkdtemp(prefix="run-", dir=_LOG_ROOTS[0])


_LOG_ROOTS: list = []


def train_config(**kw):
    """The flagship recipe with ``kw`` over it; ``log_path`` defaults to a
    fresh temporary root."""
    from bdbnn_tpu_torch.train.config import RunConfig

    kw.setdefault("log_path", fresh_log_root())
    return RunConfig(**{**TRAIN_ARGS, **kw})


def phase_train():
    """The training main path: ``fit`` on the flagship at -b 256. Returns
    (launch counts of the run, step records, ok)."""
    return run_fit("[train]", "resnet18", TRAIN_STEPS)


def run_fit(tag: str, arch: str, steps: int, n_convs: int = N_BINARY_CONVS, fwd_repeats: int = 1,
            **cfg_kw):
    """``fit`` on ``arch`` (ImageNet, the BASELINE config 3 recipe unless
    ``cfg_kw`` changes it) at -b 256 for ``steps`` steps and the eval pass
    of each epoch, counts set to 0 just before and read just after. Every
    loss must be finite and every step launch K5 and K6 once for each of
    the model's ``n_convs`` binary convs, K1 and K2 ``fwd_repeats`` times
    (2 under remat: the forward and its recompute) and K7 twice (the loss,
    and the binarization probes' grouped forward); a bf16 run launches
    only the bf16 modes of K1, K2, K5 and K6, an f32 run none of them. The
    eval passes' launches count in the run's, not in a step's. Step times
    are taken between the steps of one epoch. Returns (launch counts of
    the run with the bf16 modes' apart, step records, ok)."""
    import torch

    from bdbnn_tpu_torch.train import loop

    cfg = train_config(arch=arch, batch_size=TRAIN_BATCH, synthetic_train_size=steps * TRAIN_BATCH,
                       synthetic_val_size=TRAIN_BATCH, device="cuda", **cfg_kw)
    events, per_step, losses = [], [], []
    prev = {}

    def on_step(epoch, step, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((epoch, ev))
        now = {**read_counts(), **read_bf16_counts()}
        per_step.append({k: now[k] - prev.get(k, 0) for k in now})
        prev.update(now)
        losses.append(m["loss"])

    real_validate = loop._validate

    def validate(*a, **kw):
        acc1 = real_validate(*a, **kw)
        prev.update({**read_counts(), **read_bf16_counts()})
        return acc1

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loop._validate = validate
    t0 = time.perf_counter()
    try:
        res = loop.fit(cfg, on_step=on_step)
    finally:
        loop._validate = real_validate
    wall = time.perf_counter() - t0
    counts = {**read_counts(), **read_bf16_counts()}
    torch.cuda.synchronize()
    loss_vals = [float(v) for v in losses]
    step_ms = [b.elapsed_time(e) for (ea, b), (eb, e) in zip(events, events[1:]) if ea == eb]
    fwd = fwd_repeats * n_convs
    want = {"K1": fwd, "K2": fwd, "K3": 0, "K4": 0, "K5": n_convs, "K6": n_convs, "K7": 2}
    bf16 = cfg.dtype == "bfloat16"
    want.update({f"{k} bf16": want[k] if bf16 else 0 for k in BF16_KERNELS})
    ok = (len(loss_vals) == steps * cfg.epochs and all(math.isfinite(v) for v in loss_vals)
          and all(c == want for c in per_step))
    mean_ms = sum(step_ms) / max(len(step_ms), 1)
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} fit {arch} imagenet -b {TRAIN_BATCH} {cfg_kw}: {cfg.epochs} x {steps} steps + "
        f"eval in {wall:.1f}s -> {res}; peak device memory (torch.cuda.max_memory_allocated) "
        f"{peak} bytes = {peak / 2**30:.2f} GiB")
    log(f"{tag} losses {loss_vals}")
    log(f"{tag} launches per step {per_step} (expected {want} each: K7 once for the loss "
        f"and once for the binarization probes; 'bf16' the bf16 modes' launches among them); "
        f"whole run {counts}")
    log(f"{tag} step ms after each epoch's first step (CUDA events, fit's loop with its host "
        f"input pipeline): {step_ms}; mean {mean_ms:.2f} ms = "
        f"{TRAIN_BATCH / mean_ms * 1e3:.1f} images/s")
    if not ok:
        log(f"{tag} FAIL: a loss is not finite or a step's launch counts differ")
    return counts, {"step_ms": step_ms, "losses": loss_vals, "peak_bytes": peak}, ok


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


class InputReplay:
    """Records the input of every module where the forward branches on a
    threshold — each binary conv (the sign of ``x - shift``) and each
    RPReLU (its kink at ``gamma``) — on the card (forward pre-hooks, in
    forward order), then feeds the CPU step's modules those exact values,
    the gradient passing straight through to the CPU's own input.
    Differences upstream (the stem conv, BN's batch sums in another order)
    then cannot move a value across a threshold: at batch 8 a full-width
    net has tens of millions of such values, some within rounding of their
    threshold, and one sign that flips changes the batch statistics of
    every later layer. Counts, per kind, the values the CPU's own inputs
    would have put on the other side, and their largest difference from
    the card's."""

    def __init__(self, kinds=("conv", "rprelu")):
        self.kinds = kinds
        self.recorded, self.at = [], 0
        self.flips = {k: 0 for k in kinds}
        self.max_diff = 0.0

    def hooks(self, model, side: str):
        from bdbnn_tpu_torch.nn.layers import RPReLU, _BinaryConvBase

        fn = self._record if side == "card" else self._replay
        types = tuple(t for k, t in (("conv", _BinaryConvBase), ("rprelu", RPReLU))
                      if k in self.kinds)
        return [m.register_forward_pre_hook(fn) for m in model.modules() if isinstance(m, types)]

    @staticmethod
    def _threshold(mod):
        if hasattr(mod, "gamma"):
            return "rprelu", mod.gamma.detach()
        return "conv", mod.act_shift.detach() if mod.has_shift else 0.0

    def _record(self, mod, args):
        self.recorded.append(args[0].detach().cpu().clone())

    def _replay(self, mod, args):
        import torch

        x, card = args[0], self.recorded[self.at]
        self.at += 1
        kind, t = self._threshold(mod)
        self.flips[kind] += int(((x.detach() - t >= 0) != (card - t >= 0)).sum())
        self.max_diff = max(self.max_diff, float((x.detach() - card).abs().max()))

        class Exact(torch.autograd.Function):
            @staticmethod
            def forward(ctx, own):
                return card.clone()

            @staticmethod
            def backward(ctx, g):
                return g

        return (Exact.apply(x),) + tuple(args[1:])


def make_step(cfg, state, step_cfg, draws=None):
    """The train step ``fit`` builds for ``cfg``: under teacher–student
    the teacher from ``cfg.resume_teacher`` on the model's device, its
    layer-KL pairs and the TS step; else the plain step."""
    from bdbnn_tpu_torch.train.loop import build_teacher, match_kd_pairs
    from bdbnn_tpu_torch.train.step import make_train_step, make_ts_train_step

    if not cfg.teacher_student:
        return make_train_step(state.model, state.optimizer, step_cfg, draws=draws)
    device = next(state.model.parameters()).device
    teacher = build_teacher(cfg, device)
    step_cfg = match_kd_pairs(state.model, teacher, step_cfg)
    return make_ts_train_step(state.model, teacher, state.optimizer, step_cfg, draws=draws)


# card vs CPU at batch 8 in bf16 (see phase_train_parity): both sides
# round every activation to bf16, and a sum that lands on the other side
# of a bf16 rounding boundary on one device (the stem conv and BN's
# means in another order, K5's and K6's sums against the plain f32
# products) moves a value by one bf16 rounding, up to 2^-8 of it. The
# loss to one such rounding; each gradient to 0.1 of its tensor's largest
# |entry|: a binary conv's weight gradient takes a bf16 cotangent that
# has come back through every later layer, each of whose backward ops
# rounds it again (19 binary convs with their BN and RPReLU: some fifty
# roundings reach layer1_0.conv1), so its difference grows with the depth
# behind it; Adam's first update held where the decayed gradient is at
# least 0.2 of its tensor's largest, twice that tolerance, where its sign
# cannot differ; the batch statistics to 2^-8 of their largest.
BF16_PARITY = dict(loss_rtol=2.0**-8, grad_tol=0.1, keep_frac=0.2, bn_atol=2.0**-8)


def phase_train_parity(tag: str = "[train]", arch: str = "resnet18", replay_inputs=(),
                       loss_rtol: float = TRAIN_LOSS_RTOL, grad_tol: float = GRAD_TOL,
                       keep_frac: float = 1e-3, bn_atol: float = 1e-4, **cfg_kw) -> bool:
    """One train step on the card against the CPU plain step at batch 8,
    from identical weights and batch (under the stochastic family, the
    same draws: :class:`MarginDraws` on the card, replayed on the CPU;
    under teacher–student, the same teacher file, and the TS step; with
    ``replay_inputs`` (module kinds), those modules on the CPU take the
    card's inputs, :class:`InputReplay`).
    Held: the loss terms (rtol
    TRAIN_LOSS_RTOL; under teacher–student loss_kl and loss_kl_c too); every parameter's gradient (GRAD_TOL of its
    tensor's largest |entry|), which K5, K6, the dshift sum, K7's
    gradient and the estimator routing all reach; every updated
    parameter: Adam's first update is lr·g/(|g| + eps), so an entry
    whose decayed gradient is under 1e-3 of its tensor's largest can turn
    summation noise into an update of up to 2·lr and is held only to
    that, the others to 2e-3·lr; the batch statistics to rtol 1e-5 with
    1e-4 of the tensor's largest |entry|. A bf16 run takes
    :data:`BF16_PARITY`'s tolerances in their place (``loss_rtol``,
    ``grad_tol``, ``keep_frac``, ``bn_atol``)."""
    import numpy as np
    import torch

    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.train.loop import build_datasets, build_training, epoch_schedule

    cfg = train_config(arch=arch, batch_size=8, synthetic_train_size=8, synthetic_val_size=8,
                       device="cpu", **cfg_kw).validate()
    keys = ("loss", "loss_ce", "loss_kurt") + (("loss_kl", "loss_kl_c") if cfg.teacher_student else ())
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    pipe, _, _ = build_datasets(cfg)
    x, y = next(iter(pipe.epoch(0)))
    tk, gate = epoch_schedule(family, cfg, 0)
    out = {}
    t0 = time.perf_counter()
    recorded = MarginDraws(seed=23)
    inputs = InputReplay(replay_inputs)
    for side, dev in (("card", "cuda"), ("cpu", "cpu")):
        state, step_cfg = build_training(cfg, torch.device(dev), 1, 224)
        model, opt = state.model, state.optimizer
        old = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        wd = {id(p): grp["weight_decay"] for grp in opt.param_groups for p in grp["params"]}
        source = recorded if side == "card" else ReplayDraws(recorded.drawn)
        step = make_step(cfg, state, step_cfg, draws=lambda _step: source)
        batch = (torch.from_numpy(np.array(x)).to(dev), torch.from_numpy(np.array(y)).to(dev))
        handles = inputs.hooks(model, side) if replay_inputs else []
        try:
            _, m = step(state, batch, tk, gate)
        finally:
            for h in handles:
                h.remove()
        out[side] = {
            "m": {k: float(m[k]) for k in keys},
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
    if replay_inputs:
        if not (inputs.recorded and inputs.at == len(inputs.recorded)):
            fails.append(f"the CPU replayed {inputs.at} of {len(inputs.recorded)} binary conv inputs")
        log(f"{tag} module inputs replayed on the CPU ({', '.join(replay_inputs)}): "
            f"{inputs.at}; values the CPU's own inputs would have put on the other side of "
            f"their threshold: {inputs.flips}; largest |CPU - card| input difference "
            f"{inputs.max_diff}")
    rel = {k: (abs(card["m"][k] - cpu["m"][k]) / abs(cpu["m"][k]) if cpu["m"][k] != 0.0
               else (0.0 if card["m"][k] == 0.0 else math.inf)) for k in cpu["m"]}
    fails += [f"{k} relative {v}" for k, v in rel.items() if not v <= loss_rtol]
    fails += [f"{k} starts from other weights" for k in cpu["old"]
              if not torch.equal(card["old"][k], cpu["old"][k])]
    lr = cpu["lr"]
    worst_g = worst_p = worst_bn = 0.0
    kept = total = 0
    g_errs = {}
    for name, v in cpu["new"].items():
        got, old = card["new"][name], cpu["old"][name]
        if name.endswith(("running_mean", "running_var")):
            atol = bn_atol * float(v.abs().max())
            err = float(((got - v).abs() - 1e-5 * v.abs()).max())
            worst_bn = max(worst_bn, err / max(atol, 1e-30))
            if not err <= atol:
                fails.append(f"{name} differs by {err} beyond rtol 1e-5 (atol {atol})")
            continue
        g_ref = cpu["grad"][name]
        gmax = max(float(g_ref.abs().max()), 1e-30)
        gerr = float((card["grad"][name] - g_ref).abs().max()) / gmax
        worst_g = max(worst_g, gerr)
        g_errs[name] = gerr
        if not gerr <= grad_tol:
            fails.append(f"{name} gradient differs by {gerr} of its largest |entry|")
        g_eff = g_ref + cpu["wd"][name] * old
        keep = g_eff.abs() >= keep_frac * float(g_eff.abs().max())
        kept += int(keep.sum())
        total += keep.numel()
        derr = (got - old) - (v - old)
        perr = float(derr[keep].abs().max()) / lr if bool(keep.any()) else 0.0
        worst_p = max(worst_p, perr)
        if not (perr <= 2e-3 and float(derr.abs().max()) <= 2.0 * lr * (1 + 1e-6)):
            fails.append(f"{name} update differs by {perr}·lr")
    ok = not fails
    log(f"{tag} one step at batch 8, card {card['m']} vs CPU plain {cpu['m']}: relative {rel} "
        f"(tol {loss_rtol}); worst gradient error {worst_g} of the tensor's largest "
        f"(tol {grad_tol}, {len(cpu['grad'])} tensors); worst update error {worst_p}·lr on "
        f"{kept}/{total} entries (tol 2e-3·lr); worst batch-stat error {worst_bn} of its "
        f"tolerance; ok={ok} ({time.perf_counter() - t0:.1f}s)")
    log(f"{tag} largest gradient errors (of the tensor's largest |entry|): " + ", ".join(
        f"{n} {e:.3e}" for n, e in sorted(g_errs.items(), key=lambda kv: -kv[1])[:8]))
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
                    print_freq=1, device="cuda", log_path=fresh_log_root())
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
           "--synthetic-train-size", "512", "--synthetic-val-size", "256", "--seed", "0",
           "--log_path", fresh_log_root()]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    log(f"[train-cli] {' '.join(cmd[1:])} -> exit {r.returncode} in {time.perf_counter() - t0:.1f}s")
    if r.returncode != 0:
        log(r.stdout[-2000:] + r.stderr[-4000:])
        return False
    res = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"[train-cli] result {res}; last log lines: {r.stderr.strip().splitlines()[-3:]}")
    return set(res) == {"best_acc1", "best_epoch"}


def profile_train_step(iters: int = 3, tag: str = "flagship", batch=None, trace: bool = True,
                       **cfg_kw) -> dict:
    """A train step of the flagship (or ``cfg_kw``'s model) at -b 256
    alone: CUDA-event time per step on a batch already on the card
    (``batch``, else seeded normal images) and the peak device memory of
    those steps (``torch.cuda.max_memory_allocated``: model, optimizer
    state, batch and the step's activations); then, with ``trace``,
    device time by kernel, with ``torch.rand``'s share (the stochastic
    family's draws) named."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.train.loop import build_training, epoch_schedule

    cfg = train_config(batch_size=TRAIN_BATCH, device="cuda", **cfg_kw).validate()
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    state, step_cfg = build_training(cfg, torch.device("cuda"), 10, 224)
    step = make_step(cfg, state, step_cfg)
    if batch is None:
        g = torch.Generator(device="cuda").manual_seed(3)
        batch = (torch.randn((TRAIN_BATCH, 224, 224, 3), generator=g, device="cuda"),
                 torch.randint(0, 1000, (TRAIN_BATCH,), generator=g, device="cuda"))
    tk, gate = epoch_schedule(family, cfg, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch, tk, gate), iters, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    log(f"[profile] {tag} train step -b {TRAIN_BATCH}, batch on the card: {ms:.2f} ms "
        f"= {TRAIN_BATCH / ms * 1e3:.1f} images/s (CUDA events, {iters} steps after 2 warm-up); "
        f"peak device memory {peak} bytes = {peak / 2**30:.2f} GiB")
    if not trace:
        del state, step, batch
        torch.cuda.empty_cache()
        return {"step_ms": ms, "peak_bytes": peak}
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
        shares = {k: sum(v for name, v in per_kernel.items() if kernel_id(name) == k)
                  for k in K_KERNEL_NAMES}
        log(f"[profile] {tag} K-kernels' device ms a step (share of busy): " + ", ".join(
            f"{k} {v:.3f} ({v / busy:.3f})" for k, v in shares.items())
            + f"; all K {sum(shares.values()):.3f} ({sum(shares.values()) / busy:.3f})")
        for name, kms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
            log(f"[profile]   {kms:8.4f} ms  {name[:100]}")
    del state, step, batch
    torch.cuda.empty_cache()
    return {"step_ms": ms, "busy_ms": busy, "wall_ms": wall_ms, "rand_ms": rand_ms,
            "peak_bytes": peak}


# the device kernels of each K wrapper, by the name the profiler gives them
K_KERNEL_NAMES = {
    "K1": ("binary_conv_fwd_kernel", "fwd_sign_prep_kernel"),
    "K2": ("weight_sign_kernel", "weight_alpha_finish_kernel"),
    "K5": ("binary_conv_dgrad_kernel", "dgrad_split_kernel"),
    "K6": ("binary_conv_wgrad_kernel", "binary_conv_wgrad_reduce_kernel", "wgrad_prep_kernel"),
    "K7": ("kurt_mean_kernel", "kurt_moments_kernel", "kurt_grad_kernel"),
}


def kernel_id(name: str):
    """The K wrapper a profiled device kernel belongs to, or None."""
    for k, names in K_KERNEL_NAMES.items():
        if any(n in name for n in names):
            return k
    return None


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


# the teacher-student main path (path 1): BASELINE config 4 in f32 (ImageNet
# resnet34 react student, 35 binary convs at the flagship's ten shapes;
# resnet34_float teacher; loss α·logitKL + λ·kurt under --react). Path 2:
# the four-term loss on resnet18 without --react, a resnet18_float teacher
# (16 name- and shape-matched conv pairs). Path 3: the bottleneck teacher
# resnet50_float over resnet18 under --react (logit-only KD).
TS_CONVS = 35
TS_STEPS = 3
TS_PATHS = {
    "path 1": dict(arch="resnet34", diffkurt=False, imagenet_setting_step_2_ts=True, react=True,
                   arch_teacher="resnet34_float"),
    "path 2": dict(arch="resnet18", diffkurt=False, imagenet_setting_step_2_ts=True, react=False,
                   arch_teacher="resnet18_float", alpha=0.9, beta=200.0),
    "path 3": dict(arch="resnet18", diffkurt=False, imagenet_setting_step_2_ts=True, react=True,
                   arch_teacher="resnet50_float"),
}


def phase_train_ts():
    """[train-ts]: the teacher–student step. (a) a teacher ``.pth.tar`` per
    teacher arch in torchvision's key layout; (b) ``fit`` on path 1 at -b
    256, 3 steps and the eval pass: finite losses, exactly 35 launches of
    K1, K2, K5, K6 and 2 of K7 a step (the teacher launches none), the
    teacher's parameters and statistics after the run bitwise what was
    loaded; (c) one TS step at batch 8 on the card against the CPU, the
    CPU's thresholded modules fed the card's inputs (:class:`InputReplay`);
    (d) path 2, 2 steps and the batch-8 step; (e) path 3, 2 steps; (f) the
    CLI trains 2 TS steps as a subprocess; (g) a profile of path 1's
    step. Returns (path 1's launch counts, ok)."""
    import torch

    from bdbnn_tpu_torch.train import loop

    tag = "[train-ts]"
    oks = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files, written = {}, {}
        for arch in sorted({kw["arch_teacher"] for kw in TS_PATHS.values()}):
            files[arch] = os.path.join(tmp, f"{arch}.pth.tar")
            written[arch] = write_teacher_checkpoint(files[arch], arch, "imagenet", seed=11)
        log(f"{tag} (a) wrote teacher files {sorted(files)} in {time.perf_counter() - t0:.1f}s")
        kw = {name: {**p, "resume_teacher": files[p["arch_teacher"]]} for name, p in TS_PATHS.items()}

        built = []
        build_teacher = loop.build_teacher

        def capture(cfg, device):
            built.append(build_teacher(cfg, device))
            return built[-1]

        loop.build_teacher = capture
        try:
            p1 = {k: v for k, v in kw["path 1"].items() if k != "arch"}
            counts, rec, oks["fit path 1"] = run_fit(f"{tag} (b) path 1", "resnet34", TS_STEPS,
                                                     TS_CONVS, **p1)
            ok_frozen = len(built) == 1 and not built[0].training
            want = written["resnet34_float"].state_dict()
            got = {k: v.cpu() for k, v in built[0].state_dict().items()} if built else {}
            differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
            oks["teacher frozen"] = ok_frozen and not differ and set(got) == set(want)
            log(f"{tag} (b) the teacher after fit: {len(want)} tensors, bitwise as loaded "
                f"{not differ}, eval mode {ok_frozen}, requires_grad none "
                f"{not any(p.requires_grad for p in built[0].parameters())}; differing {differ[:5]}")
            del built[:]
            for name, letter in (("path 2", "d"), ("path 3", "e")):
                pk = {k: v for k, v in kw[name].items() if k != "arch"}
                _, _, oks[f"fit {name}"] = run_fit(f"{tag} ({letter}) {name}", kw[name]["arch"],
                                                   2, **pk)
        finally:
            loop.build_teacher = build_teacher
        for name, letter in (("path 1", "c"), ("path 2", "d")):
            pk = {k: v for k, v in kw[name].items() if k != "arch"}
            oks[f"card vs CPU {name}"] = phase_train_parity(f"{tag} ({letter}) {name}",
                                                            kw[name]["arch"],
                                                            replay_inputs=("conv", "rprelu"), **pk)
        oks["cli"] = phase_train_ts_cli(tag, files["resnet34_float"])
        prof = profile_train_step(tag=f"{tag} (g) path 1 resnet34 + resnet34_float teacher",
                                  **kw["path 1"])
        teacher_ms, kd_ms = ts_parts(tag, kw["path 1"])
    ok = all(oks.values())
    log(f"{tag} {oks}; path 1 step {prof['step_ms']:.2f} ms = "
        f"{TRAIN_BATCH / prof['step_ms'] * 1e3:.1f} images/s, the teacher's forward alone "
        f"{teacher_ms / prof['step_ms']:.3f} of it, the KD loss terms alone "
        f"{kd_ms / prof['step_ms']:.5f}; fit's peak device memory {rec['peak_bytes']} bytes; "
        f"ok={ok}")
    return counts, ok


def phase_train_ts_cli(tag: str, teacher_file: str) -> bool:
    """``python -m bdbnn_tpu_torch.cli`` trains path 1 for 2 steps."""
    cmd = [sys.executable, "-m", "bdbnn_tpu_torch.cli", "--dataset", "imagenet", "-a", "resnet34",
           "--synthetic", "-b", "256", "--epochs", "1", "--imagenet_setting_step_2_ts", "--react",
           "--arch_teacher", "resnet34_float", "--resume_teacher", teacher_file, "--w-kurtosis",
           "--kd", "--synthetic-train-size", "512", "--synthetic-val-size", "256", "--seed", "0",
           "--log_path", fresh_log_root()]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    log(f"{tag} (f) {' '.join(cmd[1:])} -> exit {r.returncode} in {time.perf_counter() - t0:.1f}s")
    if r.returncode != 0:
        log(r.stdout[-2000:] + r.stderr[-4000:])
        return False
    res = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"{tag} (f) result {res}; last log lines: {r.stderr.strip().splitlines()[-3:]}")
    return set(res) == {"best_acc1", "best_epoch"}


def ts_parts(tag: str, cfg_kw: dict, iters: int = 10):
    """Path 1's teacher forward and KD loss terms alone at -b 256 (CUDA
    events after a warm-up): the teacher's eval forward under no_grad, and
    the loss terms' forward and backward from the student's logits.
    Returns their ms."""
    import torch

    from bdbnn_tpu_torch.losses.kd import distribution_loss, softmax_cross_entropy
    from bdbnn_tpu_torch.train.loop import build_teacher

    cfg = train_config(batch_size=TRAIN_BATCH, device="cuda", **cfg_kw).validate()
    teacher = build_teacher(cfg, torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((TRAIN_BATCH, 224, 224, 3), generator=g, device="cuda")
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=g, device="cuda")
    logits = torch.randn((TRAIN_BATCH, 1000), generator=g, device="cuda", requires_grad=True)

    def teacher_fwd():
        with torch.no_grad():
            return teacher(x)

    t_logits = teacher_fwd()

    w_ce = 0.0 if cfg.react else cfg.w_lambda_ce  # StepConfig.resolved()

    def kd_terms():
        loss = (distribution_loss(logits, t_logits) * cfg.alpha
                + softmax_cross_entropy(logits, labels) * w_ce)
        loss.backward()

    t_ms = cuda_ms(teacher_fwd, iters)
    kd_ms = cuda_ms(kd_terms, iters)
    log(f"{tag} (g) alone at -b {TRAIN_BATCH}: the teacher's forward (resnet34_float, eval, "
        f"no_grad, cuDNN {cfg.dtype}, TF32 off) {t_ms:.3f} ms; the KD loss terms (α·logitKL + "
        f"{w_ce}·CE, forward and backward) {kd_ms:.4f} ms (CUDA events, {iters} calls)")
    del teacher, x, logits, t_logits
    torch.cuda.empty_cache()
    return t_ms, kd_ms


# [train-resume]: the flagship recipe, 2 epochs of 4 steps at -b 256, a
# checkpoint every 2 steps; every fit under its own temporary log_path
RESUME_STEPS = 4
# 4096 val images: an untrained model's top-1 on random labels is about
# 0.1%, and model_best is written only when an eval's top-1 beats 0, so
# (f) and (g) read a model_best only if some image is right
RESUME_ARGS = dict(epochs=2, save_every_steps=2, batch_size=TRAIN_BATCH,
                   synthetic_train_size=RESUME_STEPS * TRAIN_BATCH, synthetic_val_size=4096,
                   device="cuda")
# (f): the student and its float teacher's arch
RESUME_TS = ("resnet18", "resnet18_float")
SCHED_KEYS = ("epoch", "step_in_epoch", "lr_step", "ede_t", "ede_k", "kurt_gate", "sched",
              "binarizer")
# the CLI run of (d), with cuDNN held to its deterministic algorithms as
# the in-process runs are (the stem conv's backward)
SIGKILL_CHILD = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
                 "from bdbnn_tpu_torch import cli; sys.exit(cli.main(sys.argv[1:]))")


def resume_cli_args(root: str) -> list:
    """The CLI flags of RESUME_ARGS over TRAIN_ARGS, under ``root``."""
    kw = {**TRAIN_ARGS, **RESUME_ARGS}
    assert kw["w_kurtosis"] and kw["diffkurt"] and kw["synthetic"]
    return ["--dataset", kw["dataset"], "-a", kw["arch"], "--synthetic", "-b",
            str(kw["batch_size"]), "--epochs", str(kw["epochs"]), "-lr", str(kw["lr"]),
            "--w-kurtosis", "--diffkurt", "--seed", str(kw["seed"]), "-p", str(kw["print_freq"]),
            "--save-every-steps", str(kw["save_every_steps"]),
            "--synthetic-train-size", str(kw["synthetic_train_size"]),
            "--synthetic-val-size", str(kw["synthetic_val_size"]), "--device", kw["device"],
            "--log_path", root]


def run_dir_of(root: str) -> str:
    from bdbnn_tpu_torch.obs.events import EVENTS_NAME

    (d,) = {dp for dp, _, fs in os.walk(root) if EVENTS_NAME in fs}
    return d


def final_payload(run_dir: str) -> dict:
    import torch

    from bdbnn_tpu_torch.utils import checkpoint as ck

    return torch.load(os.path.join(run_dir, ck.CKPT_NAME, ck.PAYLOAD_NAME), map_location="cpu",
                      weights_only=True)["state"]


def state_diff(a: dict, b: dict) -> list:
    """(name, max |a - b|) of every tensor that differs between two
    ``state_payload`` dicts (model, optimizer moments, step)."""
    import torch

    out = []
    if a["step"] != b["step"]:
        out.append(("step", abs(a["step"] - b["step"])))
    flat = lambda s: {**{"model " + k: v for k, v in s["model"].items()},
                      **{f"optimizer {i} {k}": v for i, st in s["optimizer"]["state"].items()
                         for k, v in st.items()}}
    fa, fb = flat(a), flat(b)
    for k in sorted(set(fa) | set(fb)):
        if k not in fa or k not in fb:
            out.append((k, "missing"))
            continue
        x, y = fa[k].cpu(), fb[k].cpu()
        if not torch.equal(x, y):
            out.append((k, float((x.double() - y.double()).abs().max())))
    return out


def device_snapshot(state) -> dict:
    """The state's model and optimizer tensors cloned where they lie (on
    the card: an enqueued copy, no wait), in ``state_payload``'s layout."""
    def clone(obj):
        if hasattr(obj, "detach"):
            return obj.detach().clone()
        if isinstance(obj, dict):
            return {k: clone(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(clone(v) for v in obj)
        return obj

    return {"model": clone(state.model.state_dict()),
            "optimizer": clone(state.optimizer.state_dict()), "step": int(state.step)}


class SaveSpy:
    """Wraps the loop's ``save_checkpoint``: a snapshot of the state the
    last save was given (cloned on its device, so the save's own timing
    is not disturbed), and the seconds of each save."""

    def __init__(self, loop):
        self.loop, self.real = loop, loop.save_checkpoint
        self.last, self.seconds = None, []

    def __enter__(self):
        def save(path, state, **kw):
            self.last = (kw, device_snapshot(state))
            t0 = time.perf_counter()
            out = self.real(path, state, **kw)
            self.seconds.append(time.perf_counter() - t0)
            return out

        self.loop.save_checkpoint = save
        return self

    def __exit__(self, *exc):
        self.loop.save_checkpoint = self.real


def resumed_like(tag: str, label: str, got_losses: dict, got_final: dict, a: dict) -> bool:
    """Each loss of a resumed run and its final state bitwise those of the
    uninterrupted run A; prints what differs and by how much."""
    import torch

    want = {k: v for k, v in a["losses"].items() if k >= min(got_losses)}
    differ = [k for k in want if k not in got_losses or not torch.equal(got_losses[k], want[k])]
    diff = state_diff(got_final, a["final"])
    ok = sorted(got_losses) == sorted(want) and not differ and not diff
    log(f"{tag} {label}: steps {sorted(got_losses)}; each loss bitwise A's {not differ} "
        f"(differing {[(k, float(got_losses[k]), float(want[k])) for k in differ[:4]]}); final "
        f"model, optimizer state and step bitwise A's {not diff} (differing, max |diff|: "
        f"{diff[:8]}{' ...' if len(diff) > 8 else ''} of {len(diff)})")
    return ok


def phase_train_resume(pk):
    """[train-resume]: checkpoints, preemption and resume of the flagship
    ``fit`` (RESUME_ARGS: 2 epochs × 4 steps at -b 256, a checkpoint every
    2 steps), cuDNN deterministic throughout. (a) run A uninterrupted;
    (b) run B through ``cli.main``, SIGTERMed from a thread right after
    its checkpoint event of epoch 1 step 2: exit 75, ``preempt`` and
    ``checkpoint`` events, the committed state bitwise what the save was
    given; (c) B resumed: the ``restore`` event's schedule fields bitwise
    the checkpoint event's, each later loss and the final model,
    optimizer state and step bitwise A's; (d) the CLI in a subprocess,
    SIGKILLed right after its first mid-epoch checkpoint event, resumed
    and held as (c); (e) A's final checkpoint loaded with
    ``device="cpu"``, bitwise the card's state; (f) a resnet18_float run
    dir as the teacher of a resnet18 --react student, bitwise what
    ``load_variables`` reads after ``fit``; (g) A exported and served on
    the card in three modes at bucket 32, bitwise across modes and
    within CPU_LOGIT_TOL of the CPU engine, its recorded accuracy A's
    best eval. Prints each checkpoint's seconds and bytes, the restore
    seconds, and the step time around the saves. Returns (run A's launch
    counts, ok)."""
    import signal
    import threading

    import numpy as np
    import torch

    from bdbnn_tpu_torch import cli
    from bdbnn_tpu_torch.obs import events as tevents
    from bdbnn_tpu_torch.obs.events import read_events
    from bdbnn_tpu_torch.train import loop
    from bdbnn_tpu_torch.utils import checkpoint as ck

    tag = "[train-resume]"
    oks = {}
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # (a) run A
        losses, walls, events = {}, [], []

        def on_step(epoch, step, m):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            walls.append(time.perf_counter())
            losses[(epoch, step)] = m["loss"].clone()

        root_a = fresh_log_root()
        reset_counts()
        t0 = time.perf_counter()
        with SaveSpy(loop) as spy_a:
            res_a = loop.fit(train_config(log_path=root_a, **RESUME_ARGS), on_step=on_step)
        counts = read_counts()
        torch.cuda.synchronize()
        dir_a = run_dir_of(root_a)
        a = {"losses": losses, "final": final_payload(dir_a), "res": res_a}
        ckpts = read_events(dir_a, "checkpoint")
        evals = read_events(dir_a, "eval")
        want = {"K1": 8 * N_BINARY_CONVS, "K2": 8 * N_BINARY_CONVS, "K5": 8 * N_BINARY_CONVS,
                "K6": 8 * N_BINARY_CONVS, "K7": 16}
        loss_vals = [float(v) for v in losses.values()]
        oks["a"] = (len(losses) == 2 * RESUME_STEPS and all(math.isfinite(v) for v in loss_vals)
                    and all(counts[k] >= n for k, n in want.items()) and len(ckpts) == 4
                    and not state_diff(spy_a.last[1], a["final"]))
        log(f"{tag} (a) run A: fit {2 * RESUME_STEPS} steps + 2 evals in "
            f"{time.perf_counter() - t0:.1f}s -> {res_a}; losses {loss_vals}; launches {counts} "
            f"(at least {want}: the evals add K1 and K2); final checkpoint bitwise what its save "
            f"was given {not state_diff(spy_a.last[1], a['final'])}")
        for e in ckpts:
            log(f"{tag} (h) checkpoint {e['reason']} epoch {e['epoch']} step {e['step_in_epoch']}:"
                f" seconds {e['seconds']} (event), {e['bytes']} bytes = "
                f"{e['bytes'] / 2**20:.1f} MiB")
        log(f"{tag} (h) save_checkpoint seconds, host clock (device copy, torch.save, sha256, "
            f"commit; model_best copies on improving evals): {[round(x, 4) for x in spy_a.seconds]}")
        # what a save adds to the step it follows: host time between the
        # on_step calls around it, against the others of the same epoch
        step_ms = [events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))]
        gap_ms = [(walls[i] - walls[i - 1]) * 1e3 for i in range(1, len(walls))]
        keys = sorted(losses)
        after_save = [i for i in range(1, len(keys)) if keys[i][1] == 2]
        plain = [i for i in range(1, len(keys)) if keys[i][1] in (1, 3)]
        mean = lambda xs: sum(xs) / max(len(xs), 1)
        log(f"{tag} (h) fit step ms (CUDA events between on_step calls) {[round(x, 2) for x in step_ms]};"
            f" host ms between steps {[round(x, 2) for x in gap_ms]}; steps with no save or eval "
            f"before them: mean {mean([gap_ms[i - 1] for i in plain]):.2f} ms host, "
            f"{mean([step_ms[i - 1] for i in plain]):.2f} ms events; steps after a mid-epoch "
            f"save: {mean([gap_ms[i - 1] for i in after_save]):.2f} ms host, "
            f"{mean([step_ms[i - 1] for i in after_save]):.2f} ms events")

        # (b) run B: SIGTERM through the CLI
        root_b = fresh_log_root()
        real_emit = tevents.EventWriter.emit

        def emit(self, kind, **fields):
            rec = real_emit(self, kind, **fields)
            if kind == "checkpoint" and (fields["epoch"], fields["step_in_epoch"]) == (1, 2):
                t = threading.Thread(target=os.kill, args=(os.getpid(), signal.SIGTERM))
                t.start()
                t.join()
            return rec

        tevents.EventWriter.emit = emit
        try:
            with SaveSpy(loop) as spy_b:
                rc = cli.main(resume_cli_args(root_b))
        finally:
            tevents.EventWriter.emit = real_emit
        dir_b = run_dir_of(root_b)
        pre = read_events(dir_b, "preempt")
        last_b = read_events(dir_b, "checkpoint")[-1]
        committed = state_diff(final_payload(dir_b), spy_b.last[1])
        oks["b"] = (rc == 75 and len(pre) == 1 and pre[0]["signum"] == signal.SIGTERM
                    and (last_b["reason"], last_b["epoch"], last_b["step_in_epoch"])
                    == ("preempt", 1, 3) and not committed)
        log(f"{tag} (b) run B, SIGTERM after the checkpoint of epoch 1 step 2: cli.main -> {rc}; "
            f"preempt {pre}; last checkpoint {last_b['reason']} ({last_b['epoch']}, "
            f"{last_b['step_in_epoch']}) lr_step {last_b['lr_step']}; committed state bitwise "
            f"what the save was given {not committed} {committed[:4]}")

        # (c) resume B
        losses_c = {}
        root_c = fresh_log_root()
        loop.fit(train_config(log_path=root_c, resume=dir_b, **RESUME_ARGS),
                 on_step=lambda e, i, m: losses_c.__setitem__((e, i), m["loss"].clone()))
        dir_c = run_dir_of(root_c)
        (restore,) = read_events(dir_c, "restore")
        same_sched = {k: restore[k] for k in SCHED_KEYS} == {k: last_b[k] for k in SCHED_KEYS}
        log(f"{tag} (c) resume B: restore event {dict((k, restore[k]) for k in SCHED_KEYS)}, "
            f"bitwise the checkpoint event's {same_sched}; load_checkpoint {restore['seconds']} s "
            f"(integrity {restore['integrity']}, fallback {restore['fallback']})")
        oks["c"] = same_sched and resumed_like(tag, "(c) resume B", losses_c,
                                               final_payload(dir_c), a)

        # (d) SIGKILL the CLI in a subprocess after its first mid-epoch checkpoint
        root_d = fresh_log_root()
        err_path = os.path.join(root_d, "stderr.txt")
        with open(err_path, "w") as err_f:
            proc = subprocess.Popen([sys.executable, "-c", SIGKILL_CHILD,
                                     *resume_cli_args(root_d)],
                                    cwd=REPO, stdout=subprocess.DEVNULL, stderr=err_f)
        hit = None
        try:
            deadline = time.time() + 300
            while hit is None and proc.poll() is None and time.time() < deadline:
                time.sleep(0.02)
                evs = [e for dp, _, fs in os.walk(root_d) if tevents.EVENTS_NAME in fs
                       for e in read_events(dp, "checkpoint")]
                hit = next((e for e in evs if e["step_in_epoch"] > 0), None)
            proc.kill()
            rc_d = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(err_path) as f:
            err = f.read()
        if hit is None:
            log(f"{tag} (d) FAIL: the subprocess never checkpointed mid-epoch: {err[-3000:]}")
            oks["d"] = False
        else:
            dir_d = run_dir_of(root_d)
            victim = read_events(dir_d, "checkpoint")
            log(f"{tag} (d) subprocess killed (exit {rc_d}) after its checkpoint ({hit['epoch']}, "
                f"{hit['step_in_epoch']}); its checkpoint events {[(e['epoch'], e['step_in_epoch']) for e in victim]}")
            losses_d = {}
            root_d2 = fresh_log_root()
            loop.fit(train_config(log_path=root_d2, resume=dir_d, **RESUME_ARGS),
                     on_step=lambda e, i, m: losses_d.__setitem__((e, i), m["loss"].clone()))
            dir_d2 = run_dir_of(root_d2)
            (restore_d,) = read_events(dir_d2, "restore")
            src = next(e for e in reversed(victim) if (e["epoch"], e["step_in_epoch"])
                       == (restore_d["epoch"], restore_d["step_in_epoch"]))
            same_d = {k: restore_d[k] for k in SCHED_KEYS} == {k: src[k] for k in SCHED_KEYS}
            log(f"{tag} (d) restore ({restore_d['epoch']}, {restore_d['step_in_epoch']}) from "
                f"{restore_d['source']} (fallback {restore_d['fallback']}), schedule fields "
                f"bitwise its checkpoint event's {same_d}; load_checkpoint {restore_d['seconds']} s")
            oks["d"] = rc_d == -signal.SIGKILL and same_d and resumed_like(
                tag, "(d) resume after SIGKILL", losses_d, final_payload(dir_d2), a)

        # (e) A's final checkpoint on the CPU
        cfg_cpu = train_config(log_path=root_a, **{**RESUME_ARGS, "device": "cpu"}).validate()
        state_cpu, _ = loop.build_training(cfg_cpu, torch.device("cpu"), RESUME_STEPS, 224)
        t0 = time.perf_counter()
        ck.load_checkpoint(dir_a, state_cpu)
        load_cpu_s = time.perf_counter() - t0
        diff_e = state_diff(ck.state_payload(state_cpu), spy_a.last[1])
        oks["e"] = not diff_e
        log(f"{tag} (e) A's final checkpoint loaded with device='cpu' in {load_cpu_s:.3f}s: "
            f"bitwise the card's state {not diff_e} {diff_e[:4]}")
        del state_cpu

        # (f) a float run dir as the teacher
        root_f = fresh_log_root()
        student, float_arch = RESUME_TS
        loop.fit(train_config(log_path=root_f, arch=float_arch, diffkurt=False,
                              w_kurtosis=False, batch_size=TRAIN_BATCH,
                              synthetic_train_size=2 * TRAIN_BATCH,
                              synthetic_val_size=RESUME_ARGS["synthetic_val_size"],
                              device=RESUME_ARGS["device"]))
        dir_f = run_dir_of(root_f)
        built = []
        build_teacher = loop.build_teacher
        loop.build_teacher = lambda cfg, device: (built.append(build_teacher(cfg, device)),
                                                  built[-1])[1]
        try:
            _, _, ok_ts = run_fit(f"{tag} (f) {student} --react, teacher from a run dir",
                                  student, 2, diffkurt=False, imagenet_setting_step_2_ts=True,
                                  react=True, arch_teacher=float_arch, resume_teacher=dir_f)
        finally:
            loop.build_teacher = build_teacher
        which = ck.BEST_NAME if os.path.isdir(os.path.join(dir_f, ck.BEST_NAME)) else ck.CKPT_NAME
        want_t = ck.load_variables(dir_f)
        got_t = {k: v.cpu() for k, v in built[0].state_dict().items()} if built else {}
        differ_t = [k for k in want_t if k not in got_t or not torch.equal(got_t[k], want_t[k])]
        oks["f"] = ok_ts and len(built) == 1 and not differ_t and set(got_t) == set(want_t)
        log(f"{tag} (f) the teacher after fit: {len(want_t)} tensors bitwise the float run's "
            f"{which} {not differ_t}; differing {differ_t[:4]}")
        del built[:]

        # (g) export A and serve it
        oks["g"] = serve_exported(tag, dir_a, evals, res_a["best_acc1"])
    finally:
        torch.backends.cudnn.deterministic = prev_det
    ok = all(oks.values())
    log(f"{tag} {oks} ok={ok}")
    return counts, ok


def serve_exported(tag: str, run_dir: str, evals: list, best_acc1: float) -> bool:
    """(g): ``export_artifact(run_dir)`` served on the card in dense,
    unpack and popcount modes at bucket 32: logits finite and bitwise
    equal across modes, within CPU_LOGIT_TOL of the CPU engine on images
    whose stem sums are exact (one nonzero pixel in any 7×7 window, so
    everything up to the pool is bitwise on both devices), and the
    artifact's recorded accuracy the run's best top-1 (``fit``'s result;
    the eval events round it to 4 decimals)."""
    import numpy as np

    from bdbnn_tpu_torch.serve.engine import InferenceEngine, max_abs_logit_drift
    from bdbnn_tpu_torch.serve.export import export_artifact
    from bdbnn_tpu_torch.utils import checkpoint as ck

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "art")
        t0 = time.perf_counter()
        a = export_artifact(run_dir, art)
        best = max(e["acc1"] for e in evals)
        has_best = os.path.isdir(os.path.join(run_dir, ck.BEST_NAME))
        rec = a["eval"]
        acc_ok = (rec["checkpoint_acc1"] == best_acc1 and round(best_acc1, 4) == best
                  if has_best else
                  rec["checkpoint_acc1"] is None and rec["best_seen_acc1"] == best == 0.0)
        log(f"{tag} (g) exported in {time.perf_counter() - t0:.1f}s: source {rec['source']}, "
            f"checkpoint_acc1 {rec['checkpoint_acc1']}, A's best_acc1 {best_acc1}, its eval "
            f"events {[e['acc1'] for e in evals]} "
            f"(model_best written: {has_best}; without one the artifact records no accuracy) "
            f"-> {acc_ok}; integrity {a['checkpoint']['integrity']}")
        ok = ok and acc_ok and a["checkpoint"]["integrity"] == "ok"
        modes = {"dense": {}, "unpack": {"packed": True, "packed_impl": "unpack"},
                 "popcount": {"packed": True, "packed_impl": "popcount"}}
        engines = {m: InferenceEngine(art, buckets=(32,), device="cuda", **kw)
                   for m, kw in modes.items()}
        rng = np.random.default_rng(4)
        hw, classes = a["image_size"], a["num_classes"]
        x = rng.normal(size=(32, hw, hw, 3)).astype(np.float32)
        out = {m: e.predict_logits(x) for m, e in engines.items()}
        fin = all(np.all(np.isfinite(v)) and v.shape == (32, classes) for v in out.values())
        same = all(np.array_equal(out[m].view(np.uint32), out["dense"].view(np.uint32))
                   for m in ("unpack", "popcount"))
        sparse = np.zeros_like(x)
        sparse[:, ::7, ::7, :] = rng.normal(size=sparse[:, ::7, ::7, :].shape)
        cpu = InferenceEngine(art, buckets=(32,), device="cpu")
        c, d = cpu.predict_logits(sparse), engines["dense"].predict_logits(sparse)
        rel = float(np.max(np.abs(c - d))) / max(float(np.max(np.abs(c))), 1e-30)
        top1 = bool(np.array_equal(c.argmax(-1), d.argmax(-1)))
        log(f"{tag} (g) bucket 32: logits finite {fin}, bitwise across dense/unpack/popcount "
            f"{same} (popcount vs dense {max_abs_logit_drift(out['popcount'], out['dense'])}); "
            f"CPU engine vs card on exact-stem images: relative {rel} (tol {CPU_LOGIT_TOL}), "
            f"top-1 equal {top1}")
        ok = ok and fin and same and rel <= CPU_LOGIT_TOL and top1
    return ok


# [train-folder]: ImageNet from an image folder. The tree (write_image_folder):
# 16 classes, 1,537 train JPEGs (6 steps at -b 256, one file truncated) and
# 512 val; fit runs the flagship recipe on it for 1 epoch
FOLDER_STEPS = 6
FOLDER_VAL = 512
# two epochs: the second's wall time holds no first step of fit (its
# first launches, the first pinned block)
FOLDER_EPOCHS = 2
FOLDER_THREAD_STEPS = 2


def _timed_build(task):
    """``_mp_build_batch`` in an input worker, timed there: (seconds,
    batch). Its round trip less these seconds is the batch's transfer."""
    from bdbnn_tpu_torch.data.pipeline import _mp_build_batch

    t0 = time.perf_counter()
    out = _mp_build_batch(task)
    return time.perf_counter() - t0, out


def _batches_equal(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        xa.dtype == xb.dtype and np.array_equal(xa, xb) and np.array_equal(ya, yb)
        for (xa, ya), (xb, yb) in zip(a, b))


def _thread_subset(root: str, folder, out: str) -> str:
    """A data dir beside ``root`` whose train split links every third train
    file (FOLDER_THREAD_STEPS batches and one over) and whose val split is
    ``root``'s."""
    for path, _ in folder.samples[::3]:
        rel = os.path.relpath(path, os.path.join(root, "train"))
        os.makedirs(os.path.dirname(os.path.join(out, "train", rel)), exist_ok=True)
        os.symlink(path, os.path.join(out, "train", rel))
    os.symlink(os.path.join(root, "val"), os.path.join(out, "val"))
    return out


def phase_train_folder(smi_line: str):
    """[train-folder]: ImageNet from an image folder on the flagship.
    (a) write_image_folder's tree, its bytes and seconds; (b) on the card's
    host: ``mp`` train batches bitwise at -j 1 and -j W, ``threads`` and
    ``mp`` eval batches bitwise, ``epoch(0, start_step=4)`` bitwise
    batches 4... of the uninterrupted epoch for both backends, and the
    truncated file one substitution with the expected index, substitute
    and path; ``prep_images`` on the card bitwise the host ``normalize``
    of the first batch; (c) ``fit`` with --device-normalize
    --input-backend mp -j W (W = cores − 2, at most 16) for 2 epochs of 6
    steps, each with the eval of 512 images, and under --input-backend
    threads for 2 steps: finite losses, 19 launches each of K1, K2, K5,
    K6 and 2 of K7 a step, one ``data_error`` event naming the truncated
    file in each epoch that holds it, no input worker alive after
    ``fit``; (d) the run exported and ``cli predict`` on the card over
    the folder's val split: exit 0, count 512, device cuda, its hits the
    engine's on the same images; the exported checkpoint's training eval
    forward (BN unfolded, normalized on the card) hits what its eval event
    says, and the engine's logits (BN folded into the artifact) match that
    forward's within CPU_LOGIT_TOL of the largest |logit| on the median
    image. The rest differ where rounding flips a binary activation's sign
    at its threshold: their count and the top-1 disagreements are logged,
    and predict's top-1 may differ from the eval's by those images;
    (e) times beside the card's name and power limit:
    decode per image on one thread, a batch of 256 alone per backend, the
    pin and copy of a uint8 batch, fit's step per backend and epoch, the
    device step on a folder batch on the card, and the device's idle
    share of fit's steps. Returns (the mp run's launch counts, ok)."""
    import contextlib
    import io
    import multiprocessing
    import shutil

    import numpy as np
    import torch

    from bdbnn_tpu_torch import cli
    from bdbnn_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        ImageFolder,
        ImageFolderPipeline,
        MPImageFolderPipeline,
        host_shard_indices,
        normalize,
    )
    from bdbnn_tpu_torch.data.pipeline import _load_one
    from bdbnn_tpu_torch.models import create_model
    from bdbnn_tpu_torch.obs.events import read_events
    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.export import export_artifact
    from bdbnn_tpu_torch.train.step import prep_images
    from bdbnn_tpu_torch.utils.checkpoint import load_variables

    tag = "[train-folder]"
    cores = os.cpu_count() or 1
    workers = max(1, min(16, cores - 2))
    log(f"{tag} host: os.cpu_count() {cores}, affinity {len(os.sched_getaffinity(0))} cpus; "
        f"-j {workers}")
    norm = (tuple(map(float, IMAGENET_MEAN)), tuple(map(float, IMAGENET_STD)))
    oks = {}
    pipes = []
    root = tempfile.mkdtemp(prefix="chip_smoke_folder-")
    try:
        # (a) the tree
        info = write_image_folder(root, val=FOLDER_VAL, threads=cores)
        log(f"{tag} (a) wrote {info['files']} JPEGs, {info['bytes']} bytes "
            f"({info['bytes'] / info['files'] / 1e3:.1f} kB a file) in {info['seconds']:.2f}s "
            f"on {cores} host threads; truncated {os.path.relpath(info['truncated'], root)} "
            f"(train index {info['index']})")
        train, val = (ImageFolder(os.path.join(root, s)) for s in ("train", "val"))

        # (e) decode alone, one thread, in this process
        times = {}
        for split, folder, is_train in (("train", train, True), ("eval", val, False)):
            t0 = time.perf_counter()
            for i in range(TRAIN_BATCH):
                _load_one(folder, i, np.random.default_rng(i), is_train, 224)
            times[split] = (time.perf_counter() - t0) / TRAIN_BATCH * 1e3
        log(f"{tag} (e) decode + transform per image, one thread: train {times['train']:.3f} "
            f"ms, eval {times['eval']:.3f} ms [{smi_line}; {cores} host cores]")

        # (b) pipeline gates on the host
        def mk(cls, folder, is_train, **kw):
            pipe = cls(folder, TRAIN_BATCH, train=is_train, seed=0, device_normalize=True, **kw)
            if hasattr(pipe, "close"):  # a worker pool to close
                pipes.append(pipe)
            return pipe

        mpw = mk(MPImageFolderPipeline, train, True, num_workers=workers)
        # one worker, one batch in flight: a batch's time alone
        mp1 = mk(MPImageFolderPipeline, train, True, num_workers=1, prefetch_batches=1)
        thr = mk(ImageFolderPipeline, train, True)
        mp_val = mk(MPImageFolderPipeline, val, False, num_workers=workers)
        thr_val = mk(ImageFolderPipeline, val, False)
        errs = {"mp": [], "threads": []}
        mpw.on_data_error, thr.on_data_error = errs["mp"].append, errs["threads"].append
        t0 = time.perf_counter()
        full_mp = list(mpw.epoch(0))
        t_mp_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        full_thr = list(thr.epoch(0))
        t_thr = time.perf_counter() - t0
        mpw.on_data_error = thr.on_data_error = None
        t0 = time.perf_counter()
        n_warm = len(list(mpw.epoch(1)))
        t_mp_warm = time.perf_counter() - t0
        it = thr.epoch(1)
        t0 = time.perf_counter()
        next(it)
        t_thr_one = time.perf_counter() - t0
        it.close()
        mp1._get_pool().apply(int, (0,))  # the worker is up
        it = mp1.epoch(0)
        t0 = time.perf_counter()
        first_j1 = [next(it)]
        t_mp_one = time.perf_counter() - t0
        first_j1.append(next(it))
        it.close()
        # each worker builds one batch, timed inside it: the round trip's
        # rest is the 38.5 MB's way back through the pool's pipe
        idx3 = host_shard_indices(len(train), 3, seed=0, drop_remainder_to=TRAIN_BATCH)
        tasks = [(3, idx3[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH].tolist())
                 for k in range(min(workers, len(idx3) // TRAIN_BATCH))]
        t0 = time.perf_counter()
        inner = [r.get()[0] for r in [mpw._get_pool().apply_async(_timed_build, (t,))
                                      for t in tasks]]
        t_trip = time.perf_counter() - t0
        log(f"{tag} (e) {len(tasks)} batches, one a worker: built in {[round(t, 3) for t in inner]} "
            f"s inside the workers, {t_trip:.3f} s round trip [{smi_line}]")
        oks["mp -j 1 == -j W"] = _batches_equal(first_j1, full_mp[:2])
        oks["threads eval == mp eval"] = _batches_equal(list(thr_val.epoch(0)),
                                                        list(mp_val.epoch(0)))
        oks["mp start_step 4"] = _batches_equal(list(mpw.epoch(0, start_step=4)), full_mp[4:])
        oks["threads start_step 4"] = _batches_equal(list(thr.epoch(0, start_step=4)),
                                                     full_thr[4:])
        n = len(train)
        want = {"index": info["index"], "substitute": (info["index"] + 1) % n,
                "path": info["truncated"]}
        for backend, got in errs.items():
            oks[f"{backend} data_error"] = (
                len(got) == 1 and {k: got[0][k] for k in want} == want
                and got[0]["error"].startswith("OSError"))
        log(f"{tag} (b) data errors: mp {errs['mp']}; threads {errs['threads']}")
        shapes = {x.shape for x, _ in full_mp + full_thr}
        oks["batch shapes"] = shapes == {(TRAIN_BATCH, 224, 224, 3)}
        log(f"{tag} (e) a -b {TRAIN_BATCH} batch alone: mp {t_mp_one * 1e3:.1f} ms (one worker "
            f"decodes it), threads {t_thr_one * 1e3:.1f} ms (8 threads); an epoch of "
            f"{len(full_mp)} batches: mp -j {workers} {t_mp_warm * 1e3 / n_warm:.1f} ms a "
            f"batch with the pool warm ({t_mp_cold:.2f}s for the first epoch, the pool's "
            f"spawn included), threads {t_thr * 1e3 / len(full_thr):.1f} ms a batch "
            f"[{smi_line}]")

        # the card's normalize against the host's, and the pinned copy
        x0 = full_mp[0][0]
        dev = torch.device("cuda")
        t_pin = []
        for _ in range(4):  # the first pin allocates the pinned block, later ones reuse it
            t0 = time.perf_counter()
            pinned = torch.from_numpy(x0).pin_memory()
            t_pin.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd = pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t_copy = time.perf_counter() - t0
        copy_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 5)
        got = prep_images(xd, norm).cpu().numpy()
        host = normalize(x0, IMAGENET_MEAN, IMAGENET_STD)
        oks["normalize bitwise"] = got.dtype == host.dtype and np.array_equal(
            got.view(np.uint32), host.view(np.uint32))
        scalar = ((xd.to(torch.float32) / 255.0 - torch.tensor(norm[0], device=dev))
                  / torch.tensor(norm[1], device=dev)).cpu().numpy()
        ulps = np.abs(scalar.view(np.int32).astype(np.int64) - host.view(np.int32))
        log(f"{tag} (b) prep_images on the card vs host normalize, {x0.nbytes} bytes of uint8: "
            f"bitwise {oks['normalize bitwise']}; dividing by the host scalar 255.0 instead "
            f"differs at {int(np.count_nonzero(ulps))} of {ulps.size} values, at most "
            f"{int(ulps.max())} ulp(s)")
        log(f"{tag} (e) uint8 batch to the card: pin_memory {[round(t, 2) for t in t_pin]} ms, "
            f"copy "
            f"{t_copy * 1e3:.2f} ms (first), {copy_ms:.3f} ms (CUDA events, pinned, 5 copies) "
            f"[{smi_line}]")
        del full_thr, first_j1, got, host, scalar, ulps
        for p in pipes:
            p.close()
        pipes.clear()

        # (c) fit on the folder, worker processes then threads
        logs = fresh_log_root()
        before = multiprocessing.active_children()
        counts, rec, oks["fit mp"] = run_fit(
            tag, "resnet18", FOLDER_STEPS, data=root, synthetic=False, device_normalize=True,
            input_backend="mp", workers=workers, epochs=FOLDER_EPOCHS, log_path=logs)
        left = [c for c in multiprocessing.active_children() if c not in before]
        oks["no worker left"] = left == []
        run_dir = run_dir_of(logs)
        derr = read_events(run_dir, "data_error")
        # one substitution in each epoch whose batches hold the truncated
        # file (epoch 0's do, by write_image_folder's choice)
        want_epochs = [e for e in range(FOLDER_EPOCHS) if info["index"] in host_shard_indices(
            len(train), e, seed=0, drop_remainder_to=TRAIN_BATCH)]
        oks["fit data_error"] = (
            want_epochs[:1] == [0] and [e["epoch"] for e in derr] == want_epochs
            and all(e["path"] == info["truncated"] for e in derr))
        evals = read_events(run_dir, "eval")
        oks["eval count"] = [e["count"] for e in evals] == [FOLDER_VAL] * FOLDER_EPOCHS
        log(f"{tag} (c) -j {workers} ({cores} host cores): data_error events {derr}; workers left "
            f"after fit {left}; evals {evals}")
        ivals = read_events(run_dir, "train_interval")
        epoch_step_ms = {}
        for e in read_events(run_dir, "epoch"):
            wait = sum(i["data_wait_s"] for i in ivals if i["epoch"] == e["epoch"])
            epoch_step_ms[e["epoch"]] = e["wall_s"] * 1e3 / FOLDER_STEPS
            log(f"{tag} (e) fit, mp, epoch {e['epoch']}: {e['wall_s']} s for {FOLDER_STEPS} "
                f"steps = {epoch_step_ms[e['epoch']]:.2f} ms a step (the epoch event's wall_s), "
                f"of which the loop waited for input {wait:.3f} s (train_interval data_wait_s) "
                f"[{smi_line}]")
        sub = _thread_subset(root, train, os.path.join(root, "threads"))
        _, rec_thr, oks["fit threads"] = run_fit(
            tag + "[threads]", "resnet18", FOLDER_THREAD_STEPS, data=sub, synthetic=False,
            device_normalize=True, input_backend="threads")

        # (d) predict over the export, and the export's engine against the
        # training eval forward of the same checkpoint on the same images
        art = os.path.join(root, "art")
        export_artifact(run_dir, art)
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["predict", art, root])
        wall = time.perf_counter() - t0
        pcounts = read_counts()
        res = json.loads(out.getvalue())
        # the artifact holds model_best (the best eval), or the last
        # checkpoint when no eval beat 0
        acc_e = res["recorded_checkpoint_acc1"]
        if acc_e is None:
            acc_e = 100.0 * round(evals[-1]["acc1"] * FOLDER_VAL / 100.0) / FOLDER_VAL
        model = create_model("resnet18", "imagenet")
        model.load_state_dict(load_variables(run_dir))
        model = model.to(dev).eval()
        engine = InferenceEngine(art, buckets=(TRAIN_BATCH,), device="cuda")
        le, lp, ys = [], [], []
        for x, y in ImageFolderPipeline(val, TRAIN_BATCH, train=False,
                                        device_normalize=True).epoch(0):
            with torch.no_grad():
                le.append(model(prep_images(torch.from_numpy(x).to(dev), norm)).cpu().numpy())
            lp.append(engine.predict_logits(normalize(x, IMAGENET_MEAN, IMAGENET_STD)))
            ys.append(y)
        le, lp, ys = (np.concatenate(v) for v in (le, lp, ys))
        drift = np.abs(le - lp).max(-1) / np.abs(le).max(-1)
        hits_e, hits_p = int((le.argmax(-1) == ys).sum()), int((lp.argmax(-1) == ys).sum())
        flips = int((le.argmax(-1) != lp.argmax(-1)).sum())
        oks["predict"] = (rc == 0 and res["count"] == FOLDER_VAL and res["correct"] == hits_p
                          and res["device"].startswith("cuda"))
        oks["eval forward"] = hits_e == round(acc_e * FOLDER_VAL / 100.0)
        oks["engine vs eval forward"] = float(np.median(drift)) <= CPU_LOGIT_TOL
        log(f"{tag} (d) cli predict {art} {root}: exit {rc} in {wall:.1f}s, top1 {res['top1']} "
            f"({res['correct']} of {res['count']}) device {res['device']}, recorded checkpoint "
            f"acc1 {res['recorded_checkpoint_acc1']} (match {res['match']}); the eval events' "
            f"acc1 {[e['acc1'] for e in evals]}; launches {pcounts}")
        log(f"{tag} (d) the exported checkpoint's training eval forward (BN unfolded, the uint8 "
            f"normalized on the card) hits {hits_e}, the engine (BN folded, host normalize) "
            f"{hits_p}; per-image max |logit difference| / max |logit|: median "
            f"{np.median(drift):.3e} (tol {CPU_LOGIT_TOL}), 90th pct "
            f"{np.quantile(drift, 0.9):.3e}, max {drift.max():.3e}; images above 1e-4 "
            f"{int((drift > 1e-4).sum())}, top-1 disagreements {flips} of {len(ys)}")
        del model, engine

        # (e) the device step on a folder batch already on the card
        batch = (xd, torch.from_numpy(full_mp[0][1]).to(dev))
        prof = profile_train_step(tag="flagship (folder batch, uint8, --device-normalize)",
                                  batch=batch, data=root, synthetic=False, device_normalize=True)
        steps = {"mp, epoch 0 (fit's first step included)": epoch_step_ms[0],
                 "mp, epoch 1": epoch_step_ms[1],
                 "threads": sum(rec_thr["step_ms"]) / max(len(rec_thr["step_ms"]), 1)}
        for label, ms in steps.items():
            log(f"{tag} (e) fit's step, {label}: {ms:.2f} ms = {TRAIN_BATCH / ms * 1e3:.1f} "
                f"images/s; device step alone {prof['step_ms']:.2f} ms; the device's idle share "
                f"of fit's steps (1 − device step / fit's step) {1 - prof['step_ms'] / ms:.3f} "
                f"[{smi_line}; -j {workers}, {cores} host cores]")
    finally:
        for p in pipes:
            p.close()
        shutil.rmtree(root, ignore_errors=True)
    ok = all(oks.values())
    log(f"{tag} {oks} ok={ok}")
    return counts, ok


# [train-bf16]: bf16 compute and remat, as MIGRATION.md's ImageNet
# recipes 3-5 run (--dtype bfloat16). UB bounds one bf16 rounding of a
# value (its distance to either bf16 neighbour is at most 2^-8 of it).
UB = 2.0**-8
BF16_STEPS = 3


def bf16_kernels(tag: str, pk):
    """(a) K1, K2, K5 and K6 in their bf16 modes at the flagship's ten
    distinct binary conv shapes at -b 256, each held to its plain bf16
    version: K1 and K2's sign bitwise, K2's alpha within one bf16 rounding
    (both sum in float64) and bitwise across two runs; K5 (the flagship's
    approx slope) and K6 to the float64 sum of the same bf16 products
    within the f32 summation bound 4u·Σ|terms| plus one bf16 rounding of
    the result, and to the plain version within 8u·Σ|terms| (the plain's
    f32 sum has its own error) plus two roundings; K5 and K6 bitwise
    across two runs. Times each beside its plain version and cuDNN's bf16
    ``conv2d`` / ``conv2d_input`` / ``conv2d_weight`` on the same ±1
    operands (the library yardstick); bounds from bf16 bytes and, for K5
    and K6, 2·MACs at the bf16 tensor rate (one bf16 piece of g·alpha).
    Returns per-kernel records (without ``launches``) and ok."""
    import torch
    import torch.nn.functional as F
    from torch.nn import grad as tgrad

    from bdbnn_tpu_torch.nn.kernels import (
        binary_conv2d,
        binary_conv2d_dgrad,
        binary_conv2d_dgrad_plain,
        binary_conv2d_plain,
        binary_conv2d_wgrad,
        binary_conv2d_wgrad_plain,
        weight_binarize,
        weight_binarize_plain,
    )
    from bdbnn_tpu_torch.nn.kernels.binary_conv import binarize_input, estimator_slope

    bf = torch.bfloat16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    recs = {f"{k} bf16": {"shapes": []} for k in BF16_KERNELS}
    ok = True
    approx = ("approx", 0.0, 0.0)
    b = TRAIN_BATCH
    for name, hw, c, o, k, s, count in FLAGSHIP_CONVS:
        pad = k // 2
        ho = (hw + 2 * pad - k) // s + 1
        st = (s, s)
        m, kk = b * ho * ho, k * k * c
        macs = m * o * kk
        x = torch.randn((b, hw, hw, c), generator=g, device=dev).to(bf)
        shift = (0.1 * torch.randn((c,), generator=g, device=dev)).to(bf)
        w = 0.5 * torch.randn((k, k, c, o), generator=g, device=dev)  # some |W| > 1
        gy = torch.randn((b, ho, ho, o), generator=g, device=dev).to(bf)
        rows = {}
        # K2
        sign, alpha = weight_binarize(w, dtype=bf)
        sign2, alpha2 = weight_binarize(w, dtype=bf)
        psign, palpha = weight_binarize_plain(w, dtype=bf)
        a_err = (alpha.float() - palpha.float()).abs()
        k2_ok = (torch.equal(sign, psign) and bool((a_err <= UB * palpha.float().abs()).all())
                 and torch.equal(sign, sign2) and torch.equal(alpha, alpha2))
        nw = w.numel()
        rows["K2"] = _conv_row(name, b, count, cuda_ms(lambda: weight_binarize(w, dtype=bf), 50),
                               cuda_ms(lambda: weight_binarize_plain(w, dtype=bf), 20), None,
                               bound(nw * 4 + nw + o * 2, 3.0 * nw, pk["f32_tflops"], pk),
                               float(a_err.max()), k2_ok,
                               graph_ms=graph_ms(lambda: weight_binarize(w, dtype=bf)))
        # K1, and cuDNN's bf16 conv on the same ±1 operands
        y, py = (binary_conv2d(x, sign, alpha, shift=shift, strides=st),
                 binary_conv2d_plain(x, sign, alpha, shift=shift, strides=st))
        k1_ok = torch.equal(y, py)
        xb = binarize_input(x, shift).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        wf = sign.permute(0, 3, 1, 2).to(bf).contiguous(memory_format=torch.channels_last)
        rows["K1"] = _conv_row(
            name, b, count,
            cuda_ms(lambda: binary_conv2d(x, sign, alpha, shift=shift, strides=st), 20),
            cuda_ms(lambda: binary_conv2d_plain(x, sign, alpha, shift=shift, strides=st), 3),
            cuda_ms(lambda: F.conv2d(xb, wf, stride=st, padding=pad), 20),
            bound(b * hw * hw * c * 2 + o * kk + o * 2 + c * 2 + m * o * 2, 2.0 * macs,
                  pk["int8_tops"], pk),
            float((y.float() - py.float()).abs().max()), k1_ok)
        del y, py
        # K5: the sum against the float64 one, then the approx slope
        dx = binary_conv2d_dgrad(gy, x, sign, alpha, shift=shift, strides=st, estimator=approx)
        dx2 = binary_conv2d_dgrad(gy, x, sign, alpha, shift=shift, strides=st, estimator=approx)
        pdx = binary_conv2d_dgrad_plain(gy, x, sign, alpha, shift=shift, strides=st,
                                        estimator=approx)
        exact = dgrad_exact(gy, x, sign, alpha, s, pad)  # of the bf16 products g·alpha
        ga = (gy * alpha).float()
        terms = binary_conv2d_dgrad_plain(ga.abs(), x.float(), torch.ones_like(sign),
                                          torch.ones((o,), device=dev), strides=st).double()
        slope = estimator_slope(x - shift, approx).double().abs()
        ex = exact * slope
        err_ex = (dx.double() - ex).abs()
        err = (dx.double() - pdx.double()).abs()
        # the sum and the slope multiply each round once more on each side
        bound_ex = (4 * U * terms + UB * exact.abs()) * slope + UB * (dx.double().abs() + ex.abs())
        bound_p = ((8 * U * terms + 2 * UB * exact.abs()) * slope
                   + UB * (dx.double().abs() + pdx.double().abs()))
        k5_ok = (torch.equal(dx, dx2) and bool((err_ex <= bound_ex + 1e-30).all())
                 and bool((err <= bound_p + 1e-30).all()))
        log(f"{tag} (a) K5 bf16 {name} b{b} approx: within bound and bitwise across two runs "
            f"{k5_ok}; entries off the plain version {int((err > 0).sum())} of {err.numel()}, "
            f"off the rounded float64 sum {int((err_ex > UB * ex.abs()).sum())}; largest error "
            f"over its bound: vs exact {float((err_ex / (bound_ex + 1e-30)).max()):.3f}, vs plain "
            f"{float((err / (bound_p + 1e-30)).max()):.3f}")
        gan = ga.to(bf).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        rows["K5"] = _conv_row(
            name, b, count,
            cuda_ms(lambda: binary_conv2d_dgrad(gy, x, sign, alpha, shift=shift, strides=st,
                                                estimator=approx), 10),
            cuda_ms(lambda: binary_conv2d_dgrad_plain(gy, x, sign, alpha, shift=shift, strides=st,
                                                      estimator=approx), 3),
            cuda_ms(lambda: tgrad.conv2d_input((b, c, hw, hw), wf, gan, stride=s, padding=pad), 10),
            bound(gy.numel() * 2 + 2 * x.numel() * 2 + sign.numel() + (o + c) * 2, 2.0 * macs,
                  pk["bf16_tflops"], pk),
            float(err.max()), k5_ok)
        del dx, dx2, pdx, exact, terms, slope, ex, err, err_ex, bound_ex, bound_p
        # K6: against the float64 sum, masked on bf16(W)
        dw = binary_conv2d_wgrad(gy, x, w, alpha, shift=shift, strides=st)
        dw2 = binary_conv2d_wgrad(gy, x, w, alpha, shift=shift, strides=st)
        pdw = binary_conv2d_wgrad_plain(gy, x, w, alpha, shift=shift, strides=st)
        ex6 = wgrad_exact(gy, x, w.to(bf).float(), alpha, shift, s, pad)
        wterms = binary_conv2d_wgrad_plain(ga.abs(), torch.ones_like(x, dtype=torch.float32),
                                           torch.zeros_like(w), torch.ones((o,), device=dev),
                                           strides=st).double()
        err6_ex = (dw.double() - ex6).abs()
        err6 = (dw - pdw).abs().double()
        k6_ok = (torch.equal(dw, dw2)
                 and bool((err6_ex <= 4 * U * wterms + UB * ex6.abs() + 1e-30).all())
                 and bool((err6 <= 8 * U * wterms + UB * (dw.abs() + pdw.abs()).double()
                           + 1e-30).all()))
        log(f"{tag} (a) K6 bf16 {name} b{b}: within bound and bitwise across two runs {k6_ok}; "
            f"entries off the plain version {int((err6 > 0).sum())} of {err6.numel()}")
        rows["K6"] = _conv_row(
            name, b, count,
            cuda_ms(lambda: binary_conv2d_wgrad(gy, x, w, alpha, shift=shift, strides=st), 10),
            cuda_ms(lambda: binary_conv2d_wgrad_plain(gy, x, w, alpha, shift=shift, strides=st), 3),
            cuda_ms(lambda: tgrad.conv2d_weight(xb, wf.shape, gan, stride=s, padding=pad), 10),
            bound(gy.numel() * 2 + x.numel() * 2 + 2 * w.numel() * 4 + (o + c) * 2, 2.0 * macs,
                  pk["bf16_tflops"], pk),
            float(err6.max()), k6_ok)
        for kname in BF16_KERNELS:
            r = rows[kname]
            recs[f"{kname} bf16"]["shapes"].append(r)
            _log_row(f"{kname} bf16", r)
            ok = ok and r["ok"]
        del x, gy, w, dw, dw2, pdw, ex6, wterms, err6, err6_ex, ga, gan, xb, wf
        torch.cuda.empty_cache()
    return recs, ok


def phase_train_bf16(pk, f32_prof: dict):
    """[train-bf16]: (a) the bf16 modes of K1, K2, K5 and K6 against their
    plain versions (:func:`bf16_kernels`); (b) ``fit`` on the flagship
    recipe with --dtype bfloat16 at -b 256, 3 steps and the eval pass,
    exact launch counts (19 bf16 launches each of K1, K2, K5, K6 a step, 2
    of K7), finite losses; one batch-8 step on the card against the CPU
    with InputReplay, to :data:`BF16_PARITY`; the device step beside f32's
    ([profile], ``f32_prof``); (c) the same recipe with --remat: K1 and K2
    at 38 a step, the BN running statistics bitwise those of (b) (cuDNN
    deterministic in both), the step time and peak memory beside the runs
    without remat, in f32 and bf16; (d) BASELINE config 4 in bf16
    (resnet34 --react, a seeded resnet34_float teacher file, 3 steps):
    exact launch counts, the step, the teacher's forward alone as a share
    of it, fit's peak memory; (e) (b)'s run exported and served in dense
    and packed/unpack at bucket 32 (:func:`serve_bf16`). Returns
    (launch counts of (b), (c), (d) and (e), per-kernel records of (a), ok)."""
    import torch

    tag = "[train-bf16]"
    oks = {}
    t0 = time.perf_counter()
    krecs, oks["(a) kernels"] = bf16_kernels(tag, pk)
    log(f"{tag} (a) in {time.perf_counter() - t0:.1f}s")
    bf = dict(dtype="bfloat16")
    roots = {"b": fresh_log_root(), "c": fresh_log_root()}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts = {}
        counts["train-bf16"], rec_b, oks["(b) fit"] = run_fit(
            f"{tag} (b)", "resnet18", BF16_STEPS, log_path=roots["b"], **bf)
        counts["train-bf16-remat"], rec_c, oks["(c) fit remat"] = run_fit(
            f"{tag} (c)", "resnet18", BF16_STEPS, fwd_repeats=2, remat=True, log_path=roots["c"], **bf)
    finally:
        torch.backends.cudnn.deterministic = det
    sb, sc = (final_payload(run_dir_of(roots[k])) for k in ("b", "c"))
    stats = [k for k in sb["model"] if k.endswith(("running_mean", "running_var"))]
    differ = [k for k in stats if not torch.equal(sb["model"][k], sc["model"][k])]
    oks["(c) BN stats as without remat"] = bool(stats) and not differ
    log(f"{tag} (c) remat against (b) after {BF16_STEPS} steps: {len(stats)} running statistics, "
        f"bitwise {not differ} (differing: {differ[:4]}); losses bitwise "
        f"{rec_b['losses'] == rec_c['losses']}; tensors of model and optimizer that differ "
        f"{len(state_diff(sb, sc))}")
    oks["(b) card vs CPU"] = phase_train_parity(f"{tag} (b)", "resnet18",
                                                replay_inputs=("conv", "rprelu"), **BF16_PARITY, **bf)
    prof = {"f32": f32_prof,
            "bf16": profile_train_step(tag=f"{tag} (b) flagship bf16", **bf),
            "f32 remat": profile_train_step(tag=f"{tag} (c) flagship f32 remat", trace=False,
                                            remat=True),
            "bf16 remat": profile_train_step(tag=f"{tag} (c) flagship bf16 remat", trace=False,
                                             remat=True, **bf)}
    log(f"{tag} (b)/(c) flagship train step -b {TRAIN_BATCH} on the card, by mode: " + "; ".join(
        f"{k} {v['step_ms']:.2f} ms = {TRAIN_BATCH / v['step_ms'] * 1e3:.1f} images/s, peak "
        f"{v['peak_bytes'] / 2**30:.2f} GiB" for k, v in prof.items())
        + f"; bf16 / f32 step {prof['bf16']['step_ms'] / f32_prof['step_ms']:.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        teacher = os.path.join(tmp, "resnet34_float.pth.tar")
        write_teacher_checkpoint(teacher, "resnet34_float", "imagenet", seed=11)
        p1 = {k: v for k, v in TS_PATHS["path 1"].items() if k != "arch"}
        p1.update(resume_teacher=teacher, **bf)
        counts["train-bf16-ts"], rec_d, oks["(d) fit"] = run_fit(
            f"{tag} (d) BASELINE config 4", "resnet34", TS_STEPS, TS_CONVS, **p1)
        prof_d = profile_train_step(tag=f"{tag} (d) resnet34 + resnet34_float bf16", arch="resnet34",
                                    **p1)
        teacher_ms, kd_ms = ts_parts(f"{tag} (d)", {"arch": "resnet34", **p1})
    log(f"{tag} (d) BASELINE config 4 in bf16: step {prof_d['step_ms']:.2f} ms = "
        f"{TRAIN_BATCH / prof_d['step_ms'] * 1e3:.1f} images/s, the teacher's forward alone "
        f"{teacher_ms:.3f} ms = {teacher_ms / prof_d['step_ms']:.3f} of it, the KD loss terms "
        f"{kd_ms / prof_d['step_ms']:.5f}; fit's peak device memory {rec_d['peak_bytes']} bytes "
        f"= {rec_d['peak_bytes'] / 2**30:.2f} GiB")
    counts["serve-bf16"], oks["(e) serve"] = serve_bf16(tag, run_dir_of(roots["b"]))
    ok = all(oks.values())
    log(f"{tag} {oks} ok={ok}")
    return counts, krecs, ok


def serve_bf16(tag: str, run_dir: str):
    """(e) the bf16 run exported (the artifact records dtype=bfloat16) and
    served on the card at bucket 32 in dense and packed/unpack: logits
    finite and bitwise across the two modes; against the CPU engine on
    images with one nonzero value in any 7×7 window of one channel (each
    stem sum is one exact product, so both devices are bitwise up to the
    pool), within two bf16 ulps of the largest |logit| (the pool's f32 mean
    and the classifier's f32 sum run in another order on each device and
    may round to the neighbouring bf16 value); packed/popcount refused
    with the reference's ValueError. Returns (launch counts of the two
    modes' forwards, ok)."""
    import numpy as np

    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.export import export_artifact

    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "art")
        a = export_artifact(run_dir, art)
        engines = {"dense": InferenceEngine(art, buckets=(32,), device="cuda"),
                   "unpack": InferenceEngine(art, buckets=(32,), device="cuda", packed=True)}
        x = np.random.default_rng(6).normal(size=(32, 224, 224, 3)).astype(np.float32)
        reset_counts()
        out = {m: e.predict_logits(x) for m, e in engines.items()}
        counts = {**read_counts(), **read_bf16_counts()}
        fin = all(np.all(np.isfinite(v)) and v.shape == (32, 1000) for v in out.values())
        same = np.array_equal(out["dense"].view(np.uint32), out["unpack"].view(np.uint32))
        sparse = np.zeros_like(x)
        sparse[:, ::7, ::7, 0] = np.random.default_rng(7).normal(size=sparse[:, ::7, ::7, 0].shape)
        c = InferenceEngine(art, buckets=(32,), device="cpu").predict_logits(sparse)
        d = engines["dense"].predict_logits(sparse)
        rel = float(np.max(np.abs(c - d))) / max(float(np.max(np.abs(c))), 1e-30)
        try:
            InferenceEngine(art, buckets=(32,), device="cuda", packed=True, packed_impl="popcount")
            refused = False
        except ValueError:
            refused = True
        want = {"K1 bf16": 2 * N_BINARY_CONVS, "K2 bf16": 2 * N_BINARY_CONVS}
        ok = (a["model"]["dtype"] == "bfloat16" and fin and same and rel <= 2 * UB and refused
              and all(counts[k] == n for k, n in want.items()) and counts["K4"] == 0)
        log(f"{tag} (e) the bf16 artifact (dtype {a['model']['dtype']}) at bucket 32: logits "
            f"finite {fin}, bitwise across dense/unpack {same}; CPU engine vs card on "
            f"one-channel exact-stem images: relative {rel} (tol {2 * UB}), top-1 equal on "
            f"{int((c.argmax(-1) == d.argmax(-1)).sum())} of 32; popcount refused {refused}; "
            f"launches {counts} (one forward a mode: {want} each); ok={ok}")
    return counts, ok


# ---------------------------------------------------------------------------
# [train-ddp]: data parallelism across processes
# ---------------------------------------------------------------------------

# the ranks of (a), on the one card over gloo, and (a)'s steps: with
# --save-every-steps 2 the run commits a mid-epoch checkpoint at step 2,
# which the epoch-end save displaces to checkpoint.old for (d)
DDP_WORLD = 2
DDP_STEPS = 3
# a rank's collectives, and a spawned job as a whole, fail past these
DDP_TIMEOUT_S = 300.0
DDP_JOB_TIMEOUT_S = 480.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(job: str, world: int, device: str, backend: str, kw: dict,
                timeout_s: float = DDP_JOB_TIMEOUT_S) -> list:
    """``DDP_JOBS[job](**kw)`` on ``world`` ranks, each a spawned process
    that joins one process group over ``backend`` at a free localhost port
    (torchrun's environment, set by hand) with every rank on ``device``;
    returns each rank's result, in rank order. A rank that fails or
    outlasts ``timeout_s`` stops every rank and raises."""
    import multiprocessing
    import shutil

    import torch

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks-")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, device, backend, job, kw, outs[r]))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a rank failed: the others would wait for it in vain
            time.sleep(0.1)
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"data-parallel job {job!r} on {world} ranks ({backend}, {device}): "
                               f"ranks (rank, exit code) {failed} failed or outlasted "
                               f"{timeout_s:.0f}s")
        return [torch.load(o, map_location="cpu", weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, world: int, port: int, device: str, backend: str, job: str, kw: dict,
               out: str) -> None:
    """A spawned rank of :func:`spawn_ranks`: join the group, run the job,
    save its result to ``out``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch

    from bdbnn_tpu_torch.parallel import initialize_distributed

    if device == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(backend=backend, device=device, timeout_s=DDP_TIMEOUT_S)
    try:
        torch.save(DDP_JOBS[job](**kw), out)
    finally:
        torch.distributed.destroy_process_group()


class SignTape:
    """The sign each binary conv takes of its input in one forward,
    ``x - shift >= 0`` (what K1 fuses), recorded by forward pre-hooks for
    the model's first ``n`` binary conv calls, each as numpy ``packbits``
    of its rows; :func:`sign_crossings` counts where two runs differ."""

    def __init__(self, model):
        from bdbnn_tpu_torch.nn.layers import _BinaryConvBase

        mods = [m for m in model.modules() if isinstance(m, _BinaryConvBase)]
        self.n = len(mods)
        self.rows = []
        self.handles = [m.register_forward_pre_hook(self._hook) for m in mods]

    def _hook(self, mod, args):
        import numpy as np

        if len(self.rows) >= self.n:
            return
        x = args[0].detach()
        v = x - mod.act_shift.detach().to(x.dtype) if mod.has_shift else x
        self.rows.append(np.packbits((v >= 0).reshape(x.shape[0], -1).cpu().numpy(), axis=1))

    def close(self) -> None:
        for h in self.handles:
            h.remove()


def sign_crossings(rank_rows: list, one_rows: list) -> list:
    """Per binary conv, the signs where the ranks' rows (concatenated in
    rank order) and one process's rows of the same global batch differ."""
    import numpy as np

    return [int(np.unpackbits(np.concatenate([r[i] for r in rank_rows]) ^ ref).sum())
            for i, ref in enumerate(one_rows)]


class ShardReplay:
    """Draws recorded over the global batch (:class:`MarginDraws` in one
    process), replayed in order, each cut to rank ``rank``'s rows
    ``[rank·B, (rank+1)·B)`` of ``world``: the layout of ``StepDraws`` with
    a ``shard``."""

    def __init__(self, drawn, rank: int, world: int):
        self.queue, self.rank, self.world = list(drawn), rank, world

    def __call__(self, x):
        import torch

        u, b = self.queue.pop(0), x.shape[0]
        if tuple(u.shape) != (b * self.world, *x.shape[1:]):
            raise ValueError(f"replayed draw {u.shape} for rows {tuple(x.shape)} of {self.world}")
        return torch.from_numpy(u[self.rank * b:(self.rank + 1) * b]).to(x.device)


def ddp_steps(cfg_kw: dict, batches: list, device: str = "cpu", draws=None, signs: bool = False,
              steps_per_epoch: int = 4, inputs=None) -> dict:
    """Train steps of ``RunConfig(**cfg_kw)``'s model from its seeded
    init, one per global batch of ``batches`` (numpy (x, y)), on this
    process's rows of each: rank r of a job of W takes rows
    ``[r·B, (r+1)·B)``, one process all of them. ``draws``: the stochastic
    family's source (a callable), or the list of global draws a
    :class:`MarginDraws` recorded, replayed to each rank
    (:class:`ShardReplay`). Returns the per-step losses (this process's
    mean), the first step's gradients, the state after the steps
    (``state_payload``; the model's after the first step too, when there
    are more) and, with ``signs``, the first forward's :class:`SignTape`
    rows. ``inputs="record"``: the input of every binary conv and RPReLU
    call of the first step (its forward, and remat's recompute), this
    process's rows, as ``inputs``; a list of such inputs of the global
    batch (the ranks' concatenated): the first step's binary convs and
    RPReLUs take them in its place (:class:`InputReplay`), and
    ``input_flips`` counts, by kind, the values this process's own inputs
    would have put on the other side of their threshold."""
    import dataclasses

    import numpy as np
    import torch

    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.parallel import create_sharded_state, make_mesh
    from bdbnn_tpu_torch.train.config import RunConfig
    from bdbnn_tpu_torch.train.loop import build_training, epoch_schedule
    from bdbnn_tpu_torch.utils.checkpoint import state_payload

    cfg = RunConfig(**cfg_kw).validate()
    mesh = make_mesh()
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    dev = torch.device(device)
    if dev.type == "cuda":
        # as fit: the stem conv and the classifier in full f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    state, step_cfg = build_training(cfg, dev, steps_per_epoch,
                                     224 if cfg.dataset == "imagenet" else 32)
    if mesh.collective:
        step_cfg = dataclasses.replace(step_cfg, data_shard=(mesh.rank, mesh.data))
    source = ShardReplay(draws, mesh.rank, mesh.data) if isinstance(draws, list) else draws
    step = make_step(cfg, state, step_cfg, draws=None if source is None else (lambda _s: source))
    create_sharded_state(mesh, state)
    tape = SignTape(state.model) if signs else None
    replay = None
    if inputs is not None:
        replay = InputReplay(("conv", "rprelu"))
        if inputs != "record":
            replay.recorded = [t.to(dev) for t in inputs]
        handles = replay.hooks(state.model, "card" if inputs == "record" else "cpu")
    tk, gate = epoch_schedule(family, cfg, 0)
    out = {"losses": [], "rank": mesh.rank, "world": mesh.data}
    for i, (x, y) in enumerate(batches):
        b = len(x) // mesh.data
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev) for a in (x, y))
        _, m = step(state, batch, tk, gate)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["grads"] = {n: p.grad.detach().cpu().clone()
                            for n, p in state.model.named_parameters()}
            if tape is not None:
                tape.close()
            if replay is not None:
                for h in handles:
                    h.remove()
                if inputs == "record":
                    out["inputs"] = replay.recorded
                else:
                    if replay.at != len(replay.recorded):
                        raise ValueError(f"replayed {replay.at} of {len(replay.recorded)} inputs")
                    out["input_flips"] = dict(replay.flips)
            if len(batches) > 1:
                out["first_state"] = state_payload(state)["model"]
    out["state"] = state_payload(state)
    out["signs"] = tape.rows if tape is not None else None
    out["launches"] = read_counts()
    return out


def ddp_fit(log_path: str, arch: str = "resnet18", steps: int = DDP_STEPS,
            batch: int = TRAIN_BATCH, device: str = "cuda", deterministic: bool = False,
            profile_steps: int = 0, time_wrapped: bool = False, **cfg_kw) -> dict:
    """``fit`` on the flagship recipe (``cfg_kw`` over it) at global batch
    ``batch`` for ``steps`` steps, an eval pass of ``batch`` images and a
    checkpoint every 2 steps, under ``log_path``, in this process: a rank
    of the job whose group is up, or one process. Returns its launch
    counts (per step, and of the whole run, with the bf16 modes' apart),
    losses, step times (CUDA events between steps, on the card), the first
    step's gradients and loss and :class:`SignTape` rows, the final state
    (``state_payload``) and the run dir. ``profile_steps``: that many more
    steps of the state, timed and profiled (the share of the gloo
    all-reduces); ``time_wrapped`` (one rank): a fresh state's step timed
    plain and wrapped in ``DistributedDataParallel`` with global BN."""
    import torch

    from bdbnn_tpu_torch.train import loop
    from bdbnn_tpu_torch.utils.checkpoint import state_payload

    cuda = torch.device(device).type == "cuda"
    cfg = train_config(arch=arch, batch_size=batch, synthetic_train_size=steps * batch,
                       synthetic_val_size=batch, device=device, save_every_steps=2,
                       log_path=log_path, **cfg_kw)
    held, per_step, losses, marks = {}, [], [], []
    prev = {}
    real_build, real_validate = loop.build_training, loop._validate

    def build(*a, **k):
        st, sc = real_build(*a, **k)
        held.update(state=st, step_cfg=sc, tape=SignTape(st.model))
        return st, sc

    def on_step(epoch, step, m):
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        now = {**read_counts(), **read_bf16_counts()}
        per_step.append({k: now[k] - prev.get(k, 0) for k in now})
        prev.update(now)
        losses.append(m["loss"])
        if "grads" not in held:
            held["grads"] = {n: p.grad.detach().cpu().clone()
                             for n, p in held["state"].model.named_parameters()}
            held["tape"].close()

    def validate(*a, **kw):
        acc1 = real_validate(*a, **kw)
        prev.update({**read_counts(), **read_bf16_counts()})
        return acc1

    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or prev_det
    reset_counts()
    loop.build_training, loop._validate = build, validate
    t0 = time.perf_counter()
    try:
        loop.fit(cfg, on_step=on_step)
    finally:
        loop.build_training, loop._validate = real_build, real_validate
        torch.backends.cudnn.deterministic = prev_det
    wall = time.perf_counter() - t0
    counts = {**read_counts(), **read_bf16_counts()}
    if cuda:
        torch.cuda.synchronize()
    state = held["state"]
    out = {"counts": counts, "per_step": per_step, "losses": [float(v) for v in losses],
           "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])], "wall_s": wall,
           "grads": held["grads"], "signs": held["tape"].rows, "state": state_payload(state),
           "run_dir": run_dir_of(log_path)}
    if profile_steps:
        out["profile"] = _profile_ddp_steps(cfg, state, held["step_cfg"], profile_steps)
    if time_wrapped:
        out["wrapped"] = _time_wrapped_step(cfg)
    return out


def _rank_shard():
    """(rank, world) of the process group that is up, (0, 1) without one."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _rank_batch(cfg, device):
    """A seeded batch of this rank's rows on ``device``."""
    import torch

    b = cfg.batch_size // _rank_shard()[1]
    g = torch.Generator().manual_seed(3)
    return (torch.randn((b, 224, 224, 3), generator=g).to(device),
            torch.randint(0, 1000, (b,), generator=g).to(device))


def _profile_ddp_steps(cfg, state, step_cfg, steps: int) -> dict:
    """``steps`` more train steps of ``state`` (DDP-wrapped in a job) on a
    seeded batch on its device: the host wall per step (synchronized), and
    under torch.profiler the host spans of the gloo all-reduces (enqueue to
    completion, so they overlap the backward) and the device busy time."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bdbnn_tpu_torch.nn.binarize import get_active_family
    from bdbnn_tpu_torch.train.loop import epoch_schedule

    dev = next(state.model.parameters()).device
    step = make_step(cfg, state, dataclasses.replace(step_cfg, data_shard=_rank_shard()))
    batch = _rank_batch(cfg, dev)
    tk, gate = epoch_schedule(get_active_family(), cfg, 0)
    step(state, batch, tk, gate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch, tk, gate)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, batch, tk, gate)
        torch.cuda.synchronize()
    comm_ms, busy_ms, keys = 0.0, 0.0, set()
    for ev in prof.key_averages():
        name = ev.key.lower()
        if "gloo" in name and ("all_reduce" in name or "allreduce" in name):
            comm_ms += ev.cpu_time_total / 1e3 / steps
            keys.add(ev.key)
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_ms += us / 1e3 / steps
    return {"wall_ms": wall_ms, "gloo_allreduce_ms": comm_ms, "busy_ms": busy_ms,
            "keys": sorted(keys)}


def _time_wrapped_step(cfg, iters: int = 3) -> dict:
    """One rank's step at ``cfg``'s batch, plain and with the student
    wrapped as a job of more ranks wraps it (``DistributedDataParallel``
    over the group and BN's statistics all-reduced), on the same seeded
    batch: CUDA-event ms of each, what the wrapper and its collectives
    cost on one rank."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from bdbnn_tpu_torch.nn.binarize import get_active_family
    from bdbnn_tpu_torch.nn.layers import BatchNorm
    from bdbnn_tpu_torch.train.loop import build_training, epoch_schedule

    dev = torch.device(cfg.device)
    out = {}
    for wrapped in (False, True):
        state, step_cfg = build_training(cfg, dev, 10, 224)
        step = make_step(cfg, state, step_cfg)
        if wrapped:
            for m in state.model.modules():
                if isinstance(m, BatchNorm):
                    m.process_group = dist.group.WORLD
            state.ddp = DistributedDataParallel(state.model, broadcast_buffers=False)
        batch = _rank_batch(cfg, dev)
        tk, gate = epoch_schedule(get_active_family(), cfg, 0)
        out["ddp_ms" if wrapped else "plain_ms"] = cuda_ms(lambda: step(state, batch, tk, gate),
                                                           iters, warmup=2)
        del state, step, batch
        torch.cuda.empty_cache()
    return out



def compare_ddp_step(ranks: list, one: dict) -> dict:
    """A job's first step (each rank's result of :func:`ddp_fit` or
    :func:`ddp_steps`) against one process's on the ranks' batches
    concatenated in rank order: the relative error of the global loss (the
    mean of the ranks' means), each gradient's largest difference over its
    tensor's largest |entry|, whether the ranks' gradients are bitwise
    equal, and the sign crossings of each binary conv (where
    :class:`SignTape` rows were taken)."""
    import torch

    loss = sum(r["losses"][0] for r in ranks) / len(ranks)
    ref = one["losses"][0]
    grad_err = {}
    for name, g in one["grads"].items():
        scale = max(float(g.abs().max()), 1e-30)
        grad_err[name] = float((ranks[0]["grads"][name] - g).abs().max()) / scale
    same = all(torch.equal(r["grads"][n], ranks[0]["grads"][n]) for r in ranks[1:]
               for n in ranks[0]["grads"])
    signs = [r.get("signs") for r in ranks]
    crossings = (sign_crossings(signs, one["signs"])
                 if one.get("signs") is not None and all(s is not None for s in signs) else None)
    return {"loss": loss, "loss_one": ref, "loss_rel": abs(loss - ref) / abs(ref),
            "grad_err": grad_err, "ranks_grads_equal": same, "crossings": crossings}


def _held_ddp_step(tag: str, cmp: dict) -> bool:
    worst = max(cmp["grad_err"].items(), key=lambda kv: kv[1])
    ok = (cmp["loss_rel"] <= TRAIN_LOSS_RTOL and worst[1] <= GRAD_TOL
          and cmp["ranks_grads_equal"])
    cross = cmp["crossings"]
    log(f"{tag} global loss {cmp['loss']!r} vs one process {cmp['loss_one']!r}: relative "
        f"{cmp['loss_rel']:.3e} (tol {TRAIN_LOSS_RTOL}); worst gradient error {worst[1]:.3e} of "
        f"its tensor's largest |entry| ({worst[0]}; tol {GRAD_TOL}, {len(cmp['grad_err'])} "
        f"tensors); ranks' gradients bitwise equal: {cmp['ranks_grads_equal']}; sign crossings "
        f"per binary conv {cross} (total {sum(cross) if cross is not None else 'not counted'}); "
        f"ok={ok}")
    log(f"{tag} largest gradient errors: " + ", ".join(
        f"{n} {e:.3e}" for n, e in sorted(cmp["grad_err"].items(), key=lambda kv: -kv[1])[:6]))
    return ok


def phase_train_ddp(smi_line: str):
    """[train-ddp]: data parallelism on the flagship recipe at -b 256.
    (a) two ranks on the one card over gloo, each 128 images a step,
    through ``fit``: 3 steps, a checkpoint every 2 and the eval pass;
    exact launch counts on each rank, both ranks' final parameters, Adam
    state and BN running statistics bitwise equal, the eval ``count`` the
    whole val split, finite losses; each rank's step and the gloo
    all-reduces' share of it (torch.profiler). (b) (a)'s first step against
    one process fed the ranks' batches concatenated in rank order: the
    loss to TRAIN_LOSS_RTOL, every gradient to GRAD_TOL of its tensor's
    largest |entry|, the sign crossings counted; where crossings break
    that gate at full width it is held at batch 8. (c) one rank over NCCL
    (W = 1, the group a real job makes) bitwise the run without a group
    (losses and final state, cuDNN deterministic), each step beside the
    other's, and a step with the student wrapped as a job wraps it beside
    the plain step. (d) (a)'s mid-epoch checkpoint (step 2,
    ``checkpoint.old``) resumed on one process: ``restore`` with
    ``resharded`` true and the schedule fields of the checkpoint's event,
    the restored model, optimizer and step bitwise the saved ones.
    Returns (the launch counts of (a), both ranks summed, ok)."""
    import dataclasses

    import numpy as np
    import torch

    from bdbnn_tpu_torch.obs.events import read_events, read_jsonl
    from bdbnn_tpu_torch.parallel import Mesh
    from bdbnn_tpu_torch.train import loop
    from bdbnn_tpu_torch.utils import checkpoint as ck

    tag = "[train-ddp]"
    card = f"({smi_line})"
    oks = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # (a)
    root = fresh_log_root()
    t0 = time.perf_counter()
    ranks = spawn_ranks("fit", DDP_WORLD, "cuda:0", "gloo",
                        dict(log_path=root, arch="resnet18", device="cuda:0", profile_steps=2))
    log(f"{tag} (a) {DDP_WORLD} ranks over gloo on cuda:0, fit flagship -b {TRAIN_BATCH} "
        f"({TRAIN_BATCH // DDP_WORLD} a rank), {DDP_STEPS} steps + eval, in "
        f"{time.perf_counter() - t0:.1f}s (processes started, kernels loaded)")
    fwd = N_BINARY_CONVS
    want = {"K1": fwd, "K2": fwd, "K3": 0, "K4": 0, "K5": fwd, "K6": fwd, "K7": 2,
            **{f"{k} bf16": 0 for k in BF16_KERNELS}}
    run_dir = ranks[0]["run_dir"]
    evals = [read_events(run_dir, "eval")] + [
        [e for e in read_jsonl(os.path.join(run_dir, f"events.p{r}.jsonl")) if e["kind"] == "eval"]
        for r in range(1, DDP_WORLD)]
    diff = state_diff(ranks[0]["state"], ranks[1]["state"])
    oks["(a) launches"] = all(len(r["per_step"]) == DDP_STEPS and all(c == want for c in r["per_step"])
                              for r in ranks)
    oks["(a) finite"] = all(len(r["losses"]) == DDP_STEPS and all(math.isfinite(v) for v in r["losses"])
                            for r in ranks)
    oks["(a) replicas equal"] = not diff
    oks["(a) one run dir"] = all(r["run_dir"] == run_dir for r in ranks)
    oks["(a) eval count"] = all(len(ev) == 1 and ev[0]["count"] == TRAIN_BATCH for ev in evals)
    counts = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}
    for r, res in enumerate(ranks):
        prof = res["profile"]
        log(f"{tag} (a) rank {r}: losses {res['losses']}; launches per step {res['per_step']} "
            f"(expected {want} each); step ms (CUDA events, fit's loop) {res['step_ms']} {card}; "
            f"alone after fit: {prof['wall_ms']:.2f} ms a step (host wall, synchronized), gloo "
            f"all-reduce spans {prof['gloo_allreduce_ms']:.2f} ms a step = "
            f"{prof['gloo_allreduce_ms'] / prof['wall_ms']:.3f} of it (torch.profiler host spans "
            f"{prof['keys']}, enqueue to completion, overlapping the backward), device busy "
            f"{prof['busy_ms']:.2f} ms {card}")
    log(f"{tag} (a) eval events {[ev[0] if ev else None for ev in evals]}; replicas' differing "
        f"tensors {diff[:5]}; whole run launches (both ranks) {counts}")
    # (b)
    cfg = train_config(arch="resnet18", batch_size=TRAIN_BATCH,
                       synthetic_train_size=DDP_STEPS * TRAIN_BATCH,
                       synthetic_val_size=TRAIN_BATCH, device="cuda").validate()
    xs, ys = [], []
    for r in range(DDP_WORLD):
        pipe, _, _ = loop.build_datasets(cfg, mesh=Mesh(data=DDP_WORLD, rank=r))
        pipe.prefetch = 0
        x, y = next(iter(pipe.epoch(0)))
        xs.append(x)
        ys.append(y)
    one = ddp_steps(dataclasses.asdict(cfg), [(np.concatenate(xs), np.concatenate(ys))],
                    device="cuda:0", signs=True, steps_per_epoch=DDP_STEPS)
    cmp = compare_ddp_step(ranks, one)
    oks["(b) step"] = _held_ddp_step(f"{tag} (b) first step at -b {TRAIN_BATCH}", cmp)
    del one
    if not oks["(b) step"] and cmp["crossings"] and sum(cmp["crossings"]):
        # as the card-vs-CPU gates do: at batch 8 the one process's binary
        # convs take the job's inputs, so the crossings cannot move the rest
        log(f"{tag} (b) sign crossings break the full-width gate: held at batch 8, the one "
            "process's binary convs taking the job's inputs (InputReplay)")
        small = dataclasses.asdict(dataclasses.replace(cfg, batch_size=8))
        g = np.random.default_rng(11)
        batch = (g.normal(size=(8, 224, 224, 3)).astype(np.float32),
                 g.integers(0, 1000, size=(8,)).astype(np.int64))
        r8 = spawn_ranks("steps", DDP_WORLD, "cuda:0", "gloo",
                         dict(cfg_kw=small, batches=[batch], device="cuda:0", inputs="record"))
        inputs = [torch.cat(per_rank) for per_rank in zip(*(r["inputs"] for r in r8))]
        one8 = ddp_steps(small, [batch], device="cuda:0", inputs=inputs)
        log(f"{tag} (b) batch 8: sign crossings the one process's own inputs would have made "
            f"{one8['input_flips']}")
        oks["(b) step"] = _held_ddp_step(f"{tag} (b) first step at batch 8", compare_ddp_step(r8, one8))
    # (c)
    (grp,) = spawn_ranks("fit", 1, "cuda:0", "nccl",
                         dict(log_path=fresh_log_root(), arch="resnet18", device="cuda:0",
                              deterministic=True, time_wrapped=True))
    plain = ddp_fit(fresh_log_root(), arch="resnet18", device="cuda:0", deterministic=True)
    cdiff = state_diff(grp["state"], plain["state"])
    oks["(c) bitwise"] = grp["losses"] == plain["losses"] and not cdiff
    w = grp["wrapped"]
    log(f"{tag} (c) one rank over NCCL vs no group: losses {grp['losses']} vs {plain['losses']}, "
        f"final state differs in {cdiff[:5]}; bitwise {oks['(c) bitwise']}; step ms with the group "
        f"{grp['step_ms']} vs without {plain['step_ms']} {card}; a -b {TRAIN_BATCH} step on one "
        f"rank plain {w['plain_ms']:.2f} ms, wrapped in DDP with global BN {w['ddp_ms']:.2f} ms "
        f"(+{w['ddp_ms'] - w['plain_ms']:.2f} ms, CUDA events) {card}")
    # (d)
    old = os.path.join(run_dir, ck.CKPT_NAME + ".old")
    saved = torch.load(os.path.join(old, ck.PAYLOAD_NAME), map_location="cpu",
                       weights_only=True)["state"]
    restored = {}
    real_load = loop.load_checkpoint

    def load(path, state, **kw):
        res = real_load(path, state, **kw)
        restored.update(ck.state_payload(state))
        return res

    loop.load_checkpoint = load
    try:
        d = ddp_fit(fresh_log_root(), arch="resnet18", device="cuda:0", resume=old)
    finally:
        loop.load_checkpoint = real_load
    (restore,) = read_events(d["run_dir"], "restore")
    (ck_ev,) = [e for e in read_events(run_dir, "checkpoint") if e["step_in_epoch"] == 2]
    ddiff = state_diff(saved, restored)
    topo2 = {"processes": DDP_WORLD, "devices": DDP_WORLD, "mesh": {"data": DDP_WORLD, "model": 1}}
    oks["(d) resume"] = (
        restore["resharded"] is True and restore["topology_from"] == topo2
        and restore["topology_to"] == {"processes": 1, "devices": 1, "mesh": {"data": 1, "model": 1}}
        and {k: restore[k] for k in SCHED_KEYS} == {k: ck_ev[k] for k in SCHED_KEYS}
        and not ddiff and len(d["losses"]) == DDP_STEPS - 2
        and all(math.isfinite(v) for v in d["losses"]))
    log(f"{tag} (d) {old} resumed on one process: restore resharded={restore['resharded']} "
        f"{restore['topology_from']} -> {restore['topology_to']}, schedule "
        f"{ {k: restore[k] for k in SCHED_KEYS} } (checkpoint event "
        f"{ {k: ck_ev[k] for k in SCHED_KEYS} }); restored state differs in {ddiff[:5]}; "
        f"losses after it {d['losses']}")
    ok = all(oks.values())
    log(f"{tag} {oks} in {time.perf_counter() - t_phase:.1f}s; ok={ok}")
    return counts, ok


def ddp_batchnorm(x, g, scale, bias, mean, var) -> dict:
    """A train-mode ``BatchNorm`` with these parameters and running
    statistics on this process's rows of ``x`` (the global batch), its
    statistics the ranks' global ones, and the backward of ``sum(y·g)``
    over the rows: the output and input gradient of the rows, the
    parameter gradients summed over the ranks (the full batch's) and the
    running statistics after the update."""
    import torch
    import torch.distributed as dist

    from bdbnn_tpu_torch.nn.layers import BatchNorm
    from bdbnn_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    if mesh.collective:
        bn.process_group = dist.group.WORLD
    b = x.shape[0] // mesh.data
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(g[rows])).sum().backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    if mesh.collective:
        dist.all_reduce(grads)
    return {"y": y.detach(), "dx": xt.grad, "dscale": grads[0], "dbias": grads[1],
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}


def ddp_primitives(flags: list, values: list, sums: list) -> dict:
    """This rank's view of the mesh primitives on its own inputs
    (``flags[rank]``, ``values[rank]``, ``sums[rank]``): its mesh's shape
    and topology, ``coordinate_flags``, ``sum_host_values``,
    ``broadcast_host_int`` and the train loop's ``global_sums``."""
    from bdbnn_tpu_torch.parallel import (
        broadcast_host_int,
        coordinate_flags,
        make_mesh,
        sum_host_values,
        topology,
    )

    from bdbnn_tpu_torch.train.loop import global_sums

    mesh = make_mesh()
    mine, value = flags[mesh.rank], values[mesh.rank]
    return {"rank": mesh.rank, "shape": mesh.shape, "topology": topology(mesh),
            "max": coordinate_flags(mine, mesh).tolist(),
            "sum": sum_host_values(mine, mesh).tolist(),
            "broadcast": broadcast_host_int(value, mesh),
            "global_sums": global_sums(sums[mesh.rank], mesh)}


def ddp_each(calls: list) -> list:
    """``DDP_JOBS[job](**kw)`` of each (job, kw) of ``calls``, in order, in
    one job (one process group for several cases)."""
    return [DDP_JOBS[job](**kw) for job, kw in calls]


DDP_JOBS = {"steps": ddp_steps, "fit": ddp_fit, "batchnorm": ddp_batchnorm,
            "primitives": ddp_primitives, "each": ddp_each}


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
    f32_prof = profile_train_step()
    stoch_counts, ok_ts = phase_train_stoch(pk)
    ts_counts, ok_tts = phase_train_ts()
    resume_counts, ok_tr = phase_train_resume(pk)
    folder_counts, ok_tf = phase_train_folder(smi_line)
    bf16_counts, brecs, ok_tb = phase_train_bf16(pk, f32_prof)
    recs.update(brecs)
    ddp_counts, ok_td = phase_train_ddp(smi_line)

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
    # on the stochastic family's training path, on the teacher-student
    # path, on the checkpoint/resume path's run A and on the image-folder
    # path's mp run (K1, K2, K5-K7), on the bf16 flagship's (K1, K2,
    # K5-K7), and on the data-parallel job's two ranks (K1, K2, K5-K7,
    # both ranks' launches summed). A bf16 mode's record (K1 bf16, ...) counts that mode's
    # launches: on the bf16 flagship's path, its remat run, the bf16
    # BASELINE config 4 run and the bf16 artifact's serving
    by_path = {k: {"serve": counts.get(k, 0), "train": train_counts.get(k, 0),
                   "train-stoch": stoch_counts.get(k, 0), "train-ts": ts_counts.get(k, 0),
                   "train-resume": resume_counts.get(k, 0),
                   "train-folder": folder_counts.get(k, 0),
                   "train-bf16": bf16_counts["train-bf16"].get(k, 0),
                   "train-ddp": ddp_counts.get(k, 0)}
               for k in sources}
    for k in BF16_KERNELS:
        sources[f"{k} bf16"], replaces[f"{k} bf16"] = sources[k], replaces[k]
        names[f"{k} bf16"] = names[k].replace(" (", " bf16 mode (", 1)
        by_path[f"{k} bf16"] = {path: c.get(f"{k} bf16", 0) for path, c in bf16_counts.items()}
        by_path[f"{k} bf16"]["train-ddp"] = ddp_counts.get(f"{k} bf16", 0)
    used = {k: by_path[k]["serve" if k in ("K1", "K2", "K3", "K4") else "train"] for k in sources
            if k in recs and not k.endswith("bf16")}
    used.update({f"{k} bf16": by_path[f"{k} bf16"]["train-bf16"] for k in BF16_KERNELS})
    ok_used = all(v > 0 for v in used.values()) and all(
        by_path[k][path] > 0 for k in ("K1", "K2", "K5", "K6", "K7")
        for path in ("train", "train-stoch", "train-ts", "train-resume", "train-folder",
                     "train-bf16", "train-ddp"))
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
    ms_of.update({f"{k} bf16": step + "; bf16 operands, library_ms cuDNN's bf16 call"
                  for k in BF16_KERNELS})

    def sums(sh):
        lib = [s["library_ms"] for s in sh]
        total = lambda key: sum(s.get("count", 1) * s[key] for s in sh)
        out = {"ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
               "bound_by": max(sh, key=lambda s: s["bound_ms"])["bound_by"],
               "library_ms": None if any(v is None for v in lib) else total("library_ms")}
        if all("graph_ms" in s for s in sh):
            out["graph_ms"] = total("graph_ms")
        return out

    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7") + tuple(f"{k} bf16" for k in BF16_KERNELS):
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
           "train_cli": ok_tc, "train_stoch": ok_ts, "train_ts": ok_tts, "train_resume": ok_tr,
           "train_folder": ok_tf, "train_bf16": ok_tb, "train_ddp": ok_td, "launched": ok_used}
    if not all(oks.values()):
        log(f"chip_smoke: FAILED {oks}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
