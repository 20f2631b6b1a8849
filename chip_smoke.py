"""Chip smoke test of the PyTorch/CUDA port (``bdbnn_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — requires CUDA; prints ``nvidia-smi`` name and power limit;
2. build   — builds every kernel from ``bdbnn_tpu_torch/csrc`` with nvcc
             (one process per source, all at once), prints seconds and the
             tensor-core instructions in the SASS of K1, K4 and the bf16
             modes of K1, K5 and K6, each of the latter three holding its
             warpgroup MMA (IGMMA, HGMMA, HGMMA);
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
             forward's 19 weights in one graph; (c) the kernel bench
             script's ``main(batch=64)`` (``dot_f32`` and ``dot_bf16`` at
             the reference's seven shapes, beside K1 alone by graph replay
             and ``F.conv2d``), no row an error;
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
4b. serve-bench — the serving stack under load on the same artifact
             (phase_serve_bench), each run's launches of K1-K4 (and the
             bf16 modes of K1, K2) exactly 19 × its engines' forwards: (a)
             ``python -m bdbnn_tpu_torch.cli serve-bench`` as a subprocess,
             closed loop, concurrency 32, 2,048 requests, buckets 1 8 32,
             ``--packed-weights ab`` (dense, then packed/unpack): exit 0,
             every request completed or shed, none failed, drained clean,
             the queue bound held, the packed block's resident bytes and
             ratio those worked out from the artifact's tensors, the
             request tracer's attribution; then closed loops at bucket 1
             and bucket 8 alone; (b) open loop (Poisson) at 0.5× and 1.2×
             (a)'s throughput, packed: none shed at 0.5×, only explicit
             shedding at 1.2×; (c) packed/popcount, closed loop (K4); (d) a
             replica pool of one real engine on cuda:0 behind the batcher's
             async dispatch, every answer bitwise the single engine's on the
             same batch; the paced sweep ``--replicas 1 2 4 --pace-ms 10``
             monotone; ``--replicas 2`` refused by ``replica_devices`` on one
             card (served on two or more); (e) SIGTERM to a serve-bench
             subprocess 1 s after its warmup: exit 0, preempted, drained,
             every accepted request answered; (f) 256 exact-stem answers
             through the batcher and the load generator against
             ``predict_logits`` of each image alone, within CPU_LOGIT_TOL
             (bitwise rows counted); (g) the bf16 flagship artifact, closed
             loop, 512 requests. Prints p50/p95/p99, throughput, occupancy,
             shed rates, resident bytes, step_ms and the per-stage
             attribution, and one ``[serve-bench] summary`` JSON line;
4c. serve-http — the network front end on the same artifact over
             loopback sockets (phase_serve_http), each run's launches of
             K1-K3 exactly 19 × its engines' forwards (the ``http``
             ``stop`` event's ``forwards``): (a) ``python -m
             bdbnn_tpu_torch.cli serve-http ART --port 0 --packed-weights``
             as a subprocess in serve mode, the client here: /readyz 503
             ``warming`` then
             200, /healthz 200 throughout, 64 exact-stem images (16 one at
             a time, 48 from 8 threads; raw float32 and JSON, several
             priorities and tenants) all 200 and within SH_WIRE_ATOL +
             CPU_LOGIT_TOL·max|logit| of ``predict_logits`` of each image
             alone (rows bitwise the rounded logits counted), /statsz with
             the batcher, admission and capacity blocks, SIGTERM → exit 0,
             preempted, drained, the ledger identity; the wire time per
             request; then (b)'s saturating calibration schedule offered
             from this process (the in-process client's cost); (b) bench mode, poisson, ``--packed-weights``, 1,024
             requests at R = 0.5 × a calibration run's throughput (capped
             at 0.5 × serve-bench's closed loop): nothing dropped or
             failed, the attribution's read/admit/respond stages, the
             capacity block, p50/p95/p99 per priority; the device's busy
             share under the profiler for 256 requests over loopback, in
             process; (c) flash crowd ×8 at R, 10,000 requests with SIGTERM
             3 s after ready, then 1,500 run to their end through the
             burst from 64 connections against 8-deep class queues: exit 0, drained, nothing dropped, every shed an
             explicit 429 or 503, priority 0's shed rate at most priority
             2's, fairness ratio and shed rates by class printed; (d)
             quotas 20:20 with tenant-a unlimited, 512 requests at R:
             tenant-b gets 429
             ``over_quota`` with ``retry-after``, tenant-a none; (e) two
             flagship versions published with the port's ``registry``,
             served with ``--resident-models 2``: each answer its own
             version's, the versions' answers differ, an unknown
             ``x-model`` is 404 and runs no engine;
4d. serve-rollout — blue/green swaps of the flagship, v1 and v2 (seeds 0
             and 1) published in a registry, ``--packed-weights``,
             ``--replicas 1`` (phase_serve_rollout): (a) bench mode,
             poisson at 100 req/s, 512 requests, ``--swap-to v0002
             --swap-at 0.5``: nothing dropped, the ledger identity, lone
             probes from here before the swap within tolerance of v1's
             engine and after it of v2's, p99 and shed rate before, during
             and after the swap, launches 19 × the forwards; the peak
             memory while both models are resident, from an in-process
             pool swapped the same way; (c) a standby whose weights file is
             truncated: the swap ``failed``, v1 still answering; (b) then,
             on that server, ``POST /admin/swap {"version": 2}`` polled to
             ``done``, v2 answering; (d) the canary, only on two cards;
4e. serve-fleet — ``serve-fleet`` (the router as its CLI subprocess, its
             scenario's load in its own process) in front of port
             ``serve-http`` hosts sharing the card, each a CLI subprocess
             with its own CUDA context and registry, ``--replicas 1
             --packed-weights``, buckets 1 8 32 (phase_serve_fleet): (a)
             poisson at 100 req/s, 512 requests over h0 and h1: nothing
             dropped, the per-host ledgers summing to the client's; lone
             raw requests through the router byte-for-byte (but for
             ``latency_ms``) the host's own answer, within the serve-http
             tolerance of an engine in the hosts' mode; (b) 4,000 req/s
             offered through the router and to h0 alone, each host's device
             busy share (a profiler window SIGUSR1/SIGUSR2 open and close in
             the host); (e) a torn v2 in h0's registry fails the fleet swap
             with v1 answering on both, then v1 -> v2 under load host by
             host to ``done``, v2 answering on both, each host's shed and
             p99 before / during / after; (d) SIGSTOP h1 (timeouts retried
             on h0, its scraped window stale, the hop in
             ``fleet_attribution``), (c) a flash crowd with SIGTERM to h1
             half way (it drains, the router sees ``draining`` first), (d)
             SIGKILL a fresh host h2 (connect/reset retries on h0, ``dead``
             after the debounce); launches 19 × the forwards of each host
             that exits cleanly, the SIGKILLed host's unknown;
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
             2, cuDNN deterministic (fit sets it on the card): (a) run A uninterrupted (its K1, K2,
             K5, K6, K7 launches); (b) run B through ``cli.main``
             SIGTERMed after its checkpoint of epoch 1 step 2: exit 75,
             preempt and checkpoint events, the committed state bitwise
             the saved one; (c) B resumed: restore schedule fields bitwise
             the checkpoint event's, every later loss and the final model,
             optimizer state and step bitwise A's; (d) the CLI in a
             subprocess (``-m bdbnn_tpu_torch.cli``, no setting of its
             own) SIGKILLed after its first mid-epoch checkpoint,
             resumed, held as (c); (e) A's checkpoint loaded on the CPU,
             bitwise the card's state; (f) a resnet18_float run dir as the
             teacher of a resnet18 --react student, bitwise after fit; (g)
             A exported and served in three modes at bucket 32 (bitwise
             across modes, within CPU_LOGIT_TOL of the CPU engine), its
             recorded accuracy A's; (h) each checkpoint's seconds and
             bytes, the restore seconds, the step time around the saves;
13a. bench — the bench scripts (phase_bench): (a) ``python -m
             bdbnn_tpu_torch.scripts.bench --batch 128 --iters 5`` as a
             subprocess (the flagship's bf16 train step on a batch on the
             card, 5 fenced windows, a 5-step profiler window, the f32
             comparison): exit 0, a line with ``value`` > 0 and no
             ``error``, nvidia-smi's device name, ``timing_suspect`` false,
             the fenced rate at most 1.05 × the traced device rate, the
             worker's launches 19 a step of K1, K2, K5, K6 (their bf16 modes
             in the bf16 stage) and one of K7; (b) the profile script in
             this process (one fenced window of 5 steps, then the 5-step
             profiler window): device ms by kernel name and category, the
             by-name total within 5% of the steps' mean busy sum, its
             step within 10% of (a)'s, the trace's K1-K7 kernels equal to
             the launch counters over its window; (c) of the kernel bench runs in
             [kernels] (``bench_kernels_rows``), (d) of the pipeline bench
             in [train-folder] (e);
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
             images; decode, transfer, copy, step and device-step times,
             threads against worker processes through the pipeline bench
             script (its target [bench] (a)'s device rate) and the device's
             idle share beside the card's name and power limit;
15. train-bf16 — bf16 compute and remat (MIGRATION.md recipes 3-5 run
             --dtype bfloat16): (a) K1, K2, K5 and K6 in their bf16 modes at
             the flagship's ten conv shapes at -b 256 against their plain
             bf16 versions (K1 and K2's sign bitwise, K2's alpha within one
             bf16 rounding, K5 and K6 within the float64-sum bound plus one
             bf16 rounding), each timed beside cuDNN's bf16 conv2d /
             conv2d_input / conv2d_weight on the same ±1 operands, and K5
             bf16 on same-sign terms at layer4 (phase_k5_bf16_same_sign); (b)
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
16a. train-tp — tensor parallelism (phase_train_tp), the flagship recipe
             at -b 64, the ranks on the one card over gloo: (a) two ranks,
             ``--model-parallel 2``, through ``fit`` (3 steps, a checkpoint
             every 2, eval): exact launch counts a rank, the replicated
             tensors bitwise across the ranks, the eval count the whole
             split; (b) its first step against one process: the forward
             bitwise up to the classifier, the logits within FC_TOL, every
             gradient within GRAD_TOL; (c) four ranks, data 2 x model 2;
             (d) checkpoints resumed across the layouts bitwise, the TP run
             exported and served; (e) K1, K5 and K6 at the shard shapes at
             N = 2 and 4; (f) the step, the collectives' share and bytes;
16b. train-health — the health monitor (phase_train_health) on the
             flagship recipe through the CLI's ``fit``, 8 steps, a drain a
             step: (a) flip_explosion forced past real flip rates: one
             alert, one forensics checkpoint that verifies, one ``profile``
             window whose trace holds K1, K2, K5, K6 and K7 by kernel name
             as often as the launch counters say, the ``health`` summary;
             (b) the forensics checkpoint resumed bitwise; (c) the memory
             events' peaks equal ``torch.cuda.max_memory_allocated()``;
             (d) ``--profile-at 0:5:3``; (e) the default monitor against
             ``--no-health``: step times and the synchronisation calls in
             a window;
16c. perf — the observatory (phase_perf, phase_perf_summarize): (a)
             ``python -m bdbnn_tpu_torch.cli perf`` on the flagship artifact
             (buckets 1 8 32, impls dense unpack popcount, 20 forwards a
             profiler window) through ``counted_cli``: exit 0, every cell
             traced, the 21 layers of the static table attributed with ms >
             0, each window's K1-K4 kernels in its trace by name equal to
             its launch counters, every K1-K4 kernel in its binary conv's
             layer, layers + unattributed = the device total; (b) the
             port's ``summarize`` of [train-health] (a)'s run dir:
             binarize, binary_conv, bn_act, kurtosis_loss and optimizer
             above zero, no K1, K2, K5, K6 or K7 kernel unattributed;
             (c) the port's ``compare`` of (a)'s verdict against itself
             exits 0, against a copy with one layer's ms doubled 3;
16d. search — the ``search`` CLI on the card (:func:`phase_search`): four
             full-width flagship trials (ste, ede × lr 0.1, 0.01; -b 64, 8
             steps, an eval of 256) on two workers, each a CLI process
             whose launches are counted; (a) clean, exit 0; (b) SIGTERMed
             once a trial is done and another past its first step, exit 75,
             then ``--resume`` exit 0 with (a)'s ranking and every trial's
             final state bitwise (a)'s; (c) ``summarize``, ``watch`` and
             ``compare`` of both; the harness loads no torch; trial walls,
             their startup share, the overlap of two workers, a -b 64 step;
16e. check — ``python -m bdbnn_tpu_torch.cli check`` exits 0 and loads no
             torch, numpy or jax;
16f. scripts — the root scripts' twins, their short part
             (:func:`phase_scripts`; the long runs are ``--scripts``'):
             (a) ``python -m bdbnn_tpu_torch.scripts.run_accuracy``'s
             ``main`` for 2 epochs on the committed digits split: the
             reference's output keys, val and train curves of length 2 and
             finite, and every step launching K1, K2, K5 and K6 once for
             each of resnet20's binary convs and K7 twice (the kurtosis
             loss and the binarization probes); (b)
             ``scripts/remat_ceiling.py``'s ``_try_batch(64)`` with remat
             off and on fits, its loss finite;
17. output — one ``{"kernels": [...]}`` line (K1-K7 and the bf16 modes K1
             bf16, K2 bf16, K5 bf16, K6 bf16; ``launches_by_path`` gives
             serve, serve-bench, serve-http, serve-rollout, serve-fleet, train, train-stoch,
             train-ts, train-resume, train-folder, train-bf16, train-ddp,
             train-tp, train-health, perf, search, bench and scripts, and
             for a bf16 mode train-bf16, train-bf16-remat, train-bf16-ts,
             serve-bf16, train-ddp, train-tp, serve-bench, bench and
             scripts), then
             as the last line
             ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --weight-kernels`` runs phases 1-3 for K2, K3 and
K7 alone and prints their records as one JSON line: run from two trees in
turns, it compares their weight kernels on one card. ``python3
chip_smoke.py --serve-bench`` runs the build and phase 4b alone, and
``python3 chip_smoke.py --serve-http`` the build and phase 4c alone,
``python3 chip_smoke.py --serve-fleet`` the build and phase 4e alone
(``--fleet-verdicts DIR`` keeps its verdicts), and
``python3 chip_smoke.py --health`` the build and phases 4d and 16b, and
``python3 chip_smoke.py --train-tp`` the build and phase 16a, and
``python3 chip_smoke.py --perf`` the build, [train-health] (a)'s fit and
phase 16c.
``python3 chip_smoke.py --search`` runs the build and phases 16d and 16e.
``python3 chip_smoke.py --bench`` runs the build, phase 13a and [kernels]
(c).
``python3 chip_smoke.py --determinism [--tree DIR ...]`` runs the flagship
CLI (2 epochs × 4 steps at -b 256) from each checkout straight through and
SIGTERMed after its first mid-epoch checkpoint then resumed, counts the
final ``state.pt`` tensors that differ, and times the -b 256 step with
cuDNN's deterministic algorithms off and on in turns.
``python3 chip_smoke.py --scripts [--scripts-out DIR]`` runs the build,
[scripts] and the twins' long runs (phase_scripts_long): (c) the no-KD accuracy run
at ``ACCURACY_r04.json``'s recipe (100 epochs, adam-linear, lr 0.1, -b 128)
and (d) the KD run at ``ACCURACY_r05_ts.json``'s (teacher 60 epochs at lr
0.001; student 100 epochs, α 0.9, β 0.01, T 4), each reaching its target of
90% top-1, the four teacher–student loss components finite and (d) an equal
recipe to (c); (e) the remat ceiling search to ``--max-batch 8192`` (no error
but out-of-memory, a ceiling gain above 1, a throughput cost in (0, 0.5),
then a finite step at -b 256); (f) ``dryrun_multichip(4)`` on the card (data
2 × model 2, gloo ranks sharing it). The kernels are built before (c) and
(d), so no nvcc time lands in their ``time_to_target_s``; their outputs go
to DIR (a temporary directory by default).
``python3 chip_smoke.py --trace-prefix N`` runs [train-health] (a)'s fit
2N times, in turns without and with the burst that opens a profiler window
on the card (``obs/trace.py``), and counts the device records each window's
trace lost.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the card's timers (CUDA events; CUDA-graph replay) and the kernel
# wrappers' launch counters, shared with the bench scripts
from bdbnn_tpu_torch.obs.launches import (  # noqa: E402
    BF16_KERNELS,
    KERNELS,
    launch_counts,
)
from bdbnn_tpu_torch.obs.launches import reset_launches as reset_counts  # noqa: E402
from bdbnn_tpu_torch.obs.timing import cuda_ms, graph_ms  # noqa: E402

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


# every logged line that reports a failure, repeated on standard error at
# the end of a failed run: a caller that keeps only the tail of the
# output (the training phases log to standard error) still sees why
_FAILURES: list = []


def log(msg: str) -> None:
    print(msg, flush=True)
    if "FAIL" in msg or "ok=False" in msg:
        _FAILURES.append(msg[:3000])


def peaks_for(name: str):
    key = "PCIe" if "pcie" in name.lower() else "SXM"
    return key, PEAKS[key]


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
    ok = bench_kernels_rows() and ok
    return recs, ok


def bench_kernels_rows() -> bool:
    """[kernels] (c): the kernel bench script's ``main(batch=64)``
    (``dot_f32`` and ``dot_bf16`` at the reference's seven shapes, each
    beside K1 alone by graph replay and ``F.conv2d``): every row timed, none
    an error."""
    from bdbnn_tpu_torch.scripts import bench_kernels

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = bench_kernels.main(batch=64)
    rows = summary["results"]
    ok = len(rows) == 2 * len(bench_kernels.SHAPES) and not any("error" in r for r in rows)
    for r in rows:
        log(f"[kernels] (c) bench_kernels {json.dumps(r)}")
    log(f"[kernels] (c) bench_kernels batch 64 totals {summary['totals_ms']} ms on "
        f"{summary['device_kind']} in {time.perf_counter() - t0:.1f}s: ok={ok}")
    return ok


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


# the warpgroup MMA each bf16-mode library must hold in its SASS
WGMMA_OF = {"binary_conv_fwd_bf16": "IGMMA", "binary_conv_dgrad_bf16": "HGMMA",
            "binary_conv_wgrad_bf16": "HGMMA"}


def log_mma_instructions() -> bool:
    """Which tensor-core instructions the built K1, K4 and bf16-mode K1,
    K5 and K6 libraries hold (``cuobjdump -sass`` beside ``nvcc``), for the
    log: mma.sync as IMMA/BMMA/HMMA, wgmma as IGMMA/HGMMA. The five
    disassemblies run side by side. False unless each bf16-mode library
    holds its wgmma (:data:`WGMMA_OF`)."""
    import collections
    import re

    from bdbnn_tpu_torch.nn.kernels import _build

    names = ("binary_conv", "packed", *WGMMA_OF)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log(f"[build] {', '.join(names)}: no cuobjdump beside nvcc, instructions not read: FAIL")
        return False
    outs = {name: tempfile.TemporaryFile(mode="w+") for name in names}
    procs = {name: subprocess.Popen([tool, "-sass", _build.library_path(name)],
                                    stdout=outs[name], stderr=subprocess.DEVNULL)
             for name in names}
    ok = True
    for name, proc in procs.items():
        proc.wait(timeout=120)
        outs[name].seek(0)
        sass = outs[name].read()
        outs[name].close()
        ops = collections.Counter(re.findall(r"\b([BIH]G?MMA\.[A-Za-z0-9.]+)", sass))
        want = WGMMA_OF.get(name)
        has = want is None or any(op.startswith(want + ".") for op in ops)
        ok = ok and has
        log(f"[build] {name}: tensor-core instructions in its SASS {dict(ops)}"
            + (f"; {want} present: {has}" if want else ""))
    return ok


def make_flagship_artifact(out_dir: str, dtype: str = "float32", seed: int = 0):
    """Full-width ImageNet resnet18 (react) from a seeded generator, with
    non-trivial BN statistics, act_shifts and RPReLU vectors. The stem
    conv's weights are rounded to multiples of 2^-10: on images with
    entries in {-1, 0, 1} its sums are then exact in float32 in any
    order, so the card and the CPU feed the first sign bit-identical
    values (see phase_main). ``dtype="bfloat16"`` records a bf16 model in
    the artifact (the same f32 weights; the engine builds the bf16
    forward); ``seed`` seeds the generator (another seed, another model)."""
    import torch

    from bdbnn_tpu_torch.models import create_model
    from bdbnn_tpu_torch.nn.layers import BatchNorm, BinaryConvReact, RPReLU
    from bdbnn_tpu_torch.serve.export import write_artifact

    g = torch.Generator().manual_seed(seed)
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
    write_artifact(model.to_flax(), out_dir, arch="resnet18", dataset="imagenet", dtype=dtype)


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


def read_counts() -> dict:
    """K1-K7's launches alone (the gates that hold all seven to a want)."""
    now = launch_counts()
    return {k: now[k] for k in KERNELS}


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


# ---------------------------------------------------------------------------
# [serve-bench]: the serving stack under load
# ---------------------------------------------------------------------------

SB_BUCKETS = (1, 8, 32)
SB_REQUESTS = 2048
SB_CONCURRENCY = 32
# the kernels a forward of each weights mode launches, 19 times each
SB_MODE_KERNELS = {"dense": ("K1", "K2"), "unpack": ("K1", "K2", "K3"),
                   "popcount": ("K2", "K3", "K4")}
SB_COUNTED = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K1 bf16", "K2 bf16", "K5 bf16",
              "K6 bf16")
# a subprocess's launch counters are its own: the CLI child writes them
# into the file this variable names when it exits
COUNTS_ENV = "CHIP_SMOKE_COUNTS"
COUNTED_CLI = "import sys, chip_smoke; sys.exit(chip_smoke.counted_cli())"


def counted_cli() -> int:
    """``python -m bdbnn_tpu_torch.cli`` with this process's arguments;
    then the run's kernel launch counts as JSON into ``$CHIP_SMOKE_COUNTS``
    (into ``<pid>.json`` inside it when it names a directory) and, when SIGUSR1/SIGUSR2 opened and closed profiler windows
    (:class:`BusyWindows`), their kernel and wall ms beside it; with
    ``$CHIP_SMOKE_WINDOWS`` set, each ``TraceCapture`` window's launches
    (:func:`count_windows`) into that file."""
    import runpy

    path = os.environ[COUNTS_ENV]
    if os.path.isdir(path):
        # one directory for many processes (a search's trials): one file each
        path = os.path.join(path, f"{os.getpid()}.json")
    busy = BusyWindows(path + BUSY_SUFFIX)
    windows = count_windows() if os.environ.get(WINDOWS_ENV) else None
    code = 1
    try:
        runpy.run_module("bdbnn_tpu_torch.cli", run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    finally:
        with open(path, "w") as f:
            json.dump(launch_counts(), f)
        if windows is not None:
            with open(os.environ[WINDOWS_ENV], "w") as f:
                json.dump(windows, f)
        if busy.windows:
            with open(path + BUSY_SUFFIX, "w") as f:
                json.dump(busy.windows, f)
    return code


def sb_passes(run_dir: str, bf16: bool = False) -> list:
    """(weights mode, engine forwards, bf16) of each single-engine pass of a
    serve-bench run dir (its ``serve`` ``pass`` events)."""
    from bdbnn_tpu_torch.obs.events import read_events

    return [("dense" if e["weights_mode"] == "dense" else e["packed_impl"], e["forwards"], bf16)
            for e in read_events(run_dir, "serve") if e.get("phase") == "pass"]


def sb_launch_gate(tag: str, counts: dict, passes: list, phase: str = "[serve-bench]") -> bool:
    """Each kernel's launches in a run == 19 × the forwards of the engines
    whose mode runs it (K5-K7 none); at least one forward."""
    want = {k: 0 for k in SB_COUNTED}
    for mode, forwards, bf16 in passes:
        for k in SB_MODE_KERNELS[mode]:
            want[k] += N_BINARY_CONVS * forwards
            if bf16 and k in ("K1", "K2"):
                want[f"{k} bf16"] += N_BINARY_CONVS * forwards
    got = {k: counts.get(k, 0) for k in SB_COUNTED}
    ok = got == want and sum(p[1] for p in passes) > 0
    log(f"{phase} {tag} launches {got}; engine forwards "
        f"{[(m, f) for m, f, _ in passes]} require {want}: ok={ok}")
    return ok


def sb_line(v: dict) -> str:
    return (f"p50/p95/p99 {v['p50_ms']}/{v['p95_ms']}/{v['p99_ms']} ms, "
            f"{v['throughput_rps']} req/s, occupancy {v['mean_batch_occupancy']} over "
            f"{v['batches']} batches; submitted {v['requests_submitted']} completed "
            f"{v['requests_completed']} shed {v['requests_shed']} (rate {v['shed_rate']}) "
            f"failed {v['requests_failed']}; queue peak {v['max_queue_depth_seen']} of "
            f"{v['max_queue']}; wall {v['wall_s']} s; drained_clean {v['drained_clean']}")


def sb_accounted(v: dict) -> bool:
    """Every request answered or explicitly shed, none failed, the queue
    bound held, the drain clean."""
    return (v["requests_completed"] + v["requests_shed"] == v["requests_submitted"]
            and v["requests_failed"] == 0 and v["drained_clean"]
            and v["max_queue_depth_seen"] <= v["max_queue"])


def sb_attribution(att: dict) -> dict:
    """The rtrace attribution's per-stage p50/p99/mean ms, the queue share
    and the reconciliation, compactly."""
    stages = {s: [b["p50_ms"], b["p99_ms"], b["mean_ms"]]
              for s, b in att["stages"].items() if b is not None}
    rec = att["reconciliation"]
    return {"stages_p50_p99_mean_ms": stages, "queue_share": att["queue_share"],
            "reconciliation_ok": rec["ok"], "mean_abs_err_pct": rec["mean_abs_err_pct"],
            "device": att.get("device")}


def artifact_resident_bytes(art: str) -> tuple:
    """(dense, packed) bytes the two weight modes keep resident, worked out
    from the artifact's tensor list: every tensor at its dtype, a binary
    conv as f32 (dense) or as its packbits sign + f32 alpha (packed), plus
    the identity statistics (mean, var: 2 × 4 bytes a channel) the loader
    gives each folded BN."""
    import numpy as np

    from bdbnn_tpu_torch.nn.packed import dense_weight_bytes, packed_weight_bytes
    from bdbnn_tpu_torch.serve.export import read_artifact

    a = read_artifact(art)
    dense = packed = 0
    shapes = {}
    for t in a["tensors"]:
        shapes[t["path"]] = t["shape"]
        if t["kind"] == "binary":
            dense += dense_weight_bytes(t["shape"])
            packed += packed_weight_bytes(t["shape"])
        else:
            n = int(np.prod(t["shape"])) * np.dtype(t["dtype"]).itemsize
            dense += n
            packed += n
    stats = sum(2 * 4 * int(shapes[f"{bn}/scale"][0]) for bn in a["bn_folded"])
    return dense + stats, packed + stats


def sb_run(root: str, art: str, **kw):
    """One in-process ``run_serve_bench`` on the card; returns (verdict, run
    dir, launch counts of the run, seconds)."""
    from bdbnn_tpu_torch.serve.config import ServeBenchConfig
    from bdbnn_tpu_torch.serve.loadgen import run_serve_bench

    cfg = ServeBenchConfig(**{"artifact": art, "log_path": tempfile.mkdtemp(dir=root),
                              "buckets": SB_BUCKETS, "device": "cuda", **kw})
    reset_counts()
    t0 = time.perf_counter()
    res = run_serve_bench(cfg)
    counts = launch_counts()
    return res["verdict"], res["run_dir"], counts, time.perf_counter() - t0


def sb_cli(root: str, art: str, args: list, sigterm_after_s=None):
    """``serve-bench ART args`` as a subprocess (the CLI through
    :func:`counted_cli`); with ``sigterm_after_s``, SIGTERM that long after
    the run's ``serve`` ``start`` event (warmup done). Returns (exit code,
    verdict or None, run dir, launch counts, stderr tail, seconds)."""
    import glob
    import signal

    from bdbnn_tpu_torch.obs.events import read_events

    log_path = tempfile.mkdtemp(dir=root)
    counts_file = os.path.join(log_path, "counts.json")
    cmd = [sys.executable, "-c", COUNTED_CLI, "serve-bench", art, "--log-path", log_path,
           "--buckets", *map(str, SB_BUCKETS), *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, COUNTS_ENV: counts_file})
    if sigterm_after_s is not None:
        deadline = time.monotonic() + 300
        while proc.poll() is None and time.monotonic() < deadline:
            dirs = glob.glob(os.path.join(log_path, "*", "events.jsonl"))
            if dirs and any(e.get("phase") == "start"
                            for e in read_events(os.path.dirname(dirs[0]), "serve")):
                time.sleep(sigterm_after_s)
                proc.send_signal(signal.SIGTERM)
                break
            time.sleep(0.05)
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    verdict = json.loads(out) if proc.returncode == 0 else None
    (run_dir,) = [os.path.dirname(p) for p in glob.glob(os.path.join(log_path, "*", "events.jsonl"))] or [None]
    counts = {}
    if os.path.exists(counts_file):
        with open(counts_file) as f:
            counts = json.load(f)
    return proc.returncode, verdict, run_dir, counts, err[-3000:], seconds


def sb_busy_share(art: str, requests: int = 1024) -> tuple:
    """The device's busy share under load: a packed/unpack engine behind
    the batcher, a closed loop of ``requests`` at concurrency 32 over the
    bench's 32 seeded images, with torch.profiler (CUPTI) around the load
    alone; busy = the kernels' device time over the load's wall. Returns
    (busy ms, wall ms, completed, launch counts, forwards)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bdbnn_tpu_torch.serve.batching import MicroBatcher
    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.loadgen import LoadGenerator

    engine = InferenceEngine(art, buckets=SB_BUCKETS, device="cuda", packed=True)
    images = np.random.default_rng(0).standard_normal((32, 224, 224, 3)).astype(np.float32)
    b = MicroBatcher(lambda xs: engine.predict_logits(np.stack(xs)), max_batch=SB_BUCKETS[-1],
                     max_queue=128, max_delay_ms=5.0)
    reset_counts()
    fw0 = engine.forwards
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        raw = LoadGenerator(b.submit, lambda i: images[i % 32], mode="closed", requests=requests,
                            concurrency=SB_CONCURRENCY).run()
        b.drain(60)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, wall_ms, raw["completed"], counts, engine.forwards - fw0


def phase_serve_bench(art: str, smi_line: str):
    """[serve-bench]: the flagship served under load through
    ``serve-bench`` (batcher, load generator, replica pool, request
    tracer, residency), every run's launches held to 19 × its engines'
    forwards. Returns (launch counts summed over the runs, ok, the closed
    loop's throughput)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from bdbnn_tpu_torch.parallel.mesh import replica_devices
    from bdbnn_tpu_torch.serve.batching import MicroBatcher
    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.loadgen import LoadGenerator
    from bdbnn_tpu_torch.serve.pool import ReplicaPool, make_engine_runner_factory

    t_phase = time.perf_counter()
    log(f"[serve-bench] {smi_line}")
    oks = {}
    total = {k: 0 for k in SB_COUNTED}

    def add(counts):
        for k in SB_COUNTED:
            total[k] += counts.get(k, 0)

    summary = {"device": smi_line}
    with tempfile.TemporaryDirectory() as root:
        # (a) the CLI, closed loop, dense then packed
        rc, v, run_dir, counts, err, secs = sb_cli(
            root, art, ["--mode", "closed", "--concurrency", str(SB_CONCURRENCY), "--requests",
                        str(SB_REQUESTS), "--packed-weights", "ab"])
        if rc != 0 or v is None:
            log(f"[serve-bench] (a) FAIL: exit {rc}\n{err}")
            return total, False, None
        add(counts)
        want_d, want_p = artifact_resident_bytes(art)
        pk = v["packed"]
        ratio = round(want_d / max(want_p, 1), 3)
        oks["a"] = (sb_accounted(v) and v["attribution"] is not None
                    and pk["resident_ratio"] == ratio
                    and pk["dense"]["resident_bytes"] == want_d
                    and pk["packed"]["resident_bytes"] == want_p
                    and sb_launch_gate("(a)", counts, sb_passes(run_dir)))
        log(f"[serve-bench] (a) cli closed loop, concurrency {SB_CONCURRENCY}, {SB_REQUESTS} "
            f"requests, buckets {SB_BUCKETS}, packed (primary pass): {sb_line(v)}; exit {rc} in "
            f"{secs:.1f}s")
        log(f"[serve-bench] (a) resident bytes dense {pk['dense']['resident_bytes']} packed "
            f"{pk['packed']['resident_bytes']} ratio {pk['resident_ratio']} (from the "
            f"artifact's tensors: {want_d} / {want_p} = {ratio}); step_ms (bucket 32, CUDA "
            f"events) dense {pk['dense']['step_ms']} packed {pk['packed']['step_ms']} "
            f"(delta {pk['step_ms_delta_pct']}%); dense pass {pk['dense']['throughput_rps']} "
            f"req/s p99 {pk['dense']['p99_ms']} ms")
        log(f"[serve-bench] (a) attribution {json.dumps(sb_attribution(v['attribution']))}")
        log(f"[serve-bench] (a) ok={oks['a']}")
        summary["a"] = {"verdict": {k: v[k] for k in (
            "p50_ms", "p95_ms", "p99_ms", "throughput_rps", "mean_batch_occupancy", "batches",
            "requests_shed", "warmup_compile_s")}, "packed": pk,
            "attribution": sb_attribution(v["attribution"])}
        thr = v["throughput_rps"]

        busy, wall, done, counts, fw = sb_busy_share(art)
        add(counts)
        oks["a_busy"] = done == 1024 and sb_launch_gate(
            "(a) profiled", counts, [("unpack", fw, False)])
        share = (f"busy share {busy / wall:.4f}, idle {1 - busy / wall:.4f}" if busy > 0
                 else "the profiler saw no device time (busy share not measured)")
        log(f"[serve-bench] (a) device busy under load (packed/unpack, closed loop of 1024 at "
            f"concurrency {SB_CONCURRENCY}, torch.profiler on): {busy:.3f} ms of kernels in "
            f"{wall:.3f} ms wall: {share} ({1024 / wall * 1e3:.1f} req/s under the profiler); "
            f"ok={oks['a_busy']}")
        summary["a"]["busy_ms"], summary["a"]["busy_wall_ms"] = busy, wall

        # closed loop with one bucket each: 1 and 8 (32 is (a)'s largest)
        for b, n in ((1, 512), (8, 1024)):
            vb, rd, counts, secs = sb_run(root, art, mode="closed", concurrency=SB_CONCURRENCY,
                                          requests=n, buckets=(b,))
            add(counts)
            oks[f"bucket{b}"] = sb_accounted(vb) and sb_launch_gate(
                f"(a) bucket {b}", counts, sb_passes(rd))
            log(f"[serve-bench] (a) closed loop, dense, bucket {b} alone, {n} requests: "
                f"{sb_line(vb)} ({secs:.1f}s)")
            summary[f"bucket{b}"] = {k: vb[k] for k in (
                "p50_ms", "p95_ms", "p99_ms", "throughput_rps", "mean_batch_occupancy")}
            summary[f"bucket{b}"]["attribution"] = sb_attribution(vb["attribution"])

        # (b) open loop (Poisson) at 0.5x and 1.2x (a)'s throughput, packed
        # as (a)'s primary pass; about 2 s of offered load each
        summary["b"] = {}
        for factor in (0.5, 1.2):
            rate = round(factor * thr, 3)
            n = int(min(max(2.0 * rate, 256), 4096))
            vo, rd, counts, secs = sb_run(root, art, mode="open", rate=rate, requests=n,
                                          packed_weights="on")
            add(counts)
            ok = sb_accounted(vo) and sb_launch_gate(f"(b) {factor}x", counts, sb_passes(rd))
            if factor < 1.0:
                ok = ok and vo["requests_shed"] == 0
            oks[f"b{factor}"] = ok
            log(f"[serve-bench] (b) open loop at {factor}x = {rate} req/s, {n} requests: "
                f"{sb_line(vo)} ({secs:.1f}s) ok={ok}")
            summary["b"][str(factor)] = {k: vo[k] for k in (
                "rate_rps", "requests_submitted", "requests_shed", "shed_rate", "p50_ms",
                "p99_ms", "throughput_rps", "max_queue_depth_seen")}

        # (c) packed/popcount, closed loop: K4
        vc, rd, counts, secs = sb_run(root, art, mode="closed", concurrency=SB_CONCURRENCY,
                                      requests=1024, packed_weights="on", packed_impl="popcount")
        add(counts)
        oks["c"] = sb_accounted(vc) and counts["K4"] > 0 and sb_launch_gate(
            "(c)", counts, sb_passes(rd))
        log(f"[serve-bench] (c) packed/popcount closed loop, 1024 requests: {sb_line(vc)}; "
            f"step_ms {vc['packed']['packed']['step_ms']} ({secs:.1f}s) ok={oks['c']}")
        summary["c"] = {k: vc[k] for k in ("p50_ms", "p99_ms", "throughput_rps")}
        summary["c"]["step_ms"] = vc["packed"]["packed"]["step_ms"]

        # (d) the pool: one real engine on cuda:0 behind the batcher's async
        # dispatch, every answer bitwise the single engine's on the same batch
        engines, batches = [], []
        real = make_engine_runner_factory(SB_BUCKETS, on_engine=lambda e, d: engines.append(e))

        def factory(ref, device):
            inner = real(ref, device)

            def runner(payloads):
                out = inner(payloads)
                batches.append((list(payloads), out))
                return out

            return runner

        rng = np.random.default_rng(12)
        images = [rng.normal(size=(224, 224, 3)).astype(np.float32) for _ in range(96)]
        reset_counts()
        pool = ReplicaPool(factory, replica_devices(1), artifact_ref=art)
        batcher = MicroBatcher(pool.submit, max_batch=SB_BUCKETS[-1], max_queue=128,
                               max_delay_ms=5.0, max_pending_batches=2)
        futs = {}

        def submit(i):
            futs[i] = batcher.submit(images[i])
            return futs[i]

        raw = LoadGenerator(submit, lambda i: i, mode="closed", requests=len(images),
                            concurrency=SB_CONCURRENCY).run()
        drained = batcher.drain(60) and pool.drain(60)
        counts = launch_counts()
        add(counts)
        single = InferenceEngine(art, buckets=SB_BUCKETS, device="cuda")
        index = {id(img): i for i, img in enumerate(images)}
        same = len(batches) > 0
        for payloads, out in batches:
            ids = [index[id(p)] for p in payloads]
            want = single.predict_logits(np.stack(payloads))
            same = same and np.array_equal(out.view(np.uint32), want.view(np.uint32))
            same = same and all(np.array_equal(futs[i].result().view(np.uint32),
                                               want[r].view(np.uint32)) for r, i in enumerate(ids))
        stats = pool.stats()
        oks["d_pool"] = (drained and same and raw["completed"] == len(images)
                         and stats["replicas"][0]["device"] == "cuda:0"
                         and sb_launch_gate("(d) pool", counts, [("dense", engines[0].forwards, False)]))
        log(f"[serve-bench] (d) pool of 1 real engine on {stats['replicas'][0]['device']}: "
            f"{raw['completed']} answers in {len(batches)} batches, each bitwise the single "
            f"engine's on the same batch {same}, drained {drained}; ok={oks['d_pool']}")
        del pool, batcher, engines[:], single

        # (d) the paced fabric sweep
        vp, _, counts, secs = sb_run(root, art, mode="closed", concurrency=64, requests=512,
                                     buckets=(4,), queue_depth=512, max_delay_ms=8.0,
                                     replicas=(1, 2, 4), pace_ms=10.0)
        sc = vp["scaling"]
        oks["d_paced"] = (sb_accounted(vp) and sc["monotone"] is True
                          and all(counts.get(k, 0) == 0 for k in SB_COUNTED))
        log(f"[serve-bench] (d) paced sweep --replicas 1 2 4 --pace-ms 10: throughput "
            f"{sc['throughput_rps']} monotone {sc['monotone']} efficiency {sc['efficiency']} "
            f"({secs:.1f}s) ok={oks['d_paced']}")
        summary["d_paced"] = sc

        # (d) --replicas 2: one engine per card is the contract
        from bdbnn_tpu_torch import cli

        n_cards = torch.cuda.device_count()
        argv = ["serve-bench", art, "--mode", "closed", "--requests", "64", "--replicas", "2",
                "--log-path", tempfile.mkdtemp(dir=root)]
        reset_counts()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = cli.main(argv)
            msg = f"exit {rc}, replicas {json.loads(out.getvalue())['replicas']['n']}"
            oks["d_two"] = n_cards >= 2 and rc == 0
        except ValueError as e:
            msg = f"ValueError: {e}"
            oks["d_two"] = n_cards < 2 and "one engine per device is the contract" in str(e)
        add(launch_counts())
        log(f"[serve-bench] (d) --replicas 2 with {n_cards} card(s): {msg}; ok={oks['d_two']}")

        # (e) SIGTERM after the warmup: drained, every accepted request answered
        rc, ve, run_dir, counts, err, secs = sb_cli(
            root, art, ["--mode", "open", "--rate", str(round(0.5 * thr, 3)), "--requests",
                        "1000000"], sigterm_after_s=1.0)
        add(counts)
        oks["e"] = (rc == 0 and ve is not None and ve["preempted"] is True
                    and sb_accounted(ve) and ve["requests_submitted"] < 1000000
                    and sb_launch_gate("(e)", counts, sb_passes(run_dir)))
        log(f"[serve-bench] (e) SIGTERM 1 s into an open loop at {round(0.5 * thr, 3)} req/s: "
            f"exit {rc}, " + (f"preempted {ve['preempted']}, {sb_line(ve)}" if ve else err)
            + f" ({secs:.1f}s) ok={oks['e']}")

        # (f) answers through the batcher and the load generator against
        # predict_logits of each image alone, exact-stem images
        engine = InferenceEngine(art, buckets=SB_BUCKETS, device="cuda")
        tern = rng.integers(-1, 2, size=(256, 224, 224, 3)).astype(np.float32)
        reset_counts()
        fw0 = engine.forwards
        b = MicroBatcher(lambda ids: engine.predict_logits(tern[ids]), max_batch=SB_BUCKETS[-1],
                         max_queue=256, max_delay_ms=5.0)
        ffuts = {}

        def fsubmit(i):
            ffuts[i] = b.submit(i)
            return ffuts[i]

        raw = LoadGenerator(fsubmit, lambda i: i, mode="closed", requests=len(tern),
                            concurrency=SB_CONCURRENCY).run()
        drained = b.drain(60)
        got = np.stack([ffuts[i].result() for i in range(len(tern))])
        alone = np.concatenate([engine.predict_logits(tern[i:i + 1]) for i in range(len(tern))])
        counts = launch_counts()
        add(counts)
        rel = float(np.max(np.abs(got - alone))) / max(float(np.max(np.abs(alone))), 1e-30)
        bitwise = int(np.sum(np.all(got.view(np.uint32) == alone.view(np.uint32), axis=-1)))
        top1 = int(np.sum(got.argmax(-1) == alone.argmax(-1)))
        oks["f"] = (drained and raw["completed"] == len(tern) and np.all(np.isfinite(got))
                    and rel <= CPU_LOGIT_TOL
                    and sb_launch_gate("(f)", counts, [("dense", engine.forwards - fw0, False)]))
        log(f"[serve-bench] (f) {len(tern)} exact-stem answers through the batcher and the load "
            f"generator vs predict_logits of each image alone: relative {rel} (tol "
            f"{CPU_LOGIT_TOL}), {bitwise} of {len(tern)} rows bitwise, top-1 equal on {top1}; "
            f"ok={oks['f']}")
        summary["f"] = {"relative": rel, "bitwise_rows": bitwise, "rows": len(tern)}
        del engine, tern, alone, got

        # (g) the bf16 flagship artifact, closed loop: the bf16 modes of K1, K2
        bf16 = os.path.join(root, "resnet18_react_bf16")
        make_flagship_artifact(bf16, dtype="bfloat16")
        vg, rd, counts, secs = sb_run(root, bf16, mode="closed", concurrency=SB_CONCURRENCY,
                                      requests=512)
        add(counts)
        oks["g"] = sb_accounted(vg) and counts["K1 bf16"] > 0 and sb_launch_gate(
            "(g) bf16", counts, sb_passes(rd, bf16=True))
        log(f"[serve-bench] (g) bf16 artifact closed loop, 512 requests: {sb_line(vg)} "
            f"({secs:.1f}s) ok={oks['g']}")
        summary["g"] = {k: vg[k] for k in ("p50_ms", "p99_ms", "throughput_rps")}

    ok = all(oks.values())
    summary["seconds"] = round(time.perf_counter() - t_phase, 1)
    log(f"[serve-bench] summary {json.dumps(summary)}")
    log(f"[serve-bench] gates {oks}; launches over the runs {total}; "
        f"{summary['seconds']}s: ok={ok}")
    return total, ok, thr


# ---------------------------------------------------------------------------
# [serve-http]: the network front end over loopback sockets
# ---------------------------------------------------------------------------

SH_BUCKETS = (1, 8, 32)
SH_QUOTA = "100000:100000"
# an answer over the wire against predict_logits of its image alone: the
# 4-place rounding of the wire format (half a unit of the 4th place, with
# room for the float's own rounding) plus the bucket-against-bucket
# tolerance [serve-bench] (f) holds batched answers to
SH_WIRE_ATOL = 5e-5
# the saturating schedule (b)'s calibration offers from inside the server's
# process and (a) from outside it
SH_SAT_RATE = 4000.0
SH_SAT_REQUESTS = 256
# (b)'s poisson run at half the calibrated rate, (c)'s flash crowd run to
# its end and (d)'s quota run: each lasts requests / rate seconds, so
# their counts set most of the phase's length past its server starts
SH_B_REQUESTS = 512
SH_BURST_REQUESTS = 750
SH_D_REQUESTS = 256


def sh_request(host: str, port: int, method: str, path: str, body: bytes = b"",
               headers=None, timeout: float = 120.0):
    """One HTTP/1.1 exchange on a fresh connection: (status, headers, parsed
    JSON body or None)."""
    import socket

    from bdbnn_tpu_torch.serve.loadgen import recv_response

    with socket.create_connection((host, port), timeout=timeout) as s:
        head = f"{method} {path} HTTP/1.1\r\nhost: {host}\r\ncontent-length: {len(body)}\r\n"
        for k, v in (headers or {}).items():
            head += f"{k}: {v}\r\n"
        s.sendall((head + "connection: close\r\n\r\n").encode("latin-1") + body)
        status, resp_headers, raw = recv_response(s.makefile("rb"))
    return status, resp_headers, json.loads(raw) if raw else None


def sh_predict(host: str, port: int, image, *, raw: bool = True, priority: int = 0,
               tenant: str = "tenant-a", model=None):
    """POST one image to /v1/predict, as raw float32 or as JSON; returns
    (status, headers, body, seconds on the wire)."""
    headers = {"x-priority": str(priority), "x-tenant": tenant}
    if model is not None:
        headers["x-model"] = model
    if raw:
        headers["content-type"] = "application/octet-stream"
        body = image.astype("<f4").tobytes()
    else:
        headers["content-type"] = "application/json"
        body = json.dumps(image.tolist()).encode()
    t0 = time.perf_counter()
    status, h, payload = sh_request(host, port, "POST", "/v1/predict", body, headers)
    return status, h, payload, time.perf_counter() - t0


def _http_events(log_path: str, phase: str):
    import glob

    from bdbnn_tpu_torch.obs.events import read_events

    for ev in glob.glob(os.path.join(log_path, "*", "events.jsonl")):
        for e in read_events(os.path.dirname(ev), "http"):
            if e.get("phase") == phase:
                return e, os.path.dirname(ev)
    return None, None


def sh_cli(root: str, art: str, args: list, client=None, sigterm_after_ready_s=None):
    """``serve-http ART args`` as a subprocess (the CLI through
    :func:`counted_cli`), on port 0. With ``client``, once the run's ``http``
    ``start`` event names the port, ``client(host, port)`` runs here and
    its return value is kept; with ``sigterm_after_ready_s``, SIGTERM that
    long after the ``ready`` event; a serve-mode run gets SIGTERM after
    ``client``. The server is killed in a ``finally`` if it still runs.
    Returns a dict: rc, verdict (or None), run_dir, counts, forwards (the
    ``http`` ``stop`` event's), client (its result), err (stderr tail),
    seconds."""
    import signal

    log_path = tempfile.mkdtemp(dir=root)
    counts_file = os.path.join(log_path, "counts.json")
    cmd = [sys.executable, "-c", COUNTED_CLI, "serve-http", art, "--port", "0", "--log-path",
           log_path, "--buckets", *map(str, SH_BUCKETS), *args]
    out = {"client": None, "verdict": None, "run_dir": None, "counts": {}, "forwards": None}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, COUNTS_ENV: counts_file})
    try:
        deadline = time.monotonic() + 300
        start = None
        while proc.poll() is None and start is None and time.monotonic() < deadline:
            start, _ = _http_events(log_path, "start")
            time.sleep(0.005)
        if start is not None and client is not None:
            out["client"] = client(start["host"], start["port"])
        if start is not None and sigterm_after_ready_s is not None:
            while proc.poll() is None and time.monotonic() < deadline:
                if _http_events(log_path, "ready")[0] is not None:
                    time.sleep(sigterm_after_ready_s)
                    break
                time.sleep(0.02)
        if proc.poll() is None and ("--scenario" not in args or sigterm_after_ready_s is not None):
            proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            stdout, stderr = proc.communicate()
    out["seconds"] = time.perf_counter() - t0
    out["rc"], out["err"] = proc.returncode, stderr[-3000:]
    if proc.returncode == 0:
        out["verdict"] = json.loads(stdout)
    stop, out["run_dir"] = _http_events(log_path, "stop")
    if stop is not None:
        out["forwards"] = stop["forwards"]
    if os.path.exists(counts_file):
        with open(counts_file) as f:
            out["counts"] = json.load(f)
    return out


def sh_launch_gate(tag: str, run: dict, mode: str) -> bool:
    """The run's launches == 19 × its engines' forwards, for the kernels
    ``mode`` runs (the ``http`` ``stop`` event's ``forwards``)."""
    if run["forwards"] is None:
        log(f"[serve-http] {tag} no http stop event: forwards unknown")
        return False
    return sb_launch_gate(tag, run["counts"], [(mode, run["forwards"], False)],
                          phase="[serve-http]")


def sh_accounted(v: dict) -> bool:
    """The client's ledger and the server's: every request answered, none
    dropped, none failed, the drain clean, the server ledger's identity."""
    c = v.get("client") or {}
    return (c.get("dropped") == 0 and c.get("responses") == c.get("submitted")
            and v["requests_completed"] + v["requests_shed"] + v["requests_failed"]
            + v["requests_rejected"] == v["requests_submitted"]
            and v["requests_failed"] == 0 and v["drained_clean"])


def sh_per_priority(v: dict) -> dict:
    return {p: {k: b[k] for k in ("submitted", "completed", "shed", "shed_rate", "p50_ms",
                                  "p95_ms", "p99_ms")}
            for p, b in v["per_priority"].items()}


def sh_wire_check(answers: list, alone, tag: str, lone: int = 0) -> dict:
    """Answers over the wire ``[(status, body)]`` against ``alone`` (the
    engine's logits of each image alone): the largest difference and the
    tolerance, rows bitwise equal to the rounded logits (the first
    ``lone`` answers, each sent alone, counted apart), and the top-1
    disagreements, each where the top two logits lie within the tolerance."""
    import numpy as np

    got = np.array([a[1]["result"]["logits"] for a in answers], np.float64)
    scale = float(np.max(np.abs(alone)))
    tol = SH_WIRE_ATOL + CPU_LOGIT_TOL * scale
    diff = float(np.max(np.abs(got - alone)))
    rounded = [[round(float(x), 4) for x in row] for row in alone]
    same = [a[1]["result"]["logits"] == r for a, r in zip(answers, rounded)]
    bitwise, lone_bitwise = sum(same), sum(same[:lone])
    top2 = np.sort(alone, axis=-1)[:, -2:]
    near = np.abs(top2[:, 1] - top2[:, 0]) <= tol
    pred = np.array([a[1]["result"]["pred"] for a in answers])
    off = pred != alone.argmax(-1)
    ok = (all(a[0] == 200 for a in answers) and diff <= tol and not bool(np.any(off & ~near)))
    log(f"[serve-http] {tag} {len(answers)} answers vs predict_logits of each image alone: "
        f"max diff {diff} (tol {SH_WIRE_ATOL} + {CPU_LOGIT_TOL}·max|logit| = {tol}), "
        f"{bitwise} of {len(answers)} bitwise the rounded logits, pred off the argmax on "
        f"{int(off.sum())} ({int((off & near).sum())} with the top two within tolerance, "
        f"{int(near.sum())} such rows)"
        + (f"; of the {lone} sent alone {lone_bitwise} bitwise, of the other "
           f"{len(answers) - lone} {bitwise - lone_bitwise}" if lone else "") + f"; ok={ok}")
    return {"ok": ok, "max_diff": diff, "tol": tol, "bitwise": bitwise,
            "lone_bitwise": lone_bitwise, "pred_off": int(off.sum()),
            "top2_near": int(near.sum())}


def sh_busy_share(art: str, rate: float, requests: int = 256) -> tuple:
    """The device's busy share under HTTP load, as [serve-bench] measures
    it: the packed/unpack engine behind the batcher and ``HttpFrontEnd`` on
    loopback, the socket load generator offering a ``requests``-long
    Poisson schedule at ``rate``, torch.profiler (CUPTI) around the load
    alone; busy = the kernels' device time over the load's wall. Returns
    (busy ms, wall ms, client ledger, launch counts, forwards)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bdbnn_tpu_torch.serve.admission import AdmissionController
    from bdbnn_tpu_torch.serve.batching import MicroBatcher
    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.http import HttpFrontEnd, image_codec
    from bdbnn_tpu_torch.serve.loadgen import HttpLoadGenerator, build_schedule

    engine = InferenceEngine(art, buckets=SH_BUCKETS, device="cuda", packed=True)
    decode, encode = image_codec(224)
    fe = HttpFrontEnd(
        MicroBatcher(lambda xs: engine.predict_logits(np.stack(xs)), max_batch=SH_BUCKETS[-1],
                     max_queue=64, max_delay_ms=5.0, priorities=3),
        AdmissionController(default_rate=1e9, default_burst=1e9), decode=decode, encode=encode,
        port=0)
    host, port = fe.start()
    images = np.random.default_rng(0).standard_normal((32, 224, 224, 3)).astype(np.float32)
    bodies = [x.tobytes() for x in images]
    sched = build_schedule("poisson", requests=requests, rate=rate, seed=0)
    reset_counts()
    fw0 = engine.forwards
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            raw = HttpLoadGenerator(host, port, sched, body_fn=lambda i: bodies[i % 32],
                                    concurrency=16).run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fe.drain(60)
    counts = launch_counts()
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, wall_ms, raw, counts, engine.forwards - fw0


def phase_serve_http(art: str, smi_line: str, sb_thr=None):
    """[serve-http]: the flagship served over loopback sockets through
    ``serve-http`` (admission, the asyncio front end, the capacity plane,
    the registry, the scenario load generator), every run's launches held
    to 19 × its engines' forwards. ``sb_thr`` (serve-bench's closed-loop
    throughput in this run, when it ran) caps the bench's rate. Returns
    (launch counts summed over the runs, ok)."""
    import threading

    import numpy as np

    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.loadgen import HttpLoadGenerator, build_schedule

    t_phase = time.perf_counter()
    log(f"[serve-http] {smi_line}")
    oks = {}
    total = {k: 0 for k in SB_COUNTED}
    summary = {"device": smi_line}

    def add(counts):
        for k in SB_COUNTED:
            total[k] += counts.get(k, 0)

    # the yardstick in the server's own mode: packed weights, its buckets (a
    # lone image runs at bucket 1 in both)
    engine = InferenceEngine(art, buckets=SH_BUCKETS, device="cuda", packed=True)
    rng = np.random.default_rng(21)
    tern = rng.integers(-1, 2, size=(64, 224, 224, 3)).astype(np.float32)
    alone = np.concatenate([engine.predict_logits(tern[i:i + 1]) for i in range(len(tern))])

    with tempfile.TemporaryDirectory() as root:
        # (a) serve mode, the client here, in another process than the server
        def client_a(host, port):
            seen, health = set(), True
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                status, _, body = sh_request(host, port, "GET", "/readyz")
                seen.add((status, body["state"]))
                health = health and sh_request(host, port, "GET", "/healthz")[0] == 200
                if status == 200:
                    break
                time.sleep(0.01)
            answers, wire = [None] * 64, []
            for i in range(16):  # one at a time: each rides alone, bucket 1
                s, _, b, secs = sh_predict(host, port, tern[i], raw=i % 2 == 0,
                                           priority=i % 3, tenant=f"tenant-{'ab'[i % 2]}")
                answers[i] = (s, b)
                wire.append(secs * 1e3)

            def worker(ids):
                for i in ids:
                    s, _, b, _ = sh_predict(host, port, tern[i], raw=i < 40, priority=i % 3,
                                            tenant=f"tenant-{'ab'[i % 2]}")
                    answers[i] = (s, b)

            threads = [threading.Thread(target=worker, args=(range(16 + w, 64, 8),))
                       for w in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            conc_s = time.perf_counter() - t0
            # the schedule (b)'s calibration offers from the server's own
            # process, offered from this one: what the in-process client costs
            bodies = [x.astype("<f4").tobytes() for x in tern[:32]]
            sat = HttpLoadGenerator(host, port, build_schedule(
                "poisson", requests=SH_SAT_REQUESTS, rate=SH_SAT_RATE, seed=0),
                body_fn=lambda i: bodies[i % 32], concurrency=16).run()
            health = health and sh_request(host, port, "GET", "/healthz")[0] == 200
            statsz = sh_request(host, port, "GET", "/statsz")
            return {"readyz": sorted(seen), "health": health, "answers": answers,
                    "wire_ms": wire, "concurrent_s": conc_s, "statsz": statsz, "sat": sat}

        a = sh_cli(root, art, ["--default-quota", SH_QUOTA, "--packed-weights"], client=client_a)
        add(a["counts"])
        v, c = a["verdict"], a["client"]
        if v is None or c is None:
            log(f"[serve-http] (a) FAIL: exit {a['rc']}\n{a['err']}")
            return total, False
        wire = sh_wire_check(c["answers"], alone, "(a)", lone=16)
        ws = sorted(c["wire_ms"])
        st_status, _, st = c["statsz"]
        oks["a"] = (a["rc"] == 0 and (503, "warming") in c["readyz"] and (200, "ready") in
                    c["readyz"] and c["health"] and wire["ok"] and st_status == 200
                    and all(st.get(k) for k in ("batcher", "admission", "capacity"))
                    and v["preempted"] is True and v["drained_clean"] is True
                    and v["requests_completed"] == v["requests_submitted"] == 64 + SH_SAT_REQUESTS
                    and c["sat"]["dropped"] == 0
                    and v["capacity"]["demand"]["identity_ok"] is True
                    and sh_launch_gate("(a)", a, "unpack"))
        sat_rps = round(c["sat"]["responses"] / max(c["sat"]["wall_s"], 1e-9), 3)
        raw_ms = sorted(c["wire_ms"][0::2])
        json_ms = sorted(c["wire_ms"][1::2])
        log(f"[serve-http] (a) serve mode, packed/unpack, client in this process and the "
            f"server in another: /readyz states seen {c['readyz']}, /healthz 200 throughout "
            f"{c['health']}; 16 requests one at a time, wire ms of the 8 raw float32 bodies "
            f"p50 {raw_ms[4]:.3f} min {raw_ms[0]:.3f} max {raw_ms[-1]:.3f}, of the 8 JSON "
            f"bodies p50 {json_ms[4]:.3f} min {json_ms[0]:.3f} max {json_ms[-1]:.3f}; 48 more "
            f"(24 raw, 24 JSON) from 8 threads in {c['concurrent_s']:.3f} s "
            f"({48 / c['concurrent_s']:.1f} req/s); then poisson at {SH_SAT_RATE} req/s "
            f"offered, {SH_SAT_REQUESTS} raw requests on 16 connections from here: "
            f"{sat_rps} req/s, client {c['sat']['by_status']} dropped {c['sat']['dropped']}, "
            f"p99 by priority {c['sat']['p99_ms_by_priority']}; /statsz "
            f"{st_status} with {sorted(st)}; SIGTERM: exit {a['rc']}, preempted "
            f"{v['preempted']}, drained_clean {v['drained_clean']}; {sb_line(v)} "
            f"({a['seconds']:.1f}s) ok={oks['a']}")
        summary["a"] = {"wire_ms_raw": raw_ms, "wire_ms_json": json_ms,
                        "concurrent_s": c["concurrent_s"], "wire": wire,
                        "out_of_process_rps": sat_rps, "out_of_process": c["sat"],
                        "per_priority": sh_per_priority(v),
                        "attribution": sb_attribution(v["attribution"])}

        # (b) bench mode, poisson, packed weights: R from a calibration run
        base = ["--default-quota", SH_QUOTA, "--packed-weights", "--concurrency", "16"]
        cal = sh_cli(root, art, [*base, "--scenario", "poisson", "--rate", str(SH_SAT_RATE),
                                 "--requests", str(SH_SAT_REQUESTS)])
        add(cal["counts"])
        if cal["verdict"] is None:
            log(f"[serve-http] (b) calibration FAIL: exit {cal['rc']}\n{cal['err']}")
            return total, False
        cal_thr = cal["verdict"]["throughput_rps"]
        cc_ = cal["verdict"]["client"]
        cal_client_rps = round(cc_["responses"] / max(cc_["wall_s"], 1e-9), 3)
        log(f"[serve-http] (b) the GIL: the same poisson schedule ({SH_SAT_RATE} req/s offered, "
            f"{SH_SAT_REQUESTS} requests, 16 connections) answered {cal_client_rps} req/s with "
            f"the client in the server's process and {sat_rps} req/s with the client in "
            f"another ((a)), as each client counts (responses over its wall)")
        summary["gil"] = {"in_process_rps": cal_client_rps, "out_of_process_rps": sat_rps}
        rate = 0.5 * cal_thr if sb_thr is None else min(0.5 * cal_thr, 0.5 * sb_thr)
        rate = round(rate, 3)
        oks["b_cal"] = sh_accounted(cal["verdict"]) and sh_launch_gate("(b) calibration", cal,
                                                                       "unpack")
        log(f"[serve-http] (b) calibration: poisson at {SH_SAT_RATE} req/s offered, "
            f"{SH_SAT_REQUESTS} requests, "
            f"packed: {sb_line(cal['verdict'])}; R = 0.5 × {cal_thr}"
            + (f", capped at 0.5 × serve-bench's {sb_thr}" if sb_thr else "")
            + f" = {rate} req/s ({cal['seconds']:.1f}s) ok={oks['b_cal']}")
        b = sh_cli(root, art, [*base, "--scenario", "poisson", "--rate", str(rate),
                               "--requests", str(SH_B_REQUESTS)])
        add(b["counts"])
        vb = b["verdict"]
        att = (vb or {}).get("attribution") or {}
        stages = {s for s, blk in (att.get("stages") or {}).items() if blk is not None}
        oks["b"] = (b["rc"] == 0 and vb is not None and sh_accounted(vb)
                    and {"read", "admit", "respond"} <= stages and vb["capacity"] is not None
                    and sh_launch_gate("(b)", b, "unpack"))
        if vb is not None:
            log(f"[serve-http] (b) poisson at {rate} req/s, {SH_B_REQUESTS} requests, concurrency 16, "
                f"packed/unpack: {sb_line(vb)}; client {vb['client']}")
            log(f"[serve-http] (b) per priority {json.dumps(sh_per_priority(vb))}")
            log(f"[serve-http] (b) attribution {json.dumps(sb_attribution(att))}")
            log(f"[serve-http] (b) capacity headroom {json.dumps(vb['capacity']['headroom'])} "
                f"burn_rate_max {vb['capacity']['burn_rate_max']}")
            summary["b"] = {"rate": rate, "calibration_rps": cal_thr,
                            "throughput_rps": vb["throughput_rps"],
                            "per_priority": sh_per_priority(vb),
                            "attribution": sb_attribution(att)}
        log(f"[serve-http] (b) exit {b['rc']} ({b['seconds']:.1f}s) ok={oks['b']}"
            + ("" if vb is not None else f"\n{b['err']}"))
        busy, wall, raw, counts, fw = sh_busy_share(art, rate)
        add(counts)
        oks["b_busy"] = raw["dropped"] == 0 and sb_launch_gate(
            "(b) profiled", counts, [("unpack", fw, False)], phase="[serve-http]")
        share = (f"busy share {busy / wall:.4f}, idle {1 - busy / wall:.4f}" if busy > 0
                 else "the profiler saw no device time (busy share not measured)")
        log(f"[serve-http] (b) device busy under HTTP load (packed/unpack, in process, 256 "
            f"requests poisson at {rate} req/s, concurrency 16, torch.profiler on): {busy:.3f} "
            f"ms of kernels in {wall:.3f} ms wall: {share}; client {raw['by_status']}; "
            f"ok={oks['b_busy']}")
        summary["b_busy"] = {"busy_ms": busy, "wall_ms": wall}

        # (c) flash crowd ×8, dense: 10,000 requests with SIGTERM 3 s after
        # ready (the burst window opens a third of the way through the
        # schedule, 10000 / (3 R) s in); then SH_BURST_REQUESTS run to
        # their end, whose burst opens a third of the way in, from 64 connections against
        # 8-deep class queues (16 connections never fill the default
        # 64-deep queues: the backlog would wait on the client's side)
        for tag, n, term, extra in (
                ("c", 10000, 3.0, []),
                ("c_burst", SH_BURST_REQUESTS, None,
                 ["--concurrency", "64", "--queue-depth", "8"])):
            cc = sh_cli(root, art, ["--default-quota", SH_QUOTA, "--scenario", "flash_crowd",
                                    "--rate", str(rate), "--flash-factor", "8", "--requests",
                                    str(n), *extra], sigterm_after_ready_s=term)
            add(cc["counts"])
            vc = cc["verdict"]
            if vc is None:
                oks[tag] = False
                log(f"[serve-http] ({tag}) FAIL: exit {cc['rc']}\n{cc['err']}")
                continue
            by = vc["client"]["by_status"]
            explicit = set(by) <= {"200", "429", "503"} and (
                by.get("429", 0) + by.get("503", 0) == vc["requests_shed"])
            pp = vc["per_priority"]
            oks[tag] = (cc["rc"] == 0 and vc["preempted"] is (term is not None)
                        and sh_accounted(vc) and explicit
                        and (vc["client"]["submitted"] < n if term else
                             vc["client"]["submitted"] == n)
                        and pp["0"]["shed_rate"] <= pp["2"]["shed_rate"]
                        and sh_launch_gate(f"({tag})", cc, "dense"))
            log(f"[serve-http] ({tag}) flash crowd at {rate} req/s × 8, {n} requests {extra}"
                + (f", SIGTERM {term} s after ready" if term else "")
                + f": exit {cc['rc']}, preempted {vc['preempted']}, {sb_line(vc)}; client "
                f"{vc['client']}; shed rate by class "
                f"{ {p: b['shed_rate'] for p, b in pp.items()} }; fairness_ratio "
                f"{vc['fairness_ratio']} ({cc['seconds']:.1f}s) ok={oks[tag]}")
            summary[tag] = {"per_priority": sh_per_priority(vc),
                            "fairness_ratio": vc["fairness_ratio"], "client": vc["client"],
                            "throughput_rps": vc["throughput_rps"]}

        # (d) quotas: tenant-b on the default 20:20, tenant-a unlimited
        def client_d(host, port):
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                if sh_request(host, port, "GET", "/readyz")[0] == 200:
                    break
                time.sleep(0.01)
            got = [sh_predict(host, port, tern[i % 8], tenant="tenant-b")[:3] for i in range(30)]
            got += [sh_predict(host, port, tern[i % 8], tenant="tenant-a")[:3] for i in range(5)]
            return got

        d = sh_cli(root, art, ["--scenario", "poisson", "--rate", str(rate), "--requests",
                               str(SH_D_REQUESTS),
                               "--default-quota", "20:20", "--tenant-quota",
                               "tenant-a=100000:100000"], client=client_d)
        add(d["counts"])
        vd = d["verdict"]
        if vd is not None and d["client"] is not None:
            b429 = [x for x in d["client"][:30] if x[0] == 429]
            a_codes = {x[0] for x in d["client"][30:]}
            pt = vd["per_tenant"]
            oks["d"] = (d["rc"] == 0 and bool(b429)
                        and all(x[2]["error"] == "over_quota" and "retry-after" in x[1]
                                for x in b429)
                        and a_codes == {200} and pt["tenant-b"]["over_quota"] > 0
                        and pt["tenant-a"]["over_quota"] == 0 and sh_accounted(vd)
                        and sh_launch_gate("(d)", d, "dense"))
            log(f"[serve-http] (d) quotas 20:20 default, tenant-a unlimited, poisson at {rate} "
                f"req/s, {SH_D_REQUESTS} requests, and 30 direct tenant-b + 5 tenant-a requests: direct "
                f"tenant-b 429s {len(b429)} (over_quota with retry-after), tenant-a codes "
                f"{sorted(a_codes)}; per tenant "
                f"{ {t: {k: r[k] for k in ('submitted', 'completed', 'over_quota')} for t, r in pt.items()} }; "
                f"client {vd['client']} ({d['seconds']:.1f}s) ok={oks['d']}")
        else:
            oks["d"] = False
            log(f"[serve-http] (d) FAIL: exit {d['rc']}\n{d['err']}")

        # (e) the registry and two resident flagship versions
        second = os.path.join(root, "resnet18_react_seed1")
        make_flagship_artifact(second, seed=1)
        reg = os.path.join(root, "registry")
        pubs = [subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", "registry",
                                "publish", p, "-r", reg], cwd=REPO, capture_output=True,
                               text=True, timeout=300) for p in (art, second)]
        res = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", "registry", "resolve",
                              "v0002", "-r", reg], cwd=REPO, capture_output=True, text=True,
                             timeout=300)
        e_alone = {"v0001": alone[:8],
                   "v0002": np.concatenate([
                       InferenceEngine(res.stdout.strip(), buckets=(1,), device="cuda")
                       .predict_logits(tern[i:i + 1]) for i in range(8)])} if (
            res.returncode == 0) else None

        def client_e(host, port):
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                if sh_request(host, port, "GET", "/readyz")[0] == 200:
                    break
                time.sleep(0.01)
            got = {m: [sh_predict(host, port, tern[i], model=m)[:3] for i in range(8)]
                   for m in ("v0001", "v0002")}
            got["bad"] = sh_predict(host, port, tern[0], model="v0009")[:3]
            got["replicas"] = sh_request(host, port, "GET", "/admin/replicas")
            return got

        e = sh_cli(root, "v0001", ["--default-quota", SH_QUOTA, "--registry", reg,
                                   "--resident-models", "2"], client=client_e)
        add(e["counts"])
        ve, ce = e["verdict"], e["client"]
        if ve is not None and ce is not None and e_alone is not None:
            checks = {m: sh_wire_check([(s, b) for s, _, b in ce[m]], e_alone[m], f"(e) {m}")
                      for m in ("v0001", "v0002")}
            differ = [b["result"]["logits"] for _, _, b in ce["v0001"]] != [
                b["result"]["logits"] for _, _, b in ce["v0002"]]
            # no engine ran for the unknown version: the forwards are the two
            # engines' warmups and the 16 requests, one at a time
            want_fw = 2 * len(SH_BUCKETS) + 16
            oks["e"] = (all(p.returncode == 0 for p in pubs) and res.returncode == 0
                        and all(ch["ok"] for ch in checks.values()) and differ
                        and ce["bad"][0] == 404 and ce["replicas"][0] == 200
                        and set(ve["resident"]["models"]) == {"default", "v0002"}
                        and e["forwards"] == want_fw and ve["requests_rejected"] == 1
                        and sh_launch_gate("(e)", e, "dense"))
            log(f"[serve-http] (e) registry: two flagships published and v0002 resolved by "
                f"the port's CLI; "
                f"served as v0001 with --resident-models 2: answers differ across versions "
                f"{differ}, x-model v0009 -> {ce['bad'][0]} {ce['bad'][2]}; resident "
                f"{ {k: m['resident_bytes'] for k, m in ve['resident']['models'].items()} }; "
                f"forwards {e['forwards']} (want {want_fw}) ({e['seconds']:.1f}s) ok={oks['e']}")
        else:
            oks["e"] = False
            log(f"[serve-http] (e) FAIL: publish {[p.returncode for p in pubs]} resolve "
                f"{res.returncode} serve exit {e['rc']}\n{e['err']}\n{res.stderr[-2000:]}")

    ok = all(oks.values())
    summary["seconds"] = round(time.perf_counter() - t_phase, 1)
    log(f"[serve-http] summary {json.dumps(summary)}")
    log(f"[serve-http] gates {oks}; launches over the runs {total}; {summary['seconds']}s: "
        f"ok={ok}")
    return total, ok


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


def _ratio(err, base, scale, rnd: float = U) -> float:
    """The largest (err - rnd|base|) / scale: how many u·Σ|terms| an error
    takes beyond the final rounding (of unit ``rnd``)."""
    return float(((err - rnd * base.abs()).clamp(min=0) / scale.clamp(min=1e-30)).max())


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


def phase_k5_bf16_same_sign(gen) -> bool:
    """K5's bf16 mode on same-sign terms at layer4 3x3 s1 512->512 @7, -b
    256, as :func:`phase_k5_same_sign` holds the f32 mode: |g|, alpha > 0
    and every sign +1, so each output sums 4,608 positive bf16 products
    and a drift of the tensor cores' truncation cannot cancel. Held to the
    float64 sum of the same bf16 products within 4·u·Σ|terms| plus one
    bf16 rounding, and to the plain bf16 version within 8·u·Σ|terms| plus
    one bf16 rounding on each side."""
    import torch

    from bdbnn_tpu_torch.nn.kernels import binary_conv2d_dgrad, binary_conv2d_dgrad_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, hw, c, o = TRAIN_BATCH, 7, 512, 512
    x = torch.randn((b, hw, hw, c), generator=gen, device=dev).to(bf)
    gy = torch.randn((b, hw, hw, o), generator=gen, device=dev).abs().to(bf)
    alpha = (0.05 + torch.rand((o,), generator=gen, device=dev)).to(bf)
    wsign = torch.ones((o, 3, 3, c), dtype=torch.int8, device=dev)
    dx = binary_conv2d_dgrad(gy, x, wsign, alpha)
    pdx = binary_conv2d_dgrad_plain(gy, x, wsign, alpha)
    exact = dgrad_exact(gy, x, wsign, alpha, 1, 1)
    ok = _hold_same_sign(f"K5 bf16 same-sign probe layer4 3x3 s1 512->512 @7 b{b}", dx, pdx,
                         exact, rnd=UB)
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


def _hold_same_sign(label: str, got, plain, exact, rnd: float = U) -> bool:
    """A same-sign probe's check: every term is positive, so Σ|terms| is
    the float64 sum itself. ``got`` within 4·u·Σ|terms| + rnd|exact| of
    it, and within 8·u·Σ|terms| + rnd|plain| of ``plain`` wherever
    ``plain`` is within 4·u·Σ|terms| + rnd|exact| of it; logs the ratios
    and the count of elements where the plain version is beyond its own
    bound. ``rnd`` is the output's one rounding: u for f32; 2⁻⁸ for bf16,
    where each side rounds its sum once (rnd|got| more against the plain
    version)."""
    scale = U * exact
    got, plain = got.float(), plain.float()
    err, err_ex = (got - plain).abs(), (got.double() - exact).abs()
    plain_in = (plain.double() - exact).abs() <= 4 * scale + rnd * exact.abs() + 1e-30
    bound_p = 8 * scale.float() + rnd * plain.abs() + (rnd - U) * got.abs() + 1e-30
    ok = (bool((err <= bound_p)[plain_in].all())
          and bool((err_ex <= 4 * scale + rnd * exact.abs() + 1e-30).all()))
    r = "u" if rnd == U else f"{rnd:g}"
    log(f"[train_kernels] {label} (|g|, signs +1): "
        f"within bound {ok}; the plain version is beyond its own float64 bound at "
        f"{int((~plain_in).sum())} of {plain_in.numel()} elements; (err - {r}|ref|)/(u·Σ|terms|) "
        f"max: kernel vs plain "
        f"{_ratio(err[plain_in], plain[plain_in], scale.float()[plain_in], rnd):.3f} "
        f"where the plain is within its bound (bound 8), "
        f"{_ratio(err, plain, scale.float(), rnd):.3f} over all, kernel vs exact "
        f"{_ratio(err_ex, exact, scale, rnd):.3f} (bound 4), plain vs exact "
        f"{_ratio((plain.double() - exact).abs(), exact, scale, rnd):.3f}; mean (kernel - exact)/"
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
        now = launch_counts()
        per_step.append({k: now[k] - prev.get(k, 0) for k in now})
        prev.update(now)
        losses.append(m["loss"])

    real_validate = loop._validate

    def validate(*a, **kw):
        acc1 = real_validate(*a, **kw)
        prev.update(launch_counts())
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
    counts = launch_counts()
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


def make_step(cfg, state, step_cfg, draws=None, mesh=None):
    """The train step ``fit`` builds for ``cfg``: under teacher–student
    the teacher from ``cfg.resume_teacher`` on the model's device (sharded
    over ``mesh``'s model axis, as ``fit`` shards it), its layer-KL pairs
    and the TS step; else the plain step."""
    from bdbnn_tpu_torch.parallel.tensor import shard_model
    from bdbnn_tpu_torch.train.loop import build_teacher, match_kd_pairs
    from bdbnn_tpu_torch.train.step import make_train_step, make_ts_train_step

    if not cfg.teacher_student:
        return make_train_step(state.model, state.optimizer, step_cfg, draws=draws)
    device = next(state.model.parameters()).device
    teacher = build_teacher(cfg, device)
    step_cfg = match_kd_pairs(state.model, teacher, step_cfg)
    if mesh is not None and mesh.model > 1:
        shard_model(teacher, mesh)
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
                       batch_size: int = TRAIN_BATCH, **cfg_kw) -> dict:
    """A train step of the flagship (or ``cfg_kw``'s model) at -b 256 (or
    ``batch_size``) alone: CUDA-event time per step on a batch already on the card
    (``batch``, else seeded normal images) and the peak device memory of
    those steps (``torch.cuda.max_memory_allocated``: model, optimizer
    state, batch and the step's activations); then, with ``trace``,
    device time by kernel, with ``torch.rand``'s share (the stochastic
    family's draws) named."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.train.loop import build_training, epoch_schedule

    cfg = train_config(batch_size=batch_size, device="cuda", **cfg_kw).validate()
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    state, step_cfg = build_training(cfg, torch.device("cuda"), 10, 224)
    step = make_step(cfg, state, step_cfg)
    if batch is None:
        g = torch.Generator(device="cuda").manual_seed(3)
        batch = (torch.randn((batch_size, 224, 224, 3), generator=g, device="cuda"),
                 torch.randint(0, 1000, (batch_size,), generator=g, device="cuda"))
    tk, gate = epoch_schedule(family, cfg, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch, tk, gate), iters, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    log(f"[profile] {tag} train step -b {batch_size}, batch on the card: {ms:.2f} ms "
        f"= {batch_size / ms * 1e3:.1f} images/s (CUDA events, {iters} steps after 2 warm-up); "
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
        log(f"[profile] {tag} train step -b {batch_size}: device busy {busy:.3f} ms of "
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
    "K1": ("binary_conv_fwd_kernel", "fwd_sign_prep_kernel", "fwd_wpad_kernel"),
    "K2": ("weight_sign_kernel", "weight_alpha_finish_kernel"),
    "K5": ("binary_conv_dgrad_kernel", "dgrad_split_kernel", "dgrad_wsign_bf16_kernel"),
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
# 1024 val images (4096 before the script's time limit forced the cut: the
# synthetic data and the evals of six runs took about a minute): an
# untrained model's top-1 on random labels is about 0.1%, and model_best
# is written only when an eval's top-1 beats 0, so (f) and (g) read a
# model_best if some image is right and the last checkpoint otherwise, and
# hold either
RESUME_ARGS = dict(epochs=2, save_every_steps=2, batch_size=TRAIN_BATCH,
                   synthetic_train_size=RESUME_STEPS * TRAIN_BATCH, synthetic_val_size=1024,
                   device="cuda")
# (f): the student and its float teacher's arch
RESUME_TS = ("resnet18", "resnet18_float")
SCHED_KEYS = ("epoch", "step_in_epoch", "lr_step", "ede_t", "ede_k", "kurt_gate", "sched",
              "binarizer")


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
    2 steps; fit holds cuDNN deterministic on the card, and this phase
    holds it for its own runs too). (a) run A uninterrupted;
    (b) run B through ``cli.main``, SIGTERMed from a thread right after
    its checkpoint event of epoch 1 step 2: exit 75, ``preempt`` and
    ``checkpoint`` events, the committed state bitwise what the save was
    given; (c) B resumed: the ``restore`` event's schedule fields bitwise
    the checkpoint event's, each later loss and the final model,
    optimizer state and step bitwise A's; (d) the CLI in a subprocess
    (``python -m bdbnn_tpu_torch.cli``, with its own settings only),
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
            # the CLI as users run it: fit itself holds cuDNN deterministic
            proc = subprocess.Popen([sys.executable, "-m", "bdbnn_tpu_torch.cli",
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


# [bench]: the bench scripts on the card (bdbnn_tpu_torch/scripts/): the
# bench line at -b 128 with 5-step windows, the profile in this process
BENCH_BATCH = 128
BENCH_ITERS = 5
# the K kernels a bench step launches, by wrapper: 19 binary convs' K1, K2
# forward and K5, K6 backward, K7 once (the kurtosis loss; the bench's
# StepConfig, the reference's, has no binarization probes, which [train]'s
# fit adds as K7's second launch)
BENCH_PER_STEP = {"K1": 19, "K2": 19, "K3": 0, "K4": 0, "K5": 19, "K6": 19, "K7": 1}
# each K's device kernel launched exactly once a wrapper call, by name
BENCH_TRACE_NAMES = {"K1": "binary_conv_fwd_kernel", "K2": "weight_sign_kernel",
                     "K3": "unpack_sign_kernel", "K4": "popcount_conv_fwd_kernel",
                     "K5": "binary_conv_dgrad_kernel", "K6": "binary_conv_wgrad_kernel",
                     "K7": "kurt_mean_kernel"}


def bench_launches_ok(stage: dict, bf16: bool) -> bool:
    """A bench stage's launches: BENCH_PER_STEP × its steps of each K, and
    of each bf16 mode as many in the bf16 stage, none in the f32 one."""
    n = stage.get("steps", 0)
    want = {k: c * n for k, c in BENCH_PER_STEP.items()}
    want.update({f"{k} bf16": want[k] if bf16 else 0 for k in BF16_KERNELS})
    return n > 0 and {k: stage.get(k) for k in want} == want


def phase_bench(smi_line: str):
    """[bench]: (a) ``python -m bdbnn_tpu_torch.scripts.bench --batch 128
    --iters 5 --attempts 1 --probe-timeout 0`` as a subprocess, profile and
    f32 comparison on: exit 0, a last line with ``value`` > 0 and no
    ``error`` or ``prior_*`` key, ``device_kind`` nvidia-smi's name,
    ``timing_suspect`` false, ``device_ms_per_step`` present, the fenced
    rate at most 1.05 × ``device_images_per_sec``, and the worker's
    launches BENCH_PER_STEP a step of each K (the bf16 modes in the bf16
    stage, none in the f32 one); (b) the profile script in this process
    at -b 128, one fenced window of 5 steps before its 5-step profile
    window: its by-name total (every device op of the window) within 5% of
    the steps' mean busy sum (the ops launched inside a step's range, so
    device work outside the steps or lost from the join shows), its
    device ms a step within 10% of (a)'s, and each K's kernels in its
    trace (BENCH_TRACE_NAMES) equal to the launch counters over its
    window. Returns ((a)'s launches, summed over its stages; ok; (a)'s
    ``device_images_per_sec``)."""
    import shutil

    from bdbnn_tpu_torch.scripts import profile_step

    tag = "[bench]"
    t_phase = time.perf_counter()
    oks = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_bench-")
    cmd = [sys.executable, "-m", "bdbnn_tpu_torch.scripts.bench", "--batch", str(BENCH_BATCH),
           "--iters", str(BENCH_ITERS), "--attempts", "1", "--probe-timeout", "0",
           "--profile-dir", os.path.join(root, "a")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    line = lines[-1] if lines else {}
    launches = next((x["launches"] for x in lines if "launches" in x), {})
    name = smi_line.split(",")[0].strip()
    dev_rate = line.get("device_images_per_sec")
    oks["a rc"] = r.returncode == 0
    oks["a line"] = (line.get("value", 0) > 0 and "error" not in line
                     and not any(k.startswith("prior_") for k in line))
    oks["a device_kind"] = line.get("device_kind") == name
    oks["a timing_suspect"] = line.get("timing_suspect") is False
    oks["a device_ms_per_step"] = bool(line.get("device_ms_per_step"))
    oks["a fenced <= 1.05 device"] = bool(dev_rate) and line["value"] <= 1.05 * dev_rate
    oks["a launches"] = (bench_launches_ok(launches.get("bf16", {}), True)
                         and bench_launches_ok(launches.get("f32", {}), False))
    log(f"{tag} (a) {' '.join(cmd[1:])} -> exit {r.returncode} in {seconds:.1f}s [{smi_line}]")
    log(f"{tag} (a) the worker's stages: " + "; ".join(
        x.split("] ", 1)[0][len("[bench +"):].strip() + " " + x.split("] ", 1)[1]
        for x in r.stderr.splitlines() if x.startswith("[bench +") and "] " in x))
    log(f"{tag} (a) line {json.dumps(line)}")
    log(f"{tag} (a) the worker's launches by stage {launches} (want {BENCH_PER_STEP} a step; "
        f"the bf16 modes' in the bf16 stage)")
    if not oks["a rc"] or not line:
        log(f"{tag} (a) FAIL stderr tail: {r.stderr[-3000:]}")
    elif line.get("value") and dev_rate:
        log(f"{tag} (a) host-fenced {line['value']} images/s = "
            f"{BENCH_BATCH / line['value'] * 1e3:.2f} ms a step; device "
            f"{line['device_ms_per_step']} ms a step (busy; extent "
            f"{line.get('device_extent_ms_per_step')} under the profiler) = {dev_rate} images/s; mfu {line.get('mfu')}, device_mfu {line.get('device_mfu')}; "
            f"f32 {line.get('f32_images_per_sec_per_chip')} images/s, bf16 speedup "
            f"{line.get('bf16_speedup_vs_f32')}; vs_baseline {line.get('vs_baseline')} [{smi_line}]")
    counts = {k: sum(st.get(k, 0) for st in launches.values()) for k in KERNELS}
    counts.update({f"{k} bf16": launches.get("bf16", {}).get(f"{k} bf16", 0)
                   for k in BF16_KERNELS})

    # (b) the profile script in this process
    t0 = time.perf_counter()
    out_dir = os.path.join(root, "b")
    prof = profile_step.main(["--batch", str(BENCH_BATCH), "--iters", str(BENCH_ITERS),
                              "--windows", "1", "--out-dir", out_dir])
    b_seconds = time.perf_counter() - t0
    tc = trace_counts(os.path.join(out_dir, profile_step.TRACE_COPY), BENCH_TRACE_NAMES)
    win = prof["launches_in_window"]
    by_name = sum(prof["device_time_breakdown_ms_per_step"].values())
    busy = prof["device_step_busy_ms"]
    busy_mean = sum(busy) / len(busy) if busy else None
    dev_b, dev_a = prof["device_ms_per_step_median"], line.get("device_ms_per_step")
    oks["b by name ~ steps' busy"] = bool(by_name and busy_mean) and abs(
        by_name - busy_mean) <= 0.05 * busy_mean
    oks["b device ms ~ (a)"] = bool(dev_a and dev_b) and abs(dev_b - dev_a) <= 0.10 * dev_a
    oks["b trace K counts"] = all(tc.get(k) == win.get(k) for k in BENCH_TRACE_NAMES)
    log(f"{tag} (b) profile_step -b {BENCH_BATCH} in {b_seconds:.1f}s: device "
        f"{dev_b} ms a step (busy; extent {prof['device_extent_ms_per_step_median']}; (a) "
        f"{dev_a}), "
        f"{prof['device_images_per_sec']} images/s, device_mfu {prof['device_mfu']}; host-fenced "
        f"{prof['host_fenced_median_img_per_sec']} images/s ({prof['host_fenced_ms_per_step']} "
        f"ms), host_fenced_mfu {prof['host_fenced_mfu']}; by-name total {by_name:.3f} ms vs "
        f"the steps' busy {busy} ms (mean {busy_mean}); attribute_trace's total "
        f"{prof['device_track_total_ms_per_step']} ms; windows {prof['profile_windows']}, lost records "
        f"{prof['lost_device_records']} [{smi_line}]")
    log(f"{tag} (b) device ms a step by kernel name (top 10 + other): "
        f"{json.dumps(prof['device_time_breakdown_ms_per_step'])}")
    log(f"{tag} (b) by category: {prof['device_attribution_ms_per_step']}, mfu "
        f"{prof['device_attribution_mfu']}")
    log(f"{tag} (b) K kernels in the trace {dict((k, tc.get(k)) for k in BENCH_TRACE_NAMES)} "
        f"against the window's launch counters {dict((k, win.get(k)) for k in BENCH_TRACE_NAMES)}"
        f"; device records lost {tc.get('lost')} of {tc.get('issued')}")
    shutil.rmtree(root, ignore_errors=True)
    ok = all(oks.values())
    log(f"{tag} gates {oks} in {time.perf_counter() - t_phase:.1f}s: ok={ok}")
    return counts, ok, dev_rate


# [train-folder] (e)'s pipeline bench: the reference's batch of 64, four
# timed batches a thread count and at least two a worker process
# (bench_pipeline.window: 4, 4, 8, 16 for 1, 2, 4, 8 processes)
PIPELINE_BATCH = 64
PIPELINE_BATCHES = 4


def phase_train_folder(smi_line: str, device_img_per_sec=None):
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
    decode per image on one thread, threads against worker processes
    (the pipeline bench script's ``run`` on the train split, its target
    ``device_img_per_sec``, [bench] (a)'s device rate), the
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
    from bdbnn_tpu_torch.scripts import bench_pipeline
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
        # one worker, one batch in flight: its batches are -j W's
        mp1 = mk(MPImageFolderPipeline, train, True, num_workers=1, prefetch_batches=1)
        thr = mk(ImageFolderPipeline, train, True)
        mp_val = mk(MPImageFolderPipeline, val, False, num_workers=workers)
        thr_val = mk(ImageFolderPipeline, val, False)
        errs = {"mp": [], "threads": []}
        mpw.on_data_error, thr.on_data_error = errs["mp"].append, errs["threads"].append
        full_mp = list(mpw.epoch(0))
        full_thr = list(thr.epoch(0))
        mpw.on_data_error = thr.on_data_error = None
        it = mp1.epoch(0)
        first_j1 = [next(it), next(it)]
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
        # threads against worker processes: the pipeline bench script on
        # this tree, the card's device rate from [bench] (a) as its target
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            pb = bench_pipeline.run(train, PIPELINE_BATCH, PIPELINE_BATCHES,
                                    device_img_per_sec=device_img_per_sec)
        log(f"{tag} (e) bench_pipeline on this tree, -b {PIPELINE_BATCH}, after a warm batch "
            f"{PIPELINE_BATCHES} a thread count and "
            f"{[bench_pipeline.window(PIPELINE_BATCHES, w) for w in bench_pipeline.PROCESSES]} "
            f"for {bench_pipeline.PROCESSES} worker processes: threads {pb['threads_img_per_sec']} images/s, worker "
            f"processes {pb['processes_img_per_sec']} images/s; the card's "
            f"{pb['device_img_per_sec_target']} images/s needs "
            f"{pb['workers_to_saturate_device']} workers; {pb['host_cpu_count']} host cores, "
            f"{time.perf_counter() - t0:.1f}s [{smi_line}]")

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
    Then K5 bf16 on same-sign terms (:func:`phase_k5_bf16_same_sign`).
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
    ok = phase_k5_bf16_same_sign(g) and ok
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
        counts = launch_counts()
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


def free_port() -> int:
    from bdbnn_tpu_torch.parallel.launch import free_port as port

    return port()


def spawn_ranks(job: str, world: int, device: str, backend: str, kw: dict,
                timeout_s: float = 0.0) -> list:
    """``DDP_JOBS[job](**kw)`` on ``world`` ranks through the package's
    spawner (``bdbnn_tpu_torch/parallel/launch.py``): each rank a spawned
    process in one process group over ``backend``, every rank on
    ``device``; returns each rank's result, in rank order. A rank that
    fails or outlasts ``timeout_s`` (the spawner's default when 0) stops
    every rank and raises.

    The ranks find the job as ``"<this module's name>:<function>"``. Run
    as ``python3 chip_smoke.py`` that module is ``__main__``, which a
    spawned rank holds already (multiprocessing loads the parent's main
    script into it as ``__mp_main__`` and aliases ``__main__`` to it), so
    neither the parent nor a rank imports this file a second time;
    imported (the tests), it is ``chip_smoke``."""
    from bdbnn_tpu_torch.parallel.launch import JOB_TIMEOUT_S
    from bdbnn_tpu_torch.parallel.launch import spawn_ranks as spawn

    fn = DDP_JOBS[job]
    if globals().get(fn.__name__) is not fn:
        raise ValueError(f"DDP_JOBS[{job!r}] is not this module's function "
                         f"{fn.__name__!r}: a rank could not find it by name")
    return spawn(f"{__name__}:{fn.__name__}", world, device, backend, kw,
                 timeout_s=timeout_s or JOB_TIMEOUT_S)


class SignTape:
    """The sign each binary conv takes of its input in one forward,
    ``x - shift >= 0`` (what K1 fuses), recorded by forward pre-hooks for
    the model's first ``n`` binary conv calls, each as numpy ``packbits``
    of its rows; :func:`sign_crossings` counts where two runs differ. Also
    the first forward's output of the last residual block (``feat``, what
    the pool and the classifier read) and its logits, on the host."""

    def __init__(self, model):
        from bdbnn_tpu_torch.nn.layers import _BinaryConvBase

        mods = [m for m in model.modules() if isinstance(m, _BinaryConvBase)]
        self.n = len(mods)
        self.rows = []
        self.handles = [m.register_forward_pre_hook(self._hook) for m in mods]
        self.out = {}
        if getattr(model, "block_names", None):
            last = getattr(model, model.block_names[-1])
            self.handles.append(last.register_forward_hook(self._keep("feat")))
        self.handles.append(model.register_forward_hook(self._keep("logits")))

    def _keep(self, key):
        def hook(mod, args, output):
            self.out.setdefault(key, output.detach().cpu().clone())
        return hook

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
              steps_per_epoch: int = 4, inputs=None, model_kw=None, variables=None) -> dict:
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
    would have put on the other side of their threshold, and
    ``input_max_diff`` their largest difference from the job's.
    ``model_kw``: a ``BiResNet(**model_kw)`` with the flax-layout
    ``variables`` (numpy) in place of the registry's seeded ``cfg.arch``,
    trained by the plain step (``StepConfig()``)."""
    import dataclasses

    import numpy as np
    import torch

    from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
    from bdbnn_tpu_torch.parallel import create_sharded_state, make_mesh
    from bdbnn_tpu_torch.train.config import RunConfig
    from bdbnn_tpu_torch.train.loop import build_training, epoch_schedule
    from bdbnn_tpu_torch.utils.checkpoint import state_payload

    cfg = RunConfig(**cfg_kw).validate()
    mesh = make_mesh(cfg.model_parallel)
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    dev = torch.device(device)
    if dev.type == "cuda":
        # as fit: the stem conv and the classifier in full f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if model_kw is None:
        state, step_cfg = build_training(cfg, dev, steps_per_epoch,
                                         224 if cfg.dataset == "imagenet" else 32)
    else:
        from bdbnn_tpu_torch.models.resnet import BiResNet
        from bdbnn_tpu_torch.train.optim import make_optimizer
        from bdbnn_tpu_torch.train.state import StepConfig, TrainState

        model = BiResNet(**model_kw).from_flax(variables).to(dev)
        opt = make_optimizer(model, dataset=cfg.dataset, lr=cfg.lr, epochs=cfg.epochs,
                             steps_per_epoch=steps_per_epoch, momentum=cfg.momentum,
                             weight_decay=cfg.weight_decay, policy=cfg.opt_policy)
        state, step_cfg = TrainState(model=model, optimizer=opt), StepConfig()
    if mesh.data > 1:
        step_cfg = dataclasses.replace(step_cfg, data_shard=(mesh.data_rank, mesh.data))
    source = (ShardReplay(draws, mesh.data_rank, mesh.data) if isinstance(draws, list)
              else draws)
    step = make_step(cfg, state, step_cfg, draws=None if source is None else (lambda _s: source),
                     mesh=mesh)
    create_sharded_state(mesh, state)
    tape = SignTape(state.model) if signs else None
    replay = None
    if inputs is not None:
        replay = InputReplay(("conv", "rprelu"))
        if inputs != "record":
            replay.recorded = [t.to(dev) for t in inputs]
        handles = replay.hooks(state.model, "card" if inputs == "record" else "cpu")
    tk, gate = epoch_schedule(family, cfg, 0)
    out = {"losses": [], "rank": mesh.rank, "world": mesh.world, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank}
    for i, (x, y) in enumerate(batches):
        b = len(x) // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev) for a in (x, y))
        _, m = step(state, batch, tk, gate)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["grads"] = whole_grads(state.model)
            out["metrics"] = {k: float(v) for k, v in m.items()}
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
                    out["input_max_diff"] = replay.max_diff
            if len(batches) > 1:
                out["first_state"] = state_payload(state)["model"]
    out["state"] = state_payload(state)
    out["local"] = local_tensors(state)
    out["signs"] = tape.rows if tape is not None else None
    out["first"] = tape.out if tape is not None else None
    out["launches"] = read_counts()
    return out


def whole_grads(model) -> dict:
    """Every parameter's gradient on the host, a sharded one gathered
    whole (a collective over ``model``: every rank calls it)."""
    import torch
    import torch.distributed as dist

    from bdbnn_tpu_torch.parallel.tensor import sharded

    out = {}
    for n, p in model.named_parameters():
        g = p.grad.detach()
        if sharded(p):
            parts = [torch.empty_like(g) for _ in range(p.model_axis.size)]
            dist.all_gather(parts, g.contiguous(), group=p.model_axis.group)
            g = torch.cat(parts, dim=p.shard_dim)
        out[n] = g.cpu().clone()
    return out


def local_tensors(state) -> dict:
    """This rank's own tensors on the host, sharded or not: the model's
    ``state_dict`` and each parameter's optimizer state by name
    (``"opt NAME KEY"``), and the names of the sharded parameters."""
    from bdbnn_tpu_torch.parallel.tensor import sharded

    out = {"model " + k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            if hasattr(v, "detach"):
                out[f"opt {names[id(p)]} {k}"] = v.detach().cpu().clone()
    return {"tensors": out, "sharded": sorted(n for n, p in state.model.named_parameters()
                                               if sharded(p))}


def local_diff(a: dict, b: dict, replicated_only: bool) -> list:
    """The names whose tensors differ between two ranks'
    :func:`local_tensors` (only the replicated ones with
    ``replicated_only``: the tensors of a sharded parameter differ
    between model ranks by design)."""
    import torch

    def is_shard(key):
        return any(key == "model " + n or key.startswith(f"opt {n} ") for n in a["sharded"])

    out = []
    for k in sorted(set(a["tensors"]) | set(b["tensors"])):
        if replicated_only and is_shard(k):
            continue
        x, y = a["tensors"].get(k), b["tensors"].get(k)
        if x is None or y is None or x.shape != y.shape or not torch.equal(x, y):
            out.append(k)
    return out


def ddp_fit(log_path: str, arch: str = "resnet18", steps: int = DDP_STEPS,
            batch: int = TRAIN_BATCH, device: str = "cuda", deterministic: bool = False,
            profile_steps: int = 0, time_wrapped: bool = False, eval_images=None,
            after_shard=None, **cfg_kw) -> dict:
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
    plain and wrapped in ``DistributedDataParallel`` with global BN. On
    a ``model`` axis (``model_parallel`` in ``cfg_kw``) the gradients and
    the final state are gathered whole, and ``local`` holds the rank's
    own tensors (:func:`local_tensors`). ``eval_images`` (numpy NHWC):
    the final model's eval-mode logits of them, as ``eval_logits``.
    ``after_shard``: a list that receives ``state_payload`` of the state
    as ``create_sharded_state`` leaves it (a restored checkpoint, cut)."""
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
    real_shard = loop.create_sharded_state

    def shard(*a, **k):
        st = real_shard(*a, **k)
        if after_shard is not None:
            after_shard.append(state_payload(st))
        return st

    def build(*a, **k):
        st, sc = real_build(*a, **k)
        held.update(state=st, step_cfg=sc, tape=SignTape(st.model))
        return st, sc

    def on_step(epoch, step, m):
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        now = launch_counts()
        per_step.append({k: now[k] - prev.get(k, 0) for k in now})
        prev.update(now)
        losses.append(m["loss"])
        if "grads" not in held:
            held["grads"] = whole_grads(held["state"].model)
            held["tape"].close()

    def validate(*a, **kw):
        acc1 = real_validate(*a, **kw)
        prev.update(launch_counts())
        return acc1

    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or prev_det
    reset_counts()
    loop.build_training, loop._validate = build, validate
    loop.create_sharded_state = shard
    t0 = time.perf_counter()
    try:
        loop.fit(cfg, on_step=on_step)
    finally:
        loop.build_training, loop._validate = real_build, real_validate
        loop.create_sharded_state = real_shard
        torch.backends.cudnn.deterministic = prev_det
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if cuda:
        torch.cuda.synchronize()
    state = held["state"]
    out = {"counts": counts, "per_step": per_step, "losses": [float(v) for v in losses],
           "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])], "wall_s": wall,
           "grads": held["grads"], "signs": held["tape"].rows, "first": held["tape"].out,
           "state": state_payload(state), "local": local_tensors(state),
           "run_dir": run_dir_of(log_path)}
    if after_shard is not None:
        out["restored"] = after_shard
    if eval_images is not None:
        state.model.eval()
        with torch.no_grad():
            x = torch.from_numpy(eval_images).to(next(state.model.parameters()).device)
            out["eval_logits"] = state.model(x).cpu()
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


def _rank_batch(cfg, device, data: int = 0):
    """A seeded batch of this rank's rows on ``device``: the global batch
    over ``data`` data ranks (the job's world when 0)."""
    import torch

    b = cfg.batch_size // (data or _rank_shard()[1])
    g = torch.Generator().manual_seed(3)
    return (torch.randn((b, 224, 224, 3), generator=g).to(device),
            torch.randint(0, 1000, (b,), generator=g).to(device))


def _profile_ddp_steps(cfg, state, step_cfg, steps: int) -> dict:
    """``steps`` more train steps of ``state`` (DDP-wrapped in a job) on a
    seeded batch of the step's data shard on its device: the host wall per
    step (synchronized); under torch.profiler the host spans of the gloo
    all-reduces and all-gathers (enqueue to completion, so the reducer's
    overlap the backward) and the device busy time; and the bytes one step
    hands to the Python collectives (the model axis's gathers and sums, BN's
    sums; the DDP reducer's buckets are not among them), by op and group,
    from the tensors' shapes."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from bdbnn_tpu_torch.nn.binarize import get_active_family
    from bdbnn_tpu_torch.parallel.tensor import sharded
    from bdbnn_tpu_torch.train.loop import epoch_schedule

    dev = next(state.model.parameters()).device
    # this rank's data shard: (rank, world) over the model axis's size
    axis = next((p.model_axis for p in state.model.parameters() if sharded(p)), None)
    n = axis.size if axis is not None else 1
    rank, world = _rank_shard()
    shard = (rank // n, world // n)
    step = make_step(cfg, state, dataclasses.replace(step_cfg, data_shard=shard))
    batch = _rank_batch(cfg, dev, shard[1])
    tk, gate = epoch_schedule(get_active_family(), cfg, 0)
    step(state, batch, tk, gate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch, tk, gate)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, tk, gate)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    comm, busy_ms, keys = {"all_reduce": 0.0, "all_gather": 0.0, "broadcast": 0.0}, 0.0, set()
    for ev in prof.key_averages():
        name = ev.key.lower().replace("allreduce", "all_reduce").replace("allgather", "all_gather")
        op = next((k for k in comm if k in name), None)
        if "gloo" in name and op is not None:
            comm[op] += ev.cpu_time_total / 1e3 / steps
            keys.add(ev.key)
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_ms += us / 1e3 / steps
    model_group = axis.group if axis is not None else None
    moved = {}
    real = {"all_gather": dist.all_gather, "all_reduce": dist.all_reduce,
            "broadcast": dist.broadcast}

    def counted(op):
        def call(*args, group=None, **kw):
            parts = args[0] if op == "all_gather" else [args[0]]
            key = f"{op} {'model' if group is not None and group is model_group else 'other'}"
            moved[key] = moved.get(key, 0) + sum(t.numel() * t.element_size() for t in parts)
            return real[op](*args, group=group, **kw)
        return call

    for op in real:
        setattr(dist, op, counted(op))
    try:
        step(state, batch, tk, gate)
    finally:
        for op, fn in real.items():
            setattr(dist, op, fn)
    torch.cuda.synchronize()
    return {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
            "gloo_allreduce_ms": comm["all_reduce"],
            "gloo_allgather_ms": comm["all_gather"], "gloo_broadcast_ms": comm["broadcast"],
            "busy_ms": busy_ms, "keys": sorted(keys), "bytes": moved}


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


def tp_primitives(seed: int = 0) -> dict:
    """This rank's view of the model-axis functions (``parallel/tensor.py``)
    on a ``make_mesh(model_parallel=2)`` of the group that is up, on
    seeded tensors: ``gather_from_model`` of the rank's slice and its
    backward (the rank's slice of the cotangent), ``copy_to_model``'s
    backward (the cotangents summed over ``model``), ``whole`` of a
    sharded parameter and its gradient, and ``agree_replicated_grads`` on
    gradients that differ from rank to rank (the first rank's on every
    rank; a sharded parameter's own left as it is)."""
    import torch

    from bdbnn_tpu_torch.parallel import make_mesh
    from bdbnn_tpu_torch.parallel.tensor import (
        agree_replicated_grads,
        copy_to_model,
        gather_from_model,
        model_axis,
        shard_slice,
        whole,
    )

    mesh = make_mesh(model_parallel=2)
    axis = model_axis(mesh)
    g = torch.Generator().manual_seed(seed)
    full = torch.randn((2, 3, 8), generator=g)
    cot = torch.randn((2, 3, 8), generator=g)
    x = shard_slice(full, axis, -1).requires_grad_(True)
    y = gather_from_model(x, axis, -1)
    (y * cot).sum().backward()
    z = torch.randn((4,), generator=g) * (1 + mesh.model_rank)
    zc = z.clone().requires_grad_(True)
    (copy_to_model(zc, axis) * 3.0).sum().backward()
    w = torch.nn.Parameter(shard_slice(torch.randn((3, 8), generator=g), axis, 1))
    w.model_axis, w.shard_dim = axis, 1
    ww = whole(w)
    (ww * ww).sum().backward()
    rep = torch.nn.Parameter(torch.zeros(5))
    rep.grad = torch.full((5,), float(mesh.rank) + 0.5)
    w_grad = w.grad.clone()
    agree_replicated_grads([w, rep])
    return {"rank": mesh.rank, "model_rank": mesh.model_rank, "full": full, "cot": cot,
            "y": y.detach(), "dx": x.grad, "z": z, "dz": zc.grad, "whole": ww.detach(),
            "dw": w.grad, "dw_before": w_grad, "rep_grad": rep.grad}


def ddp_each(calls: list) -> list:
    """``DDP_JOBS[job](**kw)`` of each (job, kw) of ``calls``, in order, in
    one job (one process group for several cases)."""
    return [DDP_JOBS[job](**kw) for job, kw in calls]


DDP_JOBS = {"steps": ddp_steps, "fit": ddp_fit, "batchnorm": ddp_batchnorm,
            "primitives": ddp_primitives, "tp_primitives": tp_primitives, "each": ddp_each}


# ---------------------------------------------------------------------------
# [train-tp]: tensor parallelism over the mesh's 'model' axis
# ---------------------------------------------------------------------------

# the ranks of (a) (data 1 x model 2) and (c) (data 2 x model 2), all on
# the one card over gloo (NCCL refuses two ranks on one card); the global
# batch; (a)'s steps, with a mid-epoch checkpoint at step 2; the epoch of
# (c)'s one-process run, whose step-2 checkpoint (c)'s four ranks resume
# for the last 2 steps
TP_MODEL = 2
TP_BATCH = 64
TP_STEPS = 3
TP_ONE_STEPS = 4
# the classifier's product over O/N columns and the whole one differ in
# their GEMM's summation order: the logits to this share of the largest
# |logit| (everything before the classifier is bitwise)
FC_TOL = 1e-6
# the shard shapes of the sharded binary convs at N = 2 and 4: the
# flagship's convs of 256 or more output channels, O cut N ways
TP_SHARD_CONVS = [cv for cv in FLAGSHIP_CONVS if cv[3] >= 256]


def tp_bytes_estimate(batch: int, n: int) -> dict:
    """The bytes one -b ``batch`` step of the flagship on an N-way model
    axis hands its model-axis collectives, from the shapes alone: the
    forward gathers of the sharded convs' outputs and of the logits (each
    the whole f32 output), and the backward sums of their inputs'
    cotangents (each the whole f32 input)."""
    fwd = bwd = 0
    for name, hw, c, o, k, s, count in TP_SHARD_CONVS:
        ho = hw // s
        fwd += count * batch * ho * ho * o * 4
        bwd += count * batch * hw * hw * c * 4
    fwd += batch * 1000 * 4
    bwd += batch * 512 * 4
    return {"forward_gathers": fwd, "backward_sums": bwd, "model": n}


def _hold_k5_k6(x, shift, w, gy, s, pad):
    """K5 (approx) and K6 at one shape against their plain versions and
    the float64 sums, with [train_kernels]' gates; (dx, ok5, err5, ok6,
    err6, ratios)."""
    import torch

    from bdbnn_tpu_torch.nn.kernels import (
        binary_conv2d_dgrad,
        binary_conv2d_dgrad_plain,
        binary_conv2d_wgrad,
        binary_conv2d_wgrad_plain,
        weight_binarize,
    )
    from bdbnn_tpu_torch.nn.kernels.binary_conv import estimator_slope

    approx = ("approx", 0.0, 0.0)
    st = (s, s)
    wsign, alpha = weight_binarize(w)
    dx = binary_conv2d_dgrad(gy, x, wsign, alpha, shift=shift, strides=st, estimator=approx)
    pdx = binary_conv2d_dgrad_plain(gy, x, wsign, alpha, shift=shift, strides=st,
                                    estimator=approx)
    slope = estimator_slope(x - shift, approx)
    ex = dgrad_exact(gy, x, wsign, alpha, s, pad) * slope.double()
    terms = binary_conv2d_dgrad_plain(gy.abs(), x, torch.ones_like(wsign), alpha.abs(),
                                      shift=shift, strides=st)
    scale = U * terms * slope.abs()
    err, err_ex = (dx - pdx).abs(), (dx.double() - ex).abs()
    ok5 = (bool((err <= 8 * scale + U * pdx.abs() + 1e-30).all())
           and bool((err_ex <= 4 * scale + U * ex.abs() + 1e-30).all()))
    r5 = (_ratio(err, pdx, scale), _ratio(err_ex, ex, scale.double()))
    err5 = float(err.max())
    del pdx, ex, terms, scale, err, err_ex
    dw = binary_conv2d_wgrad(gy, x, w, alpha, shift=shift, strides=st)
    dw2 = binary_conv2d_wgrad(gy, x, w, alpha, shift=shift, strides=st)
    pdw = binary_conv2d_wgrad_plain(gy, x, w, alpha, shift=shift, strides=st)
    ex6 = wgrad_exact(gy, x, w, alpha, shift, s, pad)
    wscale = U * binary_conv2d_wgrad_plain(gy.abs(), torch.ones_like(x), torch.zeros_like(w),
                                           alpha.abs(), strides=st)
    err6, err6_ex = (dw - pdw).abs(), (dw.double() - ex6).abs()
    ok6 = (bool((err6 <= 8 * wscale + U * pdw.abs() + 1e-30).all())
           and bool((err6_ex <= 4 * wscale + U * ex6.abs() + 1e-30).all())
           and torch.equal(dw, dw2))
    r6 = (_ratio(err6, pdw, wscale), _ratio(err6_ex, ex6, wscale.double()))
    return dx, ok5, err5, ok6, float(err6.max()), r5 + r6


def tp_kernels(tag: str, smi_line: str) -> bool:
    """(e): K1, K5 and K6 at the shard shapes of the sharded binary convs
    at N = 2 and 4, batch TP_BATCH: each rank's slice against the plain
    version and the float64 sums with the gates of [kernels] and
    [train_kernels]; K1's slice bitwise the whole conv's channels; K5's
    partial dx summed over the N slices beside the whole conv's exact dx
    (printed); the N = 2 shapes timed (CUDA events)."""
    import torch

    from bdbnn_tpu_torch.nn.kernels import (
        binary_conv2d,
        binary_conv2d_dgrad,
        binary_conv2d_plain,
        binary_conv2d_wgrad,
        weight_binarize,
    )
    from bdbnn_tpu_torch.nn.kernels.binary_conv import estimator_slope

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    ok = True
    b = TP_BATCH
    approx = ("approx", 0.0, 0.0)
    for name, hw, c, o, k, s, count in TP_SHARD_CONVS:
        pad = k // 2
        ho = (hw + 2 * pad - k) // s + 1
        st = (s, s)
        x = torch.randn((b, hw, hw, c), generator=g, device=dev)
        shift = 0.1 * torch.randn((c,), generator=g, device=dev)
        w = 0.5 * torch.randn((k, k, c, o), generator=g, device=dev)
        gy = torch.randn((b, ho, ho, o), generator=g, device=dev)
        wsign, alpha = weight_binarize(w)
        y_whole = binary_conv2d(x, wsign, alpha, shift=shift, strides=st)
        ex_whole = dgrad_exact(gy, x, wsign, alpha, s, pad) * estimator_slope(x - shift,
                                                                               approx).double()
        for n in (2, 4):
            q = o // n
            dx_sum = None
            for r in range(n):
                cut = slice(r * q, (r + 1) * q)
                ws = w[..., cut].contiguous()
                wsg, al = weight_binarize(ws)
                y = binary_conv2d(x, wsg, al, shift=shift, strides=st)
                py = binary_conv2d_plain(x, wsg, al, shift=shift, strides=st)
                k1_ok = torch.equal(y, py) and torch.equal(y, y_whole[..., cut])
                dx, ok5, err5, ok6, err6, ratios = _hold_k5_k6(x, shift, ws,
                                                               gy[..., cut].contiguous(), s, pad)
                dx_sum = dx.double() if dx_sum is None else dx_sum + dx.double()
                this = k1_ok and ok5 and ok6
                if r == 0 or not this:
                    log(f"{tag} (e) {name} N={n} slice {r} ({c}->{q}) b{b}: K1 bitwise plain "
                        f"and the whole conv's channels {k1_ok}; K5 within bound {ok5} "
                        f"max_abs_err={err5} (vs plain {ratios[0]:.3f} of bound 8, vs exact "
                        f"{ratios[1]:.3f} of 4); K6 within bound, bitwise across two runs "
                        f"{ok6} max_abs_err={err6} (vs plain {ratios[2]:.3f}, vs exact "
                        f"{ratios[3]:.3f}); ok={this}")
                ok = ok and this
                del y, py, dx
            rel = float((dx_sum - ex_whole).abs().max()) / max(float(ex_whole.abs().max()), 1e-30)
            log(f"{tag} (e) {name} N={n}: the {n} partial dx summed vs the whole conv's exact dx: "
                f"largest difference {rel:.3e} of its largest |entry|")
            if n == 2:
                ws = w[..., :q].contiguous()
                wsg, al = weight_binarize(ws)
                gq = gy[..., :q].contiguous()
                t1 = cuda_ms(lambda: binary_conv2d(x, wsg, al, shift=shift, strides=st), 10)
                t5 = cuda_ms(lambda: binary_conv2d_dgrad(gq, x, wsg, al, shift=shift, strides=st,
                                                         estimator=approx), 10)
                t6 = cuda_ms(lambda: binary_conv2d_wgrad(gq, x, ws, al, shift=shift,
                                                         strides=st), 10)
                log(f"{tag} (e) {name} N=2 slice ({c}->{q}) b{b}: K1 {t1:.4f} ms, K5 {t5:.4f} "
                    f"ms, K6 {t6:.4f} ms (CUDA events; {smi_line})")
        del x, gy, w, y_whole, ex_whole
        torch.cuda.empty_cache()
    return ok


def phase_train_tp(smi_line: str):
    """[train-tp]: tensor parallelism on the flagship recipe (BASELINE
    config 3) at -b TP_BATCH, all ranks on the one card over gloo. (a) two
    ranks, ``--model-parallel 2``, through ``fit``: TP_STEPS steps, a
    checkpoint every 2, the eval pass; each rank's launches exact (K1, K2,
    K5, K6 19 a step, K7 2), the replicated parameters, BN statistics and
    Adam state bitwise equal across the ranks, the gathered state too, the
    eval ``count`` the whole val split. (b) (a)'s first step against one
    process on the same batch: no sign crossing, the last block's output
    (what the classifier reads) bitwise, the logits within FC_TOL of the
    largest |logit|, the loss to TRAIN_LOSS_RTOL, every gradient (the
    sharded ones gathered) to GRAD_TOL of its tensor's largest |entry|.
    (c) four ranks, data 2 x model 2, resuming a one-process run's step-2
    checkpoint (TP_ONE_STEPS a epoch) for 2 steps: launches exact, the
    replicated tensors bitwise on all four, each shard bitwise on its two
    data ranks, the eval count the whole split. (d) that resume, and (a)'s
    mid-epoch checkpoint resumed on one process: ``resharded`` and the
    restored state (gathered) bitwise the saved one; (a)'s run exported and served
    in three modes (the export gates of [train-resume]), its logits beside
    (a)'s eval forward. (e) :func:`tp_kernels`. (f) printed: each rank's
    step against the one process's at the same batch, the share of the
    step in the gloo gathers and sums, and the bytes a step hands the
    model-axis collectives beside :func:`tp_bytes_estimate`. Returns (the
    launch counts of (a), both ranks summed, ok)."""
    import dataclasses

    import numpy as np
    import torch

    from bdbnn_tpu_torch.models import create_model
    from bdbnn_tpu_torch.obs.events import read_events, read_jsonl
    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.export import export_artifact
    from bdbnn_tpu_torch.train import loop
    from bdbnn_tpu_torch.utils import checkpoint as ck

    tag = "[train-tp]"
    card = f"({smi_line})"
    oks = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fwd = N_BINARY_CONVS
    want = {"K1": fwd, "K2": fwd, "K3": 0, "K4": 0, "K5": fwd, "K6": fwd, "K7": 2,
            **{f"{k} bf16": 0 for k in BF16_KERNELS}}
    eval_x = np.random.default_rng(18).normal(size=(8, 224, 224, 3)).astype(np.float32)
    common = dict(arch="resnet18", device="cuda:0", batch=TP_BATCH)

    def evals_of(run_dir, world):
        return [read_events(run_dir, "eval")] + [
            [e for e in read_jsonl(os.path.join(run_dir, f"events.p{r}.jsonl"))
             if e["kind"] == "eval"] for r in range(1, world)]

    # (a)
    t0 = time.perf_counter()
    ranks = spawn_ranks("fit", TP_MODEL, "cuda:0", "gloo",
                        dict(log_path=fresh_log_root(), steps=TP_STEPS, model_parallel=TP_MODEL,
                             profile_steps=2, eval_images=eval_x, **common))
    log(f"{tag} (a) {TP_MODEL} ranks (data 1 x model {TP_MODEL}) over gloo on cuda:0, fit "
        f"flagship -b {TP_BATCH}, {TP_STEPS} steps + eval, in {time.perf_counter() - t0:.1f}s "
        "(processes started, kernels loaded)")
    run_dir = ranks[0]["run_dir"]
    evals = evals_of(run_dir, TP_MODEL)
    rep_diff = local_diff(ranks[0]["local"], ranks[1]["local"], replicated_only=True)
    whole_diff = state_diff(ranks[0]["state"], ranks[1]["state"])
    oks["(a) launches"] = all(len(r["per_step"]) == TP_STEPS and all(c == want for c in r["per_step"])
                              for r in ranks)
    oks["(a) finite"] = all(len(r["losses"]) == TP_STEPS
                            and all(math.isfinite(v) for v in r["losses"]) for r in ranks)
    feats_equal = torch.equal(ranks[0]["first"]["feat"], ranks[1]["first"]["feat"])
    oks["(a) replicated equal"] = not rep_diff and not whole_diff and feats_equal
    oks["(a) sharded"] = len(ranks[0]["local"]["sharded"]) == 11
    oks["(a) one run dir"] = all(r["run_dir"] == run_dir for r in ranks)
    oks["(a) eval count"] = all(len(ev) == 1 and ev[0]["count"] == TP_BATCH for ev in evals)
    counts = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}
    for r, res in enumerate(ranks):
        log(f"{tag} (a) rank {r}: losses {res['losses']}; launches per step {res['per_step']} "
            f"(expected {want} each); step ms (CUDA events, fit's loop) {res['step_ms']} {card}")
    log(f"{tag} (a) sharded parameters {ranks[0]['local']['sharded']}; the first forward's "
        f"last block output bitwise on both ranks {feats_equal}; replicated tensors that "
        f"differ between the ranks {rep_diff[:5]}, gathered state {whole_diff[:5]}; eval events "
        f"{[ev[0] if ev else None for ev in evals]}; whole run launches (both ranks) {counts}")
    # (b)
    cfg = train_config(arch="resnet18", batch_size=TP_BATCH,
                       synthetic_train_size=TP_STEPS * TP_BATCH,
                       synthetic_val_size=TP_BATCH, device="cuda").validate()
    pipe, _, _ = loop.build_datasets(cfg)
    pipe.prefetch = 0
    x, y = next(iter(pipe.epoch(0)))
    one = ddp_steps(dataclasses.asdict(cfg), [(x, y)], device="cuda:0", signs=True,
                    steps_per_epoch=TP_STEPS)
    cmp = compare_ddp_step(ranks[:1], one)
    cross = sum(cmp["crossings"])
    feat_same = torch.equal(ranks[0]["first"]["feat"], one["first"]["feat"])
    lg, lg1 = ranks[0]["first"]["logits"], one["first"]["logits"]
    fc_rel = float((lg - lg1).abs().max()) / max(float(lg1.abs().max()), 1e-30)
    grads_same = all(torch.equal(ranks[1]["grads"][n], g) for n, g in ranks[0]["grads"].items())
    worst = max(cmp["grad_err"].items(), key=lambda kv: kv[1])
    oks["(b) step"] = (cross == 0 and feat_same and fc_rel <= FC_TOL and grads_same
                       and cmp["loss_rel"] <= TRAIN_LOSS_RTOL and worst[1] <= GRAD_TOL)
    log(f"{tag} (b) first step at -b {TP_BATCH} against one process on the same batch: sign "
        f"crossings per binary conv {cmp['crossings']} (total {cross}); the last block's output "
        f"bitwise {feat_same}; logits {fc_rel:.3e} of the largest |logit| (tol {FC_TOL}); loss "
        f"{cmp['loss']!r} vs {cmp['loss_one']!r}, relative {cmp['loss_rel']:.3e} (tol "
        f"{TRAIN_LOSS_RTOL}); worst gradient error {worst[1]:.3e} of its tensor's largest |entry| "
        f"({worst[0]}; tol {GRAD_TOL}, {len(cmp['grad_err'])} tensors); the ranks' gathered "
        f"gradients bitwise equal {grads_same}; ok={oks['(b) step']}")
    log(f"{tag} (b) largest gradient errors: " + ", ".join(
        f"{n} {e:.3e}" for n, e in sorted(cmp["grad_err"].items(), key=lambda kv: -kv[1])[:6]))
    del one
    # (c): a one-process run (its step timed for (f)); its step-2
    # checkpoint resumed by four ranks, data 2 x model 2, for 2 steps
    topo_tp = {"processes": TP_MODEL, "devices": TP_MODEL, "mesh": {"data": 1, "model": TP_MODEL}}
    topo4 = {"processes": 2 * TP_MODEL, "devices": 2 * TP_MODEL,
             "mesh": {"data": 2, "model": TP_MODEL}}
    topo_one = {"processes": 1, "devices": 1, "mesh": {"data": 1, "model": 1}}
    p1 = ddp_fit(fresh_log_root(), steps=TP_ONE_STEPS, profile_steps=2, **common)
    old1 = os.path.join(p1["run_dir"], ck.CKPT_NAME + ".old")
    saved1 = torch.load(os.path.join(old1, ck.PAYLOAD_NAME), map_location="cpu",
                        weights_only=True)["state"]
    t0 = time.perf_counter()
    four = spawn_ranks("fit", 2 * TP_MODEL, "cuda:0", "gloo",
                       dict(log_path=fresh_log_root(), steps=TP_ONE_STEPS, model_parallel=TP_MODEL,
                            resume=old1, after_shard=[], **common))
    run4 = four[0]["run_dir"]
    (restore4,) = read_events(run4, "restore")
    rep4 = [local_diff(four[0]["local"], r["local"], replicated_only=True) for r in four[1:]]
    shard4 = [local_diff(four[m]["local"], four[m + TP_MODEL]["local"], replicated_only=False)
              for m in range(TP_MODEL)]
    restored4 = [state_diff(saved1, r["restored"][0]) for r in four]
    steps4 = TP_ONE_STEPS - 2
    oks["(c) launches"] = all(len(r["per_step"]) == steps4
                              and all(c == want for c in r["per_step"]) for r in four)
    oks["(c) finite"] = all(len(r["losses"]) == steps4
                            and all(math.isfinite(v) for v in r["losses"]) for r in four)
    oks["(c) replicas"] = not any(rep4) and not any(shard4) and not any(
        state_diff(four[0]["state"], r["state"]) for r in four[1:])
    oks["(c) eval count"] = all(len(ev) == 1 and ev[0]["count"] == TP_BATCH
                                for ev in evals_of(run4, 2 * TP_MODEL))
    oks["(d) one -> tp"] = (restore4["resharded"] is True and restore4["topology_from"] == topo_one
                            and restore4["topology_to"] == topo4 and not any(restored4))
    log(f"{tag} (c) 4 ranks (data 2 x model {TP_MODEL}) in {time.perf_counter() - t0:.1f}s, "
        f"resuming a one-process run's step-2 checkpoint for {steps4} steps: losses "
        f"{[r['losses'] for r in four]}; launches per step {[r['per_step'] for r in four]}; "
        f"replicated tensors differing from rank 0's {[d[:3] for d in rep4]}; shards differing "
        f"between the data ranks {[d[:3] for d in shard4]}; step ms {[r['step_ms'] for r in four]} "
        f"{card}")
    log(f"{tag} (d) the one-process step-2 checkpoint resumed under --model-parallel {TP_MODEL} "
        f"(data 2): resharded {restore4['resharded']} {restore4['topology_from']} -> "
        f"{restore4['topology_to']}; the restored state, cut and gathered, differs from the "
        f"saved one in {[d[:3] for d in restored4]}")
    del four
    # (d): (a)'s step-2 checkpoint resumed on one process
    old = os.path.join(run_dir, ck.CKPT_NAME + ".old")
    saved = torch.load(os.path.join(old, ck.PAYLOAD_NAME), map_location="cpu",
                       weights_only=True)["state"]
    d1 = ddp_fit(fresh_log_root(), steps=TP_STEPS, resume=old, after_shard=[], **common)
    (restore,) = read_events(d1["run_dir"], "restore")
    diff1 = state_diff(saved, d1["restored"][0])
    oks["(d) tp -> one"] = (restore["resharded"] is True and restore["topology_from"] == topo_tp
                            and restore["topology_to"] == topo_one and not diff1
                            and len(d1["losses"]) == TP_STEPS - 2)
    log(f"{tag} (d) (a)'s step-2 checkpoint resumed on one process: resharded "
        f"{restore['resharded']} {restore['topology_from']} -> {restore['topology_to']}; restored "
        f"state differs from the saved one in {diff1[:5]}; losses after it {d1['losses']}")
    # the exported weights: (a)'s checkpoint in one process, unfolded, in
    # eval mode, against (a)'s eval forward (only the classifier's sums
    # differ); the engine serves them with BatchNorm folded
    ref = ranks[0]["eval_logits"]
    model = create_model("resnet18", "imagenet").to("cuda:0")
    model.load_state_dict(ck.load_variables(run_dir))
    model.eval()
    with torch.no_grad():
        one_eval = model(torch.from_numpy(eval_x).to("cuda:0")).cpu()
    one_rel = float((one_eval - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "art")
        a = export_artifact(run_dir, art)
        out = {}
        for mode, kw in (("dense", {}), ("unpack", {"packed": True, "packed_impl": "unpack"}),
                         ("popcount", {"packed": True, "packed_impl": "popcount"})):
            out[mode] = InferenceEngine(art, buckets=(8,), device="cuda", **kw).predict_logits(eval_x)
        fin = all(np.all(np.isfinite(v)) and v.shape == (8, 1000) for v in out.values())
        same = all(np.array_equal(out[m].view(np.uint32), out["dense"].view(np.uint32))
                   for m in ("unpack", "popcount"))
        refn = ref.numpy()
        served_rel = float(np.max(np.abs(out["dense"] - refn))) / max(float(np.max(np.abs(refn))),
                                                                     1e-30)
        top1 = float(np.mean(out["dense"].argmax(-1) == refn.argmax(-1)))
        ranks_same = torch.equal(ranks[0]["eval_logits"], ranks[1]["eval_logits"])
        oks["(d) export serves"] = (fin and same and a["checkpoint"]["integrity"] == "ok"
                                    and ranks_same and one_rel <= FC_TOL)
        log(f"{tag} (d) (a)'s checkpoint in one process, eval mode, vs (a)'s eval forward (the "
            f"ranks' bitwise equal {ranks_same}): {one_rel:.3e} of the largest |logit| (tol "
            f"{FC_TOL}); (a)'s run exported (integrity {a['checkpoint']['integrity']}) and served "
            f"on the card: logits finite {fin}, bitwise across dense/unpack/popcount {same}; "
            f"dense (BatchNorm folded) vs (a)'s eval forward {served_rel:.3e} of the largest "
            f"|logit|, top-1 agreement {top1}")
    # (e)
    oks["(e) shard kernels"] = tp_kernels(tag, smi_line)
    # (f)
    est = tp_bytes_estimate(TP_BATCH, TP_MODEL)
    one_ms = p1["profile"]["wall_ms"]
    for r, res in enumerate(ranks):
        prof = res["profile"]
        comm = prof["gloo_allgather_ms"] + prof["gloo_allreduce_ms"] + prof["gloo_broadcast_ms"]
        moved = prof["bytes"]
        log(f"{tag} (f) rank {r}: {prof['wall_ms']:.2f} ms a step (host wall, synchronized) vs one "
            f"process at -b {TP_BATCH} {one_ms:.2f} ms {card}; under the profiler "
            f"{prof['profiled_wall_ms']:.2f} ms a step, of which gloo all-gather spans "
            f"{prof['gloo_allgather_ms']:.2f} ms + all-reduce spans {prof['gloo_allreduce_ms']:.2f} "
            f"ms + broadcast spans {prof['gloo_broadcast_ms']:.2f} ms = "
            f"{comm / prof['profiled_wall_ms']:.3f} (torch.profiler host spans "
            f"{prof['keys']}); device busy {prof['busy_ms']:.2f} ms; bytes a step handed to the "
            f"collectives, by op and axis {moved} (worked out from the shapes: forward gathers of "
            f"the sharded outputs {est['forward_gathers']}, backward sums of their inputs "
            f"{est['backward_sums']}; the rest are the regularizers' and probes' weight gathers "
            f"and the metric sums)")
    ok = all(oks.values())
    log(f"{tag} {oks} in {time.perf_counter() - t_phase:.1f}s; ok={ok}")
    return counts, ok


# [train-health]: the health monitor on the flagship recipe, 8 steps at
# -b 256, a drain every step; every fit under its own temporary log_path
HEALTH_STEPS = 8
HEALTH_FORENSICS_STEPS = 4
HEALTH_ARGS = dict(epochs=1, batch_size=TRAIN_BATCH, print_freq=1, device="cuda",
                   synthetic_train_size=HEALTH_STEPS * TRAIN_BATCH,
                   synthetic_val_size=TRAIN_BATCH)
# (a): flip_explosion armed past any real flip rate, after 2 drains, on
# one breach; the other detectors disarmed, as the reference's own test
# disarms throughput
HEALTH_FORCED = ("warmup_intervals=2", "debounce=1", "flip_explosion_rate=1e-9",
                 "throughput_window=999", "flip_collapse_rate=0", "kurt_divergence_abs=1e9",
                 "loss_spike_factor=1e9", "plateau_rel_range=0", "hbm_creep_frac=1e9")
# (d) and (e): a window over steps 5-7, after the steps (e) times
HEALTH_PROFILE_AT = "0:5:3"
# the device kernel each K wrapper launches exactly once a call, by the
# name the profiler gives it
K_TRACE_NAMES = {"K1": "binary_conv_fwd_kernel", "K2": "weight_sign_kernel",
                 "K5": "binary_conv_dgrad_kernel", "K6": "binary_conv_wgrad_kernel",
                 "K7": "kurt_mean_kernel"}
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def health_cli_args(root: str, extra=()) -> list:
    """The CLI flags of HEALTH_ARGS over TRAIN_ARGS, under ``root``."""
    kw = {**TRAIN_ARGS, **HEALTH_ARGS}
    assert kw["w_kurtosis"] and kw["diffkurt"] and kw["synthetic"]
    return ["--dataset", kw["dataset"], "-a", kw["arch"], "--synthetic", "-b",
            str(kw["batch_size"]), "--epochs", str(kw["epochs"]), "-lr", str(kw["lr"]),
            "--w-kurtosis", "--diffkurt", "--seed", str(kw["seed"]), "-p", str(kw["print_freq"]),
            "--synthetic-train-size", str(kw["synthetic_train_size"]),
            "--synthetic-val-size", str(kw["synthetic_val_size"]), "--device", kw["device"],
            "--log_path", root, *extra]


def trace_counts(path: str, names=K_TRACE_NAMES) -> dict:
    """Kernel events of each K (by ``names``) and runtime calls named
    SYNC_CALLS in a gzipped Chrome trace, and under ``lost`` the launches,
    copies and sets whose device record (by correlation id) the trace
    lacks, with ``issued`` (all of them) and ``lost_at`` (the first 20
    lost ones' positions among them, in launch order)."""
    import gzip

    with gzip.open(path, "rt") as f:
        evs = json.load(f).get("traceEvents", [])
    out = {k: 0 for k in (*names, *SYNC_CALLS)}
    on_device, issued = set(), []
    for e in evs:
        name, cat = str(e.get("name", "")), e.get("cat")
        if cat == "kernel":
            for k, n in names.items():
                if n in name:
                    out[k] += 1
        elif name in SYNC_CALLS:
            out[name] += 1
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            on_device.add(e.get("args", {}).get("correlation"))
        elif cat == "cuda_runtime" and any(w in name for w in ("Launch", "Memcpy", "Memset")):
            issued.append((float(e.get("ts", 0)), e.get("args", {}).get("correlation")))
    lost_at = [i for i, (_, c) in enumerate(sorted(issued)) if c not in on_device]
    out.update(lost=len(lost_at), issued=len(issued), lost_at=lost_at[:20])
    return out


def health_fit(root: str, extra=()) -> dict:
    """``cli.main`` on the health recipe under ``root``, cuDNN deterministic
    (the caller sets it). Records each step's loss and CUDA event, the
    host clock between steps, the launch counters at each profiler
    window's open and stop, and ``torch.cuda.max_memory_allocated()`` read
    just before each ``memory`` event's poll."""
    import torch

    from bdbnn_tpu_torch import cli
    from bdbnn_tpu_torch.train import loop

    losses, marks, walls, windows, mems = {}, [], [], [], []
    real_fit, real_capture, real_mem = loop.fit, loop.TraceCapture, loop.emit_memory_event
    opened = {}

    def on_step(epoch, step, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        walls.append(time.perf_counter())
        losses[(epoch, step)] = m["loss"].clone()

    class Capture(real_capture):
        def maybe_start(self, epoch, step):
            started = super().maybe_start(epoch, step)
            if started:
                opened.update(read_counts())
            return started

        def _stop(self, fence):
            info = super()._stop(fence)
            now = read_counts()
            windows.append({**info, "launches": {k: now[k] - opened[k] for k in now}})
            return info

    def mem_spy(events, phase, devices, **kw):
        want = torch.cuda.max_memory_allocated(devices[0])
        rec = real_mem(events, phase, devices, **kw)
        mems.append((phase, want, rec["peak_bytes"]))
        return rec

    loop.fit = lambda cfg: real_fit(cfg, on_step=on_step)
    loop.TraceCapture, loop.emit_memory_event = Capture, mem_spy
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(health_cli_args(root, extra))
    finally:
        loop.fit, loop.TraceCapture, loop.emit_memory_event = real_fit, real_capture, real_mem
    torch.cuda.synchronize()
    return {"rc": rc, "run_dir": run_dir_of(root), "losses": losses, "counts": read_counts(),
            "step_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
            "host_ms": [(b - a) * 1e3 for a, b in zip(walls, walls[1:])],
            "windows": windows, "mems": mems, "seconds": time.perf_counter() - t0}


def trace_prefix(n: int, smi_line: str) -> bool:
    """[train-health] (a)'s forced-alert fit 2n times, the profiler window
    opened without (``ABSORB_LAUNCHES`` 0) and with its absorbing burst in
    turns: for each window, the device records its trace lost and each K's
    shortfall against its launch counter. True when no window opened with
    the burst lost a record or a K kernel."""
    import torch

    from bdbnn_tpu_torch.obs import trace as trace_mod

    tag = "[trace-prefix]"
    log(f"{tag} {smi_line}")
    burst = trace_mod.ABSORB_LAUNCHES
    thresholds = [x for t in HEALTH_FORCED for x in ("--health-threshold", t)]
    runs = {0: [], burst: []}
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(n):
            for launches in runs:
                trace_mod.ABSORB_LAUNCHES = launches
                a = health_fit(fresh_log_root(), ["--health-forensics-steps",
                                                  str(HEALTH_FORENSICS_STEPS), *thresholds])
                trace = trace_mod.find_trace_file(a["run_dir"])
                tc = trace_counts(trace) if trace else {"lost": None}
                win = a["windows"][0]["launches"] if len(a["windows"]) == 1 else {}
                short = {k: win.get(k, 0) - tc.get(k, 0) for k in K_TRACE_NAMES
                         if tc.get(k) != win.get(k)}
                runs[launches].append((tc["lost"], short))
                log(f"{tag} run {i} burst {launches}: device records lost {tc['lost']}, "
                    f"K kernels missing {short}")
    finally:
        trace_mod.ABSORB_LAUNCHES = burst
        torch.backends.cudnn.deterministic = prev_det
    for launches, rs in runs.items():
        log(f"{tag} burst {launches}: {sum(1 for lost, _ in rs if lost)} of {len(rs)} windows "
            f"lost device records (counts {[lost for lost, _ in rs]}), "
            f"{sum(1 for _, short in rs if short)} lost a K kernel")
    ok = all(lost == 0 and not short for lost, short in runs[burst])
    log(f"{tag} ok={ok}")
    return ok


def phase_train_health(smi_line: str):
    """[train-health]: the health monitor on the flagship recipe (BASELINE
    config 3, synthetic, -b 256, a drain every step), through the CLI's
    ``fit``, cuDNN deterministic. (a) a forced alert: flip_explosion armed
    past any real flip rate, the other detectors disarmed: exactly one
    alert, one forensics checkpoint whose files verify, one ``profile``
    event of HEALTH_FORENSICS_STEPS steps whose trace holds K1, K2, K5, K6
    and K7 by kernel name as many times as the launch counters say for
    those steps, the ``health`` summary (and the reference's ``summarize
    --strict`` exits nonzero where the JAX package is installed); (b) the
    forensics checkpoint resumed, bitwise (a)'s later losses and final
    state; (c) the ``post_compile`` and ``epoch`` memory events' peak
    bytes equal to ``torch.cuda.max_memory_allocated()`` read at the same
    points; (d) ``--profile-at 0:5:3``: one ``profile`` event over 3
    steps and a trace; (e) the default monitor against ``--no-health``,
    two runs each, in turns: the step times before the window (steps 1-4)
    and the synchronisation calls inside it. Returns ((a)'s launch
    counts, ok, (a)'s run dir)."""

    import torch

    from bdbnn_tpu_torch.obs.events import read_events
    from bdbnn_tpu_torch.obs.trace import find_trace_file
    from bdbnn_tpu_torch.train import loop
    from bdbnn_tpu_torch.utils import checkpoint as ck

    tag = "[train-health]"
    t_phase = time.perf_counter()
    log(f"{tag} {smi_line}")
    oks = {}
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # (a) the forced alert
        thresholds = [x for t in HEALTH_FORCED for x in ("--health-threshold", t)]
        a = health_fit(fresh_log_root(), ["--health-forensics-steps",
                                          str(HEALTH_FORENSICS_STEPS), *thresholds])
        dir_a = a["run_dir"]
        alerts = read_events(dir_a, "alert")
        fcks = [e for e in read_events(dir_a, "checkpoint") if e["reason"] == "forensics"]
        profs = read_events(dir_a, "profile")
        healths = read_events(dir_a, "health")
        trace = find_trace_file(dir_a)
        tc = trace_counts(trace) if trace else {}
        win = a["windows"][0]["launches"] if len(a["windows"]) == 1 else {}
        in_trace = {k: (tc.get(k), win.get(k)) for k in K_TRACE_NAMES}
        verified = len(fcks) == 1 and ck.verify_integrity(fcks[0]["path"]) == "ok"
        oks["a"] = (a["rc"] == 0 and [x["detector"] for x in alerts] == ["flip_explosion"]
                    and verified and len(profs) == 1
                    and profs[0]["steps"] == HEALTH_FORENSICS_STEPS
                    and all(t == w and w and w > 0 for t, w in in_trace.values())
                    and len(healths) == 1 and healths[0]["by_detector"] == {"flip_explosion": 1})
        log(f"{tag} (a) forced alert, cli.main -> {a['rc']} in {a['seconds']:.1f}s: alerts "
            f"{[(x['detector'], x['epoch'], x['step'], x['value'], x['threshold']) for x in alerts]}"
            f"; forensics checkpoints {[(e['detector'], e['epoch'], e['step_in_epoch'], e['seconds']) for e in fcks]}"
            f" files verify {verified}; profile events "
            f"{[(p['epoch'], p['start_step'], p['steps']) for p in profs]}; trace "
            f"{os.path.relpath(trace, dir_a) if trace else None} "
            f"({os.path.getsize(trace) if trace else 0} bytes); each K's kernels in the trace "
            f"against its launch counter over the window's steps {in_trace}; device records "
            f"the trace lost {tc.get('lost')}; health "
            f"{healths[0] if healths else None}; launches {a['counts']}; ok={oks['a']}")
        # the reference's summarize, in a process of its own; skipped where
        # the JAX package's modules are not installed
        r = subprocess.run([sys.executable, "-m", "bdbnn_tpu.cli", "summarize", dir_a,
                            "--strict"], cwd=REPO, capture_output=True, text=True, timeout=300)
        if "ModuleNotFoundError" not in r.stderr:
            oks["a_strict"] = r.returncode != 0 and "run-ending alert" in r.stderr
            log(f"{tag} (a) the reference's summarize --strict -> {r.returncode}: "
                f"{r.stderr.strip().splitlines()[:2]}")
        else:
            err = [x for x in r.stderr.splitlines() if "ModuleNotFoundError" in x][-1]
            log(f"{tag} (a) the reference's summarize --strict: skipped, the JAX package "
                f"does not import on this machine ({err.strip()})")

        # (b) the forensics checkpoint resumed, held to (a)
        b_losses = {}
        root_b = fresh_log_root()
        if fcks:
            loop.fit(train_config(log_path=root_b, resume=fcks[0]["path"], **HEALTH_ARGS),
                     on_step=lambda e, i, m: b_losses.__setitem__((e, i), m["loss"].clone()))
        oks["b"] = bool(fcks) and resumed_like(
            tag, "(b) the forensics checkpoint resumed", b_losses,
            final_payload(run_dir_of(root_b)),
            {"losses": a["losses"], "final": final_payload(dir_a)})

        # (c) the memory events
        oks["c"] = ([m[0] for m in a["mems"]] == ["post_compile", "epoch"]
                    and all(want == got for _, want, got in a["mems"]))
        log(f"{tag} (c) memory events (phase, torch.cuda.max_memory_allocated() just before "
            f"the poll, the event's peak_bytes): {a['mems']}; limit "
            f"{read_events(dir_a, 'memory')[0]['limit_bytes']} bytes; ok={oks['c']}")

        # (d) + (e): the default monitor and --no-health, in turns
        runs = {"on": [], "off": []}
        for which in ("on", "off", "on", "off"):
            extra = ["--profile-at", HEALTH_PROFILE_AT] + (["--no-health"] if which == "off"
                                                            else [])
            runs[which].append(health_fit(fresh_log_root(), extra))
        d = runs["on"][0]
        dprof = read_events(d["run_dir"], "profile")
        dtrace = find_trace_file(d["run_dir"])
        oks["d"] = (d["rc"] == 0 and [(p["epoch"], p["start_step"], p["steps"]) for p in dprof]
                    == [(0, 5, 3)] and dtrace is not None)
        log(f"{tag} (d) --profile-at {HEALTH_PROFILE_AT}: profile events "
            f"{[(p['epoch'], p['start_step'], p['steps']) for p in dprof]}, trace "
            f"{os.path.relpath(dtrace, d['run_dir']) if dtrace else None}; ok={oks['d']}")
        stats = {}
        for which, rs in runs.items():
            host = [sum(r["host_ms"][1:5]) / 4 for r in rs]
            dev = [sum(r["step_ms"][1:5]) / 4 for r in rs]
            syncs = [{c: trace_counts(find_trace_file(r["run_dir"]))[c] for c in SYNC_CALLS}
                     for r in rs]
            stats[which] = {"host_ms": host, "event_ms": dev, "syncs": syncs,
                            "alerts": [len(read_events(r["run_dir"], "alert")) for r in rs],
                            "health": [len(read_events(r["run_dir"], "health")) for r in rs],
                            "rc": [r["rc"] for r in rs]}
        on, off = stats["on"], stats["off"]
        oks["e"] = (on["rc"] == off["rc"] == [0, 0] and on["syncs"] == off["syncs"]
                    and on["alerts"] == [0, 0] and on["health"] == [1, 1]
                    and off["health"] == [0, 0])
        spread = lambda xs: f"{min(xs):.3f}-{max(xs):.3f}"
        log(f"{tag} (e) the flagship's fit step, steps 1-4 of {HEALTH_STEPS} (mean a run), "
            f"two runs each in turns on off on off: default monitor host ms "
            f"{[round(x, 3) for x in on['host_ms']]} (spread {spread(on['host_ms'])}), CUDA "
            f"events ms {[round(x, 3) for x in on['event_ms']]}; --no-health host ms "
            f"{[round(x, 3) for x in off['host_ms']]} (spread {spread(off['host_ms'])}), CUDA "
            f"events ms {[round(x, 3) for x in off['event_ms']]}; synchronisation calls in the "
            f"window (steps 5-7, its closing fence included) on {on['syncs']} off "
            f"{off['syncs']}; alerts {on['alerts']}; ok={oks['e']}")
    finally:
        torch.backends.cudnn.deterministic = prev_det
    torch.cuda.empty_cache()
    ok = all(oks.values())
    log(f"{tag} gates {oks} in {time.perf_counter() - t_phase:.1f}s: ok={ok}")
    return a["counts"], ok, dir_a


def sr_phase_stats(run_dir: str, verdict: dict) -> dict:
    """p99 and shed rate of the requests that arrived before, during and
    after the swap (between its ``swap`` ``start`` and ``done`` events), on
    the server's clock: each completed request's arrival is its ``rtrace``
    ``request`` event's time less its total; the sheds during it are the
    verdict's ``swap`` block's, those before it the ``http`` ``stats``
    events' cumulative count at the last tick before it (once a second),
    the rest after it."""
    from bdbnn_tpu_torch.obs.events import read_events
    from bdbnn_tpu_torch.serve.engine import _pct

    swaps = {e["phase"]: e["t"] for e in read_events(run_dir, "swap")}
    t0, t1 = swaps.get("start"), swaps.get("done", swaps.get("failed"))
    if t0 is None or t1 is None:
        return {}
    lat = {"before": [], "during": [], "after": []}
    for e in read_events(run_dir, "rtrace"):
        if e.get("phase") == "request":
            arr = e["t"] - e["total_ms"] / 1e3
            lat["before" if arr < t0 else "during" if arr <= t1 else "after"].append(e["total_ms"])
    before = max([sum(e["shed_by_priority"]) for e in read_events(run_dir, "http")
                  if e.get("phase") == "stats" and e["t"] <= t0], default=0)
    during = verdict["swap"]["shed"] or 0
    shed = {"before": before, "during": during,
            "after": max(verdict["requests_shed"] - before - during, 0)}
    return {k: {"completed": len(v), "p99_ms": _pct(sorted(v), 99.0), "shed": shed[k],
                "shed_rate": round(shed[k] / max(len(v) + shed[k], 1), 4)}
            for k, v in lat.items()} | {"swap_s": round(t1 - t0, 3)}


def phase_serve_rollout(art: str, smi_line: str):
    """[serve-rollout]: blue/green swaps of the flagship on one card, v1 and
    v2 (seeds 0 and 1) published in a registry, ``--packed-weights``,
    ``--replicas 1``. (a) a swap under load: ``serve-http`` bench mode,
    poisson at 100 req/s, 512 requests, ``--swap-to v0002 --swap-at 0.5``:
    zero client drops, the ledger identity, 8 lone probes from another
    process before the swap within tolerance of v1's engine and 8 after it
    of v2's (and not of v1's), p99 and shed rate before, during and after
    the swap, launches 19 × the forwards; the card's peak memory while two
    models are resident, from an in-process pool swapped the same way; (b)
    an operator swap on a serving server: ``POST /admin/swap {"version":
    2}``, polled through ``GET /admin/swap`` to ``done``; (c) before it, on
    the same server, a standby that fails to load (a truncated weights
    file): the swap ``failed`` and v1 still answering; (d) the canary, only
    with two cards. Returns (launch counts over the runs, ok)."""
    import shutil

    import numpy as np
    import torch

    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.pool import ReplicaPool, make_engine_runner_factory
    from bdbnn_tpu_torch.serve.registry import ArtifactRegistry

    tag = "[serve-rollout]"
    t_phase = time.perf_counter()
    log(f"{tag} {smi_line}")
    oks = {}
    total = {k: 0 for k in SB_COUNTED}

    def add(counts):
        for k in SB_COUNTED:
            total[k] += counts.get(k, 0)

    with tempfile.TemporaryDirectory() as root:
        second = os.path.join(root, "resnet18_react_seed1")
        make_flagship_artifact(second, seed=1)
        reg = os.path.join(root, "registry")
        registry = ArtifactRegistry(reg)
        for p in (art, second):
            registry.publish(p)
        alone = {}
        reset_counts()
        for v, path in (("v0001", art), ("v0002", second)):
            e = InferenceEngine(path, buckets=SH_BUCKETS, device="cuda", packed=True)
            size = e.image_size
            tern = np.random.default_rng(23).integers(-1, 2, size=(8, size, size, 3)).astype(
                np.float32)
            alone[v] = np.concatenate([e.predict_logits(tern[i:i + 1]) for i in range(8)])
            del e

        def probe(host, port):
            return [sh_predict(host, port, tern[i])[:3] for i in range(8)]

        def held(answers, version) -> bool:
            """Each answer within the wire tolerance of ``version``'s engine
            on its image, and outside it of the other's."""
            other = "v0002" if version == "v0001" else "v0001"
            got = np.array([b["result"]["logits"] for s, _, b in answers if s == 200], np.float64)
            if len(got) != len(answers):
                return False
            tol = SH_WIRE_ATOL + CPU_LOGIT_TOL * float(np.max(np.abs(alone[version])))
            return bool(np.max(np.abs(got - alone[version])) <= tol
                        and np.all(np.max(np.abs(got - alone[other]), axis=1) > tol))

        def wait_ready(host, port):
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                if sh_request(host, port, "GET", "/readyz")[0] == 200:
                    return True
                time.sleep(0.01)
            return False

        def wait_swap(host, port, timeout=120):
            deadline = time.monotonic() + timeout
            body = None
            while time.monotonic() < deadline:
                body = sh_request(host, port, "GET", "/admin/swap")[2]
                if body["last"] is not None:
                    return body
                time.sleep(0.02)
            return body

        # (a) the swap under load
        def client_a(host, port):
            wait_ready(host, port)
            before = probe(host, port)
            status = wait_swap(host, port)
            return {"before": before, "after": probe(host, port), "swap": status}

        run = sh_cli(root, "v0001", ["--registry", reg, "--packed-weights", "--replicas", "1",
                                     "--swap-to", "v0002", "--swap-at", "0.5", "--scenario",
                                     "poisson", "--rate", "100", "--requests", "512",
                                     "--concurrency", "16", "--default-quota", SH_QUOTA,
                                     "--rtrace-sample-every", "1"], client=client_a)
        add(run["counts"])
        v, c = run["verdict"], run["client"]
        if v is None or c is None:
            oks["a"] = False
            log(f"{tag} (a) FAIL: exit {run['rc']}\n{run['err']}")
        else:
            sw = v["swap"]
            phases = sr_phase_stats(run["run_dir"], v)
            oks["a"] = (run["rc"] == 0 and v["client"]["dropped"] == 0 and sh_accounted(v)
                        and v["client"]["submitted"] == 512 and sw["performed"]
                        and sw["version_to"] == "v0002"
                        and sum(sw["answered_by"].values()) == v["requests_completed"]
                        and held(c["before"], "v0001") and held(c["after"], "v0002")
                        and sh_launch_gate("(a)", run, "unpack"))
            log(f"{tag} (a) swap under load (poisson 100 req/s, 512 requests, swap at 0.5, "
                f"one replica): swap block {sw}; by phase (server clock, arrival) {phases}; "
                f"probes before the swap held to v1 {held(c['before'], 'v0001')}, after it to v2 "
                f"{held(c['after'], 'v0002')}; {sb_line(v)}; per priority p99 "
                f"{ {p: b['p99_ms'] for p, b in v['per_priority'].items()} } "
                f"({run['seconds']:.1f}s) ok={oks['a']}")
        # the card's memory while the standby joins: an in-process pool of
        # the same factory, swapped the same way
        counts0 = read_counts()
        factory = make_engine_runner_factory(SH_BUCKETS, packed=True)
        pool = ReplicaPool(factory, [torch.device("cuda")], artifact_ref=art, version="v0001")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        status = pool.swap(second, "v0002")
        torch.cuda.synchronize()
        peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        out = pool.submit([tern[0]]).result(60)
        pool_ok = (status["state"] == "done" and pool.drain(30)
                   and bool(np.max(np.abs(np.asarray(out[0], np.float64) - alone["v0002"][0]))
                            <= SH_WIRE_ATOL + CPU_LOGIT_TOL * float(np.max(np.abs(alone["v0002"])))))
        now = read_counts()
        add({k: now[k] - counts0[k] for k in now})
        oks["a_memory"] = pool_ok and peak > base
        log(f"{tag} (a) in-process pool swap v0001 -> v0002 on cuda:0: allocated before "
            f"{base} bytes, peak while both are resident {peak} (+{peak - base}, "
            f"{(peak - base) / 2**20:.2f} MiB), after {after}; swap {status['state']} in "
            f"{status.get('seconds')} s; forwards {factory.forwards()}; ok={oks['a_memory']}")
        del pool, factory

        # (c) then (b) on one serving server
        corrupt = os.path.join(root, "corrupt")
        shutil.copytree(second, corrupt)
        wpath = os.path.join(corrupt, "weights.npz")
        with open(wpath, "r+b") as f:
            f.truncate(os.path.getsize(wpath) // 2)

        def client_bc(host, port):
            wait_ready(host, port)
            got = {"bad": sh_request(host, port, "POST", "/admin/swap",
                                     json.dumps({"artifact": corrupt}).encode())}
            got["bad_status"] = wait_swap(host, port)
            got["v1"] = probe(host, port)
            t0 = time.perf_counter()
            got["post"] = sh_request(host, port, "POST", "/admin/swap", b'{"version": 2}')
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                body = sh_request(host, port, "GET", "/admin/swap")[2]
                if (body["last"] or {}).get("version_to") == "v0002":
                    break
                time.sleep(0.02)
            got["swap_s"] = time.perf_counter() - t0
            got["status"] = body
            got["v2"] = probe(host, port)
            return got

        bc = sh_cli(root, "v0001", ["--registry", reg, "--packed-weights", "--replicas", "1",
                                    "--default-quota", SH_QUOTA], client=client_bc)
        add(bc["counts"])
        vb, cb = bc["verdict"], bc["client"]
        if vb is None or cb is None:
            oks["b"] = oks["c"] = False
            log(f"{tag} (b)/(c) FAIL: exit {bc['rc']}\n{bc['err']}")
        else:
            bad = cb["bad_status"]["last"]
            oks["c"] = (cb["bad"][0] == 202 and bad["state"] == "failed"
                        and held(cb["v1"], "v0001"))
            log(f"{tag} (c) a standby that fails to load (weights.npz truncated): POST -> "
                f"{cb['bad'][0]}, the swap {bad['state']} ({bad.get('error')}), v1 still "
                f"answering, held to its engine {held(cb['v1'], 'v0001')}; ok={oks['c']}")
            st = cb["status"]
            oks["b"] = (bc["rc"] == 0 and cb["post"][0] == 202
                        and st["current"]["state"] == st["last"]["state"] == "done"
                        and held(cb["v2"], "v0002") and vb["swap"]["performed"]
                        and vb["requests_completed"] == vb["requests_submitted"] == 16
                        and vb["requests_failed"] == 0 and vb["drained_clean"]
                        and sh_launch_gate("(b)", bc, "unpack"))
            log(f"{tag} (b) operator swap: POST /admin/swap {{\"version\": 2}} -> "
                f"{cb['post'][0]} {cb['post'][2]}; GET /admin/swap polled to "
                f"{st['last']['state']} in {cb['swap_s']:.3f} s (the pool's {st['last'].get('seconds')} s,"
                f" shed {st['last'].get('shed')}), the pool's current state "
                f"{st['current'].get('state')}; answers after held to v2 "
                f"{held(cb['v2'], 'v0002')}; verdict swap block {vb['swap']}; exit {bc['rc']}, "
                f"submitted {vb['requests_submitted']} completed {vb['requests_completed']} "
                f"failed {vb['requests_failed']} drained_clean {vb['drained_clean']} "
                f"({bc['seconds']:.1f}s) ok={oks['b']}")

        # (d) the canary needs two replicas, one card each
        n = torch.cuda.device_count()
        if n < 2:
            log(f"{tag} (d) canary: not run — it needs --replicas >= 2 and one card a "
                f"replica, and this machine has {n} card")
        else:
            d = sh_cli(root, "v0001", ["--registry", reg, "--packed-weights", "--replicas", "2",
                                       "--swap-to", "v0002", "--swap-at", "0.5", "--scenario",
                                       "poisson", "--rate", "100", "--requests", "512",
                                       "--default-quota", SH_QUOTA, "--canary-fraction", "0.3",
                                       "--canary-replicas", "1", "--shadow-every", "2",
                                       "--canary-threshold", "min_samples=8",
                                       "--canary-threshold", "healthy_evals=2",
                                       "--canary-threshold", "eval_interval_s=0.2"])
            add(d["counts"])
            vd = d["verdict"]
            oks["d"] = (vd is not None and vd["client"]["dropped"] == 0
                        and (vd.get("canary") or {}).get("decision") in ("promote", "rollback"))
            log(f"{tag} (d) canary on {n} cards: exit {d['rc']}, canary block "
                f"{(vd or {}).get('canary')}; ok={oks['d']}")
    ok = all(oks.values())
    log(f"{tag} gates {oks}; launches over the runs {total}; "
        f"{time.perf_counter() - t_phase:.1f}s: ok={ok}")
    return total, ok


# [serve-fleet]: the fleet router in front of serve-http hosts on one card
SF_RATE = 100.0
SF_REQUESTS = 512
SF_PROBE_S = 0.1
# the busy windows a host's counted CLI keeps: SIGUSR1 opens a
# torch.profiler window over the card's kernels, SIGUSR2 closes it
BUSY_SUFFIX = ".busy"


class BusyWindows:
    """Profiler windows that a parent opens and closes by signal. SIGUSR1
    starts a ``torch.profiler`` session over the card's kernels (the CUDA
    activity only: no host-op records, so the server's Python runs as
    without it) and then writes the count of windows opened so far into
    ``<path>.open``; SIGUSR2 ends it, keeps (kernel ms, wall ms) and writes
    the count of windows closed into ``<path>.closed``. Starting or ending
    a session can take seconds in a busy process, so the parent waits for
    each count before it goes on (:func:`sf_open_windows`,
    :func:`sf_close_windows`). A handler runs on the main thread between
    two of its bytecodes: no exception escapes into the server."""

    def __init__(self, path: str):
        import signal

        self.path = path
        self.windows = []
        self.opened = 0
        self._prof = None
        signal.signal(signal.SIGUSR1, self._open)
        signal.signal(signal.SIGUSR2, self._close)

    def _mark(self, suffix: str, n: int) -> None:
        with open(self.path + suffix, "w") as f:
            f.write(str(n))

    def _open(self, *_):
        if self._prof is None:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                if torch.cuda.is_available():
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                    self._t0 = time.perf_counter()
                    self._prof = prof
            except Exception as e:
                print(f"BusyWindows: the profiler did not start: {e!r}", file=sys.stderr)
        self.opened += 1
        self._mark(".open", self.opened)

    def _close(self, *_):
        prof, self._prof = self._prof, None
        window = [0.0, 0.0]
        if prof is not None:
            try:
                import torch

                torch.cuda.synchronize()
                wall = (time.perf_counter() - self._t0) * 1e3
                prof.__exit__(None, None, None)
                busy = sum(ev.self_device_time_total for ev in prof.key_averages()
                           if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                window = [busy, wall]
            except Exception as e:
                print(f"BusyWindows: the window did not close: {e!r}", file=sys.stderr)
        self.windows.append(window)
        self._mark(".closed", len(self.windows))


def _wait_marks(hosts: list, suffix: str, want: dict, timeout: float) -> float:
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        done = 0
        for h in hosts:
            try:
                with open(h["counts_file"] + BUSY_SUFFIX + suffix) as f:
                    done += int(f.read() or 0) >= want[h["name"]]
            except (OSError, ValueError):
                pass
        if done == len(hosts):
            break
        time.sleep(0.02)
    return time.perf_counter() - t0


def sf_open_windows(hosts: list, label: str, timeout: float = 120.0) -> float:
    """SIGUSR1 to each host, then wait until each has started its profiler
    session (:class:`BusyWindows`); returns the seconds that took. Each
    host notes the window's label."""
    import signal

    for h in hosts:
        h["windows"].append([label, None])
        h["proc"].send_signal(signal.SIGUSR1)
    return _wait_marks(hosts, ".open", {h["name"]: len(h["windows"]) for h in hosts}, timeout)


def sf_close_windows(hosts: list, load_wall_s, timeout: float = 120.0) -> float:
    """SIGUSR2 to each host, then wait until each has ended its session;
    ``load_wall_s`` (the load's own wall, the share's denominator: an idle
    host launches no kernel) is noted beside its label."""
    import signal

    for h in hosts:
        h["windows"][-1][1] = load_wall_s
        h["proc"].send_signal(signal.SIGUSR2)
    return _wait_marks(hosts, ".closed", {h["name"]: len(h["windows"]) for h in hosts}, timeout)


def sf_host(root: str, name: str, registry: str, art: str = "") -> dict:
    """One fleet host: ``serve-http v0001 --registry REG --replicas 1
    --packed-weights`` (or, with ``art``, ``serve-http ART --packed-weights``:
    one engine, no pool) through :func:`counted_cli` on port 0, in serve
    mode on the card (no ``--device``: no fallback)."""
    log_path = os.path.join(root, name)
    os.makedirs(log_path)
    counts = os.path.join(log_path, "counts.json")
    served = [art] if art else ["v0001", "--registry", registry, "--replicas", "1"]
    cmd = [sys.executable, "-c", COUNTED_CLI, "serve-http", *served, "--packed-weights",
           "--port", "0", "--log-path", log_path, "--buckets", *map(str, SH_BUCKETS),
           "--default-quota", SH_QUOTA, "--server-id", name]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, COUNTS_ENV: counts})
    return {"name": name, "proc": proc, "log_path": log_path, "counts_file": counts,
            "port": None, "windows": []}


def sf_wait_host(h: dict, timeout: float = 300.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and h["proc"].poll() is None:
        start, _ = _http_events(h["log_path"], "start")
        if start is not None and _http_events(h["log_path"], "ready")[0] is not None:
            h["port"] = start["port"]
            return True
        time.sleep(0.02)
    return False


def sf_reap(h: dict, signalled: bool = False) -> dict:
    """Stop a host (SIGCONT, as a stopped process would act on nothing,
    then SIGTERM, unless it has had its SIGTERM already: a second one
    during its exit would meet the default handler) and read what it
    left: exit code, its verdict, the ``http`` ``stop`` event's forwards,
    its launch counts (written at a clean exit only; None when it wrote
    none) and profiler windows."""
    import signal

    p = h["proc"]
    if p.poll() is None and not signalled:
        p.send_signal(signal.SIGCONT)
        p.send_signal(signal.SIGTERM)
    try:
        out, err = p.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
    res = {"rc": p.returncode, "err": err[-3000:], "err_all": err, "verdict": None,
           "forwards": None, "counts": None, "busy": []}
    if p.returncode == 0:
        res["verdict"] = json.loads(out)
    stop, res["run_dir"] = _http_events(h["log_path"], "stop")
    if stop is not None:
        res["forwards"] = stop["forwards"]
    if os.path.exists(h["counts_file"]):
        with open(h["counts_file"]) as f:
            res["counts"] = json.load(f)
    if os.path.exists(h["counts_file"] + BUSY_SUFFIX):
        with open(h["counts_file"] + BUSY_SUFFIX) as f:
            res["busy"] = json.load(f)
    return res


def _fleet_events(log_path: str, kind: str = "fleet"):
    import glob

    from bdbnn_tpu_torch.obs.events import read_events

    out = []
    for ev in glob.glob(os.path.join(log_path, "*", "events.jsonl")):
        out += read_events(os.path.dirname(ev), kind)
    return out


def sf_router(root: str, art: str, hosts: list, args: list, on_ready=None, on_proxied=None,
              client=None):
    """``serve-fleet ART --hosts ... args`` as a subprocess (the router,
    with its scenario's load generator in its own process). ``on_ready()``
    runs once its ``fleet`` ``ready`` event lands, ``on_proxied(n)`` on
    each new ``fleet`` ``stats`` event with the requests proxied so far.
    With ``client`` (serve mode: no ``--scenario`` in ``args``),
    ``client(host, port)`` runs here once the router is ready, its result
    is kept, and the router gets SIGTERM after it. Returns rc, verdict
    (printed on exit 0 and 1), run dir, client, stderr tail, seconds."""
    log_path = tempfile.mkdtemp(dir=root)
    cmd = [sys.executable, "-m", "bdbnn_tpu_torch.cli", "serve-fleet", art, "--hosts",
           *(f"127.0.0.1:{h['port']}" for h in hosts), "--log-path", log_path,
           "--probe-interval-s", str(SF_PROBE_S), "--stats-interval-s", "0.2", *args]
    t0, t_spawn = time.perf_counter(), time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    if client is not None:
        import signal

        def on_ready(run=client):
            start = [e for e in _fleet_events(log_path) if e.get("phase") == "start"][0]
            got["client"] = run(start["host"], start["port"])
            proc.send_signal(signal.SIGTERM)

    got = {"client": None}
    ready, seen = on_ready is None, 0
    try:
        deadline = time.monotonic() + 600
        # the run dir's events are read only while a hook waits on them
        while (proc.poll() is None and time.monotonic() < deadline
               and not (ready and on_proxied is None)):
            ev = _fleet_events(log_path)
            if not ready and any(e.get("phase") == "ready" for e in ev):
                ready = True
                on_ready()
            stats = [e for e in ev if e.get("phase") == "stats"]
            if on_proxied is not None and len(stats) > seen:
                seen = len(stats)
                on_proxied(sum(r["proxied"] for r in stats[-1]["hosts"].values()))
            time.sleep(0.02)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            out, err = proc.communicate()
    import glob

    dirs = [os.path.dirname(p) for p in glob.glob(os.path.join(log_path, "*", "events.jsonl"))]
    # where the router process's wall went, on its own event clock
    at = {e["phase"]: e["t"] for e in _fleet_events(log_path)
          if e.get("phase") in ("start", "ready", "drain", "stop")}
    if len(at) == 4:
        log(f"[serve-fleet] router process: started {at['start'] - t_spawn:.2f}s after its "
            f"spawn, ready {at['ready'] - at['start']:.2f}s later, load {at['drain'] - at['ready']:.2f}s, "
            f"drain to stop {at['stop'] - at['drain']:.2f}s, exited {time.time() - at['stop']:.2f}s "
            "after its stop event")
    verdict = None
    if proc.returncode in (0, 1, 3) and out.strip().startswith("{"):
        verdict = json.loads(out)
    return {"rc": proc.returncode, "verdict": verdict, "run_dir": dirs[0] if dirs else None,
            "client": got["client"], "err": err[-3000:], "seconds": time.perf_counter() - t0}


def sf_consistent(v: dict, client: dict) -> bool:
    """The fleet block's ledger rule, applied to a client the router did
    not see (one in another process): per status, the hosts' relayed
    answers and the router's own sheds sum to what the client got."""
    f = v["fleet"]
    hs = f["hosts"].values()
    want = {"200": sum(h["completed"] for h in hs), "429": sum(h["relayed_429"] for h in hs),
            "503": sum(h["relayed_503"] for h in hs) + f["router_unrouteable"]
            + f["router_shed_draining"], "other": sum(h["relayed_other"] for h in hs)}
    got = {"other": 0}
    for k, n in client["by_status"].items():
        key = k if k in ("200", "429", "503") else "other"
        got[key] = got.get(key, 0) + n
    return {k: n for k, n in want.items() if n} == {k: n for k, n in got.items() if n}


def sf_raw(host: str, port: int, body: bytes, timeout: float = 60.0):
    """One raw-float32 predict on a fresh connection: (status, headers,
    body bytes)."""
    import socket

    from bdbnn_tpu_torch.serve.loadgen import recv_response

    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall((f"POST /v1/predict HTTP/1.1\r\nhost: {host}\r\nx-priority: 0\r\n"
                   "x-tenant: tenant-a\r\ncontent-type: application/octet-stream\r\n"
                   f"content-length: {len(body)}\r\nconnection: close\r\n\r\n").encode() + body)
        return recv_response(s.makefile("rb"))


def sf_line(v: dict) -> str:
    f = v["fleet"]
    hosts = {k: {x: h[x] for x in ("state", "proxied", "completed", "relayed_429",
                                   "relayed_503", "retries", "p99_ms")}
             for k, h in f["hosts"].items()}
    # a client in another process than the router: its ledger is held here
    dropped, consistent = f["dropped"], f["ledger_consistent"]
    if dropped is None:
        dropped, consistent = v["client"]["dropped"], sf_consistent(v, v["client"])
    return (f"client {v['client']['by_status']} dropped {dropped} ledger_consistent "
            f"{consistent}; {v['throughput_rps']} req/s, p50/p99 {v['p50_ms']}/"
            f"{v['p99_ms']} ms, shed {v['requests_shed']}; retries {f['retries_total']} "
            f"(rate {f['retry_rate']}); hosts {json.dumps(hosts)}")


def sf_held(answers, alone) -> bool:
    """Every answer, a (status, parsed body), is a 200 whose logits lie
    within the wire tolerance of ``alone`` (one engine's logits, an image
    each): the versions' engines differ far beyond it, so this names the
    version that answered."""
    import numpy as np

    got = np.array([b["result"]["logits"] for s, b in answers if s == 200], np.float64)
    if len(got) != len(answers):
        return False
    tol = SH_WIRE_ATOL + CPU_LOGIT_TOL * float(np.max(np.abs(alone)))
    return bool(np.max(np.abs(got - alone)) <= tol)


def phase_serve_fleet(art: str, smi_line: str, keep: str = ""):
    """[serve-fleet]: ``serve-fleet`` (the router as the CLI subprocess it
    is for users, its scenario's load generator in its own process) in
    front of port ``serve-http`` hosts, each a CLI subprocess on the one
    card with its own CUDA context (``--registry`` of its own,
    ``--replicas 1``, ``--packed-weights``, buckets 1 8 32, the flagship v1
    and v2 of seeds 0 and 1). (a) poisson at 100 req/s, 512 requests over
    h0 and h1: nothing dropped, a consistent ledger; 16 lone raw requests
    through an in-process ``FleetRouter`` byte-for-byte (but for
    ``latency_ms``) the answering host's own answer to the same body, and
    within the serve-http tolerance of an engine in the hosts' mode. (b)
    4,000 req/s offered, 512 requests, 16 connections, through the router
    over h0 and h1 (the client in the router's process, then in this one)
    and over h0 alone, then the same schedule from this process to h0 (its
    peers idle) and to h3 (one engine without a pool, the others stopped); each host's device busy share in
    each run (a torch.profiler window in the host, CUDA activity only,
    opened before the load: kernel ms over the load's wall). (e) a torn v2 in h0's registry: the fleet swap ``failed``, v1
    answering on both hosts; then v1 -> v2 under load at 100 req/s, swap
    at 0.5: pulled digest-verified, host by host to ``done``, v2 answering
    on both, each host's shed and p99 before / during / after. (d) SIGSTOP
    h1 mid-run (0.75 s proxy timeout): timeouts retried on h0, h1's window
    stale, the hop in ``fleet_attribution``; SIGCONT. (c) a flash crowd
    with SIGTERM to h1 half way: nothing dropped, h1 drains what it took
    and exits 0, the router sees it ``draining`` first. (d) SIGKILL a fresh
    host h2 mid-load over h0 and h2: connect/reset retries land on h0,
    nothing dropped, ``dead`` only after the debounce. Each host that
    exits cleanly: launches 19 × its forwards; the SIGKILLed one's are
    unknown. Returns (launch counts summed over the clean hosts, ok)."""
    import re
    import shutil
    import signal

    import numpy as np

    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.fleet import RETRY_CAUSES, FleetRouter
    from bdbnn_tpu_torch.serve.registry import ArtifactRegistry

    tag = "[serve-fleet]"
    t_phase = time.perf_counter()
    log(f"{tag} {smi_line}")
    oks = {}
    total = {k: 0 for k in SB_COUNTED}
    summary = {"device": smi_line}

    def keep_verdict(name, v):
        if keep and v is not None:
            os.makedirs(keep, exist_ok=True)
            with open(os.path.join(keep, f"{name}.json"), "w") as f:
                json.dump(v, f)

    with tempfile.TemporaryDirectory() as root:
        second = os.path.join(root, "resnet18_react_seed1")
        make_flagship_artifact(second, seed=1)
        primary = os.path.join(root, "primary")
        reg = ArtifactRegistry(primary)
        for p in (art, second):
            reg.publish(p)
        regs = [os.path.join(root, f"reg{i}") for i in range(3)]
        for r in regs:
            ArtifactRegistry(r).pull(primary, 1)
        hosts = [sf_host(root, f"h{i}", regs[i]) for i in range(3)]
        hosts.append(sf_host(root, "h3", "", art))
        # the yardsticks in the hosts' mode, while the hosts warm up
        alone = {}
        for v, path in (("v1", art), ("v2", second)):
            e = InferenceEngine(path, buckets=SH_BUCKETS, device="cuda", packed=True)
            size = e.image_size
            images = np.random.default_rng(31).integers(-1, 2, size=(16, size, size, 3)).astype(
                np.float32)
            alone[v] = np.concatenate([e.predict_logits(images[i:i + 1]) for i in range(16)])
            del e
        bodies = [x.astype("<f4").tobytes() for x in images]
        t0 = time.perf_counter()
        up = [sf_wait_host(h) for h in hosts]
        log(f"{tag} four hosts up on port 0 in {time.perf_counter() - t0:.1f}s after the "
            f"yardsticks: {[(h['name'], h['port']) for h in hosts]}")
        h0, h1, h2, h3 = hosts
        reaped = {}
        try:
            if not all(up):
                oks["hosts"] = False
                for h in hosts:
                    reaped[h["name"]] = sf_reap(h)
                log(f"{tag} FAIL: a host never got ready: "
                    f"{ {k: (r['rc'], r['err'][-800:]) for k, r in reaped.items()} }")
                return total, False

            # a process's first profiler session is the slowest to start
            warm = sf_open_windows(hosts, "warm")
            log(f"{tag} warm profiler windows on the four hosts opened in {warm:.2f}s and "
                f"closed in {sf_close_windows(hosts, None):.2f}s")

            def probe(h, v):
                got = [sh_request("127.0.0.1", h["port"], "POST", "/v1/predict", bodies[i],
                                  {"content-type": "application/octet-stream"})
                       for i in range(8)]
                return sf_held([(s, b) for s, _, b in got], alone[v][:8])

            # (a) lone requests through an in-process router, then the
            # scenario through the CLI
            router = FleetRouter([("127.0.0.1", h0["port"]), ("127.0.0.1", h1["port"])],
                                 probe_interval_s=SF_PROBE_S)
            router.start()
            same, answers, served = 0, [], {}
            try:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline and not all(
                        x.state == "ready" and x.server_id for x in router.hosts):
                    time.sleep(0.01)
                for i in range(16):
                    s, hd, raw = sf_raw("127.0.0.1", router.port, bodies[i])
                    who = hd.get("x-served-by")
                    served[who] = served.get(who, 0) + 1
                    direct = {"h0": h0, "h1": h1}[who]
                    s2, _, raw2 = sf_raw("127.0.0.1", direct["port"], bodies[i])
                    strip = lambda b: re.sub(rb'"latency_ms": [0-9.eE+-]+', b"", b)
                    same += int(s == s2 == 200 and strip(raw) == strip(raw2))
                    answers.append((s, json.loads(raw)))
            finally:
                router.drain(10)
            wire = sh_wire_check(answers, alone["v1"], "(a) through the router")
            a = sf_router(root, art, [h0, h1], ["--scenario", "poisson", "--rate", str(SF_RATE),
                                                "--requests", str(SF_REQUESTS)])
            va = a["verdict"]
            keep_verdict("a_poisson", va)
            oks["a"] = (a["rc"] == 0 and va is not None and va["fleet"]["dropped"] == 0
                        and va["fleet"]["ledger_consistent"] is True
                        and va["client"]["responses"] == SF_REQUESTS
                        and va["requests_failed"] == 0 and same == 16 and wire["ok"]
                        and len(served) == 2)
            log(f"{tag} (a) 16 lone raw requests through an in-process router "
                f"(served by {served}): {same} of 16 byte-for-byte the host's own answer "
                f"but for latency_ms; poisson {SF_RATE} req/s, {SF_REQUESTS} requests, the "
                f"client in the router's process: exit {a['rc']}; "
                + (sf_line(va) if va else a["err"]) + f" ({a['seconds']:.1f}s) ok={oks['a']}")
            if va:
                summary["a"] = {"throughput_rps": va["throughput_rps"], "p99_ms": va["p99_ms"],
                                "hosts": {k: h["completed"] for k, h in va["fleet"]["hosts"].items()},
                                "attribution_retry_hop_share":
                                    (va["fleet_attribution"] or {}).get("retry_hop_share")}

            # (b) saturation: the same schedule through the router over h0
            # and h1 with the client in the router's process (its scenario)
            # and in this one (the router in serve mode), through the
            # router over h0 alone, and from this process to h0 with its
            # peers idle and to h3 (one engine, no registry: the path
            # [serve-http] measures) with the others stopped. Each host's busy
            # share in a profiler window of its own, opened before the load:
            # kernel ms over the load's wall
            from bdbnn_tpu_torch.serve.loadgen import HttpLoadGenerator, build_schedule

            sched = build_schedule("poisson", requests=SH_SAT_REQUESTS, rate=SH_SAT_RATE, seed=0)
            rates = {}

            def rps(c):
                return round(c["responses"] / max(c["wall_s"], 1e-9), 3)

            def load(host, port):
                return HttpLoadGenerator(host, port, sched, body_fn=lambda i: bodies[i % 16],
                                         concurrency=16).run()

            def via_router(label, hs, here):
                open_s = sf_open_windows(hs, label)
                if here:
                    run = sf_router(root, art, hs, [], client=load)
                else:
                    run = sf_router(root, art, hs, [
                        "--scenario", "poisson", "--rate", str(SH_SAT_RATE), "--requests",
                        str(SH_SAT_REQUESTS), "--concurrency", "16"])
                v, c = run["verdict"], run["client"] or (run["verdict"] or {}).get("client")
                sf_close_windows(hs, c["wall_s"] if c else None)
                rates[label] = rps(c) if c else None
                where = "this process" if here else "the router's process"
                log(f"{tag} (b) {label}: {rates[label]} req/s, client in {where} (profiler "
                    f"windows opened in {open_s:.2f}s); exit {run['rc']}; "
                    + (sf_line({**v, "client": c}) if v and c else run["err"])
                    + f" ({run['seconds']:.1f}s)")
                return run, v, c

            def direct(label, h, stop=()):
                for x in stop:
                    x["proc"].send_signal(signal.SIGSTOP)
                try:
                    open_s = sf_open_windows([h], label)
                    raw = load("127.0.0.1", h["port"])
                    sf_close_windows([h], raw["wall_s"])
                finally:
                    for x in stop:
                        x["proc"].send_signal(signal.SIGCONT)
                rates[label] = rps(raw)
                log(f"{tag} (b) {label}: {rates[label]} req/s, client in this process "
                    f"(profiler window opened in {open_s:.2f}s); {raw['by_status']}, dropped "
                    f"{raw['dropped']}, p99 by priority {raw['p99_ms_by_priority']}")
                return raw

            routed = [via_router("fleet h0+h1", [h0, h1], False),
                      via_router("fleet h0+h1, client here", [h0, h1], True),
                      via_router("fleet h0 only, client here", [h0], True)]
            keep_verdict("b_saturation", routed[0][1])
            raws = [direct("h0 alone, peers idle", h0),
                    direct("h3 alone (one engine), peers stopped", h3, [h0, h1, h2])]
            oks["b"] = (all(r[0]["rc"] == 0 and r[1] is not None and r[2] is not None
                            and r[2]["dropped"] == 0 and sf_consistent(r[1], r[2])
                            for r in routed)
                        and all(raw["dropped"] == 0 for raw in raws))
            log(f"{tag} (b) saturation, poisson {SH_SAT_RATE} req/s offered, "
                f"{SH_SAT_REQUESTS} requests, 16 connections: req/s {rates}; ok={oks['b']}")
            summary["b"] = rates

            # (e) the fleet swap: a torn v2 in h0's registry first
            reg_args = ["--registry", primary, "--host-registries", regs[0], regs[1]]
            ArtifactRegistry(regs[0]).pull(primary, 2)
            torn = os.path.join(ArtifactRegistry(regs[0]).resolve(2), "weights.npz")
            good = os.path.join(root, "weights_v2.npz")
            shutil.copyfile(torn, good)
            with open(torn, "r+b") as f:
                f.truncate(os.path.getsize(torn) // 2)
            et = sf_router(root, art, [h0, h1], [
                "--scenario", "poisson", "--rate", str(SF_RATE), "--requests", "64",
                *reg_args, "--swap-to", "v0002", "--swap-at", "0.25"])
            vt = et["verdict"]
            swt = ((vt or {}).get("fleet") or {}).get("swap") or {}
            pulls_t = [e for e in _fleet_events(os.path.dirname(et["run_dir"] or root))
                       if e.get("phase") == "pull"] if et["run_dir"] else []
            v1_held = probe(h0, "v1") and probe(h1, "v1")
            oks["e_torn"] = (et["rc"] == 1 and swt.get("state") == "failed"
                             and sorted(p["pulled"] for p in pulls_t) == [0, 1]
                             and swt.get("hosts_shifted") == [] and "h0" in str(swt.get("error"))
                             and vt["fleet"]["dropped"] == 0 and v1_held)
            log(f"{tag} (e) torn v2 in h0's registry (weights truncated after a verified "
                f"pull): exit {et['rc']}, fleet swap {swt}; pulls {pulls_t}; v1 answering "
                f"on both hosts {v1_held} ({et['seconds']:.1f}s) ok={oks['e_torn']}")
            shutil.copyfile(good, torn)
            e = sf_router(root, art, [h0, h1], [
                "--scenario", "poisson", "--rate", str(SF_RATE), "--requests",
                str(SF_REQUESTS), "--rtrace-sample-every", "1", *reg_args, "--swap-to",
                "v0002", "--swap-at", "0.5"])
            ve = e["verdict"]
            keep_verdict("e_swap", ve)
            sw = ((ve or {}).get("fleet") or {}).get("swap") or {}
            fev = _fleet_events(os.path.dirname(e["run_dir"])) if e["run_dir"] else []
            pulls = [x for x in fev if x.get("phase") == "pull"]
            swaps = [x for x in fev if x.get("phase") == "swap"]
            v2_held = probe(h0, "v2") and probe(h1, "v2")
            phases = sf_swap_phases(e["run_dir"], swaps) if e["run_dir"] else {}
            oks["e"] = (e["rc"] == 0 and sw.get("state") == "done"
                        and sw.get("hosts_shifted") == ["h0", "h1"]
                        and [x.get("host") for x in swaps if x.get("state") == "shifted"]
                        == ["h0", "h1"] and len(pulls) == 2
                        and ve["fleet"]["dropped"] == 0
                        and ve["fleet"]["ledger_consistent"] is True and v2_held)
            log(f"{tag} (e) v1 -> v2 under poisson {SF_RATE} req/s, {SF_REQUESTS} requests, "
                f"swap at 0.5: exit {e['rc']}, fleet swap {sw}; pulls {pulls}; the shifts "
                f"{[(x.get('host'), x.get('shed')) for x in swaps if x.get('state') == 'shifted']}"
                f"; by phase (router clock, arrival) {phases}; v2 answering on both hosts "
                f"{v2_held}; " + (sf_line(ve) if ve else e["err"])
                + f" ({e['seconds']:.1f}s) ok={oks['e']}")
            summary["e"] = {"swap": sw, "phases": phases}

            # (d) SIGSTOP h1 mid-run, SIGCONT after
            stopped = []

            def wedge(n):
                if not stopped and n >= 40:
                    stopped.append(n)
                    h1["proc"].send_signal(signal.SIGSTOP)

            try:
                ds = sf_router(root, art, [h0, h1], [
                    "--scenario", "poisson", "--rate", "60", "--requests", "160",
                    "--proxy-timeout-s", "0.75", "--scrape-timeout-s", "0.2",
                    "--scrape-stale-after", "2", "--rtrace-sample-every", "1"],
                    on_proxied=wedge)
            finally:
                h1["proc"].send_signal(signal.SIGCONT)
            vs = ds["verdict"]
            keep_verdict("d_sigstop", vs)
            stale = []
            if ds["run_dir"]:
                stale = [x["host_windows"]["hosts"]["h1"]["stale"]
                         for x in _fleet_events(os.path.dirname(ds["run_dir"]))
                         if x.get("phase") == "stats"
                         and "h1" in ((x.get("host_windows") or {}).get("hosts") or {})]
            fa = (vs or {}).get("fleet_attribution") or {}
            hop = (fa.get("stages") or {}).get("retry_hop") or {}
            backend = [blk["p99_ms"] for blk in (fa.get("backend_stages") or {}).values()
                       if blk and blk.get("p99_ms") is not None]
            oks["d_stop"] = (ds["rc"] == 0 and bool(stopped) and vs is not None
                             and vs["fleet"]["dropped"] == 0
                             and vs["fleet"]["ledger_consistent"] is True
                             and vs["fleet"]["hosts"]["h1"]["retries"]["timeout"] > 0
                             and any(stale) and (fa.get("retry_hop_share") or 0) > 0
                             and bool(backend) and (hop.get("p99_ms") or 0) > max(backend))
            log(f"{tag} (d) SIGSTOP h1 after {stopped} proxied (poisson 60 req/s, 160 "
                f"requests, proxy timeout 0.75 s), SIGCONT after: exit {ds['rc']}; h1's "
                f"scraped window stale in {sum(stale)} of {len(stale)} stats events; "
                f"fleet_attribution retry_hop_share {fa.get('retry_hop_share')}, retry_hop "
                f"p99 {hop.get('p99_ms')} ms against the backend stages' p99 max "
                f"{max(backend) if backend else None}; reconciliation "
                f"{(fa.get('reconciliation') or {}).get('violations')} violations; "
                + (sf_line(vs) if vs else ds["err"]) + f" ({ds['seconds']:.1f}s) "
                f"ok={oks['d_stop']}")
            summary["d_stop"] = {"retry_hop_share": fa.get("retry_hop_share"),
                                 "retry_hop_p99_ms": hop.get("p99_ms")}

            # (c) a flash crowd, SIGTERM to h1 half way
            n_c = SF_REQUESTS
            termed = []

            def term(n):
                if not termed and n >= n_c // 2:
                    termed.append(time.time())
                    h1["proc"].send_signal(signal.SIGTERM)

            c = sf_router(root, art, [h0, h1], [
                "--scenario", "flash_crowd", "--rate", str(SF_RATE), "--flash-factor", "8",
                "--requests", str(n_c), "--probe-interval-s", "0.05"], on_proxied=term)
            reaped["h1"] = r1 = sf_reap(h1, signalled=bool(termed))
            vc = c["verdict"]
            keep_verdict("c_sigterm", vc)
            trail = []
            if c["run_dir"]:
                trail = [(x["state_from"], x["state_to"])
                         for x in _fleet_events(os.path.dirname(c["run_dir"]))
                         if x.get("phase") == "probe" and x.get("host") == "h1"]
            hv = r1["verdict"] or {}
            answered = (r1["rc"] == 0 and hv.get("requests_failed") == 0
                        and hv.get("drained_clean") is True and hv.get("preempted") is True
                        and hv["requests_completed"] + hv["requests_shed"]
                        + hv["requests_rejected"] == hv["requests_submitted"])
            fc = (vc or {}).get("fleet") or {}
            # its first change of state after the router found it ready
            after = trail[trail.index(("warming", "ready")) + 1:] if (
                ("warming", "ready") in trail) else []
            oks["c"] = (c["rc"] == 0 and bool(termed) and fc.get("dropped") == 0
                        and fc.get("ledger_consistent") is True and answered
                        and bool(after) and after[0] == ("ready", "draining")
                        and all(set(h["retries"]) == set(RETRY_CAUSES)
                                for h in fc["hosts"].values())
                        and fc["retries_total"] == sum(sum(h["retries"].values())
                                                       for h in fc["hosts"].values()))
            log(f"{tag} (c) flash crowd at {SF_RATE} req/s × 8, {n_c} requests, probes every "
                f"0.05 s, SIGTERM h1 at {n_c // 2} proxied: exit {c['rc']}; h1's probe trail {trail}; h1 exit "
                f"{r1['rc']}, its own verdict submitted {hv.get('requests_submitted')} "
                f"completed {hv.get('requests_completed')} shed {hv.get('requests_shed')} "
                f"failed {hv.get('requests_failed')} drained_clean {hv.get('drained_clean')}; "
                + (sf_line(vc) if vc else c["err"]) + f" ({c['seconds']:.1f}s) ok={oks['c']}")

            # (d) SIGKILL the fresh h2 mid-load over h0 and h2
            killed = []

            def kill(n):
                if not killed and n >= 80:
                    killed.append(time.time())
                    h2["proc"].kill()

            dk = sf_router(root, art, [h0, h2], [
                "--scenario", "poisson", "--rate", str(SF_RATE), "--requests", "256"],
                on_proxied=kill)
            vk = dk["verdict"]
            keep_verdict("d_sigkill", vk)
            dead = []
            if dk["run_dir"]:
                dead = [x for x in _fleet_events(os.path.dirname(dk["run_dir"]))
                        if x.get("phase") == "probe" and x.get("host") == "h1"
                        and x.get("state_to") == "dead"]
            fk = (vk or {}).get("fleet") or {}
            k_h = (fk.get("hosts") or {}).get("h1") or {}
            lag = round(dead[0]["t"] - killed[0], 3) if dead and killed else None
            oks["d_kill"] = (dk["rc"] == 0 and bool(killed) and fk.get("dropped") == 0
                             and fk.get("ledger_consistent") is True
                             and k_h["retries"]["connect"] + k_h["retries"]["reset"] > 0
                             and fk["hosts"]["h0"]["completed"] > 0
                             and vk["requests_failed"] == 0 and len(dead) == 1
                             and dead[0]["state_from"] == "ready"
                             and lag is not None and lag >= SF_PROBE_S)
            log(f"{tag} (d) SIGKILL the fresh host h2 (h1 of this router) after 80 proxied "
                f"(poisson {SF_RATE} req/s, 256 requests): exit {dk['rc']}; its retries "
                f"{k_h.get('retries')}, probe ready -> dead {lag} s after the kill (debounce "
                f"2 × {SF_PROBE_S} s); " + (sf_line(vk) if vk else dk["err"])
                + f" ({dk['seconds']:.1f}s) ok={oks['d_kill']}")
            summary["d_kill"] = {"retries": k_h.get("retries"), "dead_after_s": lag}
        finally:
            for h in hosts:
                if h["name"] not in reaped:
                    reaped[h["name"]] = sf_reap(h)

        # launches: the hosts that exited cleanly wrote their counters
        hosts_by = {h["name"]: h for h in hosts}
        clean = []
        for name in ("h0", "h1", "h3"):
            r = reaped[name]
            ok_h = (r["rc"] == 0 and r["counts"] is not None
                    and sb_launch_gate(f"{name}", r["counts"], [("unpack", r["forwards"] or 0,
                                                                 False)], phase=tag)
                    and r["forwards"] is not None)
            oks[f"launches_{name}"] = ok_h
            if r["counts"] is not None:
                clean.append(name)
                for k in SB_COUNTED:
                    total[k] += r["counts"].get(k, 0)
            # kernel ms over the load's wall; a window with no device time
            # was not measured
            busy_share = [(label, round(b_, 3), round(w_, 1),
                           round(b_ / (1e3 * load_s), 4) if b_ > 0 and load_s else None)
                          for (label, load_s), (b_, w_) in zip(hosts_by[name]["windows"],
                                                                r["busy"]) if label != "warm"]
            said = [ln for ln in r["err_all"].splitlines() if ln.startswith("BusyWindows")]
            log(f"{tag} {name} exit {r['rc']}, forwards {r['forwards']}, profiler windows "
                f"(run, kernel ms, window ms, busy share of the load) {busy_share}" + (f"; {said}" if said else ""))
            summary[f"busy_{name}"] = busy_share
        r2 = reaped["h2"]
        log(f"{tag} h2 SIGKILLed: exit {r2['rc']}, launch counts "
            f"{'unknown (it wrote none)' if r2['counts'] is None else r2['counts']}")
        oks["h2_killed"] = r2["rc"] == -signal.SIGKILL and r2["counts"] is None
    ok = all(oks.values())
    summary["seconds"] = round(time.perf_counter() - t_phase, 1)
    log(f"{tag} summary {json.dumps(summary)}")
    log(f"{tag} gates {oks}; launches over the clean hosts {clean} {total}; "
        f"{summary['seconds']}s: ok={ok}")
    return total, ok


def sf_swap_phases(run_dir: str, swaps: list) -> dict:
    """p99 of the requests the router answered before, during and after
    the fleet swap (its ``trigger`` to ``done`` events), on the router's
    clock: each sampled waterfall's arrival is its ``rtrace`` event's time
    less its total."""
    from bdbnn_tpu_torch.obs.events import read_events
    from bdbnn_tpu_torch.serve.engine import _pct

    t = {x.get("state"): x["t"] for x in swaps}
    t0, t1 = t.get("trigger"), t.get("done", t.get("failed"))
    if t0 is None or t1 is None:
        return {}
    lat = {"before": [], "during": [], "after": []}
    for e in read_events(run_dir, "rtrace"):
        if e.get("phase") == "request":
            arr = e["t"] - e["total_ms"] / 1e3
            lat["before" if arr < t0 else "during" if arr <= t1 else "after"].append(e["total_ms"])
    return {k: {"completed": len(v), "p99_ms": _pct(sorted(v), 99.0)} for k, v in lat.items()} | {
        "swap_s": round(t1 - t0, 3)}


# [perf]: the perf command's sweep on the flagship artifact
PERF_BUCKETS = (1, 8, 32)
PERF_IMPLS = ("dense", "unpack", "popcount")
PERF_ITERS = 20
# the main kernel of K1-K4 by the name the profiler gives it (one a
# wrapper call), and every kernel each launches (prep passes, finishes)
PERF_TRACE_NAMES = {"K1": "binary_conv_fwd_kernel", "K2": "weight_sign_kernel",
                    "K3": "unpack_sign_kernel", "K4": "popcount_conv_fwd_kernel"}
K_FAMILIES = {"K1": ("fwd_sign_prep_kernel", "binary_conv_fwd_kernel", "fwd_wpad_kernel"),
              "K2": ("weight_sign_kernel", "weight_alpha_finish_kernel"),
              "K3": ("unpack_sign_kernel",),
              "K4": ("popcount_prep_kernel", "popcount_conv_fwd_kernel"),
              "K5": ("dgrad_split_kernel", "dgrad_wsign_bf16_kernel", "binary_conv_dgrad_kernel"),
              "K6": ("wgrad_prep_kernel", "binary_conv_wgrad_kernel",
                     "binary_conv_wgrad_reduce_kernel"),
              "K7": ("kurt_mean_kernel", "kurt_moments_kernel", "kurt_grad_kernel")}
# a counted CLI child writes each profiler window's launches here
WINDOWS_ENV = "CHIP_SMOKE_WINDOWS"


def k_of(kernel_name: str):
    """The K whose family launched a kernel of this name, or None."""
    return next((k for k, names in K_FAMILIES.items()
                 if any(n in kernel_name for n in names)), None)


def count_windows() -> list:
    """Make every profiler window this process opens (obs/trace.py
    ``TraceCapture``, the engine's ``trace_step`` included) record the
    launch counters' increase between its open and its stop; returns the
    list it appends ``{"trace_dir", "launches"}`` to."""
    from bdbnn_tpu_torch.obs import trace

    out = []

    class Counted(trace.TraceCapture):
        def maybe_start(self, epoch, step):
            started = super().maybe_start(epoch, step)
            if started:
                self._opened = read_counts()
            return started

        def _stop(self, fence):
            info = super()._stop(fence)
            now = read_counts()
            out.append({"trace_dir": info["trace_dir"],
                        "launches": {k: now[k] - self._opened[k] for k in now}})
            return info

    trace.TraceCapture = Counted
    return out


def phase_perf(art: str, smi_line: str):
    """[perf] (a) and (c): ``cli perf`` on the flagship artifact at buckets
    1 8 32, impls dense unpack popcount, PERF_ITERS forwards a window,
    through :func:`counted_cli` with each window's launches recorded. (a)
    exit 0; every cell traced (a window whose trace lost device records
    is taken again by the command, up to three); the layers attributed
    exactly the static
    table's 21 rows, each ms > 0; each window's K1-K4 kernels in its trace
    by name equal to its launch counters (19 × iters of each the impl
    runs); every K1-K4 kernel in a binary conv's layer, 19 × iters of each
    main kernel a layer; layers + unattributed = the device total within
    rounding. (c) the port's ``compare`` of the verdict against itself
    exits 0, against a copy with one layer's ms doubled 3. Returns (the
    run's launch counts, ok)."""
    import copy
    import glob

    from bdbnn_tpu_torch.obs.trace import (
        find_trace_file,
        layer_needles,
        layer_of,
        scoped_device_ops,
    )

    tag = "[perf]"
    t_phase = time.perf_counter()
    log(f"{tag} {smi_line}")
    root = tempfile.mkdtemp(prefix="chip_smoke_perf-")
    counts_file = os.path.join(root, "counts.json")
    windows_file = os.path.join(root, "windows.json")
    verdict_path = os.path.join(root, "verdict.json")
    cmd = [sys.executable, "-c", COUNTED_CLI, "perf", art, "--log-path", os.path.join(root, "log"),
           "--buckets", *map(str, PERF_BUCKETS), "--impls", *PERF_IMPLS,
           "--iters", str(PERF_ITERS), "--out", verdict_path]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                       env={**os.environ, COUNTS_ENV: counts_file, WINDOWS_ENV: windows_file})
    seconds = time.perf_counter() - t0
    oks = {"a_rc": r.returncode == 0}
    log(f"{tag} (a) cli perf -> {r.returncode} in {seconds:.1f}s; ok={oks['a_rc']}")
    counts = json.load(open(counts_file)) if os.path.exists(counts_file) else {}
    if r.returncode != 0:
        log(f"{tag} (a) FAIL stderr tail: {r.stderr[-3000:]}")
        return counts, False
    for line in r.stderr.splitlines():
        if line.startswith(("==", "ceilings", "bucket", "--", "   ", "summary")):
            log(f"{tag} {line}")
    v = json.load(open(verdict_path))
    (run_dir,) = [os.path.dirname(p) for p in glob.glob(os.path.join(root, "log", "*",
                                                                     "perf_verdict.json"))]
    windows = {w["trace_dir"]: w["launches"] for w in json.load(open(windows_file))}
    rows = v["static"][str(PERF_BUCKETS[0])]
    names = {x["name"] for x in rows}
    binary = {x["name"] for x in rows if x["kind"] == "binary"}
    needles = layer_needles({x["name"]: x["scope"] for x in rows})
    n = 19 * PERF_ITERS
    cells = {}
    for impl in PERF_IMPLS:
        for b in PERF_BUCKETS:
            cell = v["measured"][impl][str(b)]
            rec = cell["reconciliation"]
            tdir = os.path.join(run_dir, "traces", f"{impl}_b{b}")
            trace = find_trace_file(tdir)
            tc = trace_counts(trace, PERF_TRACE_NAMES) if trace else {}
            win = windows.get(tdir, {})
            want = {"K1": n if impl != "popcount" else 0, "K2": n,
                    "K3": n if impl != "dense" else 0, "K4": n if impl == "popcount" else 0}
            per_layer, outside = {}, 0
            for op in scoped_device_ops(trace) if trace else []:
                k = k_of(op["name"])
                if k is None:
                    continue
                layer = layer_of(op["path"], needles)
                if layer not in binary:
                    outside += 1
                elif PERF_TRACE_NAMES[k] in op["name"]:
                    per_layer.setdefault(layer, {}).setdefault(k, 0)
                    per_layer[layer][k] += 1
            each = {k: PERF_ITERS for k, c in want.items() if c}
            in_layers = outside == 0 and set(per_layer) == binary and all(
                per_layer[name] == each for name in binary)
            total = rec["attributed_ms"] + rec["unattributed_ms"]
            ok = (cell["traced"] is True and set(cell["layers"]) == names
                  and all(x["ms"] > 0 for x in cell["layers"].values())
                  and all(tc.get(k) == win.get(k) == want[k] for k in want)
                  and in_layers and abs(total - rec["device_total_ms"]) <= 2e-3)
            cells[f"{impl} b{b}"] = ok
            log(f"{tag} (a) {impl} b{b}: wall {cell['wall_ms']} ms, device {rec['device_total_ms']}"
                f" ms ({rec['device_total_ms'] / cell['wall_ms']:.3f} of the wall), layers "
                f"{rec['attributed_ms']} + unattributed {rec['unattributed_ms']} ms "
                f"({rec['unattributed_ms'] / max(rec['device_total_ms'], 1e-9):.3f}), "
                f"reconcile err {rec['abs_err_pct']}% ok {rec['ok']}; {len(cell['layers'])} of "
                f"{len(names)} layers; windows taken {cell['windows']} (the kept one lost "
                f"{cell['lost_records']}); device records lost {tc.get('lost')} of "
                f"{tc.get('issued')} (at launch positions {tc.get('lost_at')}); K kernels in the trace "
                f"{dict((k, tc.get(k)) for k in want)}"
                f" against the window's launches {dict((k, win.get(k)) for k in want)} (want "
                f"{want}); K1-K4 kernels outside their layer {outside}, every binary layer "
                f"{each} {in_layers}; ok={ok}")
    oks["a_cells"] = all(cells.values())
    log(f"{tag} (a) summary {v['summary']}; device {v['device_kind']}; ceilings "
        f"{v['ceilings']}; launches {counts}; ok={oks['a_cells']}")

    # (c) the port's compare: the verdict against itself, and against a
    # copy with one layer's ms doubled
    slow = copy.deepcopy(v)
    key = max(slow["perf_layers"], key=slow["perf_layers"].get)
    slow["perf_layers"][key] *= 2.0
    slow_path = os.path.join(root, "slow.json")
    with open(slow_path, "w") as f:
        json.dump(slow, f)
    rcs = [subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", "compare", verdict_path,
                           other, "--json"], cwd=REPO, capture_output=True, text=True,
                          timeout=120).returncode for other in (verdict_path, slow_path)]
    oks["c"] = rcs == [0, 3]
    log(f"{tag} (c) compare against itself -> {rcs[0]}, against {key} doubled -> {rcs[1]}; "
        f"ok={oks['c']}")
    ok = all(oks.values())
    log(f"{tag} gates {oks} in {time.perf_counter() - t_phase:.1f}s: ok={ok}")
    return counts, ok


def phase_perf_summarize(train_dir: str) -> bool:
    """[perf] (b): the port's ``summarize`` (its CLI) of [train-health]
    (a)'s run dir, which holds one ``fit`` window of the flagship recipe:
    binarize, binary_conv, bn_act, kurtosis_loss and optimizer read above
    zero, and no K1, K2, K5, K6 or K7 kernel of the trace is unattributed
    (K1, K5, K6 in binary_conv, K2 in binarize, K7 in kurtosis_loss and,
    for the probes' kurtosis of each weight, in probes)."""
    from bdbnn_tpu_torch.obs.trace import DEVICE_SPANS, _span_of, find_trace_file, scoped_device_ops

    tag = "[perf]"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", "summarize", train_dir,
                        "--json"], cwd=REPO, capture_output=True, text=True, timeout=300)
    att = (json.loads(r.stdout).get("attribution") or {}) if r.returncode == 0 else {}
    cats = att.get("categories_ms_per_step") or {}
    want = {"K1": {"binary_conv"}, "K2": {"binarize"}, "K5": {"binary_conv"},
            "K6": {"binary_conv"}, "K7": {"kurtosis_loss", "probes"}}
    by_k = {}
    trace = find_trace_file(train_dir)
    for op in scoped_device_ops(trace) if trace else []:
        k = k_of(op["name"])
        if k in want:
            cat = _span_of(op["path"], DEVICE_SPANS) or "unattributed"
            by_k.setdefault(k, {}).setdefault(cat, 0)
            by_k[k][cat] += 1
    ok = (r.returncode == 0 and all(cats.get(c, 0) > 0 for c in
                                    ("binarize", "binary_conv", "bn_act", "kurtosis_loss",
                                     "optimizer"))
          and set(by_k) == set(want) and all(set(by_k[k]) <= cs for k, cs in want.items())
          and "kurtosis_loss" in by_k["K7"])
    log(f"{tag} (b) cli summarize of [train-health] (a) -> {r.returncode} in "
        f"{time.perf_counter() - t0:.1f}s: device ms a step by category over "
        f"{att.get('n_steps')} steps {cats}, step total {att.get('step_total_ms')} ms, host "
        f"phases {att.get('host_phases_ms_per_step')}; PERF.md section 5's -b 256 step (a "
        f"step on one batch, profiled): K5's GEMM 19.704, K6's 16.199, reductions 19.716, "
        f"gradient adds 13.224, BN/RPReLU 24.724, K1 3.333 ms; K kernels by category {by_k}; "
        f"ok={ok}")
    return ok


# ---------------------------------------------------------------------------
# [determinism]: the CLI's fit across a preemption, as users run it
# ---------------------------------------------------------------------------

DET_TURNS = 2
DET_STEP_ITERS = 10


def det_cli(root: str, tree: str, resume: str = "", sigterm_mid_epoch: bool = False) -> dict:
    """``python -m bdbnn_tpu_torch.cli`` from the checkout ``tree`` (its own
    package, its own settings) on RESUME_ARGS under ``root``; with
    ``sigterm_mid_epoch`` SIGTERMed right after its first mid-epoch
    checkpoint event. Returns {rc, run_dir, err}."""
    import signal

    from bdbnn_tpu_torch.obs import events as tevents
    from bdbnn_tpu_torch.obs.events import read_events

    args = resume_cli_args(root) + (["--resume", resume] if resume else [])
    err_path = os.path.join(root, "stderr.txt")
    env = {**os.environ, "PYTHONPATH": tree}
    with open(err_path, "w") as err_f:
        proc = subprocess.Popen([sys.executable, "-m", "bdbnn_tpu_torch.cli", *args], cwd=tree,
                                env=env, stdout=subprocess.DEVNULL, stderr=err_f)
    try:
        if sigterm_mid_epoch:
            deadline = time.time() + 600
            hit = None
            while hit is None and proc.poll() is None and time.time() < deadline:
                time.sleep(0.02)
                evs = [e for dp, _, fs in os.walk(root) if tevents.EVENTS_NAME in fs
                       for e in read_events(dp, "checkpoint")]
                hit = next((e for e in evs if e["step_in_epoch"] > 0), None)
            if hit is not None:
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(err_path) as f:
        err = f.read()
    return {"rc": rc, "run_dir": run_dir_of(root) if rc in (0, 75) else None, "err": err[-3000:]}


def determinism_across_preemption(tree: str, label: str) -> dict:
    """The flagship CLI twice from ``tree`` with one seed: A straight
    through; B SIGTERMed after its first mid-epoch checkpoint (exit 75),
    then ``--resume``d. The tensors of A's and B's final ``state.pt`` that
    differ are counted."""
    tag = "[determinism]"
    a = det_cli(fresh_log_root(), tree)
    b = det_cli(fresh_log_root(), tree, sigterm_mid_epoch=True)
    c = det_cli(fresh_log_root(), tree, resume=b["run_dir"] or "") if b["rc"] == 75 else b
    if a["rc"] != 0 or b["rc"] != 75 or c["rc"] != 0:
        log(f"{tag} {label} FAIL: exit codes A {a['rc']}, B {b['rc']} (75 wanted), resumed "
            f"{c['rc']}: {a['err'][-800:]} {b['err'][-800:]} {c['err'][-800:]}")
        return {"ok": False, "differing": None}
    diff = state_diff(final_payload(a["run_dir"]), final_payload(c["run_dir"]))
    n = len(final_payload(a["run_dir"])["model"])
    log(f"{tag} {label}: A exit 0, B SIGTERMed mid-epoch exit 75, B resumed exit 0; final "
        f"state.pt tensors that differ from A's: {len(diff)} (of {n} model tensors plus the "
        f"optimizer state; max |diff| of the first: {diff[:6]})")
    return {"ok": True, "differing": len(diff)}


def det_step_cost(smi_line: str, turns: int = DET_TURNS) -> dict:
    """What cuDNN's deterministic algorithms cost the flagship's -b 256
    f32 step (``profile_train_step``, batch on the card, CUDA events):
    ``cudnn.deterministic`` off and on in turns (benchmark off, fit's
    setting and torch's default)."""
    import torch

    ms = {"off": [], "on": []}
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        for turn in range(turns):
            for mode in (("off", "on") if turn % 2 == 0 else ("on", "off")):
                torch.backends.cudnn.deterministic = mode == "on"
                torch.backends.cudnn.benchmark = False
                r = profile_train_step(iters=DET_STEP_ITERS, tag=f"determinism {mode}",
                                       trace=False)
                ms[mode].append(round(r["step_ms"], 3))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"[determinism] flagship f32 step -b {TRAIN_BATCH} (batch on the card, CUDA events, "
        f"{DET_STEP_ITERS} steps a turn): cudnn.deterministic off {ms['off']} ms, on {ms['on']} "
        f"ms; mean {mean['off']:.3f} -> {mean['on']:.3f} ms "
        f"({(mean['on'] / mean['off'] - 1) * 100:+.2f}%); {smi_line}")
    return {"ms": ms, "mean": mean}


def phase_determinism(trees: list, smi_line: str) -> bool:
    """[determinism]: :func:`determinism_across_preemption` for each
    checkout in ``trees`` (their kernels built first), then
    :func:`det_step_cost`. Passes when every tree's CLI ran and this
    tree's resumed state is bitwise."""
    ok = True
    for tree in trees:
        tree = os.path.abspath(tree)
        if tree != REPO:
            r = subprocess.run([sys.executable, "-c", "from bdbnn_tpu_torch.nn.kernels import "
                                "_build; print(_build.build_all())"], cwd=tree,
                               env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
                               text=True, timeout=600)
            log(f"[determinism] built {tree}'s kernels: rc {r.returncode} {r.stdout.strip()}")
        res = determinism_across_preemption(tree, "this tree" if tree == REPO else tree)
        ok = ok and res["ok"] and (tree != REPO or res["differing"] == 0)
    det_step_cost(smi_line)
    log(f"[determinism] ok={ok}")
    return ok


# ---------------------------------------------------------------------------
# [search] and [check]: the recipe-search harness and the static analyzer
# ---------------------------------------------------------------------------

# the full-width flagship, synthetic: 2 families x 2 learning rates, 8
# steps of -b 64 and an eval of 256 images a trial, two workers at once
SEARCH_ARGS = ["--dataset", "imagenet", "-a", "resnet18", "--synthetic", "-b", "64",
               "--synthetic-train-size", "512", "--synthetic-val-size", "256",
               "--families", "ste", "ede", "--lrs", "0.1", "0.01", "--workers", "2"]
SEARCH_TRIALS = 4
SEARCH_STEPS = 8
SEARCH_EVAL_BATCHES = 4
SEARCH_BATCH = 64
HEAVY_ROOTS = ("torch", "numpy", "jax", "jaxlib", "flax", "bdbnn_tpu")
COUNTED_SEARCH = "import sys, chip_smoke; sys.exit(chip_smoke.counted_search())"


def counted_search() -> int:
    """``python -m bdbnn_tpu_torch.cli`` with this process's arguments (a
    ``search``) whose trial workers run through :func:`counted_cli`, each
    writing its launch counts into the directory ``$CHIP_SMOKE_COUNTS``
    names; at exit, the heavy modules this harness process loaded (none
    wanted) into ``harness.json`` there."""
    from bdbnn_tpu_torch import cli
    from bdbnn_tpu_torch.search import harness

    trial_argv = harness._trial_argv

    def counted(*a, **kw):
        argv = trial_argv(*a, **kw)
        assert argv[1:3] == ["-m", "bdbnn_tpu_torch.cli"], argv[:3]
        return [argv[0], "-c", COUNTED_CLI, *argv[3:]]

    harness._trial_argv = counted
    try:
        return cli.main(sys.argv[1:])
    finally:
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in HEAVY_ROOTS)
        with open(os.path.join(os.environ[COUNTS_ENV], "harness.json"), "w") as f:
            json.dump(loaded, f)


def search_run(out_dir: str, resume: bool = False, sigterm_when=None) -> dict:
    """The ``search`` CLI through :func:`counted_search` into ``out_dir``
    on the card (no ``--device``). ``sigterm_when(out_dir)`` is polled
    while it runs; the harness is SIGTERMed once it holds. Returns exit
    code, wall seconds, summed trial launch counts, the harness's heavy
    modules, stdout and stderr tails."""
    import signal

    counts_dir = out_dir + ".counts"
    os.makedirs(counts_dir, exist_ok=True)
    cmd = [sys.executable, "-c", COUNTED_SEARCH, "search", "--out-dir", out_dir, *SEARCH_ARGS]
    if resume:
        cmd.append("--resume")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, COUNTS_ENV: counts_dir})
    signalled = None
    try:
        if sigterm_when is not None:
            deadline = time.monotonic() + 600
            while proc.poll() is None and time.monotonic() < deadline:
                if sigterm_when(out_dir):
                    signalled = time.perf_counter() - t0
                    proc.send_signal(signal.SIGTERM)
                    break
                time.sleep(0.02)
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    counts, harness_mods = {}, None
    for name in sorted(os.listdir(counts_dir)):
        with open(os.path.join(counts_dir, name)) as f:
            got = json.load(f)
        if name == "harness.json":
            harness_mods = got
        elif name.endswith(".json"):
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
    return {"rc": proc.returncode, "wall_s": wall, "counts": counts, "harness": harness_mods,
            "signalled_s": signalled, "out": out, "err": err[-3000:]}


def search_ledger(out_dir: str) -> dict:
    from bdbnn_tpu_torch.search.harness import LEDGER_NAME

    path = os.path.join(out_dir, LEDGER_NAME)
    try:
        with open(path) as f:
            return json.load(f).get("trials") or {}
    except (OSError, ValueError):
        return {}


def trial_walls(out_dir: str) -> dict:
    """Per trial attempt, from the sweep's ``trial`` events and the
    attempt's run dir: wall seconds (harness launch to exit), seconds to
    the run's ``run_start`` (interpreter, torch, the package, the data)
    and to the end of its first step (``compile`` event: the kernels'
    first load and launch)."""
    from bdbnn_tpu_torch.obs.events import read_events

    evs = read_events(out_dir, "trial")
    out = {}
    for tid, entry in sorted(search_ledger(out_dir).items()):
        starts = [e for e in evs if e.get("trial") == tid and e["phase"] in ("start", "resumed")]
        ends = [e for e in evs if e.get("trial") == tid
                and e["phase"] in ("done", "preempted", "interrupted", "failed")]
        run_dirs = entry.get("run_dirs") or []
        rows = []
        for i, st in enumerate(starts):
            end = ends[i] if i < len(ends) else None
            run = read_events(run_dirs[min(i, len(run_dirs) - 1)]) if run_dirs else []
            rs = next((e for e in run if e["kind"] == "run_start"), None)
            comp = next((e for e in run if e["kind"] == "compile"), None)
            rows.append({
                "phase": end["phase"] if end else None,
                "wall_s": round(end["t"] - st["t"], 3) if end else None,
                "to_run_start_s": round(rs["t"] - st["t"], 3) if rs else None,
                "to_first_step_s": round(comp["t"] - st["t"], 3) if comp else None,
            })
        out[tid] = rows
    return out


def _running_past_first_step(out_dir: str) -> bool:
    """One trial done and another running past its first step (its run
    dir holds a ``compile`` event and no ``run_end``)."""
    import glob

    from bdbnn_tpu_torch.obs.events import read_events

    trials = search_ledger(out_dir)
    if not any(e.get("status") == "done" for e in trials.values()):
        return False
    for tid, e in trials.items():
        if e.get("status") != "running":
            continue
        for ev_path in glob.glob(os.path.join(out_dir, "trials", tid, "*", "*", "events.jsonl")):
            kinds = {x["kind"] for x in read_events(os.path.dirname(ev_path))}
            if "compile" in kinds and "run_end" not in kinds:
                return True
    return False


def phase_search(smi_line: str):
    """[search]: the ``search`` CLI over full-width flagship trials on the
    card (SEARCH_ARGS: ImageNet resnet18, 224², synthetic, families ste
    and ede × lrs 0.1 and 0.01, 8 steps of -b 64 and an eval of 256
    images a trial, two workers; each trial a ``python -m
    bdbnn_tpu_torch.cli`` process through :func:`counted_cli`). (a) a clean
    sweep: exit 0, 4 completed trials, each trial's K5 and K6 launches 19
    a step and K1, K2 19 a forward; (b) the same sweep SIGTERMed once one
    trial is done and another is past its first step: exit 75, then
    ``--resume`` exit 0, the ranking (a)'s, at least one trial resumed, and
    every trial's final ``state.pt`` bitwise (a)'s; (c) the port's
    ``summarize``, ``watch --once`` and ``compare`` over the two sweep dirs
    exit 0 (``compare`` with ``--tol-rel 1.0``: the wall-clock metric
    ``search_time_to_common_acc_s`` moves with the shared host, the
    deterministic ``search_best_top1`` is held at the default
    ``--tol-acc``); the harness loads no torch or numpy; each trial's wall
    and its share before the first step, the sweep's wall, the overlap of
    two workers on one card (Σ trial walls / sweep wall) and the device
    time of one trial's step (``profile_train_step`` at -b 64). Returns
    ((a)'s summed launch counts, ok)."""
    import shutil

    from bdbnn_tpu_torch.search.harness import LEADERBOARD_NAME

    tag = "[search]"
    oks = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_search-")
    try:
        # (a) the clean sweep
        dir_a = os.path.join(root, "a")
        a = search_run(dir_a)
        lb_a = json.load(open(os.path.join(dir_a, LEADERBOARD_NAME))) if a["rc"] == 0 else {}
        ca = a["counts"]
        steps = SEARCH_TRIALS * SEARCH_STEPS
        want = {"K5": steps * N_BINARY_CONVS, "K6": steps * N_BINARY_CONVS}
        fwd = SEARCH_TRIALS * (SEARCH_STEPS + SEARCH_EVAL_BATCHES) * N_BINARY_CONVS
        oks["a"] = (a["rc"] == 0 and lb_a.get("completed") == SEARCH_TRIALS
                    and lb_a.get("failed") == 0 and all(ca.get(k) == n for k, n in want.items())
                    and ca.get("K1") == fwd and ca.get("K2") == fwd and a["harness"] == [])
        walls_a = trial_walls(dir_a)
        log(f"{tag} (a) clean sweep: exit {a['rc']} in {a['wall_s']:.1f}s; completed "
            f"{lb_a.get('completed')}/{lb_a.get('trials_total')} failed {lb_a.get('failed')}; "
            f"ranking {[(r['trial'], r['best_top1'], r['final_top1']) for r in lb_a.get('ranking', [])]}; "
            f"trial launches summed {ca} (want K5, K6 {want['K5']}, K1, K2 {fwd}); heavy modules "
            f"in the harness process {a['harness']} ok={oks['a']}")
        if a["rc"] != 0:
            log(f"{tag} (a) FAIL: {a['err'][-2000:]}")
        for tid, rows in walls_a.items():
            log(f"{tag} (a) {tid}: {rows}")
        sum_walls = sum(r["wall_s"] or 0.0 for rows in walls_a.values() for r in rows)
        log(f"{tag} (a) overlap of --workers 2 on one card: trial walls sum {sum_walls:.1f}s over "
            f"the sweep's {a['wall_s']:.1f}s = {sum_walls / max(a['wall_s'], 1e-9):.2f}; {smi_line}")

        # (b) SIGTERM mid-sweep, then --resume
        dir_b = os.path.join(root, "b")
        b1 = search_run(dir_b, sigterm_when=_running_past_first_step)
        statuses = {t: e["status"] for t, e in search_ledger(dir_b).items()}
        log(f"{tag} (b) SIGTERM at {b1['signalled_s']}s: exit {b1['rc']} in {b1['wall_s']:.1f}s; "
            f"ledger {statuses}; trial launches {b1['counts']}")
        b2 = search_run(dir_b, resume=True)
        lb_b = json.load(open(os.path.join(dir_b, LEADERBOARD_NAME))) if b2["rc"] == 0 else {}
        resumed = sorted(t for t, m in (lb_b.get("trials") or {}).items() if m.get("resumed"))
        diffs = {}
        if a["rc"] == 0 and b2["rc"] == 0:
            la, lbb = search_ledger(dir_a), search_ledger(dir_b)
            diffs = {t: len(state_diff(final_payload(la[t]["run_dirs"][-1]),
                                       final_payload(lbb[t]["run_dirs"][-1])))
                     for t in sorted(la)}
        oks["b"] = (b1["rc"] == 75 and b2["rc"] == 0 and "preempted" in statuses.values()
                    and lb_b.get("ranking") == lb_a.get("ranking") and bool(resumed)
                    and len(diffs) == SEARCH_TRIALS and not any(diffs.values())
                    and b1["harness"] == [] and b2["harness"] == [])
        log(f"{tag} (b) --resume: exit {b2['rc']} in {b2['wall_s']:.1f}s; ranking (a)'s "
            f"{lb_b.get('ranking') == lb_a.get('ranking')}; resumed trials {resumed}; final "
            f"state.pt tensors differing from (a)'s, per trial {diffs} (total "
            f"{sum(diffs.values()) if diffs else None}); trial launches {b2['counts']} ok={oks['b']}")
        if b2["rc"] != 0:
            log(f"{tag} (b) FAIL: {b1['err'][-1500:]} {b2['err'][-1500:]}")
        for tid, rows in trial_walls(dir_b).items():
            log(f"{tag} (b) {tid}: {rows}")

        # (c) the readers over both sweeps
        rcs = {}
        for name, args in (("summarize a", ["summarize", dir_a]),
                           ("summarize b", ["summarize", dir_b]),
                           ("watch a", ["watch", dir_a, "--once"]),
                           ("compare a b", ["compare", dir_a, dir_b, "--tol-rel", "1.0"])):
            r = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", *args], cwd=REPO,
                               capture_output=True, text=True, timeout=300)
            rcs[name] = r.returncode
            tail = [ln for ln in r.stdout.splitlines() if "search" in ln.lower()
                    or "verdict" in ln.lower() or "winner" in ln.lower()][:4]
            log(f"{tag} (c) {name}: exit {r.returncode}; {tail}")
        oks["c"] = all(v == 0 for v in rcs.values())

        # the device time of one trial's step
        profile_train_step(iters=DET_STEP_ITERS, tag="search trial (flagship)", trace=False,
                           batch_size=SEARCH_BATCH)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = all(oks.values())
    log(f"{tag} {oks} ok={ok}")
    return a["counts"], ok


def phase_check() -> bool:
    """[check]: the port's static analyzer over this checkout's
    ``bdbnn_tpu_torch/``: ``python -m bdbnn_tpu_torch.cli check`` exits 0,
    and in a process that runs it, no module of torch, numpy or jax is
    loaded."""
    code = ("import json, sys\n"
            "from bdbnn_tpu_torch.cli import main\n"
            "rc = main(['check'])\n"
            f"print(json.dumps([m for m in sorted(sys.modules) if m.split('.')[0] in "
            f"{HEAVY_ROOTS!r}]))\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    lines = r.stdout.strip().splitlines()
    heavy = json.loads(lines[-1]) if lines else None
    ok = r.returncode == 0 and heavy == []
    log(f"[check] python -m bdbnn_tpu_torch.cli check: exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f}s; {lines[-2] if len(lines) > 1 else r.stderr[-1500:]}; "
        f"heavy modules loaded {heavy} ok={ok}")
    return ok


# ---------------------------------------------------------------------------
# [scripts]: the root scripts' twins (scripts/run_accuracy.py, run_kd.py,
# remat_ceiling.py) and dryrun_multichip
# ---------------------------------------------------------------------------

# (a)'s epochs; the output keys of the reference's run_accuracy.py
SCRIPTS_EPOCHS = 2
ACCURACY_KEYS = frozenset((
    "what", "why_not_cifar10", "platform", "device_kind", "host", "n_train", "n_test", "epochs",
    "dtype", "device_normalize", "ede", "twoblock", "lr", "arch", "batch_size", "opt_policy",
    "wall_seconds", "target_acc", "time_to_target_s", "best_val_top1", "best_epoch",
    "val_top1_curve", "train_top1_curve", "train_loss_curve", "train_img_per_sec_per_chip",
    "train_grad_norm_curve", "ede_t_curve", "ede_k_curve"))
# the reference's CPU results at (c)'s and (d)'s recipes (ACCURACY_r04.json,
# ACCURACY_r05_ts.json): the gap is printed, not gated (the packages draw
# their augmentation and init differently)
REF_CPU_TOP1 = {"no-kd": 97.78, "kd": 98.33}


def count_steps(run, *a, **kw):
    """``run(*a, on_step=..., **kw)`` with each step's launches of every
    wrapper (the eval passes' launches counted in neither step), counts
    set to 0 just before; returns (run's result, per-step launches, the
    whole run's launches)."""
    from bdbnn_tpu_torch.train import loop

    per_step, prev = [], {}

    def on_step(epoch, step, m):
        now = launch_counts()
        per_step.append({k: now[k] - prev.get(k, 0) for k in now})
        prev.update(now)

    real_validate = loop._validate

    def validate(*va, **vkw):
        acc1 = real_validate(*va, **vkw)
        prev.update(launch_counts())
        return acc1

    reset_counts()
    loop._validate = validate
    try:
        out = run(*a, on_step=on_step, **kw)
    finally:
        loop._validate = real_validate
    return out, per_step, launch_counts()


def n_binary_convs(arch: str, dataset: str = "cifar10") -> int:
    from bdbnn_tpu_torch.models import create_model
    from bdbnn_tpu_torch.nn.layers import _BinaryConvBase

    return sum(isinstance(m, _BinaryConvBase) for m in create_model(arch, dataset).modules())


def step_want(n_convs: int) -> dict:
    """A f32 train step's launches with the kurtosis loss on: K1, K2, K5,
    K6 once per binary conv, K7 twice (the loss and the binarization
    probes), nothing else."""
    want = {k: 0 for k in launch_counts()}
    want.update({"K1": n_convs, "K2": n_convs, "K5": n_convs, "K6": n_convs, "K7": 2})
    return want


def accuracy_ok(tag: str, out: dict, epochs: int, per_step: list, n_convs: int) -> bool:
    """The reference's keys, finite val and train curves of ``epochs``
    points, and every step launching what :func:`step_want` says."""
    want = step_want(n_convs)
    curves = out["val_top1_curve"] + out["train_top1_curve"]
    ok = (set(out) == ACCURACY_KEYS and len(out["val_top1_curve"]) == epochs
          and len(out["train_top1_curve"]) == epochs and all(math.isfinite(v) for v in curves)
          and bool(per_step) and all(c == want for c in per_step))
    bad = [c for c in per_step if c != want]
    log(f"{tag} {len(per_step)} steps, each's launches {want} expected: "
        f"{'all equal' if not bad else f'{len(bad)} differ, first {bad[0]}'}; "
        f"val {out['val_top1_curve']} train {out['train_top1_curve']} ok={ok}")
    return ok


def phase_scripts():
    """(a) the accuracy twin for SCRIPTS_EPOCHS epochs on the digits split
    through fit on the card, (b) the remat twin's tries at -b 64 without
    and with remat; returns (launch counts of both, ok)."""
    from bdbnn_tpu_torch.scripts import remat_ceiling, run_accuracy

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out, per_step, counts = count_steps(
            run_accuracy.main, ["--epochs", str(SCRIPTS_EPOCHS), "--out",
                                os.path.join(tmp, "ACCURACY.json")])
        log(f"[scripts] (a) run_accuracy --epochs {SCRIPTS_EPOCHS} on {out['device_kind']}: "
            f"best {out['best_val_top1']} at epoch {out['best_epoch']}, "
            f"{time.perf_counter() - t0:.1f}s; launches {counts}")
        ok_a = accuracy_ok("[scripts] (a)", out, SCRIPTS_EPOCHS, per_step,
                           n_binary_convs(out["arch"]))
    reset_counts()
    before = launch_counts()
    t0 = time.perf_counter()
    fits = {remat: remat_ceiling._try_batch(64, remat) for remat in (False, True)}
    after = launch_counts()
    ok_b = fits == {False: True, True: True}
    peaks = {f"remat={r}": remat_ceiling.PEAK_BYTES.get((64, r)) for r in (False, True)}
    log(f"[scripts] (b) remat_ceiling._try_batch(64) without and with remat: fits {fits}, "
        f"finite losses, peak device bytes {peaks}, {time.perf_counter() - t0:.1f}s; "
        f"launches {after} ok={ok_b}")
    both = {k: counts[k] + after[k] - before[k] for k in counts}
    return both, ok_a and ok_b


def guarded(tag: str, fn, *a, **kw) -> bool:
    """``fn(*a, **kw)``'s verdict, an exception logged as its failure."""
    import traceback

    try:
        return bool(fn(*a, **kw))
    except Exception:
        log(f"{tag} FAIL: {traceback.format_exc()[-2500:]}")
        return False


def phase_scripts_long(out_dir: str, smi_line: str) -> bool:
    """(c)-(f) of ``--scripts`` (the module docstring), outputs in
    ``out_dir``; each part runs whatever an earlier one did."""
    os.makedirs(out_dir, exist_ok=True)
    log(f"[scripts] {smi_line}")
    acc_path = os.path.join(out_dir, "ACCURACY_nokd.json")
    oks = {"c": guarded("[scripts] (c)", scripts_no_kd, acc_path, smi_line),
           "d": guarded("[scripts] (d)", scripts_kd, out_dir, acc_path, smi_line),
           "e": guarded("[scripts] (e)", scripts_remat, out_dir, smi_line),
           "f": guarded("[scripts] (f)", scripts_dryrun)}
    log(f"[scripts] --scripts (c)-(f): {oks}")
    return all(oks.values())


def scripts_no_kd(acc_path: str, smi_line: str) -> bool:
    from bdbnn_tpu_torch.scripts import run_accuracy

    n_convs = n_binary_convs("resnet20")
    t0 = time.perf_counter()
    out, per_step, counts = count_steps(
        run_accuracy.main, ["--epochs", "100", "--batch", "128", "--lr", "0.1", "--opt-policy",
                            "adam-linear", "--target-acc", "90", "--out", acc_path])
    ok = (accuracy_ok("[scripts] (c)", out, 100, per_step, n_convs)
                and out["best_val_top1"] >= 90.0 and out["time_to_target_s"] is not None)
    log(f"[scripts] (c) no-KD accuracy run (ACCURACY_r04.json's recipe) on {smi_line}: best "
        f"{out['best_val_top1']} at epoch {out['best_epoch']}, time to 90% "
        f"{out['time_to_target_s']} s, wall {out['wall_seconds']} s (script "
        f"{time.perf_counter() - t0:.1f}s); gap to the reference's CPU result "
        f"{REF_CPU_TOP1['no-kd']}: {out['best_val_top1'] - REF_CPU_TOP1['no-kd']:+.2f} points "
        f"(not gated); launches {counts} ok={ok}")
    return ok


def scripts_kd(out_dir: str, acc_path: str, smi_line: str) -> bool:
    from bdbnn_tpu_torch.scripts import run_kd

    n_convs = n_binary_convs("resnet20")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        kd, kd_steps, kd_counts = count_steps(
            run_kd.main, ["--workdir", work, "--teacher-epochs", "60", "--teacher-lr", "0.001",
                          "--epochs", "100", "--batch", "128", "--lr", "0.1", "--alpha", "0.9",
                          "--beta", "0.01", "--temperature", "4", "--no-kd-artifact", acc_path,
                          "--out", os.path.join(out_dir, "ACCURACY_ts.json")])
    want = step_want(n_convs)
    ok = (kd["best_val_top1"] >= 90.0 and kd["time_to_target_s"] is not None
                and kd["ts_loss_components_finite"] and kd["no_kd_reference"]["equal_recipe"]
                and bool(kd_steps) and all(c == want for c in kd_steps))
    log(f"[scripts] (d) KD accuracy run (ACCURACY_r05_ts.json's recipe) on {smi_line}: teacher "
        f"{kd['teacher']['best_val_top1']} in {kd['teacher']['wall_seconds']} s; student best "
        f"{kd['best_val_top1']} at epoch {kd['best_epoch']}, time to 90% "
        f"{kd['time_to_target_s']} s, wall {kd['student']['wall_seconds']} s (script "
        f"{time.perf_counter() - t0:.1f}s); components finite {kd['ts_loss_components_finite']}, "
        f"equal recipe {kd['no_kd_reference']['equal_recipe']}; gap to the reference's CPU "
        f"result {REF_CPU_TOP1['kd']}: {kd['best_val_top1'] - REF_CPU_TOP1['kd']:+.2f} points (not "
        f"gated); student steps {len(kd_steps)}, each {want}: "
        f"{all(c == want for c in kd_steps)}; launches (teacher's and student's) {kd_counts} "
        f"ok={ok}")
    return ok


def scripts_remat(out_dir: str, smi_line: str) -> bool:
    from bdbnn_tpu_torch.scripts import remat_ceiling

    t0 = time.perf_counter()
    reset_counts()
    remat_ceiling.PEAK_BYTES.clear()
    rc = remat_ceiling.main(["--max-batch", "8192", "--out-dir", out_dir])
    peaks = {f"{'with' if r else 'no'} remat at -b {b}": remat_ceiling.PEAK_BYTES.get((b, r))
             for b, r in ((rc["max_batch_no_remat"], False), (rc["max_batch_with_remat"], True))}
    after = remat_ceiling._try_batch(256, False)
    cost = rc["remat_throughput_cost"]
    ok = (rc["ceiling_gain"] > 1 and cost is not None and 0 < cost < 0.5
                and after is True)
    log(f"[scripts] (e) peak device memory (torch.cuda.max_memory_allocated) at the ceilings: "
        f"{ {k: (v, None if v is None else round(v / 2**30, 2)) for k, v in peaks.items()} } "
        f"(bytes, GiB)")
    log(f"[scripts] (e) remat ceiling on {smi_line}: {rc}; a step at -b 256 after the search "
        f"fits with a finite loss: {after}; {time.perf_counter() - t0:.1f}s; launches "
        f"{launch_counts()} ok={ok}")
    return ok


def scripts_dryrun() -> bool:
    import torch

    from bdbnn_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    dry = dryrun_multichip(4)
    launched = all(dry["launches"][k] > 0 for k in ("K1", "K2", "K5", "K6", "K7"))
    ok = (dry["mesh"] == {"data": 2, "model": 2} and dry["count"] == 5
                and dry["ckpt_by_rank"] == [True] * 4 and launched
                and all(math.isfinite(v) for v in (dry["loss"], dry["kurt"], dry["ts_loss"],
                                                   *dry["ts_components"].values())))
    log(f"[scripts] (f) dryrun_multichip(4) on {torch.cuda.get_device_name(0)}: {dry['line']}; "
        f"TS components {dry['ts_components']}; the four ranks' launches {dry['launches']}; "
        f"{time.perf_counter() - t0:.1f}s ok={ok}")
    return ok


# wall seconds of each phase of the whole run, logged at its end
_PHASE_S: dict = {}
_T_START = time.perf_counter()


def timed(name: str, fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    _PHASE_S[name] = round(time.perf_counter() - t0, 1)
    log(f"[timing] {name} {_PHASE_S[name]}s")
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16-kernels", action="store_true",
                    help="only build the kernels and run [train-bf16] (a): K1, K2, K5 and K6 in "
                         "their bf16 modes at the ten flagship shapes against their plain "
                         "versions and cuDNN's bf16 calls, then print their records as one JSON "
                         "line")
    ap.add_argument("--weight-kernels", action="store_true",
                    help="only build the kernels and hold and time K2, K3 and K7 (phases 1-3 "
                         "for them), then print their records as one JSON line; for comparing "
                         "two trees' weight kernels in one run")
    ap.add_argument("--serve-bench", action="store_true",
                    help="only build the kernels, write the flagship artifact and run the "
                         "[serve-bench] phase (about 90 s); exits 0 when its gates pass")
    ap.add_argument("--serve-http", action="store_true",
                    help="only build the kernels, write the flagship artifact and run the "
                         "[serve-http] phase (about 120 s); exits 0 when its gates pass")
    ap.add_argument("--serve-fleet", action="store_true",
                    help="only build the kernels, write the flagship artifact and run the "
                         "[serve-fleet] phase; exits 0 when its gates pass")
    ap.add_argument("--fleet-verdicts", default="", metavar="DIR",
                    help="also write each [serve-fleet] verdict into DIR (for the reference's "
                         "compare, which needs the JAX package, on another machine)")
    ap.add_argument("--health", action="store_true",
                    help="only build the kernels and run the [train-health] and "
                         "[serve-rollout] phases; exits 0 when their gates pass")
    ap.add_argument("--train-tp", action="store_true",
                    help="only build the kernels and run the [train-tp] phase (tensor "
                         "parallelism on the flagship); exits 0 when its gates pass")
    ap.add_argument("--perf", action="store_true",
                    help="only build the kernels, write the flagship artifact and run the "
                         "[perf] phase (and [train-health] (a)'s fit, whose window (b) "
                         "reads); exits 0 when its gates pass")
    ap.add_argument("--bench", action="store_true",
                    help="only build the kernels and run [bench] and [kernels] (c) (the bench "
                         "scripts); exits 0 when their gates pass")
    ap.add_argument("--search", action="store_true",
                    help="only build the kernels and run the [search] and [check] phases; exits "
                         "0 when their gates pass")
    ap.add_argument("--determinism", action="store_true",
                    help="only build the kernels and run [determinism]: the flagship CLI "
                         "straight through and SIGTERMed then resumed, from each --tree, and the "
                         "step's cost of cuDNN's deterministic algorithms")
    ap.add_argument("--scripts", action="store_true",
                    help="only build the kernels and run [scripts] and the twins' long runs: the "
                         "no-KD and KD accuracy runs to 90%%, the remat ceiling search and "
                         "dryrun_multichip(4)")
    ap.add_argument("--scripts-out", default="", metavar="DIR",
                    help="with --scripts: where the runs' outputs go (default: a temporary "
                         "directory)")
    ap.add_argument("--tree", action="append", default=[], metavar="DIR",
                    help="with --determinism: a checkout whose CLI to run (repeatable; default: "
                         "this one)")
    ap.add_argument("--trace-prefix", type=int, default=0, metavar="N",
                    help="only build the kernels and run [train-health] (a)'s fit 2N times, "
                         "without and with the profiler window's absorbing burst in turns; "
                         "exits 0 when no window opened with the burst lost a record")
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
    ok_sass = log_mma_instructions()

    if args.trace_prefix:
        return 0 if trace_prefix(args.trace_prefix, smi_line) else 1
    if args.determinism:
        ok_alone = phase_determinism(args.tree or [REPO], smi_line)
        if not ok_alone:
            print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 0 if ok_alone else 1
    if args.scripts:
        ok_alone = timed("scripts", phase_scripts)[1]
        with tempfile.TemporaryDirectory() as tmp:
            ok_alone = phase_scripts_long(args.scripts_out or tmp, smi_line) and ok_alone
        if not ok_alone:
            print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 0 if ok_alone else 1
    if args.bench:
        ok_alone = timed("bench", phase_bench, smi_line)[1]
        ok_alone = timed("bench_kernels", bench_kernels_rows) and ok_alone
        if not ok_alone:
            print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 0 if ok_alone else 1
    if args.search:
        ok_alone = phase_search(smi_line)[1]
        ok_alone = phase_check() and ok_alone
        if not ok_alone:
            print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 0 if ok_alone else 1
    if args.train_tp:
        ok_alone = phase_train_tp(smi_line)[1]
        if not ok_alone:
            print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 0 if ok_alone else 1
    if args.perf:
        with tempfile.TemporaryDirectory() as tmp:
            art = os.path.join(tmp, "resnet18_react")
            make_flagship_artifact(art)
            _, ok_alone = phase_perf(art, smi_line)
        thresholds = [x for t in HEALTH_FORCED for x in ("--health-threshold", t)]
        a = health_fit(fresh_log_root(), ["--health-forensics-steps", str(HEALTH_FORENSICS_STEPS),
                                          *thresholds])
        ok_alone = phase_perf_summarize(a["run_dir"]) and a["rc"] == 0 and ok_alone
        if not ok_alone:
            print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 0 if ok_alone else 1
    if args.serve_bench or args.serve_http or args.serve_fleet or args.health:
        with tempfile.TemporaryDirectory() as tmp:
            art = os.path.join(tmp, "resnet18_react")
            make_flagship_artifact(art)
            if args.serve_bench:
                _, ok_alone, _ = phase_serve_bench(art, smi_line)
            elif args.serve_http:
                _, ok_alone = phase_serve_http(art, smi_line)
            elif args.serve_fleet:
                _, ok_alone = phase_serve_fleet(art, smi_line, args.fleet_verdicts)
            else:
                ok_alone = phase_serve_rollout(art, smi_line)[1]
                ok_alone = phase_train_health(smi_line)[1] and ok_alone
        if not ok_alone:
            print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 0 if ok_alone else 1
    if args.bf16_kernels:
        brecs, ok_b = timed("bf16_kernels", bf16_kernels, "[train-bf16]", pk)
        ok_b = ok_b and ok_sass
        print(json.dumps({"bf16_kernels": brecs, "device": kind, "nvidia_smi": smi_line}),
              flush=True)
        if not ok_b:
            print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 0 if ok_b else 1
    if args.weight_kernels:
        wrecs, ok_w = phase_weight_kernels(pk)
        wrecs["K7"], ok_k7 = phase_k7(pk)
        print(json.dumps({"weight_kernels": wrecs, "device": kind, "nvidia_smi": smi_line}),
              flush=True)
        return 0 if ok_w and ok_k7 else 1
    recs, ok_k = timed("kernels", phase_kernels, pk)
    wrecs, ok_w = timed("weight_kernels", phase_weight_kernels, pk)
    recs.update(wrecs)
    trecs, ok_tk = timed("train_kernels", phase_train_kernels, pk)
    recs.update(trecs)
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "resnet18_react")
        t0 = time.perf_counter()
        make_flagship_artifact(art)
        log(f"[main] wrote flagship artifact in {time.perf_counter() - t0:.1f}s")
        counts, ok_m = timed("main", phase_main, art)
        ok_c = timed("cli", phase_cli, art)
        sb_counts, ok_sb, sb_thr = timed("serve-bench", phase_serve_bench, art, smi_line)
        sh_counts, ok_sh = timed("serve-http", phase_serve_http, art, smi_line, sb_thr)
        sr_counts, ok_sr = timed("serve-rollout", phase_serve_rollout, art, smi_line)
        sf_counts, ok_sf = timed("serve-fleet", phase_serve_fleet, art, smi_line,
                                 args.fleet_verdicts)
        perf_counts, ok_pf = timed("perf", phase_perf, art, smi_line)
    train_counts, _, ok_t = timed("train", phase_train)
    timed("host_input", time_host_input)
    ok_tp = timed("train_parity", phase_train_parity)
    ok_te = timed("train_cede", phase_train_cede)
    ok_tc = timed("train_cli", phase_train_cli)
    f32_prof = timed("profile", profile_train_step)
    stoch_counts, ok_ts = timed("train-stoch", phase_train_stoch, pk)
    ts_counts, ok_tts = timed("train-ts", phase_train_ts)
    resume_counts, ok_tr = timed("train-resume", phase_train_resume, pk)
    bench_counts, ok_bn, bench_rate = timed("bench", phase_bench, smi_line)
    folder_counts, ok_tf = timed("train-folder", phase_train_folder, smi_line, bench_rate)
    bf16_counts, brecs, ok_tb = timed("train-bf16", phase_train_bf16, pk, f32_prof)
    recs.update(brecs)
    ddp_counts, ok_td = timed("train-ddp", phase_train_ddp, smi_line)
    tp_counts, ok_ttp = timed("train-tp", phase_train_tp, smi_line)
    th_counts, ok_th, th_dir = timed("train-health", phase_train_health, smi_line)
    ok_pf = timed("perf_summarize", phase_perf_summarize, th_dir) and ok_pf
    search_counts, ok_se = timed("search", phase_search, smi_line)
    ok_ck = timed("check", phase_check)
    scripts_counts, ok_sc = timed("scripts", phase_scripts)
    log(f"[timing] phase seconds {_PHASE_S}; whole script "
        f"{time.perf_counter() - _T_START:.1f}s")

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
    # both ranks' launches summed), on the tensor-parallel job's two ranks
    # (K1, K2, K5-K7 on the shards, both ranks summed), and on the serve-bench runs (K1-K4; the
    # sum over its runs), and on the serve-http runs (K1-K3; the sum over
    # its runs and its in-process profiled load), and on the serve-fleet
    # hosts (K1-K3; the sum over the hosts that exited cleanly and wrote
    # their counters: the SIGKILLed host's are unknown), and on the perf
    # command's sweep (K1-K4; its warmups and unmeasured forwards
    # included), and on the clean recipe search's trial processes (K1,
    # K2, K5, K6, K7; the sum over its four trials), and on the bench
    # script's worker in [bench] (a) (K1, K2, K5-K7; its bf16 and f32
    # stages summed), and on [scripts] (a)'s accuracy run and (b)'s two
    # remat tries (K1, K2, K5-K7; the bf16 modes in (b)). A bf16 mode's record (K1 bf16, ...) counts that mode's
    # launches: on the bf16 flagship's path, its remat run, the bf16
    # BASELINE config 4 run, the bf16 artifact's serving and the bench's
    # bf16 stage
    by_path = {k: {"serve": counts.get(k, 0), "serve-bench": sb_counts.get(k, 0),
                   "serve-http": sh_counts.get(k, 0),
                   "serve-rollout": sr_counts.get(k, 0),
                   "serve-fleet": sf_counts.get(k, 0),
                   "train": train_counts.get(k, 0),
                   "train-stoch": stoch_counts.get(k, 0), "train-ts": ts_counts.get(k, 0),
                   "train-resume": resume_counts.get(k, 0),
                   "train-folder": folder_counts.get(k, 0),
                   "train-bf16": bf16_counts["train-bf16"].get(k, 0),
                   "train-ddp": ddp_counts.get(k, 0),
                   "train-tp": tp_counts.get(k, 0),
                   "train-health": th_counts.get(k, 0),
                   "perf": perf_counts.get(k, 0),
                   "search": search_counts.get(k, 0),
                   "bench": bench_counts.get(k, 0),
                   "scripts": scripts_counts.get(k, 0)}
               for k in sources}
    for k in BF16_KERNELS:
        sources[f"{k} bf16"], replaces[f"{k} bf16"] = sources[k], replaces[k]
    sources["K1 bf16"] = "bdbnn_tpu_torch/csrc/binary_conv_fwd_bf16.cu"
    sources["K5 bf16"] = "bdbnn_tpu_torch/csrc/binary_conv_dgrad_bf16.cu"
    sources["K6 bf16"] = "bdbnn_tpu_torch/csrc/binary_conv_wgrad_bf16.cu"
    for k in BF16_KERNELS:
        names[f"{k} bf16"] = names[k].replace(" (", " bf16 mode (", 1)
        by_path[f"{k} bf16"] = {path: c.get(f"{k} bf16", 0) for path, c in bf16_counts.items()}
        by_path[f"{k} bf16"]["train-ddp"] = ddp_counts.get(f"{k} bf16", 0)
        by_path[f"{k} bf16"]["train-tp"] = tp_counts.get(f"{k} bf16", 0)
        by_path[f"{k} bf16"]["serve-bench"] = sb_counts.get(f"{k} bf16", 0)
        by_path[f"{k} bf16"]["bench"] = bench_counts.get(f"{k} bf16", 0)
        by_path[f"{k} bf16"]["scripts"] = scripts_counts.get(f"{k} bf16", 0)
    used = {k: by_path[k]["serve" if k in ("K1", "K2", "K3", "K4") else "train"] for k in sources
            if k in recs and not k.endswith("bf16")}
    used.update({f"{k} bf16": by_path[f"{k} bf16"]["train-bf16"] for k in BF16_KERNELS})
    ok_used = all(v > 0 for v in used.values()) and all(
        by_path[k][path] > 0 for k in ("K1", "K2", "K5", "K6", "K7")
        for path in ("train", "train-stoch", "train-ts", "train-resume", "train-folder",
                     "train-bf16", "train-ddp", "train-tp", "train-health")) and all(
        by_path[k]["serve-bench"] > 0 for k in ("K1", "K2", "K3", "K4", "K1 bf16", "K2 bf16")) and all(
        by_path[k]["serve-http"] > 0 and by_path[k]["serve-rollout"] > 0
        and by_path[k]["serve-fleet"] > 0 for k in ("K1", "K2", "K3")) and all(
        by_path[k]["perf"] > 0 for k in ("K1", "K2", "K3", "K4")) and all(
        by_path[k]["search"] > 0 for k in ("K1", "K2", "K5", "K6", "K7")) and all(
        by_path[k][path] > 0 for path in ("bench", "scripts")
        for k in ("K1", "K2", "K5", "K6", "K7", "K1 bf16", "K2 bf16", "K5 bf16", "K6 bf16"))
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
    oks = {"build": ok_sass, "kernels": ok_k, "weight_kernels": ok_w, "main": ok_m, "cli": ok_c,
           "serve_bench": ok_sb, "serve_http": ok_sh, "serve_rollout": ok_sr,
           "serve_fleet": ok_sf,
           "train_kernels": ok_tk, "train": ok_t, "train_parity": ok_tp, "train_cede": ok_te,
           "train_cli": ok_tc, "train_stoch": ok_ts, "train_ts": ok_tts, "train_resume": ok_tr,
           "train_folder": ok_tf, "train_bf16": ok_tb, "train_ddp": ok_td,
           "train_tp": ok_ttp, "train_health": ok_th, "perf": ok_pf, "search": ok_se,
           "check": ok_ck, "bench": ok_bn, "scripts": ok_sc, "launched": ok_used}
    if not all(oks.values()):
        log(f"chip_smoke: FAILED {oks}")
        print("\n".join(_FAILURES), file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


@contextlib.contextmanager
def shared_bytecode_cache():
    """Let this process and every Python process it starts share compiled
    bytecode in a temporary directory (``PYTHONPYCACHEPREFIX``), removed on
    exit. Where the environment turns bytecode writing off
    (``PYTHONDONTWRITEBYTECODE``) and the installed packages ship no
    ``.pyc`` files, each process otherwise compiles torch's sources anew
    (about 6 s a process on the card's machine); the script starts dozens
    of them (CLI runs, ranks, trials, serving hosts). Nothing is written
    beside the installed sources. A prefix set by the caller is kept."""
    if os.environ.get("PYTHONPYCACHEPREFIX"):
        yield
        return
    import shutil

    prefix = tempfile.mkdtemp(prefix="chip_smoke_pyc-")
    saved = (sys.pycache_prefix, sys.dont_write_bytecode,
             os.environ.pop("PYTHONDONTWRITEBYTECODE", None))
    sys.pycache_prefix, sys.dont_write_bytecode = prefix, False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    try:
        yield
    finally:
        sys.pycache_prefix, sys.dont_write_bytecode = saved[0], saved[1]
        os.environ.pop("PYTHONPYCACHEPREFIX", None)
        if saved[2] is not None:
            os.environ["PYTHONDONTWRITEBYTECODE"] = saved[2]
        shutil.rmtree(prefix, ignore_errors=True)


if __name__ == "__main__":
    with shared_bytecode_cache():
        code = main()
    sys.exit(code)
