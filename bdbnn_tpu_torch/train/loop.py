"""Training orchestration — ``bdbnn_tpu/train/loop.py``'s ``fit``
(``_fit``, ``_train_epoch``, ``_validate``, ``_Resilience``) on the port.

:func:`fit` builds the datasets (synthetic or CIFAR), the model from the
registry with an explicit ``torch.Generator(seed)``, the optimizer, the
kurtosis hooks and targets and the :class:`StepConfig`; then runs the
epoch loop with the binarizer family's schedule and the kurtosis gate,
and the eval pass at each epoch's end. Metrics stay on the device and
are drained once every ``print_freq`` steps. It runs on the CUDA card
unless ``cfg.device`` is "cpu", and raises without a card.

The run dir is the reference's, ``<log_path>/<kurtosis_target>/<stamp>/``:
``log.txt``, ``scalars.jsonl``, ``manifest.json`` (with the restart
lineage of a resumed run), ``events.jsonl`` (rotated past
``--events-max-mb``), ``checkpoint/`` (+ ``.old``) and ``model_best/``.
A checkpoint is committed at each epoch's end, every
``--save-every-steps`` steps or ``--save-every-mins`` minutes, and on
SIGTERM/SIGINT, after which :class:`PreemptedError` is raised (the CLI
exits 75). ``--resume`` takes a run dir or a checkpoint dir (model,
optimizer, step, cursor, best, host RNG: the resumed run is bitwise the
uninterrupted one, since the draws and the LR are keyed by the step and
the batches by (seed, epoch, index)) or a reference-format ``.pth`` /
``.pth.tar`` (weights, and the LR step fast-forwarded to the epoch).
``--pretrained`` initializes the student from a float torchvision-layout
file, and ``--resume_teacher`` takes a port run dir too.

A teacher–student run (``--imagenet_setting_step_2_ts``) adds the frozen
float teacher of :func:`build_teacher` and the layer-KL conv pairs of
:func:`match_kd_pairs`, and trains with
:func:`~bdbnn_tpu_torch.train.step.make_ts_train_step`.

ImageNet trains from an image folder (``DATA/train``, ``DATA/val``)
through worker processes or a thread pool (``--input-backend``, ``-j``;
:meth:`RunConfig.input_engine`); the pools close on every exit of
:func:`fit`, a substituted undecodable image is a ``data_error`` event,
and ``--device-normalize`` sends uint8 to the card, where the step
normalizes it.

``--dtype bfloat16`` builds the student and the teacher as bf16 models
(the kernels' bf16 modes; parameters, optimizer state and running
statistics f32, so the losses and the kurtosis run on f32 logits and f32
latent weights); ``--remat`` recomputes each residual block in the
backward (``models/resnet.py``).

A data-parallel job (``--distributed-init`` from torchrun's environment,
or a process group already up when :func:`fit` starts) trains one global
batch of ``batch_size`` over W ranks, each feeding ``batch_size // W`` rows
of its shard (:mod:`bdbnn_tpu_torch.parallel`): global BatchNorm
statistics, one averaged gradient, metrics and eval totals summed over
the ranks once per drain, every rank running the same number of eval
batches. The job writes one run dir (rank 0's timestamp): rank 0 writes
``log.txt``, ``scalars.jsonl``, ``events.jsonl``, the manifest and the
checkpoints, rank r > 0 its own ``log.p{r}.txt``, ``scalars.p{r}.jsonl``
and ``events.p{r}.jsonl``. At every step boundary the ranks agree on
(signal, cadence) with one MAX all-reduce, so a SIGTERM that reaches one
rank makes every rank save the same step and exit; only rank 0's clock
feeds ``--save-every-mins``. A checkpoint records its writer's topology
and restores onto any number of ranks (the (epoch, step) cursor is
global), with ``resharded`` in the ``restore`` event when the layout
changed.

Not in this slice (``RunConfig.validate`` raises for each option, naming
its ROADMAP item): profiling windows and the ``memory`` event (item 7),
tensor parallelism (item 9). The health monitor (item 7) is not ported: a
run with ``cfg.health`` on (the default) says so in one warning.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from bdbnn_tpu_torch import resolve_device
from bdbnn_tpu_torch.data import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    CIFAR_MEAN,
    CIFAR_STD,
    ImageFolder,
    ImageFolderPipeline,
    MPImageFolderPipeline,
    Pipeline,
    load_cifar10,
    load_cifar100,
    normalize,
    synthetic_dataset,
)
from bdbnn_tpu_torch.losses.kd import match_conv_pairs
from bdbnn_tpu_torch.losses.kurtosis import resolve_targets
from bdbnn_tpu_torch.models import (
    conv_weight_hwio,
    conv_weight_paths,
    convert_torch_state_dict,
    create_model,
    get_by_path,
    load_state_dict_strict,
    load_torch_checkpoint,
    module_path_str,
    overlay_state_dict,
)
from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
from bdbnn_tpu_torch.obs.events import EventWriter
from bdbnn_tpu_torch.obs.manifest import read_manifest, write_manifest
from bdbnn_tpu_torch.obs.probes import NonFiniteLossError, drain_probe_report
from bdbnn_tpu_torch.obs.timing import StepPhaseTimer
from bdbnn_tpu_torch.parallel import (
    Mesh,
    broadcast_host_int,
    coordinate_flags,
    create_sharded_state,
    initialize_distributed,
    make_mesh,
    resharded,
    sum_host_values,
    topology,
)
from bdbnn_tpu_torch.train.config import OBS, RunConfig
from bdbnn_tpu_torch.train.ede import cpt_tk
from bdbnn_tpu_torch.train.optim import make_optimizer
from bdbnn_tpu_torch.train.resilience import CheckpointPolicy, PreemptedError, PreemptionHandler
from bdbnn_tpu_torch.train.state import StepConfig, TrainState
from bdbnn_tpu_torch.train.step import make_eval_step, make_train_step, make_ts_train_step
from bdbnn_tpu_torch.utils.checkpoint import (
    PAYLOAD_NAME,
    _candidate_dirs,
    checkpoint_bytes,
    load_checkpoint,
    load_variables,
    read_resume_state,
    save_checkpoint,
)
from bdbnn_tpu_torch.utils.logging_utils import ScalarWriter, make_log_dir, setup_logger
from bdbnn_tpu_torch.utils.meters import DeviceMetrics, Mean, ProgressLog, Throughput, format_eta

logger = logging.getLogger("bdbnn_tpu_torch.train")


def shape_tree(model: torch.nn.Module) -> dict:
    """The model's parameters as a flax-layout tree of shape stand-ins
    (``.ndim``/``.shape``), for the path utilities."""
    tree: dict = {}
    for name, p in model.named_parameters():
        node = tree
        *mods, leaf = name.split(".")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = p.detach()
    return tree


def select_hooked_paths(params, cfg: RunConfig):
    """Kurtosis hook selection (↔ the reference's): ``weight_name`` of
    ``('all',)`` hooks every conv weight but the first, minus
    ``remove_weight_name`` matches; otherwise the named layers."""
    paths = conv_weight_paths(params)
    by_name = {module_path_str(p): p for p in paths}
    if "all" in cfg.weight_name:
        selected = [module_path_str(p) for p in paths[1:]]
        selected = [n for n in selected if not any(rm in n for rm in cfg.remove_weight_name)]
    else:
        selected = [n for n in cfg.weight_name if n in by_name]
    return tuple(by_name[n] for n in selected)


def build_datasets(cfg: RunConfig, *, val_only: bool = False, mesh: Mesh = Mesh()):
    """(train pipeline, val pipeline, image size), as the reference
    builds them: synthetic images from seeds 1 (train) and 2 (val), with
    ImageNet normalization for ``imagenet``; the CIFAR splits; or the
    image folders ``cfg.data/train`` and ``cfg.data/val`` under
    :meth:`RunConfig.input_engine`'s backend. A missing data dir raises
    ``FileNotFoundError``. ``val_only`` (``cli predict``) builds no train
    split and returns None in its place. On a ``mesh`` of W ranks each
    pipeline is this rank's shard at ``batch_size // W`` a step (W must
    divide the global batch)."""
    if cfg.batch_size % mesh.data:
        raise ValueError(f"-b {cfg.batch_size} is the global batch: {mesh.data} ranks must "
                         "divide it")
    image_size = 224 if cfg.dataset == "imagenet" else 32
    seed = cfg.seed or 0
    shard = dict(host_id=mesh.rank, num_hosts=mesh.data)
    batch = cfg.batch_size // mesh.data
    if cfg.synthetic:
        transform = None
        if cfg.dataset == "imagenet":
            transform = lambda im, rng: normalize(im, IMAGENET_MEAN, IMAGENET_STD)
        mk = lambda ds, train: Pipeline(
            ds, batch, train=train, transform=transform, seed=seed, prefetch=2, **shard
        )
        val_ds = synthetic_dataset(cfg.synthetic_val_size, image_size, cfg.num_classes, seed=2)
        if val_only:
            return None, mk(val_ds, False), image_size
        train_ds = synthetic_dataset(cfg.synthetic_train_size, image_size, cfg.num_classes, seed=1)
        return mk(train_ds, True), mk(val_ds, False), image_size
    if cfg.dataset in ("cifar10", "cifar100"):
        loader = load_cifar10 if cfg.dataset == "cifar10" else load_cifar100
        try:
            train_ds = None if val_only else loader(cfg.data, "train")
            val_ds = loader(cfg.data, "test")
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"{cfg.dataset} data not found under {cfg.data!r} ({e}); "
                "pass a valid --data dir, or --synthetic for a smoke run"
            ) from e
        mk = lambda ds, train: Pipeline(
            ds, batch, train=train, seed=seed, prefetch=2,
            device_normalize=cfg.device_normalize, **shard,
        )
        return (None if val_only else mk(train_ds, True)), mk(val_ds, False), image_size
    backend, workers = cfg.input_engine()
    cls, extra = ((MPImageFolderPipeline, {"num_workers": workers}) if backend == "mp"
                  else (ImageFolderPipeline, {}))
    mk = lambda split, train: cls(
        ImageFolder(os.path.join(cfg.data, split)), batch, train=train, seed=seed,
        device_normalize=cfg.device_normalize, **shard, **extra,
    )
    try:
        train_pipe = None if val_only else mk("train", True)
        val_pipe = mk("val", False)
    except (FileNotFoundError, OSError) as e:
        raise FileNotFoundError(
            f"imagenet data not found under {cfg.data!r} ({e}); "
            "pass a valid --data dir, or --synthetic for a smoke run"
        ) from e
    return train_pipe, val_pipe, image_size


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: through pinned memory, without waiting
    for the card, when that is a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _apply_nonfinite_policy(policy: str, events, msg: str, **fields) -> None:
    """``cfg.nonfinite_policy`` at a detection site: record the event,
    then raise / warn / stay silent."""
    if events is not None:
        events.emit("nonfinite", policy=policy, message=msg, **fields)
    if policy == "raise":
        raise NonFiniteLossError(
            msg + " (nonfinite_policy='raise'; pass --nonfinite-policy warn to keep going)"
        )
    if policy == "warn":
        logger.warning("%s (nonfinite_policy='warn')", msg)


@dataclasses.dataclass
class ObsHooks:
    """What the epoch loop reports into: the event channel, the scalar
    writer, the step-phase timer, the probe sizes, the non-finite policy,
    and the mesh whose ranks' metrics are summed at each drain."""

    events: EventWriter
    writer: ScalarWriter
    timer: StepPhaseTimer
    probe_sizes: Dict[str, int]
    nonfinite_policy: str
    mesh: Mesh = Mesh()


# drained metric sums over the ranks: counts and example sums add up;
# the per-rank loss means ("loss", "loss_*") average; the rest (the grad
# norm, the binarization probes) are computed from replicated weights
# and gradients, the same on every rank
_SUMMED = ("loss_sum", "top1", "top5", "count", "nonfinite")


def global_sums(sums: Dict[str, float], mesh: Mesh) -> Dict[str, float]:
    """A drain's metric sums over every rank of ``mesh`` (one collective;
    the sums as they are on a mesh of one)."""
    if not mesh.collective:
        return sums
    keys = sorted(k for k in sums if k in _SUMMED or k.startswith("loss"))
    total = sum_host_values([sums[k] for k in keys], mesh)
    out = dict(sums)
    for k, v in zip(keys, total.tolist()):
        out[k] = v if k in _SUMMED else v / mesh.data
    return out


def _interval_observe(obs: ObsHooks, epoch, step_idx, interval_steps, sums, n, rate, probe_m):
    """Drain-time telemetry on the already-fetched sums: the non-finite
    check, the per-layer probes and the ``train_interval`` event."""
    bad = int(sums.get("nonfinite", 0))
    if bad:
        _apply_nonfinite_policy(
            obs.nonfinite_policy, obs.events,
            f"non-finite train loss in {bad}/{interval_steps} step(s) of the interval ending "
            f"at epoch {epoch} step {step_idx}",
            epoch=epoch, step=step_idx, bad_steps=bad, where="train",
        )
    flip_rate, kurt = drain_probe_report(sums, obs.probe_sizes, interval_steps)
    for name, v in flip_rate.items():
        probe_m.setdefault(f"Probe flip {name}", Mean(name)).add(v, interval_steps)
    for name, v in kurt.items():
        probe_m.setdefault(f"Probe kurt {name}", Mean(name)).add(v, interval_steps)
    obs.events.emit(
        "train_interval",
        epoch=epoch,
        step=step_idx,
        steps=interval_steps,
        loss=round(sums["loss_sum"] / n, 6),
        top1=round(100.0 * sums["top1"] / n, 3),
        img_per_s=round(rate, 2),
        **({"grad_norm": round(sums["grad_norm"] / interval_steps, 6)}
           if "grad_norm" in sums else {}),
        **obs.timer.snapshot(),
        **({"flip_rate": {k: round(v, 8) for k, v in flip_rate.items()}} if flip_rate else {}),
        **({"kurtosis": {k: round(v, 4) for k, v in kurt.items()}} if kurt else {}),
    )


def _add_component_means(comp_m, sums, interval_steps) -> None:
    """Fold the drained loss-component sums (``loss_ce``, ``loss_kl*``,
    ``loss_kurt``, ..., ``grad_norm``) into host meters."""
    if not interval_steps:
        return
    for key, val in sums.items():
        if (key.startswith("loss_") and key != "loss_sum") or key == "grad_norm":
            comp_m.setdefault(key, Mean(key)).add(val / interval_steps, interval_steps)


def _train_epoch(train_step, state, pipe, epoch, tk, kurt_gate, cfg, steps_per_epoch, device,
                 obs: ObsHooks, on_step=None, start_step: int = 0, resil=None):
    """One epoch from batch ``start_step``. The loop never waits for the
    device but at the drain every ``print_freq`` steps; the telemetry
    rides the same drains. After each step but the epoch's last,
    ``resil.after_step`` may checkpoint (cadence) or checkpoint and raise
    (preemption)."""
    devmet = DeviceMetrics()
    loss_m, top1_m, top5_m = Mean("Loss", "{:.4e}"), Mean("Acc@1", "{:6.2f}"), Mean("Acc@5", "{:6.2f}")
    comp_m: Dict[str, Mean] = {}
    probe_m: Dict[str, Mean] = {}
    thr = Throughput()
    progress = ProgressLog(steps_per_epoch, logger, prefix=f"Epoch: [{epoch}]")
    timer = obs.timer
    t_epoch = time.time()
    timer.reset()

    def drain(step_idx):
        interval_steps = devmet.pending_steps
        t_mark = time.perf_counter()
        # the one host sync of the interval, and one collective of a job
        sums = global_sums(devmet.drain(), obs.mesh)
        timer.add("drain", time.perf_counter() - t_mark)
        n = max(sums["count"], 1.0)
        _add_component_means(comp_m, sums, interval_steps)
        loss_m.add(sums["loss_sum"] / n, n)
        top1_m.add(100.0 * sums["top1"] / n, n)
        top5_m.add(100.0 * sums["top5"] / n, n)
        rate = thr.tick(n)
        _interval_observe(obs, epoch, step_idx, interval_steps, sums, n, rate, probe_m)
        progress.emit(step_idx, [loss_m.render(), top1_m.render(), top5_m.render(),
                                 f"img/s {rate:8.1f}"])
        sec_per_step = (time.time() - t_epoch) / max(step_idx + 1 - start_step, 1)
        remain = (cfg.epochs - epoch) * steps_per_epoch - step_idx
        logger.info(">>>>>>>>>>>> Remaining Time: %s <<<<<<<<<<<<", format_eta(remain * sec_per_step))

    if hasattr(pipe, "on_data_error"):
        # a substituted undecodable image is an event, not a dead run
        pipe.on_data_error = lambda info: obs.events.emit("data_error", epoch=epoch, **info)
    it = pipe.epoch(epoch, start_step)
    step_idx = start_step - 1
    try:
        # every rank runs steps_per_epoch steps, though the first ranks'
        # shards may hold one batch more
        while step_idx + 1 < steps_per_epoch:
            t_mark = time.perf_counter()
            try:
                x, y = next(it)
            except StopIteration:
                break
            step_idx += 1
            timer.add("data_wait", time.perf_counter() - t_mark)
            t_mark = time.perf_counter()
            state, m = train_step(state, (to_device(x, device), to_device(y, device)), tk,
                                  kurt_gate)
            devmet.add(m)
            t_done = time.perf_counter()
            timer.add("dispatch", t_done - t_mark)
            if timer.compile_s is None:
                # the process's first step: on the card it loads and first
                # launches the kernels
                timer.record_compile(t_done - t_mark)
                obs.events.emit("compile", seconds=round(t_done - t_mark, 3))
            if on_step is not None:
                on_step(epoch, step_idx, m)
            if step_idx % cfg.print_freq == 0:
                drain(step_idx)
            # a step boundary: the state is consistent and saveable (the
            # epoch's last step is followed by the epoch-end save instead)
            if resil is not None and step_idx + 1 < steps_per_epoch:
                resil.after_step(state, epoch, step_idx + 1)
    finally:
        it.close()
    if devmet.pending_steps:
        drain(step_idx)
    writer = obs.writer
    writer.add_scalar("Train Loss", loss_m.mean, epoch)
    writer.add_scalar("Train Acc1", top1_m.mean, epoch)
    writer.add_scalar("Train Acc5", top5_m.mean, epoch)
    writer.add_scalar("Train img/s/chip", thr.cumulative, epoch)
    for key, meter in sorted(comp_m.items()):
        writer.add_scalar(f"Train {key}", meter.mean, epoch)
    for key, meter in sorted(probe_m.items()):
        writer.add_scalar(key, meter.mean, epoch)
    obs.events.emit("epoch", epoch=epoch, loss=round(loss_m.mean, 6), top1=round(top1_m.mean, 3),
                    img_per_s_chip=round(thr.cumulative, 2),
                    wall_s=round(time.time() - t_epoch, 3))
    return state


def _validate(eval_step, state, pipe, device, epoch, obs: ObsHooks,
              fill_dtype=np.float32) -> float:
    """Top-1 over the val split: fixed-shape padded batches, sums on the
    device, one fetch (and one sum over the ranks of a job, each of which
    runs ``pipe.eval_steps()`` batches: a rank whose shard ran out feeds
    fully masked batches of ``fill_dtype``); the ``eval`` event, whose
    ``count`` is the whole split, and the Val scalars."""
    bs = pipe.batch_size
    totals = None
    it = pipe.epoch(0)
    for _ in range(pipe.eval_steps()):
        try:
            x, y = next(it)
        except StopIteration:
            x = np.zeros((0, *pipe.image_shape), fill_dtype)
            y = np.zeros((0,), np.int64)
        n = len(x)
        valid = np.zeros((bs,), np.float32)
        valid[:n] = 1.0
        if n < bs:
            x = np.concatenate([x, np.zeros((bs - n, *x.shape[1:]), x.dtype)])
            y = np.concatenate([y, np.zeros((bs - n,), y.dtype)])
        m = eval_step(state, (to_device(x, device), to_device(y, device),
                              to_device(valid, device)))
        totals = m if totals is None else {k: totals[k] + v for k, v in m.items()}
    got = {k: float(v) for k, v in totals.items()} if totals else {}
    keys = sorted(got)
    got = dict(zip(keys, sum_host_values([got[k] for k in keys], obs.mesh).tolist()))
    count = max(got.get("count", 0.0), 1.0)
    acc1 = 100.0 * got.get("top1", 0.0) / count
    acc5 = 100.0 * got.get("top5", 0.0) / count
    loss = got.get("loss_sum", 0.0) / count
    logger.info(" * Acc@1 %.3f Acc@5 %.3f (val loss %.4f)", acc1, acc5, loss)
    obs.writer.add_scalar("Val Loss", loss, epoch)
    obs.writer.add_scalar("Val Acc1", acc1, epoch)
    obs.writer.add_scalar("Val Acc5", acc5, epoch)
    obs.events.emit("eval", epoch=epoch, acc1=round(acc1, 4), acc5=round(acc5, 4),
                    loss=round(loss, 6), count=int(got.get("count", 0.0)))
    if obs.nonfinite_policy != "ignore" and not np.isfinite(loss):
        _apply_nonfinite_policy(obs.nonfinite_policy, obs.events,
                                f"non-finite validation loss at epoch {epoch}",
                                epoch=epoch, where="eval")
    return acc1


def build_training(cfg: RunConfig, device: torch.device, steps_per_epoch: int, image_size: int):
    """(state, StepConfig) of a run: the seeded model on ``device``, the
    optimizer, hooked paths, targets and probes."""
    family = resolve_family(cfg.binarizer, ede=cfg.ede)
    gen = torch.Generator().manual_seed(cfg.seed or 0)
    model = create_model(
        cfg.arch, cfg.dataset, dtype=cfg.dtype, twoblock=cfg.twoblock, remat=cfg.remat,
        generator=gen,
    ).to(device)
    opt = make_optimizer(
        model, dataset=cfg.dataset, lr=cfg.lr, epochs=cfg.epochs,
        steps_per_epoch=steps_per_epoch, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, policy=cfg.opt_policy,
    )
    tree = shape_tree(model)
    hooked = select_hooked_paths(tree, cfg) if cfg.w_kurtosis else ()
    targets = (
        resolve_targets(len(hooked), scalar_target=cfg.w_kurtosis_target,
                        diffkurt=cfg.diffkurt, dataset=cfg.dataset,
                        teacher_student=cfg.teacher_student)
        if hooked else ()
    )
    probe_paths: tuple = ()
    if cfg.probe_binarization and not cfg.arch.endswith("_float"):
        probe_paths = hooked or tuple(conv_weight_paths(tree)[1:])
    input_norm = None
    if cfg.device_normalize:
        mean, std = (
            (IMAGENET_MEAN, IMAGENET_STD) if cfg.dataset == "imagenet" else (CIFAR_MEAN, CIFAR_STD)
        )
        input_norm = (tuple(map(float, mean)), tuple(map(float, std)))
    step_cfg = StepConfig(
        w_kurtosis=cfg.w_kurtosis,
        kurt_paths=hooked,
        kurt_targets=tuple(targets),
        kurtosis_mode=cfg.kurtosis_mode,
        w_lambda_kurtosis=cfg.w_lambda_kurtosis,
        w_l2_reg=cfg.w_l2_reg,
        w_lambda_l2=cfg.w_lambda_l2,
        w_wr_reg=cfg.w_wr_reg,
        w_lambda_wr=cfg.w_lambda_wr,
        teacher_student=cfg.teacher_student,
        react=cfg.react,
        alpha=cfg.alpha,
        beta=cfg.beta,
        temperature=cfg.temperature,
        w_lambda_ce=cfg.w_lambda_ce,
        ede=cfg.ede,
        binarizer=family.name,
        binarizer_schedule=family.schedule_len > 0,
        binarizer_stochastic=family.stochastic,
        rng_seed=cfg.seed or 0,
        input_norm=input_norm,
        log_grad_norm=True,
        probe_paths=probe_paths,
        probe_names=tuple(module_path_str(p) for p in probe_paths),
        track_nonfinite=cfg.nonfinite_policy != "ignore",
    )
    return TrainState(model=model, optimizer=opt, step=0), step_cfg


def build_teacher(cfg: RunConfig, device: torch.device) -> torch.nn.Module:
    """The frozen float teacher (↔ the reference's ``build_teacher``):
    ``cfg.arch_teacher`` loaded strictly from ``cfg.resume_teacher`` — a
    torch ``.pth.tar`` in torchvision's layout, or a port run dir or
    checkpoint dir (its ``model_best`` preferred, :func:`load_variables`)
    — every parameter ``requires_grad=False``, in eval mode. Without a
    checkpoint a teacher–student run raises unless
    ``cfg.allow_random_teacher`` (seed 0's weights): distilling from a
    random teacher is a meaningless run."""
    teacher = create_model(cfg.arch_teacher, cfg.dataset, dtype=cfg.dtype,
                           generator=torch.Generator().manual_seed(0))
    if cfg.resume_teacher:
        if os.path.isdir(cfg.resume_teacher):
            loaded = load_variables(cfg.resume_teacher)
        else:
            loaded = load_torch_checkpoint(cfg.resume_teacher)
        load_state_dict_strict(teacher, loaded, scope="teacher")
    elif not cfg.allow_random_teacher:
        raise ValueError(
            "teacher-student run without --resume_teacher: the teacher would be "
            "random-init and KD meaningless. Pass a teacher checkpoint (or "
            "allow_random_teacher=True in smoke tests)."
        )
    teacher.requires_grad_(False)
    return teacher.to(device).eval()


def match_kd_pairs(model: torch.nn.Module, teacher: torch.nn.Module,
                   step_cfg: StepConfig) -> StepConfig:
    """``step_cfg`` with the layer KL's (student, teacher) conv pairs:
    name-matched (stem and downsamples skipped), and shape-matched in
    HWIO. Name-equal pairs of other shapes (a bottleneck teacher over a
    basic-block student) are dropped, and raise when the resolved β is
    not 0: the layer KL is elementwise."""
    s_tree, t_tree = shape_tree(model), shape_tree(teacher)
    s_by_name = {module_path_str(p): p for p in conv_weight_paths(s_tree)}
    t_by_name = {module_path_str(p): p for p in conv_weight_paths(t_tree)}
    kd_pairs, mismatched = [], []
    for a, b in match_conv_pairs(list(s_by_name), list(t_by_name)):
        sp, tp = s_by_name[a], t_by_name[b]
        ss = tuple(conv_weight_hwio(sp, get_by_path(s_tree, sp)).shape)
        ts = tuple(conv_weight_hwio(tp, get_by_path(t_tree, tp)).shape)
        if ss == ts:
            kd_pairs.append((sp, tp))
        else:
            mismatched.append((a, ss, ts))
    if mismatched and step_cfg.resolved().beta != 0.0:
        a, ss, ts = mismatched[0]
        raise ValueError(
            f"layer-KL (beta={step_cfg.beta}) needs shape-matched student/teacher conv "
            f"pairs, but {len(mismatched)} name-matched pairs differ in shape (first: {a!r} "
            f"student {ss} vs teacher {ts}, HWIO). Cross-architecture teachers (e.g. "
            "resnet50_float over a basic-block student) support logit-only KD: use "
            "--react or --beta 0."
        )
    return dataclasses.replace(step_cfg, kd_pairs=tuple(kd_pairs))


def epoch_schedule(family, cfg: RunConfig, epoch: int):
    """(tk, kurt_gate) entering ``epoch``: the family's schedule tuple
    (ede's (t, k), proximal's (δ,)) or the legacy (t, k) placeholder the
    step never reads; the gate is 1 from ``kurtepoch`` on."""
    t, k = cpt_tk(epoch, cfg.epochs) if cfg.ede else (1.0, 1.0)
    sched = family.schedule(epoch, cfg.epochs)
    tk = tuple(float(np.float32(v)) for v in sched) if sched else (float(np.float32(t)), float(np.float32(k)))
    return tk, 1.0 if epoch >= cfg.kurtepoch else 0.0


def _pack_host_rng() -> Dict:
    """The legacy ``np.random`` global state as strict-JSON scalars (the
    sidecar carries it)."""
    name, keys, pos, has_gauss, cached = np.random.get_state(legacy=True)
    return {"name": name, "keys": [int(x) for x in keys], "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _unpack_host_rng(d: Dict) -> None:
    np.random.set_state((d["name"], np.asarray(d["keys"], dtype=np.uint32), int(d["pos"]),
                         int(d["has_gauss"]), float(d["cached_gaussian"])))


def _resume_lineage(resume_path: str, mesh: Mesh) -> Dict:
    """Manifest extras of a resumed run: ``resumed_from``,
    ``restart_lineage`` (every earlier run dir of the chain, oldest first,
    carried from the earlier run's own manifest), and the topology the
    checkpoint's writer recorded against this run's."""
    if not resume_path:
        return {}
    prior_dir = resume_path
    if os.path.isfile(prior_dir):
        prior_dir = os.path.dirname(prior_dir) or "."
    prior = None
    # the manifest is in the --resume path itself (a run dir) or in its
    # parent (a checkpoint dir)
    for cand in (prior_dir, os.path.dirname(prior_dir.rstrip(os.sep))):
        if cand:
            m = read_manifest(cand)
            if m is not None:
                prior, prior_dir = m, cand
                break
    lineage = list((prior or {}).get("restart_lineage") or [])
    lineage.append(os.path.abspath(prior_dir))
    out = {"resumed_from": os.path.abspath(resume_path), "restart_lineage": lineage}
    if not os.path.isfile(resume_path):
        topo = next((read_resume_state(c).get("topology") for c in _candidate_dirs(resume_path)
                     if os.path.isdir(c) and read_resume_state(c).get("topology")), None)
        if topo is not None:
            out["topology_from"] = topo
            out["topology_to"] = topology(mesh)
    return out


def _fast_forward_adam(opt: torch.optim.Optimizer, step: int) -> None:
    """Adam's per-parameter step counts set to ``step`` with zero moments
    — what the reference's count fast-forward leaves after resuming from a
    torch file (its moments restart, its bias correction does not)."""
    if not isinstance(opt, torch.optim.Adam):
        return
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {
                "step": torch.tensor(float(step), dtype=torch.float32),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }


@dataclasses.dataclass
class _Resilience:
    """fit()'s preemption and cadence bundle (the reference's).
    ``save(state, epoch, step_in_epoch, reason)`` commits a checkpoint,
    emits its event and resets the cadence.

    On a ``mesh`` of more than one rank (``collective``) every step
    boundary is a coordination step: each rank's (latched signal, cadence
    due) goes through :func:`coordinate_flags`, so every rank acts on the
    same agreed triggers at the same step and the checkpoint's barriers
    align; only the ``clock_leader``'s (rank 0's) wallclock decides
    ``--save-every-mins``. One process is its own agreement, with no
    collective."""

    handler: PreemptionHandler
    policy: CheckpointPolicy
    save: Any
    events: EventWriter
    mesh: Mesh = Mesh()

    @property
    def collective(self) -> bool:
        return self.mesh.collective

    @property
    def clock_leader(self) -> bool:
        return self.mesh.primary

    def _agree(self, cadence_due: bool):
        """(signum, cadence) agreed over the ranks: a collective on a
        job, which every rank calls at the same point of its loop."""
        local = (float(self.handler.signum or 0), 1.0 if cadence_due else 0.0)
        if not self.collective:
            return int(local[0]), bool(cadence_due)
        agreed = coordinate_flags(local, self.mesh)
        return int(agreed[0]), bool(agreed[1] >= 1.0)

    def preempt_exit(self, state, epoch: int, step_in_epoch: int,
                     already_durable: bool = False, signum: Optional[int] = None) -> None:
        """Make the state durable (unless a checkpoint of exactly this
        state just committed), emit ``preempt``, raise. On a job the
        caller passes the agreed ``signum``: the signal may have reached
        another rank only."""
        signum = int(signum or self.handler.signum or 0)
        target_epoch = epoch if step_in_epoch else epoch + 1
        if not already_durable:
            self.save(state, epoch, step_in_epoch, "preempt")
        self.events.emit("preempt", signum=signum, epoch=target_epoch,
                         step_in_epoch=step_in_epoch, saved=True, coordinated=self.collective,
                         coordination_step=step_in_epoch)
        raise PreemptedError(signum, target_epoch, step_in_epoch)

    def after_step(self, state, epoch: int, next_step: int) -> None:
        """At a step boundary: agreed preemption → checkpoint, event,
        raise; agreed cadence → mid-epoch checkpoint and continue."""
        cadence_due = False
        if self.policy.active:
            self.policy.tick()
            cadence_due = self.policy.due(clock_leader=self.clock_leader)
        signum, cadence = self._agree(cadence_due)
        if signum:
            self.preempt_exit(state, epoch, next_step, signum=signum)
        if cadence:
            self.save(state, epoch, next_step, "interval")

    def poll_boundary(self) -> int:
        """The agreed signal number at an epoch boundary (0: none)."""
        return self._agree(False)[0]


def fit(cfg: RunConfig, *, on_step: Optional[Callable] = None) -> Dict[str, float]:
    """End-to-end training into a run dir under ``cfg.log_path``.
    ``on_step(epoch, step, metrics)`` is called after every train step
    (metrics are device tensors). Returns the reference's result keys:
    ``best_acc1``, ``best_epoch`` (and ``time_to_target_s`` when
    ``target_acc`` was reached); ``acc1`` with ``evaluate``. Raises
    :class:`PreemptedError` after a preemption checkpoint."""
    resources: list = []
    try:
        return _fit(cfg, resources, on_step)
    finally:
        # the scalar and event writers, the input worker pools and a
        # process group fit made close on every exit path
        for r in resources:
            r.close()


class _ProcessGroup:
    """The process group :func:`fit` made (``--distributed-init``), as a
    resource: destroyed when fit exits."""

    def close(self) -> None:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _fit(cfg: RunConfig, resources: list, on_step) -> Dict[str, float]:
    cfg = cfg.validate()
    if cfg.distributed_init and not torch.distributed.is_initialized():
        device = initialize_distributed(device=cfg.device or None)
        resources.append(_ProcessGroup())
    else:
        # a group already up (the caller made it) is the job's
        device = resolve_device(cfg.device or None)
    mesh = make_mesh(cfg.model_parallel)
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    if device.type == "cuda":
        # the stem conv and the classifier are plain torch: full f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    # one run dir a job: rank 0's timestamp (in UTC: the ranks' clocks
    # and zones may differ); rank r > 0 writes its own log, scalars and
    # events beside rank 0's
    stamp = None
    if mesh.collective:
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S",
                              time.gmtime(broadcast_host_int(int(time.time()), mesh)))
    log_path = make_log_dir(cfg.log_path, cfg.w_kurtosis_target, stamp=stamp)
    proc = "" if mesh.primary else f".p{mesh.rank}"
    setup_logger(log_path, name=logger.name, filename=f"log{proc}.txt")
    writer = ScalarWriter(log_path, name=f"scalars{proc}.jsonl", tensorboard=mesh.primary)
    resources.append(writer)
    logger.info("config: %s", cfg)
    if mesh.collective:
        logger.info("data-parallel job: rank %d of %d on %s, %d images a rank a step",
                    mesh.rank, mesh.data, device, cfg.batch_size // mesh.data)
    manifest = write_manifest(log_path, cfg, extra=_resume_lineage(cfg.resume, mesh),
                              device=device, write=mesh.primary)
    events = EventWriter(log_path, name=f"events{proc}.jsonl",
                         max_bytes=int(cfg.events_max_mb * 2**20))
    resources.append(events)
    logger.info("telemetry: manifest.json + events.jsonl in %s (config %s)", log_path,
                manifest["config_hash"])

    if cfg.health and mesh.primary:
        logger.warning("the health monitor is not ported yet (ROADMAP A 'Later' %s): this run "
                       "has none; --no-health silences this warning", OBS)

    if cfg.seed is not None:
        np.random.seed(cfg.seed)
    train_pipe, val_pipe, image_size = build_datasets(cfg, mesh=mesh)
    resources.extend(p for p in (train_pipe, val_pipe) if hasattr(p, "close"))
    if hasattr(val_pipe, "on_data_error"):
        val_pipe.on_data_error = lambda info: events.emit("data_error", where="eval", **info)
    steps_per_epoch = max(train_pipe.steps_per_epoch(), 1)
    state, step_cfg = build_training(cfg, device, steps_per_epoch, image_size)
    if mesh.collective:
        step_cfg = dataclasses.replace(step_cfg, data_shard=(mesh.rank, mesh.data))
    if cfg.pretrained:
        # a float checkpoint initializes the student: conv weights land on
        # float_weight (OIHW -> HWIO), binary extras keep their init
        overlay_state_dict(state.model, load_torch_checkpoint(cfg.pretrained_path),
                           scope="pretrained student", allow_missing=True,
                           alias_float_weight=True)
        logger.info("initialized student from %s", cfg.pretrained_path)
    logger.info("model %s on %s: %d params, %d hooked, %d probed", cfg.arch, device,
                sum(p.numel() for p in state.model.parameters()), len(step_cfg.kurt_paths),
                len(step_cfg.probe_paths))
    probe_sizes = {
        n: state.model.get_parameter(".".join(p)).numel()
        for n, p in zip(step_cfg.probe_names, step_cfg.probe_paths)
    }
    if cfg.teacher_student:
        teacher = build_teacher(cfg, device)
        step_cfg = match_kd_pairs(state.model, teacher, step_cfg)
        logger.info("teacher %s from %s: %d kd pairs", cfg.arch_teacher,
                    cfg.resume_teacher or "seed 0 (allow_random_teacher)", len(step_cfg.kd_pairs))
        train_step = make_ts_train_step(state.model, teacher, state.optimizer, step_cfg)
    else:
        train_step = make_train_step(state.model, state.optimizer, step_cfg)
    eval_step = make_eval_step(state.model, input_norm=step_cfg.input_norm)

    def _sched(epoch):
        """(ede_t, ede_k, kurt_gate) entering ``epoch``, as the reference
        records them in checkpoint and restore events."""
        t, k = cpt_tk(epoch, cfg.epochs) if cfg.ede else (1.0, 1.0)
        return float(t), float(k), 1.0 if epoch >= cfg.kurtepoch else 0.0

    def _sched_values(epoch):
        """The active family's schedule tuple entering ``epoch``."""
        return [float(v) for v in family.schedule(epoch, cfg.epochs)]

    best_acc1, best_epoch = 0.0, -1
    start_epoch, start_step = cfg.start_epoch, 0
    if cfg.resume:
        resume = cfg.resume
        if os.path.basename(resume) == PAYLOAD_NAME:
            resume = os.path.dirname(resume)
        if resume.endswith((".pth", ".pth.tar", ".pt")):
            # a reference-format torch student checkpoint
            raw = torch.load(resume, map_location="cpu", weights_only=True)
            sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
            overlay_state_dict(state.model, convert_torch_state_dict(sd), scope="resume student",
                               allow_missing=True, alias_float_weight=True)
            if isinstance(raw, dict) and not cfg.reset_resume:
                start_epoch = int(raw.get("epoch", 0))
                best_acc1 = float(raw.get("best_acc1", 0.0))
                # the LR schedule and the draws are keyed by the step: it
                # moves to the epoch's start; the Adam moments restart
                resume_step = start_epoch * steps_per_epoch
                state.step = resume_step
                _fast_forward_adam(state.optimizer, resume_step)
                ede_t, ede_k, kurt_gate = _sched(start_epoch)
                logger.warning(
                    "torch .pth resume: LR schedule fast-forwarded to step %d (EDE t=%.6g "
                    "k=%.6g, kurt gate %.0f at epoch %d); Adam moments restart",
                    resume_step, ede_t, ede_k, kurt_gate, start_epoch,
                )
                events.emit(
                    "restore", source=resume, format="torch", fallback=False, integrity="missing",
                    epoch=start_epoch, step_in_epoch=0, lr_step=resume_step,
                    ede_t=ede_t, ede_k=ede_k, kurt_gate=kurt_gate,
                    restored=["params", "batch_stats", "epoch", "best_acc1", "lr_step",
                              "ede_schedule"],
                    not_restored=["opt_moments", "step_in_epoch", "host_rng", "best_epoch"],
                )
            else:
                events.emit(
                    "restore", source=resume, format="torch", fallback=False, integrity="missing",
                    epoch=start_epoch, step_in_epoch=0, restored=["params", "batch_stats"],
                    not_restored=["epoch", "best_acc1", "lr_step", "opt_moments",
                                  "step_in_epoch", "host_rng", "best_epoch"],
                )
        else:
            t0 = time.perf_counter()
            restored = load_checkpoint(resume, state, reset_resume=cfg.reset_resume)
            load_s = time.perf_counter() - t0
            start_epoch = restored["epoch"]
            best_acc1 = restored["best_acc1"]
            best_epoch = restored["best_epoch"]
            start_step = restored["step_in_epoch"]
            if restored.get("host_rng"):
                _unpack_host_rng(restored["host_rng"])
            if restored["fallback"]:
                logger.warning("committed checkpoint unusable; restored the previous one "
                               "from %s", restored["source"])
            # elastic resume: the state is replicated and the (epoch, step)
            # cursor global, so a checkpoint restores onto any number of
            # ranks; the change of layout is recorded
            topo_from, topo_to = restored.get("topology"), topology(mesh)
            reshard = resharded(topo_from, topo_to)
            if reshard:
                logger.info("elastic resume: checkpoint written by %s restored onto %s",
                            topo_from, topo_to)
            ede_t, ede_k, kurt_gate = _sched(start_epoch)
            events.emit(
                "restore",
                source=restored["source"],
                format="native",
                fallback=bool(restored["fallback"]),
                integrity=restored["integrity"],
                epoch=start_epoch,
                step_in_epoch=start_step,
                lr_step=int(state.step),
                ede_t=ede_t,
                ede_k=ede_k,
                kurt_gate=kurt_gate,
                binarizer=cfg.binarizer,
                sched=_sched_values(start_epoch),
                topology_from=topo_from,
                topology_to=topo_to,
                resharded=reshard,
                restored=["params", "batch_stats", "opt_state", "lr_step", "epoch",
                          "best_acc1", "best_epoch", "step_in_epoch", "host_rng"]
                if not cfg.reset_resume else ["params", "batch_stats"],
                not_restored=[] if not cfg.reset_resume else [
                    "opt_state", "lr_step", "epoch", "best_acc1", "best_epoch",
                    "step_in_epoch", "host_rng"],
                seconds=round(load_s, 3),
            )
        logger.info("resumed from %s at epoch %d step %d", cfg.resume, start_epoch, start_step)
    state = create_sharded_state(mesh, state)

    obs = ObsHooks(events=events, writer=writer, timer=StepPhaseTimer(), probe_sizes=probe_sizes,
                   nonfinite_policy=cfg.nonfinite_policy, mesh=mesh)
    eval_fill = np.uint8 if cfg.device_normalize else np.float32
    if cfg.evaluate:
        return {"acc1": _validate(eval_step, state, val_pipe, device, 0, obs, eval_fill)}

    # time to target counts from a run's start; a resumed process cannot
    # know the wall clock before it, so the metric is off
    t_fit = time.time()
    time_to_target = None
    track_target = cfg.target_acc > 0 and start_epoch == 0 and not cfg.resume
    if cfg.target_acc > 0 and not track_target:
        logger.warning("time-to-target disabled: resumed at epoch %d, pre-resume wall-clock "
                       "unknown", start_epoch)
    events.emit("run_start", config_hash=manifest["config_hash"], start_epoch=start_epoch,
                start_step=start_step, epochs=cfg.epochs, steps_per_epoch=steps_per_epoch,
                probed_layers=list(probe_sizes))

    policy = CheckpointPolicy(cfg.save_every_steps, cfg.save_every_mins)

    def _save_ckpt(st, epoch, step_in_epoch, reason, is_best=False):
        """Commit a checkpoint (mid-epoch when step_in_epoch > 0) with the
        full resume state, emit the ``checkpoint`` event with the schedule
        scalars the resumed run must reproduce bitwise, reset the
        cadence."""
        t0 = time.time()
        target_epoch = epoch if step_in_epoch else epoch + 1
        ede_t, ede_k, kurt_gate = _sched(target_epoch)
        lr_step = int(st.step)
        path = save_checkpoint(
            log_path, st, epoch=epoch, arch=cfg.arch, best_acc1=best_acc1, is_best=is_best,
            step_in_epoch=step_in_epoch, mesh=mesh,
            resume_state={
                "best_epoch": int(best_epoch),
                "host_rng": _pack_host_rng(),
                "lr_step": lr_step,
                "ede_t": ede_t,
                "ede_k": ede_k,
                "kurt_gate": kurt_gate,
                "binarizer": cfg.binarizer,
                "sched": _sched_values(target_epoch),
                "topology": topology(mesh),
            },
        )
        events.emit(
            "checkpoint", reason=reason, epoch=target_epoch, step_in_epoch=step_in_epoch,
            lr_step=lr_step, ede_t=ede_t, ede_k=ede_k, kurt_gate=kurt_gate,
            binarizer=cfg.binarizer, sched=_sched_values(target_epoch), coordinated=mesh.collective,
            path=path, seconds=round(time.time() - t0, 3), bytes=checkpoint_bytes(path),
        )
        policy.note_saved()

    if start_step >= steps_per_epoch:
        logger.warning("resume cursor step %d >= %d steps/epoch (config change since the "
                       "checkpoint?); epoch %d will run no steps", start_step, steps_per_epoch,
                       start_epoch)

    handler = PreemptionHandler()
    resil = _Resilience(handler, policy, _save_ckpt, events, mesh)
    with handler:
        for epoch in range(start_epoch, cfg.epochs):
            tk, kurt_gate = epoch_schedule(family, cfg, epoch)
            if cfg.ede:
                t, k = cpt_tk(epoch, cfg.epochs)
                writer.add_scalar("EDE t", float(t), epoch)
                writer.add_scalar("EDE k", float(k), epoch)
            elif family.schedule(epoch, cfg.epochs):
                for i, v in enumerate(family.schedule(epoch, cfg.epochs)):
                    writer.add_scalar(f"Binarizer {family.name} s{i}", float(v), epoch)
            state = _train_epoch(train_step, state, train_pipe, epoch, tk, kurt_gate, cfg,
                                 steps_per_epoch, device, obs, on_step,
                                 start_step=start_step if epoch == start_epoch else 0,
                                 resil=resil)
            # a signal during the epoch's last step: save now, before the
            # eval pass outlasts the grace period
            signum = resil.poll_boundary()
            if signum:
                resil.preempt_exit(state, epoch, 0, signum=signum)
            acc1 = _validate(eval_step, state, val_pipe, device, epoch, obs, eval_fill)
            if time_to_target is None and track_target and acc1 >= cfg.target_acc:
                time_to_target = time.time() - t_fit
                writer.add_scalar("Time to target (s)", time_to_target, epoch)
                logger.info(" ##### reached target Acc@1 %.2f at epoch %d after %.1fs",
                            cfg.target_acc, epoch, time_to_target)
            is_best = acc1 > best_acc1
            if is_best:
                best_epoch = epoch
            best_acc1 = max(acc1, best_acc1)
            writer.add_scalar("Best val Acc1", best_acc1, epoch)
            logger.info(" ***** Best acc is Acc@1 %.3f, epoch %d, log %s", best_acc1, best_epoch,
                        log_path)
            _save_ckpt(state, epoch, 0, "epoch", is_best=is_best)
            # a signal during eval or the save: the epoch-end checkpoint
            # is already durable
            signum = resil.poll_boundary()
            if signum:
                resil.preempt_exit(state, epoch, 0, already_durable=True, signum=signum)

    events.emit("run_end", best_acc1=best_acc1, best_epoch=best_epoch,
                wall_s=round(time.time() - t_fit, 1),
                **({"time_to_target_s": round(time_to_target, 1)}
                   if time_to_target is not None else {}))
    out = {"best_acc1": best_acc1, "best_epoch": float(best_epoch)}
    if time_to_target is not None:
        out["time_to_target_s"] = round(time_to_target, 1)
    return out


__all__ = [
    "ObsHooks",
    "build_datasets",
    "build_teacher",
    "build_training",
    "epoch_schedule",
    "fit",
    "global_sums",
    "match_kd_pairs",
    "select_hooked_paths",
    "shape_tree",
    "to_device",
]
