"""Training orchestration — the core of ``bdbnn_tpu/train/loop.py``'s
``fit`` (``_fit``, ``_train_epoch``, ``_validate``) on the port.

:func:`fit` builds the datasets (synthetic or CIFAR), the model from the
registry with an explicit ``torch.Generator(seed)``, the optimizer, the
kurtosis hooks and targets and the :class:`StepConfig`; then runs the
epoch loop with the binarizer family's schedule and the kurtosis gate,
and the eval pass at each epoch's end. Metrics stay on the device and
are drained once every ``print_freq`` steps. It runs on the CUDA card
unless ``cfg.device`` is "cpu", and raises without a card.

Not in this slice (``RunConfig.validate`` raises for each option, naming
its ROADMAP item): checkpoints and resume, the events/manifest
telemetry, the health monitor, profiling windows, teacher-student
training, DDP.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bdbnn_tpu_torch import resolve_device
from bdbnn_tpu_torch.data import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    CIFAR_MEAN,
    CIFAR_STD,
    Pipeline,
    load_cifar10,
    load_cifar100,
    normalize,
    synthetic_dataset,
)
from bdbnn_tpu_torch.losses.kurtosis import resolve_targets
from bdbnn_tpu_torch.models import conv_weight_paths, create_model, module_path_str
from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
from bdbnn_tpu_torch.obs.probes import NonFiniteLossError, drain_probe_report
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.ede import cpt_tk
from bdbnn_tpu_torch.train.optim import make_optimizer
from bdbnn_tpu_torch.train.state import StepConfig, TrainState
from bdbnn_tpu_torch.train.step import make_eval_step, make_train_step

logger = logging.getLogger("bdbnn_tpu_torch.train")


def _setup_logging() -> None:
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False


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


def build_datasets(cfg: RunConfig):
    """(train pipeline, val pipeline, image size), as the reference
    builds them: synthetic images from seeds 1 (train) and 2 (val), with
    ImageNet normalization for ``imagenet``; or the CIFAR splits."""
    image_size = 224 if cfg.dataset == "imagenet" else 32
    seed = cfg.seed or 0
    if cfg.synthetic:
        transform = None
        if cfg.dataset == "imagenet":
            transform = lambda im, rng: normalize(im, IMAGENET_MEAN, IMAGENET_STD)
        mk = lambda ds, train: Pipeline(
            ds, cfg.batch_size, train=train, transform=transform, seed=seed, prefetch=2
        )
        val_ds = synthetic_dataset(cfg.synthetic_val_size, image_size, cfg.num_classes, seed=2)
        train_ds = synthetic_dataset(cfg.synthetic_train_size, image_size, cfg.num_classes, seed=1)
        return mk(train_ds, True), mk(val_ds, False), image_size
    if cfg.dataset in ("cifar10", "cifar100"):
        loader = load_cifar10 if cfg.dataset == "cifar10" else load_cifar100
        try:
            train_ds, val_ds = loader(cfg.data, "train"), loader(cfg.data, "test")
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"{cfg.dataset} data not found under {cfg.data!r} ({e}); "
                "pass a valid --data dir, or --synthetic for a smoke run"
            ) from e
        mk = lambda ds, train: Pipeline(
            ds, cfg.batch_size, train=train, seed=seed, prefetch=2,
            device_normalize=cfg.device_normalize,
        )
        return mk(train_ds, True), mk(val_ds, False), image_size
    raise NotImplementedError("ImageNet from an image folder is not ported yet; use --synthetic")


class DeviceMetrics:
    """Sums of per-step device scalars; :meth:`drain` is the one host
    sync per interval."""

    def __init__(self) -> None:
        self._acc: Optional[Dict[str, torch.Tensor]] = None
        self.pending_steps = 0

    def add(self, metrics: Dict[str, torch.Tensor]) -> None:
        m = {k: v.to(torch.float64) for k, v in metrics.items()}
        self._acc = m if self._acc is None else {k: self._acc[k] + v for k, v in m.items()}
        self.pending_steps += 1

    def drain(self) -> Dict[str, float]:
        if self._acc is None:
            return {}
        keys = sorted(self._acc)
        vals = torch.stack([self._acc[k] for k in keys]).cpu().tolist()
        self._acc, self.pending_steps = None, 0
        return dict(zip(keys, vals))


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: through pinned memory, without waiting
    for the card, when that is a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _nonfinite(policy: str, msg: str) -> None:
    if policy == "raise":
        raise NonFiniteLossError(msg + " (nonfinite_policy='raise')")
    if policy == "warn":
        logger.warning("%s (nonfinite_policy='warn')", msg)


def _train_epoch(train_step, state, pipe, epoch, tk, kurt_gate, cfg, steps_per_epoch,
                 device, probe_sizes, on_step):
    devmet = DeviceMetrics()
    seen = loss_sum = top1 = 0.0
    t0 = time.perf_counter()
    t_mark, n_mark = t0, 0.0

    def drain(step_idx):
        nonlocal seen, loss_sum, top1, t_mark, n_mark
        steps = devmet.pending_steps
        sums = devmet.drain()
        n = max(sums["count"], 1.0)
        seen += n
        loss_sum += sums["loss_sum"]
        top1 += sums["top1"]
        if sums.get("nonfinite", 0):
            _nonfinite(cfg.nonfinite_policy,
                       f"non-finite train loss in {int(sums['nonfinite'])}/{steps} step(s) "
                       f"of the interval ending at epoch {epoch} step {step_idx}")
        now = time.perf_counter()
        rate = n / max(now - t_mark, 1e-9)
        t_mark = now
        flip_rate, kurt = drain_probe_report(sums, probe_sizes, steps)
        extra = "".join(
            f" {k} {sums[k] / steps:.4e}" for k in ("loss_ce", "loss_kurt", "grad_norm") if k in sums
        )
        logger.info(
            "Epoch: [%d][%d/%d] Loss %.4e Acc@1 %6.2f Acc@5 %6.2f img/s %8.1f%s%s",
            epoch, step_idx, steps_per_epoch, sums["loss_sum"] / n, 100.0 * sums["top1"] / n,
            100.0 * sums["top5"] / n, rate, extra,
            (f" flip_rate(mean) {np.mean(list(flip_rate.values())):.3e}"
             f" kurt(mean) {np.mean(list(kurt.values())):.4f}") if flip_rate else "",
        )

    step_idx = -1
    for x, y in pipe.epoch(epoch):
        step_idx += 1
        batch = (to_device(x, device), to_device(y, device))
        state, m = train_step(state, batch, tk, kurt_gate)
        devmet.add(m)
        if on_step is not None:
            on_step(epoch, step_idx, m)
        if step_idx % cfg.print_freq == 0:
            drain(step_idx)
    if devmet.pending_steps:
        drain(step_idx)
    logger.info("Epoch %d: train loss %.4e top1 %.2f (%.1fs)", epoch,
                loss_sum / max(seen, 1.0), 100.0 * top1 / max(seen, 1.0),
                time.perf_counter() - t0)
    return state


def _validate(eval_step, state, pipe, device, epoch, nonfinite_policy="raise") -> float:
    """Top-1 over the val split: fixed-shape padded batches, sums on the
    device, one fetch."""
    bs = pipe.batch_size
    totals = None
    for x, y in pipe.epoch(0):
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
    count = max(got.get("count", 0.0), 1.0)
    acc1 = 100.0 * got.get("top1", 0.0) / count
    acc5 = 100.0 * got.get("top5", 0.0) / count
    loss = got.get("loss_sum", 0.0) / count
    logger.info(" * Acc@1 %.3f Acc@5 %.3f (val loss %.4f) epoch %d", acc1, acc5, loss, epoch)
    if nonfinite_policy != "ignore" and not np.isfinite(loss):
        _nonfinite(nonfinite_policy, f"non-finite validation loss at epoch {epoch}")
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


def epoch_schedule(family, cfg: RunConfig, epoch: int):
    """(tk, kurt_gate) entering ``epoch``: the family's schedule tuple
    (ede's (t, k), proximal's (δ,)) or the legacy (t, k) placeholder the
    step never reads; the gate is 1 from ``kurtepoch`` on."""
    t, k = cpt_tk(epoch, cfg.epochs) if cfg.ede else (1.0, 1.0)
    sched = family.schedule(epoch, cfg.epochs)
    tk = tuple(float(np.float32(v)) for v in sched) if sched else (float(np.float32(t)), float(np.float32(k)))
    return tk, 1.0 if epoch >= cfg.kurtepoch else 0.0


def fit(cfg: RunConfig, *, on_step: Optional[Callable] = None) -> Dict[str, float]:
    """End-to-end training. ``on_step(epoch, step, metrics)`` is called
    after every train step (metrics are device tensors). Returns the
    reference's result keys: ``best_acc1``, ``best_epoch`` (and
    ``time_to_target_s`` when ``target_acc`` was reached); ``acc1`` with
    ``evaluate``."""
    _setup_logging()
    cfg = cfg.validate()
    device = resolve_device(cfg.device or None)
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    if device.type == "cuda":
        # the stem conv and the classifier are plain torch: full f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    if cfg.seed is not None:
        np.random.seed(cfg.seed)
    logger.info("config: %s", cfg)
    train_pipe, val_pipe, image_size = build_datasets(cfg)
    steps_per_epoch = max(train_pipe.steps_per_epoch(), 1)
    state, step_cfg = build_training(cfg, device, steps_per_epoch, image_size)
    logger.info("model %s on %s: %d params, %d hooked, %d probed", cfg.arch, device,
                sum(p.numel() for p in state.model.parameters()), len(step_cfg.kurt_paths),
                len(step_cfg.probe_paths))
    probe_sizes = {
        n: state.model.get_parameter(".".join(p)).numel()
        for n, p in zip(step_cfg.probe_names, step_cfg.probe_paths)
    }
    train_step = make_train_step(state.model, state.optimizer, step_cfg)
    eval_step = make_eval_step(state.model, input_norm=step_cfg.input_norm)
    if cfg.evaluate:
        return {"acc1": _validate(eval_step, state, val_pipe, device, 0, cfg.nonfinite_policy)}

    t_fit = time.time()
    time_to_target = None
    best_acc1, best_epoch = 0.0, -1
    for epoch in range(cfg.start_epoch, cfg.epochs):
        tk, kurt_gate = epoch_schedule(family, cfg, epoch)
        state = _train_epoch(train_step, state, train_pipe, epoch, tk, kurt_gate, cfg,
                             steps_per_epoch, device, probe_sizes, on_step)
        acc1 = _validate(eval_step, state, val_pipe, device, epoch, cfg.nonfinite_policy)
        if time_to_target is None and cfg.target_acc > 0 and acc1 >= cfg.target_acc:
            time_to_target = time.time() - t_fit
            logger.info(" ##### reached target Acc@1 %.2f at epoch %d after %.1fs",
                        cfg.target_acc, epoch, time_to_target)
        if acc1 > best_acc1:
            best_epoch = epoch
        best_acc1 = max(acc1, best_acc1)
        logger.info(" ***** Best acc is Acc@1 %.3f, epoch %d", best_acc1, best_epoch)
    out = {"best_acc1": best_acc1, "best_epoch": float(best_epoch)}
    if time_to_target is not None:
        out["time_to_target_s"] = round(time_to_target, 1)
    return out


__all__ = [
    "DeviceMetrics",
    "build_datasets",
    "build_training",
    "epoch_schedule",
    "fit",
    "select_hooked_paths",
    "shape_tree",
    "to_device",
]
