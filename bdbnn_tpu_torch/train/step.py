"""Train and eval steps — counterparts of ``bdbnn_tpu/train/step.py``
(``make_train_step``, ``make_eval_step``, ``topk_correct``,
``_regularization_terms``, ``_step_metrics``), with the same metric keys.

A train step is one eager forward (the binary convs on K2 → K1), the
loss (CE + λ·kurt on K7 [+ L2 / |W|→±1]), one backward (K5 + K6 per
binary conv, K7's gradient added into the hooked weights' ``.grad`` by
autograd) and the optimizer update at the epoch-keyed LR. ``tk`` (the
binarizer family's schedule scalars) and ``kurt_gate`` are per-call
arguments; metrics stay device tensors until the loop drains them. Under
the stochastic family the forward samples its activation signs from the
step's draws: :class:`~bdbnn_tpu_torch.nn.binarize.StepDraws` of
``(rng_seed, step)`` (the reference's ``fold_in(PRNGKey(rng_seed),
step)``), or the ``draws(step)`` source the caller passes to
:func:`make_train_step`. :func:`make_ts_train_step` is the teacher–student
step: the frozen float teacher runs on the same prepared images in eval
mode without autograd, and the loss is ``β·layerKL + α·logitKL +
w_lambda_ce·CE + λ·kurt``, each weight pair in HWIO.

In a data-parallel job (``state.ddp``) each rank's loss is the mean over
its own rows and the forward runs through the DDP wrapper, whose average
of the ranks' gradients is the gradient of the global batch's mean; the
kurtosis and the weight KL see the replicated weights on every rank, and
the teacher runs on each rank's rows. The stochastic draws are the global
batch's, each rank taking its rows (``StepConfig.data_shard``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from bdbnn_tpu_torch.losses.kd import distribution_loss, layer_weight_kl, softmax_cross_entropy
from bdbnn_tpu_torch.losses.kurtosis import (
    kurtosis_regularization,
    l2_regularization,
    weight_to_pm1_regularization,
)
from bdbnn_tpu_torch.models.resnet import conv_weight_hwio
from bdbnn_tpu_torch.nn.binarize import DrawSource, StepDraws
from bdbnn_tpu_torch.obs.probes import nonfinite_flag, probe_metrics, probe_signs
from bdbnn_tpu_torch.train.optim import set_lr
from bdbnn_tpu_torch.train.state import StepConfig, TrainState

Tensor = torch.Tensor


def param_by_path(model: torch.nn.Module, path) -> torch.nn.Parameter:
    """The parameter at a flax-layout path, e.g. ``('layer1_0', 'conv1',
    'float_weight')`` (the port's module names are the flax paths)."""
    return model.get_parameter(".".join(path))


def topk_correct(
    logits: Tensor, labels: Tensor, ks=(1, 5), valid: Optional[Tensor] = None
) -> Dict[str, Tensor]:
    """Counts of top-k correct predictions (int32 device scalars);
    ``valid`` (0/1 per example) masks padded rows out."""
    k_max = min(max(ks), logits.shape[-1])
    top = torch.topk(logits, k_max, dim=-1).indices
    hit = (top == labels.reshape(-1, 1)).to(torch.int32)
    if valid is not None:
        hit = hit * valid.to(torch.int32).reshape(-1, 1)
    return {f"top{k}": hit[:, : min(k, logits.shape[-1])].sum() for k in ks}


def prep_images(images: Tensor, input_norm) -> Tensor:
    """Device-side normalization of raw uint8 batches (StepConfig
    .input_norm): ``(x/255 - mean)/std`` in float32, the host pipeline's
    arithmetic, bitwise its ``normalize``. The divisor 255 is a tensor on
    the batch's device: CUDA's division by a host scalar multiplies by its
    reciprocal, which is an ulp off x/255 for 126 of the 256 values."""
    if input_norm is None:
        return images
    mean, std = input_norm
    x = images.to(torch.float32)
    d = torch.tensor(255.0, dtype=torch.float32, device=x.device)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x / d - m) / s


def regularization_terms(model, cfg: StepConfig, kurt_gate: float) -> Tuple[Tensor, Dict[str, Tensor]]:
    """λ·kurt (+ optional L2 / |W|→±1) over the hooked latent weights."""
    dev = next(model.parameters()).device
    terms: Dict[str, Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.w_kurtosis and cfg.kurt_paths:
        weights = [param_by_path(model, p) for p in cfg.kurt_paths]
        kurt = kurtosis_regularization(weights, cfg.kurt_targets, cfg.kurtosis_mode)
        kurt = cfg.w_lambda_kurtosis * kurt * kurt_gate
        terms["loss_kurt"] = kurt
        total = total + kurt
        if cfg.w_l2_reg:
            l2 = cfg.w_lambda_l2 * l2_regularization(weights)
            terms["loss_l2"] = l2
            total = total + l2
        if cfg.w_wr_reg:
            wr = cfg.w_lambda_wr * weight_to_pm1_regularization(weights)
            terms["loss_wr"] = wr
            total = total + wr
    return total, terms


def step_metrics(aux, logits, labels, grads, old_signs, new_weights, cfg: StepConfig):
    """The per-step metric dict: loss terms, example-weighted loss sum,
    top-k counts and, per StepConfig, grad norm, probes, non-finite flag.
    Every value is a device tensor."""
    metrics = {
        **aux,
        "loss_sum": aux["loss"] * labels.shape[0],
        **topk_correct(logits, labels),
        # a fill, not a host copy: a copy to the card would wait for it
        "count": torch.full((), labels.shape[0], dtype=torch.int32, device=logits.device),
    }
    if cfg.log_grad_norm:
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if cfg.probe_paths:
        metrics.update(probe_metrics(old_signs, new_weights, cfg.probe_names))
    if cfg.track_nonfinite:
        metrics["nonfinite"] = nonfinite_flag(aux["loss"])
    return metrics


def _make_step(model, optimizer, cfg: StepConfig, draws, loss_terms) -> Callable:
    """A train step whose loss is the sum of ``loss_terms(images, labels,
    logits)`` (an ordered dict of named terms) and the regularizers."""
    if draws is None:
        draws = functools.partial(StepDraws, cfg.rng_seed, shard=cfg.data_shard)

    def train_step(state: TrainState, batch, tk, kurt_gate: float):
        model, opt = state.model, state.optimizer
        images, labels = batch
        images = prep_images(images, cfg.input_norm)
        model.train()
        # the family's schedule reaches the convs only when it has one
        # (the reference's _apply_kwargs)
        sched = tuple(tk) if (cfg.ede or cfg.binarizer_schedule) else None
        # the stochastic family samples from the step's draws (the
        # reference's per-step ``binarize`` rng stream)
        # a data-parallel job runs the forward through its DDP wrapper,
        # which averages the gradient over the ranks in the backward
        net = model if state.ddp is None else state.ddp
        logits = net(images, sched, draws(state.step) if cfg.binarizer_stochastic else None)
        losses = loss_terms(images, labels, logits)
        reg, terms = regularization_terms(model, cfg, kurt_gate)
        loss = sum(losses.values()) + reg
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        probed = [param_by_path(model, p) for p in cfg.probe_paths]
        old_signs = probe_signs(probed) if probed else []
        set_lr(opt, state.step)
        opt.step()
        state.step += 1
        aux = {"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()},
               **{k: v.detach() for k, v in terms.items()}}
        metrics = step_metrics(aux, logits.detach(), labels, grads, old_signs, probed, cfg)
        return state, metrics

    return train_step


def make_train_step(
    model, optimizer, cfg: StepConfig, draws: Optional[Callable[[int], DrawSource]] = None
) -> Callable:
    """Plain train step: loss = CE + λ·kurt [+ L2 + WR]. Returns
    ``train_step(state, (images, labels), tk, kurt_gate) -> (state,
    metrics)``; ``state`` is updated in place. Under the stochastic family
    ``draws(step)`` gives the step's draw source (default:
    ``StepDraws(cfg.rng_seed, step)``)."""
    cfg = cfg.resolved()
    return _make_step(model, optimizer, cfg, draws,
                      lambda images, labels, logits: {"loss_ce": softmax_cross_entropy(logits, labels)})


def make_ts_train_step(
    model, teacher, optimizer, cfg: StepConfig,
    draws: Optional[Callable[[int], DrawSource]] = None,
) -> Callable:
    """Teacher–student step (↔ the reference's ``make_ts_train_step``):
    loss = β·layerKL + α·logitKL + w_lambda_ce·CE + λ·kurt, with react's
    overrides (β = w_lambda_ce = 0) from ``cfg.resolved()``. The teacher
    takes the student's prepared images in eval mode under
    ``torch.no_grad()``; ``cfg.kd_pairs`` names the (student, teacher)
    conv weights of the layer KL, compared in HWIO. Metric keys:
    ``loss``, ``loss_ce``, ``loss_kl``, ``loss_kl_c`` and the
    regularizers'. ``state`` and ``draws`` as in :func:`make_train_step`."""
    cfg = cfg.resolved()

    def loss_terms(images, labels, logits):
        teacher.eval()
        with torch.no_grad():
            t_logits = teacher(images)
        ce = softmax_cross_entropy(logits, labels) * cfg.w_lambda_ce
        kl_c = distribution_loss(logits, t_logits) * cfg.alpha
        if cfg.beta != 0.0 and cfg.kd_pairs:
            sw = [conv_weight_hwio(sp, param_by_path(model, sp)) for sp, _ in cfg.kd_pairs]
            tw = [conv_weight_hwio(tp, param_by_path(teacher, tp)) for _, tp in cfg.kd_pairs]
            kl_layer = layer_weight_kl(sw, tw) * cfg.beta
        else:
            kl_layer = torch.zeros((), dtype=torch.float32, device=logits.device)
        # the reference's order of the sum: layer KL, logit KL, CE
        return {"loss_kl": kl_layer, "loss_kl_c": kl_c, "loss_ce": ce}

    return _make_step(model, optimizer, cfg, draws, loss_terms)


def make_eval_step(model, input_norm=None) -> Callable:
    """Validation step on ``(images, labels, valid)`` (batches padded to
    a fixed shape, ``valid`` masks the padding); returns SUMS."""

    def eval_step(state: TrainState, batch):
        images, labels, valid = batch
        images = prep_images(images, input_norm)
        model.eval()
        with torch.no_grad():
            logits = model(images)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, labels.reshape(-1, 1).to(torch.int64))[:, 0]
            v = valid.to(nll.dtype)
            return {
                "loss_sum": torch.sum(nll * v),
                **topk_correct(logits, labels, valid=valid),
                "count": torch.sum(valid.to(torch.int32)),
            }

    return eval_step


__all__ = [
    "make_eval_step",
    "make_train_step",
    "make_ts_train_step",
    "param_by_path",
    "prep_images",
    "regularization_terms",
    "step_metrics",
    "topk_correct",
]
