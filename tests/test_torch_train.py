"""The port's training slice against the JAX reference, on the CPU:

- train-mode BatchNorm (output, input gradient, running statistics)
  against flax's ``BatchNorm(use_running_average=False)``: rtol 1e-5 (the
  batch statistics are f32 sums in another order);
- the Adam decay set against ``conv_weight_mask``, and the LR at every
  epoch against both reference schedules (f32 arithmetic, rtol 1e-6);
- train batches bitwise equal to the JAX ``Pipeline`` for the same
  (seed, epoch), with the keyed CIFAR augmentation and a custom transform;
- one full train step of two narrow models from weights carried over by
  ``bridge.py`` against ``make_train_step``: a react ``BiResNet((1, 1),
  width=8)`` with the imagenet stem, ``--w-kurtosis`` and Adam-linear, and
  ``resnet8_tiny`` CIFAR under ``--ede`` with SGD-cosine. Every pre-sign
  value is first asserted to lie more than 1e-5 from its threshold, so an
  ulp cannot flip a sign. Then: the loss to rtol 1e-5; every gradient and
  the grad norm to 1e-3 of its tensor's largest |entry| (f32 sums in other
  orders through BN statistics, the float stem, K5/K6 and the closed-form
  K7 gradient; the reference moves by up to 1.1e-4 between jit and
  op-by-op execution on the CIFAR case);
  the update of every param to 2e-3·lr under Adam (its first step is
  lr·g/(|g| + eps), so an entry whose gradient is under 1e-3 of its
  tensor's largest turns the gradient's summation noise into an update
  of up to lr: those entries are left out) and to lr times the gradient
  tolerance under SGD; the batch statistics to rtol 1e-5 with 1e-4 of the
  tensor's largest |entry| (a binary conv's outputs are ±alpha·K-sized
  and their batch mean cancels to ~1/100 of them); three steps'
  losses to rtol 1e-3 (after the first update the two runs' weights
  differ by the gradients' noise, which can move a pre-sign value across
  its threshold);
- the CLI trains two steps with ``--device cpu`` (also under
  ``--binarizer stochastic``) and refuses to start without a card.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from bdbnn_tpu.data import pipeline as jpipe
from bdbnn_tpu.data.datasets import ArrayDataset as JArrayDataset
from bdbnn_tpu.losses.kd import softmax_cross_entropy as jax_ce
from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.models import resnet as jres
from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.train import StepConfig as JStepConfig
from bdbnn_tpu.train import TrainState as JTrainState
from bdbnn_tpu.train import make_optimizer as jax_make_optimizer
from bdbnn_tpu.train import make_train_step as jax_make_train_step
from bdbnn_tpu.train.optim import (
    conv_weight_mask,
    cosine_epoch_schedule,
    linear_epoch_schedule,
)
from bdbnn_tpu.train.step import _regularization_terms
from bdbnn_tpu_torch import cli
from bdbnn_tpu_torch.bridge import flax_to_state_dict
from bdbnn_tpu_torch.data import Pipeline, normalize, IMAGENET_MEAN, IMAGENET_STD
from bdbnn_tpu_torch.data.datasets import ArrayDataset
from bdbnn_tpu_torch.models import registry as treg
from bdbnn_tpu_torch.models import resnet as tres
from bdbnn_tpu_torch.nn import binarize as tb
from bdbnn_tpu_torch.nn.layers import BatchNorm, _BinaryConvBase
from bdbnn_tpu_torch.train import optim as toptim
from bdbnn_tpu_torch.train.loop import select_hooked_paths, shape_tree
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.state import StepConfig, TrainState
from bdbnn_tpu_torch.train.step import make_train_step


# a gradient's tolerance, of its tensor's largest |entry|: the BN
# backward cancels heavily, and on the CIFAR case the reference itself
# moves by up to 1.1e-4 of a tensor's largest gradient between jit and
# op-by-op execution (f32 sums in another order)
GRAD_TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


# -- BatchNorm --------------------------------------------------------------

def test_train_mode_batchnorm_matches_flax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 5, 5, 6)) * 2 + 3).astype(np.float32)
    scale = rng.uniform(0.5, 2, 6).astype(np.float32)
    bias = rng.normal(0, 0.1, 6).astype(np.float32)
    ra_mean = rng.normal(0, 0.1, 6).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def f(xx):
        return bn.apply(variables, xx, mutable=["batch_stats"])

    y, mutated = f(jnp.asarray(x))
    ref_dx = jax.grad(lambda xx: jnp.sum(f(xx)[0] * g))(jnp.asarray(x))
    port = BatchNorm(6).train()
    with torch.no_grad():
        port.weight.copy_(_t(scale))
        port.bias.copy_(_t(bias))
        port.running_mean.copy_(_t(ra_mean))
        port.running_var.copy_(_t(ra_var))
    xt = _t(x).requires_grad_(True)
    yt = port(xt)
    (yt * _t(g)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), mutated["batch_stats"]["mean"], rtol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), mutated["batch_stats"]["var"], rtol=1e-5)


# -- optimizer ----------------------------------------------------------------

def test_adam_decay_set_matches_conv_weight_mask():
    port = tres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="react", act="rprelu")
    variables = port.to_flax()
    ref = jax.tree_util.tree_map(bool, conv_weight_mask(variables["params"]))
    tree = {"params": ref, "batch_stats": variables["batch_stats"]}
    ref_sd = {k: bool(v.reshape(-1)[0]) for k, v in flax_to_state_dict(tree).items()
              if not k.endswith(("running_mean", "running_var"))}
    got = toptim.decay_mask(port.named_parameters())
    assert got == ref_sd
    assert got["layer1_0.conv1.act_shift"] and got["conv1.weight"]
    assert not got["bn1.weight"] and not got["fc.weight"] and not got["layer1_0.act1.slope"]
    opt = toptim.make_optimizer(port, dataset="imagenet", lr=1e-3, epochs=4, steps_per_epoch=3)
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"] > 0 for p in g["params"]}
    assert decayed == {id(p) for n, p in port.named_parameters() if got[n]}


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_lr_per_epoch_matches_reference_schedules(kind):
    make_t = toptim.linear_epoch_schedule if kind == "linear" else toptim.cosine_epoch_schedule
    make_j = linear_epoch_schedule if kind == "linear" else cosine_epoch_schedule
    ours, ref = make_t(0.1, 7, 3), make_j(0.1, 7, 3)
    for step in range(0, 7 * 3):
        np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))), rtol=1e-6, atol=1e-12)
    assert ours(0) == ours(2) != ours(3)


# -- pipeline -----------------------------------------------------------------

@pytest.mark.parametrize("custom", [False, True])
def test_train_batches_bitwise_equal_to_jax_pipeline(custom):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, size=(37, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(37,))
    tf = (lambda im, r: normalize(im, IMAGENET_MEAN, IMAGENET_STD)) if custom else None
    jtf = (lambda im, r: jpipe.normalize(im, jpipe.IMAGENET_MEAN, jpipe.IMAGENET_STD)) if custom else None
    ours = Pipeline(ArrayDataset(images, labels), 8, train=True, transform=tf, seed=3, prefetch=1)
    ref = jpipe.Pipeline(JArrayDataset(images, labels), 8, train=True, transform=jtf, seed=3)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == 4
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 4
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == wx.dtype and np.array_equal(gx.view(np.uint8), wx.view(np.uint8))
            assert np.array_equal(gy, wy)
    assert not np.array_equal(list(ours.epoch(0))[0][1], list(ours.epoch(1))[0][1])


# -- one full train step --------------------------------------------------------

def _seeded_tree(flax_model, image_shape, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda k: flax_model.init(k, jnp.zeros((1, *image_shape)), train=False),
        jax.random.PRNGKey(0),
    )

    def draw(path, sd):
        name, shape = path[-1].key, sd.shape
        if name in ("float_weight", "weight", "kernel"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(1.0, 3.0, shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "slope":
            return rng.uniform(0.1, 0.4, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(draw, dict(shapes)))


def _min_presign_margin(model, x, tk):
    margins = []

    def hook(mod, args):
        v = args[0] - mod.act_shift if getattr(mod, "has_shift", False) else args[0]
        a = v.detach().abs()
        margins.append(float(a[a > 0].min()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, _BinaryConvBase)]
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        model.train()(x, tk)
    finally:
        for h in handles:
            h.remove()
        model.load_state_dict(saved)
    return min(margins)


STEP_CASES = {
    # id: (flax model, port model, image shape, dataset, family, opt policy, lr, kurtosis)
    "react-adam-kurt": (
        lambda: jres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="react", act="rprelu"),
        lambda: tres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="react", act="rprelu"),
        (32, 32, 3), "imagenet", "ste", "adam-linear", 1e-3, True),
    "cifar-ede-sgd": (
        lambda: jreg.create_model("resnet8_tiny", "cifar10"),
        lambda: treg.create_model("resnet8_tiny", "cifar10"),
        (16, 16, 3), "cifar10", "ede", "sgd-cosine", 0.02, False),
}


@functools.lru_cache(maxsize=None)
def _run_both(case_id, steps=3, seed=0):
    """Three train steps of both packages from the same weights and
    batches (cached: the one-step and three-step tests share the run)."""
    make_j, make_t, shape, dataset, family, policy, lr, kurt = STEP_CASES[case_id]
    jmodel, port = make_j(), make_t()
    tree = _seeded_tree(jmodel, shape, seed)
    port.from_flax(tree)
    hooked = select_hooked_paths(shape_tree(port), RunConfig(w_kurtosis=True)) if kurt else ()
    targets = tuple(1.2 + 0.1 * i for i in range(len(hooked)))
    fam = jb.make_family(family)
    common = dict(
        w_kurtosis=kurt, kurt_paths=hooked, kurt_targets=targets, w_lambda_kurtosis=0.5,
        ede=family == "ede", binarizer=family, binarizer_schedule=fam.schedule_len > 0,
        log_grad_norm=True, probe_paths=hooked,
        probe_names=tuple(".".join(p[:-1]) for p in hooked), track_nonfinite=True,
    )
    tk = tuple(np.float32(v) for v in fam.schedule(0, 2)) or (np.float32(1), np.float32(1))
    rng = np.random.default_rng(seed + 7)
    batches = [(rng.normal(size=(8, *shape)).astype(np.float32),
                rng.integers(0, 10, size=(8,)).astype(np.int32)) for _ in range(steps)]

    tx = jax_make_optimizer(tree["params"], dataset=dataset, lr=lr, epochs=2,
                            steps_per_epoch=4, policy=policy)
    jcfg = JStepConfig(**common)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, jcfg))
    jstate = JTrainState.create(tree, tx)
    opt = toptim.make_optimizer(port, dataset=dataset, lr=lr, epochs=2, steps_per_epoch=4,
                                policy=policy)
    tstate = TrainState(port, opt)
    tstep = make_train_step(port, opt, StepConfig(**common))
    jtk = tuple(jnp.float32(v) for v in tk)
    out = []
    prev_j, prev_t = jb.get_active_family(), tb.get_active_family()
    jb.set_active_family(family)
    tb.set_active_family(family)
    try:
        for i, (x, y) in enumerate(batches):
            if i == 0:
                assert _min_presign_margin(port, _t(x), tuple(map(float, tk))) > 1e-5
            jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jtk, jnp.float32(1.0))
            tstate, tm = tstep(tstate, (_t(x), _t(y).long()), tuple(map(float, tk)), 1.0)
            out.append((jax.device_get(jm), {k: v.numpy() for k, v in tm.items()},
                        {n: p.grad.clone() for n, p in port.named_parameters()} if i == 0 else None,
                        jax.device_get(jstate.variables), {k: v.clone() for k, v in port.state_dict().items()},
                        tree if i == 0 else None))
    finally:
        jb.set_active_family(prev_j)
        tb.set_active_family(prev_t)
    return out, lr


@pytest.mark.parametrize("case_id", list(STEP_CASES))
def test_one_train_step_matches_make_train_step(case_id):
    out, lr = _run_both(case_id)
    jm, tm, tgrads, jvars, tsd, tree = out[0]
    adam = STEP_CASES[case_id][5] == "adam-linear"
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(tm["loss_ce"], jm["loss_ce"], rtol=1e-5)
    for key in [k for k in jm if k.startswith(("kurt/", "loss_kurt"))]:
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5)
    for key in ("top1", "top5", "count", "nonfinite"):
        assert tm[key] == jm[key]
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=GRAD_TOL)
    # gradients, from the reference's own loss function
    jgrads = _reference_grads(case_id, tree)
    ref_g = flax_to_state_dict({"params": jgrads, "batch_stats": tree["batch_stats"]})
    assert set(tgrads) <= set(ref_g)
    for name, g in tgrads.items():
        want = ref_g[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=GRAD_TOL * scale, err_msg=name)
    # updated params and batch statistics
    ref_sd = flax_to_state_dict(jvars)
    old_sd = flax_to_state_dict(tree)
    for name, v in tsd.items():
        want = ref_sd[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                       atol=1e-4 * float(np.abs(want).max()), err_msg=name)
            continue
        step_ref = want - old_sd[name].numpy()
        gref = ref_g[name].numpy()
        gmax = max(float(np.abs(gref).max()), 1e-30)
        if adam:
            keep = np.abs(gref) >= 1e-3 * gmax
            atol = 2e-3 * lr
        else:
            keep = np.ones(gref.shape, bool)
            atol = lr * GRAD_TOL * gmax + 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose((v.numpy() - old_sd[name].numpy())[keep], step_ref[keep],
                                   rtol=0, atol=atol, err_msg=name)


def _reference_grads(case_id, tree):
    make_j, _, shape, dataset, family, policy, lr, kurt = STEP_CASES[case_id]
    jmodel = make_j()
    port = STEP_CASES[case_id][1]()
    hooked = select_hooked_paths(shape_tree(port), RunConfig(w_kurtosis=True)) if kurt else ()
    cfg = JStepConfig(w_kurtosis=kurt, kurt_paths=hooked,
                      kurt_targets=tuple(1.2 + 0.1 * i for i in range(len(hooked))),
                      w_lambda_kurtosis=0.5)
    fam = jb.make_family(family)
    tk = tuple(jnp.float32(v) for v in fam.schedule(0, 2))
    rng = np.random.default_rng(7)  # _run_both's first batch
    x = rng.normal(size=(8, *shape)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,)).astype(np.int32)

    def loss_fn(params):
        logits, _ = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]},
                                 jnp.asarray(x), train=True, mutable=["batch_stats"],
                                 **({"tk": tk} if tk else {}))
        reg, _ = _regularization_terms(params, cfg, jnp.float32(1.0))
        return jax_ce(logits, jnp.asarray(y)) + reg

    prev = jb.get_active_family()
    jb.set_active_family(family)
    try:
        return jax.device_get(jax.jit(jax.grad(loss_fn))(tree["params"]))
    finally:
        jb.set_active_family(prev)


@pytest.mark.parametrize("case_id", list(STEP_CASES))
def test_three_steps_losses_track_the_reference(case_id):
    out, _ = _run_both(case_id)
    for jm, tm, *_ in out:
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-3)
        assert np.isfinite(tm["loss"])


# -- CLI ------------------------------------------------------------------------

def test_cli_trains_two_steps_on_the_cpu(tmp_path, capsys):
    rc = cli.main(["--dataset", "cifar10", "-a", "resnet8_tiny", "--synthetic", "-b", "8",
                   "--epochs", "1", "--synthetic-train-size", "16", "--synthetic-val-size", "8",
                   "--w-kurtosis", "--ede", "--seed", "1", "--device", "cpu",
                   "--log_path", str(tmp_path)])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"best_acc1", "best_epoch"}


def test_cli_trains_under_the_stochastic_family_on_the_cpu(tmp_path, capsys):
    rc = cli.main(["--dataset", "cifar10", "-a", "resnet8_tiny", "--synthetic", "-b", "8",
                   "--epochs", "1", "--synthetic-train-size", "16", "--synthetic-val-size", "8",
                   "--binarizer", "stochastic", "--w-kurtosis", "--seed", "1", "--device", "cpu",
                   "--log_path", str(tmp_path)])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"best_acc1", "best_epoch"}


@pytest.mark.parametrize("extra", [["--dtype", "bfloat16"], ["--remat"],
                                   ["--dtype", "bfloat16", "--remat"]],
                         ids=["bf16", "remat", "bf16-remat"])
def test_cli_trains_bf16_and_remat_on_the_cpu(tmp_path, capsys, extra):
    """--dtype bfloat16 and --remat train through the CLI (they raised
    before the bf16 slice): two steps and the eval, finite results."""
    rc = cli.main(["--dataset", "cifar10", "-a", "resnet8_tiny", "--synthetic", "-b", "8",
                   "--epochs", "1", "--synthetic-train-size", "16", "--synthetic-val-size", "8",
                   "--w-kurtosis", "--seed", "1", "--device", "cpu", "--log_path", str(tmp_path),
                   *extra])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"best_acc1", "best_epoch"} and np.isfinite(res["best_acc1"])


def test_cli_refuses_without_a_card_and_names_unported_options():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    args = ["--dataset", "cifar10", "-a", "resnet8_tiny", "--synthetic", "-b", "8",
            "--epochs", "1", "--synthetic-train-size", "16", "--synthetic-val-size", "8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
    with pytest.raises(RuntimeError, match="TensorFlow input pipeline"):
        cli.main(args + ["--input-backend", "tfdata", "--device", "cpu"])
    # --distributed-init runs a data-parallel job, and outside torchrun's
    # environment it refuses to start rather than train as one process
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(args + ["--distributed-init", "--device", "cpu"])
    # --model-parallel 2 without a process group: a world of 1 that the
    # model axis does not divide, the reference's ValueError
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        cli.main(args + ["--model-parallel", "2", "--device", "cpu"])
    # the obs options are ported: a bad value fails at config time, as the
    # reference's does
    for extra, msg in [(["--profile-at", "5"], "bad --profile-at spec"),
                       (["--health-threshold", "grad_norm=1"], "bad --health-threshold")]:
        with pytest.raises(ValueError, match=msg):
            cli.main(args + extra + ["--device", "cpu"])
