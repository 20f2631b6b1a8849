"""The port's teacher–student slice against the JAX reference, on the CPU:

- every KD loss and its student gradient against ``jax.grad`` (rtol 1e-6;
  a gradient entry also within 1e-6 of its tensor's largest), with
  saturated teacher rows (``xlogy``) and a 1x1 conv, whose softened
  softmax runs over axis 1 of HWIO (size 1), as the reference's does;
  the teacher side gets no gradient, and an OIHW teacher tensor beside an
  HWIO student tensor raises;
- ``match_conv_pairs`` on resnet18 and resnet18_float paths;
- a narrow bottleneck float ``BiResNet`` forward (eval and train-mode BN)
  against flax with bridged weights (rtol 1e-5), and the bridge's round
  trip of its ``conv3``/``bn3``/``downsample_*`` leaves;
- one torchvision-layout ``.pth.tar`` (written by
  ``chip_smoke.write_teacher_checkpoint``'s key map) loaded by both
  packages gives the same logits; the strict loader's three errors;
- one teacher–student train step of both packages from the same weights
  and batch, tolerances as in ``test_torch_train.py``, for a same-shape
  float teacher with β = 200 and kurtosis, and for ``--react`` with a
  bottleneck teacher; three steps' losses to rtol 1e-3; the teacher
  bitwise unchanged;
- the layer-KL shape guard in both packages' ``fit`` (raises with β ≠ 0
  for a bottleneck teacher, passes under ``--react`` with the same pairs);
- ``build_teacher``'s refusals, ``fit`` with a teacher file leaving the
  teacher bitwise as loaded, and the CLI training two TS steps on the CPU.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.configs.config import RunConfig as JRunConfig
from bdbnn_tpu.losses import kd as jkd
from bdbnn_tpu.losses.kd import softmax_cross_entropy as jax_ce
from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.models import resnet as jres
from bdbnn_tpu.models.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint
from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.train import StepConfig as JStepConfig
from bdbnn_tpu.train import TrainState as JTrainState
from bdbnn_tpu.train import loop as jloop
from bdbnn_tpu.train import make_optimizer as jax_make_optimizer
from bdbnn_tpu.train.step import _regularization_terms
from bdbnn_tpu.train.step import make_ts_train_step as jax_make_ts_train_step
from bdbnn_tpu_torch import cli
from bdbnn_tpu_torch.bridge import flax_to_state_dict
from bdbnn_tpu_torch.losses import kd as tkd
from bdbnn_tpu_torch.models import load_state_dict_strict, load_torch_checkpoint
from bdbnn_tpu_torch.models import registry as treg
from bdbnn_tpu_torch.models import resnet as tres
from bdbnn_tpu_torch.nn import binarize as tb
from bdbnn_tpu_torch.train import loop as tloop
from bdbnn_tpu_torch.train import optim as toptim
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.loop import (
    build_teacher,
    match_kd_pairs,
    select_hooked_paths,
    shape_tree,
)
from bdbnn_tpu_torch.train.state import StepConfig, TrainState
from bdbnn_tpu_torch.train.step import make_ts_train_step
from bdbnn_tpu_torch.utils.checkpoint import save_checkpoint
from chip_smoke import torchvision_state_dict, write_teacher_checkpoint

GRAD_TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the losses -------------------------------------------------------------------

def _logits(seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(0, 2, (6, 10)).astype(np.float32)
    t = rng.normal(0, 2, (6, 10)).astype(np.float32)
    t[1, 3] = 1e4  # a saturated teacher row: softmax underflows to 0 elsewhere
    t[4] = -1e4
    t[4, 0] = 0.0
    return s, t


def _weights(seed):
    rng = np.random.default_rng(seed)
    shapes = [(3, 3, 4, 5), (1, 1, 6, 7), (3, 3, 5, 5)]
    ws = [rng.normal(0, 0.3, sh).astype(np.float32) for sh in shapes]
    wt = [rng.normal(0, 0.3, sh).astype(np.float32) for sh in shapes]
    wt[0][:, 0] = -1e4  # saturated along the softened axis (HWIO axis 1)
    wt[0][:, 0, 1, 2] = 5.0
    return ws, wt


def _close_grad(got, ref):
    """rtol 1e-6, and 1e-6 of the tensor's largest |entry| where a small
    entry is the difference of two softmax terms (f32 cancellation)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * float(np.abs(ref).max()))


LOGIT_LOSSES = {
    "distribution_loss": (jkd.distribution_loss, tkd.distribution_loss),
    "loss_kd": (functools.partial(jkd.loss_kd, temperature=4.0),
                functools.partial(tkd.loss_kd, temperature=4.0)),
}
WEIGHT_LOSSES = {
    "layer_weight_kl": (jkd.layer_weight_kl, tkd.layer_weight_kl),
    "layer_weight_kl_softened": (functools.partial(jkd.layer_weight_kl_softened, temperature=6.0),
                                 functools.partial(tkd.layer_weight_kl_softened, temperature=6.0)),
}


@pytest.mark.parametrize("name", list(LOGIT_LOSSES))
def test_logit_losses_and_student_grads_match_jax(name):
    jf, tf = LOGIT_LOSSES[name]
    s, t = _logits(1)
    ref, ref_g = jax.value_and_grad(jf)(jnp.asarray(s), jnp.asarray(t))
    st, tt = _t(s).requires_grad_(True), _t(t).requires_grad_(True)
    got = tf(st, tt)
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    _close_grad(st.grad, ref_g)
    assert tt.grad is None  # the teacher is detached


@pytest.mark.parametrize("name", list(WEIGHT_LOSSES))
def test_weight_losses_and_student_grads_match_jax(name):
    jf, tf = WEIGHT_LOSSES[name]
    ws, wt = _weights(2)
    ref, ref_g = jax.value_and_grad(jf)([jnp.asarray(w) for w in ws], [jnp.asarray(w) for w in wt])
    st = [_t(w).requires_grad_(True) for w in ws]
    tt = [_t(w).requires_grad_(True) for w in wt]
    got = tf(st, tt)
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    for g, rg in zip(st, ref_g):
        _close_grad(g.grad, rg)
    assert all(w.grad is None for w in tt)
    if name == "layer_weight_kl_softened":
        # the 1x1 conv's softened axis is the kernel width (size 1): it
        # contributes nothing, as in the reference
        assert not st[1].grad.any()


def test_layer_kl_refuses_an_oihw_teacher_beside_an_hwio_student():
    ws, wt = _weights(3)
    st = [_t(w) for w in ws]
    oihw = [_t(w).permute(3, 2, 0, 1) for w in wt]
    for f in (tkd.layer_weight_kl, tkd.layer_weight_kl_softened):
        with pytest.raises(ValueError, match="HWIO"):
            f(st, oihw)
        f(st, [w.permute(2, 3, 1, 0) for w in oihw])  # back in HWIO: fine


def _conv_paths_jax(model, image_shape):
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, *image_shape)), train=False),
                            jax.random.PRNGKey(0))
    return [jres.module_path_str(p) for p in jres.conv_weight_paths(shapes["params"])]


@pytest.mark.parametrize("skip_downsample", [True, False])
def test_match_conv_pairs_matches_jax_on_resnet18(skip_downsample):
    s_j = _conv_paths_jax(jreg.create_model("resnet18", "imagenet"), (224, 224, 3))
    t_j = _conv_paths_jax(jreg.create_model("resnet18_float", "imagenet"), (224, 224, 3))
    s_t = [tres.module_path_str(p) for p in
           tres.conv_weight_paths(shape_tree(treg.create_model("resnet18", "imagenet")))]
    t_t = [tres.module_path_str(p) for p in
           tres.conv_weight_paths(shape_tree(treg.create_model("resnet18_float", "imagenet")))]
    assert (s_t, t_t) == (s_j, t_j)
    got = tkd.match_conv_pairs(s_t, t_t, skip_downsample=skip_downsample)
    assert got == jkd.match_conv_pairs(s_j, t_j, skip_downsample=skip_downsample)
    assert len(got) == (16 if skip_downsample else 19)


# -- the bottleneck teacher and the bridge ------------------------------------------

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


def _narrow(pkg, kind):
    kw = {"react": dict(variant="react", act="rprelu"),
          "float": dict(variant="float", act="identity"),
          "bottleneck": dict(variant="float", act="identity", block="bottleneck")}[kind]
    return pkg.BiResNet((1, 1), 10, width=8, stem="imagenet", **kw)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_narrow_bottleneck_forward_matches_flax(train):
    jmodel = _narrow(jres, "bottleneck")
    tree = _seeded_tree(jmodel, (32, 32, 3), seed=4)
    port = _narrow(tres, "bottleneck").from_flax(tree)
    assert isinstance(port.layer1_0, tres.FloatBottleneck) and port.fc.in_features == 4 * 8 * 2
    x = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    if train:
        ref, mutated = jmodel.apply(tree, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jmodel.apply(tree, jnp.asarray(x), train=False)
    got = port.train(train)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    if train:
        want = flax_to_state_dict({"params": tree["params"], "batch_stats": mutated["batch_stats"]})
        for k, v in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_bridge_round_trips_the_bottleneck_exactly():
    jmodel = _narrow(jres, "bottleneck")
    tree = _seeded_tree(jmodel, (32, 32, 3), seed=6)
    port = _narrow(tres, "bottleneck").from_flax(tree)
    back = port.to_flax()
    flat = lambda t: {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(t)}
    want, got = flat(tree), flat(back)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for leaf in ("conv3", "bn3", "downsample_conv", "downsample_bn"):
        assert leaf in back["params"]["layer1_0"]
    assert "downsample_conv" not in back["params"].get("layer1_1", {})
    sd = port.state_dict()
    assert sd["layer1_0.conv3.weight"].shape == (32, 8, 1, 1)
    assert sd["layer2_0.downsample_conv.weight"].shape == (64, 32, 1, 1)


# -- teacher checkpoints ---------------------------------------------------------------

def _teacher_file(tmp_path, kind, seed=7):
    """A narrow float model's weights in torchvision layout, as a .pth.tar."""
    tree = _seeded_tree(_narrow(jres, kind), (32, 32, 3), seed)
    port = _narrow(tres, kind).from_flax(tree)
    path = str(tmp_path / f"{kind}.pth.tar")
    torch.save({"state_dict": torchvision_state_dict(port.state_dict()), "epoch": 3}, path)
    return path


def _jax_load(kind, path):
    jmodel = _narrow(jres, kind)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    loaded = jax_load_torch_checkpoint(path)
    return jmodel, {
        "params": jloop._overlay(init["params"], loaded["params"], scope="teacher params",
                                 allow_missing=False),
        "batch_stats": jloop._overlay(init["batch_stats"], loaded["batch_stats"],
                                      scope="teacher batch_stats", allow_missing=False),
    }


@pytest.mark.parametrize("kind", ["float", "bottleneck"])
def test_one_teacher_file_gives_both_packages_the_same_logits(tmp_path, kind):
    path = _teacher_file(tmp_path, kind)
    sd = torch.load(path, weights_only=True)["state_dict"]
    assert all(k.startswith("module.") for k in sd)
    assert any(".downsample.0." in k for k in sd) and any("num_batches_tracked" in k for k in sd)
    jmodel, jvars = _jax_load(kind, path)
    port = load_state_dict_strict(_narrow(tres, kind), load_torch_checkpoint(path)).eval()
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("fault,match", [("shape", "shape mismatch"), ("extra", "not consumed"),
                                         ("missing", "missing")])
def test_strict_loading_errors_raise_in_both_packages(tmp_path, fault, match):
    path = _teacher_file(tmp_path, "float")
    ckpt = torch.load(path, weights_only=True)
    sd = ckpt["state_dict"]
    if fault == "shape":
        sd["module.layer1.0.conv2.weight"] = sd["module.layer1.0.conv2.weight"][:, :4].clone()
    elif fault == "extra":
        sd["module.layer3.0.conv1.weight"] = torch.zeros(4, 4, 3, 3)
    else:
        del sd["module.layer2.0.bn1.running_var"]
    torch.save(ckpt, path)
    with pytest.raises(ValueError, match=match):
        load_state_dict_strict(_narrow(tres, "float"), load_torch_checkpoint(path))
    with pytest.raises(ValueError, match=match):
        _jax_load("float", path)


# -- one teacher-student step -------------------------------------------------------------

TS_CASES = {
    # id: (teacher kind, react, beta, kurtosis)
    "float-teacher-beta200-kurt": ("float", False, 200.0, True),
    "react-bottleneck-teacher": ("bottleneck", True, 200.0, True),
}


@functools.lru_cache(maxsize=None)
def _run_both(case_id, steps=3, seed=0):
    """Three TS steps of both packages from the same student and teacher
    weights and batches (cached: the tests share the run)."""
    kind, react, beta, kurt = TS_CASES[case_id]
    lr, shape = 1e-3, (32, 32, 3)
    jmodel, port = _narrow(jres, "react"), _narrow(tres, "react")
    jteacher, tteacher = _narrow(jres, kind), _narrow(tres, kind)
    tree = _seeded_tree(jmodel, shape, seed)
    ttree = _seeded_tree(jteacher, shape, seed + 100)
    port.from_flax(tree)
    tteacher.from_flax(ttree).requires_grad_(False)
    teacher_before = {k: v.clone() for k, v in tteacher.state_dict().items()}
    hooked = select_hooked_paths(shape_tree(port), RunConfig(w_kurtosis=True)) if kurt else ()
    common = dict(
        w_kurtosis=kurt, kurt_paths=hooked, kurt_targets=tuple(1.2 + 0.1 * i for i in range(len(hooked))),
        w_lambda_kurtosis=0.5, teacher_student=True, react=react, alpha=0.9, beta=beta,
        w_lambda_ce=1.0, log_grad_norm=True, probe_paths=hooked,
        probe_names=tuple(".".join(p[:-1]) for p in hooked), track_nonfinite=True,
    )
    tcfg = match_kd_pairs(port, tteacher, StepConfig(**common))
    pairs = tcfg.kd_pairs
    rng = np.random.default_rng(seed + 7)
    batches = [(rng.normal(size=(8, *shape)).astype(np.float32),
                rng.integers(0, 10, size=(8,)).astype(np.int32)) for _ in range(steps)]
    tx = jax_make_optimizer(tree["params"], dataset="imagenet", lr=lr, epochs=2, steps_per_epoch=4,
                            policy="adam-linear")
    jcfg = JStepConfig(**common, kd_pairs=pairs)
    jstep = jax.jit(jax_make_ts_train_step(jmodel, jteacher, tx, jcfg))
    jstate = JTrainState.create(tree, tx)
    opt = toptim.make_optimizer(port, dataset="imagenet", lr=lr, epochs=2, steps_per_epoch=4,
                                policy="adam-linear")
    tstate = TrainState(port, opt)
    tstep = make_ts_train_step(port, tteacher, opt, tcfg)
    tk = (1.0, 1.0)
    jtk = (jnp.float32(1.0), jnp.float32(1.0))
    out = []
    prev_j, prev_t = jb.get_active_family(), tb.get_active_family()
    jb.set_active_family("ste")
    tb.set_active_family("ste")
    try:
        for i, (x, y) in enumerate(batches):
            jstate, jm = jstep(jstate, ttree, (jnp.asarray(x), jnp.asarray(y)), jtk, jnp.float32(1.0))
            tstate, tm = tstep(tstate, (_t(x), _t(y).long()), tk, 1.0)
            out.append((jax.device_get(jm), {k: v.numpy() for k, v in tm.items()},
                        {n: p.grad.clone() for n, p in port.named_parameters()} if i == 0 else None,
                        jax.device_get(jstate.variables),
                        {k: v.clone() for k, v in port.state_dict().items()}))
    finally:
        jb.set_active_family(prev_j)
        tb.set_active_family(prev_t)
    teacher_after = {k: v.clone() for k, v in tteacher.state_dict().items()}
    return dict(out=out, lr=lr, tree=tree, ttree=ttree, pairs=pairs, cfg=jcfg, batch=batches[0],
                teacher=(teacher_before, teacher_after, tteacher))


def _jax_ts_grads(case_id, run):
    """The reference's TS loss (``make_ts_train_step``'s ``loss_fn``) and
    its gradient at the first step."""
    kind = TS_CASES[case_id][0]
    jmodel, jteacher = _narrow(jres, "react"), _narrow(jres, kind)
    cfg, tree, ttree = run["cfg"].resolved(), run["tree"], run["ttree"]
    x, y = (jnp.asarray(a) for a in run["batch"])

    def loss_fn(params):
        logits, _ = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]}, x,
                                 train=True, mutable=["batch_stats"])
        t_logits = jteacher.apply(ttree, x, train=False)
        loss = (jkd.distribution_loss(logits, t_logits) * cfg.alpha
                + jax_ce(logits, y) * cfg.w_lambda_ce)
        if cfg.beta != 0.0 and cfg.kd_pairs:
            sw = [jres.get_by_path(params, sp) for sp, _ in cfg.kd_pairs]
            tw = [jres.get_by_path(ttree["params"], tp) for _, tp in cfg.kd_pairs]
            loss = jkd.layer_weight_kl(sw, tw) * cfg.beta + loss
        reg, _ = _regularization_terms(params, cfg, jnp.float32(1.0))
        return loss + reg

    return jax.device_get(jax.jit(jax.grad(loss_fn))(tree["params"]))


@pytest.mark.parametrize("case_id", list(TS_CASES))
def test_one_ts_step_matches_the_reference(case_id):
    run = _run_both(case_id)
    jm, tm, tgrads, jvars, tsd = run["out"][0]
    lr, tree = run["lr"], run["tree"]
    react = TS_CASES[case_id][1]
    if react:
        assert float(tm["loss_kl"]) == 0.0 and float(tm["loss_ce"]) == 0.0
        assert len(run["pairs"]) == 2  # layerS_0.conv2 only; the guard passes under react
    else:
        assert len(run["pairs"]) == 4 and float(tm["loss_kl"]) > 0.0
    for key in ("loss", "loss_ce", "loss_kl", "loss_kl_c", "loss_kurt"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=1e-30, err_msg=key)
    for key in ("top1", "top5", "count", "nonfinite"):
        assert tm[key] == jm[key]
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=GRAD_TOL)
    ref_g = flax_to_state_dict({"params": _jax_ts_grads(case_id, run),
                                "batch_stats": tree["batch_stats"]})
    for name, g in tgrads.items():
        want = ref_g[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=GRAD_TOL * scale, err_msg=name)
    ref_sd, old_sd = flax_to_state_dict(jvars), flax_to_state_dict(tree)
    for name, v in tsd.items():
        want = ref_sd[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                       atol=1e-4 * float(np.abs(want).max()), err_msg=name)
            continue
        gref = ref_g[name].numpy()
        keep = np.abs(gref) >= 1e-3 * max(float(np.abs(gref).max()), 1e-30)
        np.testing.assert_allclose((v.numpy() - old_sd[name].numpy())[keep],
                                   (want - old_sd[name].numpy())[keep], rtol=0, atol=2e-3 * lr,
                                   err_msg=name)


@pytest.mark.parametrize("case_id", list(TS_CASES))
def test_three_ts_steps_track_the_reference_and_leave_the_teacher_unchanged(case_id):
    run = _run_both(case_id)
    for jm, tm, *_ in run["out"]:
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-3)
        assert np.isfinite(tm["loss"])
    before, after, teacher = run["teacher"]
    assert set(before) == set(after)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(not p.requires_grad and p.grad is None for p in teacher.parameters())


# -- fit: the shape guard, build_teacher, the frozen teacher, the CLI --------------------------

class _Reached(Exception):
    pass


@pytest.mark.parametrize("react", [False, True], ids=["beta200-raises", "react-passes"])
def test_shape_guard_in_both_fits(tmp_path, monkeypatch, react):
    """Both packages' ``fit`` with a narrow react student and a narrow
    bottleneck teacher, stopped where the TS step is built."""
    narrow_j = {"resnet18": lambda: _narrow(jres, "react"),
                "resnet50_float": lambda: _narrow(jres, "bottleneck")}
    narrow_t = {"resnet18": lambda: _narrow(tres, "react"),
                "resnet50_float": lambda: _narrow(tres, "bottleneck")}

    def reached(*args):
        raise _Reached(args[-1].kd_pairs)

    monkeypatch.setattr(jloop, "create_model", lambda arch, dataset, **kw: narrow_j[arch]())
    monkeypatch.setattr(tloop, "create_model", lambda arch, dataset, **kw: narrow_t[arch]())
    monkeypatch.setattr(jloop, "make_ts_train_step", reached)
    monkeypatch.setattr(tloop, "make_ts_train_step", reached)
    kw = dict(dataset="imagenet", arch="resnet18", synthetic=True, synthetic_train_size=8,
              synthetic_val_size=8, batch_size=8, epochs=1, imagenet_setting_step_2_ts=True,
              arch_teacher="resnet50_float", allow_random_teacher=True, react=react, beta=200.0,
              seed=0)
    outcomes = []
    for fit_fn, cfg in ((jloop.fit, JRunConfig(log_path=str(tmp_path / "jlog"), **kw)),
                        (tloop.fit, RunConfig(device="cpu", log_path=str(tmp_path / "tlog"),
                                              **kw))):
        with pytest.raises((ValueError, _Reached)) as e:
            fit_fn(cfg)
        outcomes.append(e.value)
    if react:
        assert all(isinstance(o, _Reached) for o in outcomes)
        assert outcomes[0].args[0] == outcomes[1].args[0] and len(outcomes[0].args[0]) == 2
    else:
        assert all(isinstance(o, ValueError) and "shape-matched" in str(o) for o in outcomes)
        assert "(3, 3, 8, 8) vs teacher (1, 1, 8, 8)" in str(outcomes[1])


def test_build_teacher_refuses_a_random_teacher_and_a_run_dir(tmp_path):
    """A random teacher and a directory that holds no run are refused; a
    port run dir loads, its ``model_best`` bitwise."""
    cfg = RunConfig(dataset="cifar10", arch="resnet20", imagenet_setting_step_2_ts=True,
                    arch_teacher="resnet20_float", device="cpu")
    with pytest.raises(ValueError, match="random-init"):
        build_teacher(cfg, torch.device("cpu"))
    (tmp_path / "not_a_run").mkdir()
    with pytest.raises(RuntimeError, match="no loadable checkpoint"):
        build_teacher(RunConfig(**{**cfg.__dict__, "resume_teacher": str(tmp_path / "not_a_run")}),
                      torch.device("cpu"))
    written = write_teacher_checkpoint(str(tmp_path / "t.pth.tar"), "resnet20_float", "cifar10",
                                       seed=4)
    opt = toptim.make_optimizer(written, dataset="cifar10", lr=0.1, epochs=1, steps_per_epoch=1)
    save_checkpoint(str(tmp_path / "run"), TrainState(model=written, optimizer=opt), epoch=0,
                    arch="resnet20_float", best_acc1=10.0, is_best=True)
    loaded = build_teacher(RunConfig(**{**cfg.__dict__, "resume_teacher": str(tmp_path / "run")}),
                           torch.device("cpu"))
    want, got = written.state_dict(), loaded.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    teacher = build_teacher(RunConfig(**{**cfg.__dict__, "allow_random_teacher": True}),
                            torch.device("cpu"))
    for t in (loaded, teacher):
        assert not t.training and not any(p.requires_grad for p in t.parameters())


def test_fit_leaves_the_loaded_teacher_bitwise_unchanged(tmp_path, monkeypatch):
    path = str(tmp_path / "resnet20_float.pth.tar")
    written = write_teacher_checkpoint(path, "resnet20_float", "cifar10", seed=3)
    built = []

    def capture(cfg, device):
        built.append(build_teacher(cfg, device))
        return built[-1]

    monkeypatch.setattr(tloop, "build_teacher", capture)
    losses = []
    res = tloop.fit(RunConfig(dataset="cifar10", arch="resnet20", synthetic=True, batch_size=8,
                              epochs=1, synthetic_train_size=16, synthetic_val_size=8, seed=1,
                              imagenet_setting_step_2_ts=True, arch_teacher="resnet20_float",
                              resume_teacher=path, w_kurtosis=True, print_freq=1, device="cpu",
                              log_path=str(tmp_path / "log")),
                    on_step=lambda e, i, m: losses.append({k: float(m[k]) for k in
                                                           ("loss", "loss_kl", "loss_kl_c")}))
    assert set(res) == {"best_acc1", "best_epoch"} and len(losses) == 2
    assert all(np.isfinite(list(m.values())).all() and m["loss_kl"] > 0 for m in losses)
    (teacher,) = built
    assert not teacher.training
    want = written.state_dict()
    got = teacher.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_cli_trains_two_ts_steps_on_the_cpu(tmp_path, capsys):
    path = str(tmp_path / "resnet20_float.pth.tar")
    write_teacher_checkpoint(path, "resnet20_float", "cifar10", seed=2)
    rc = cli.main(["--dataset", "cifar10", "-a", "resnet20", "--synthetic", "-b", "8",
                   "--epochs", "1", "--synthetic-train-size", "16", "--synthetic-val-size", "8",
                   "--imagenet_setting_step_2_ts", "--react", "--arch_teacher", "resnet20_float",
                   "--resume_teacher", path, "--w-kurtosis", "--kd", "--alpha", "0.8",
                   "--temperature", "3", "--w-lambda-ce", "0.5", "--seed", "1", "--device", "cpu",
                   "--log_path", str(tmp_path / "log")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"best_acc1", "best_epoch"}
