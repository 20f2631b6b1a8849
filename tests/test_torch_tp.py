"""Tensor parallelism over the mesh's ``model`` axis on the CPU: spawned
ranks over gloo (one process group for the cases of each job), held to
the JAX package and to one process of the port:

- ``param_spec``/``params_shardings``: the port shards exactly the
  parameters the JAX ``params_shardings`` shards, on the flagship,
  ``resnet18_float`` and ``resnet34_float`` trees (``jax.eval_shape``
  inits), at N = 2 and 4. (The JAX package's own TP tests use width 8,
  where no leaf reaches the 256 output channels the rule asks for: these
  trees, and the float model below, have stages 256 and 512 wide);
- a float ``BiResNet(stage_sizes=(1, 1), width=128, stem="cifar",
  variant="float")`` (its second stage 256 wide: three convs sharded) at
  8×8 from the JAX init carried over by ``bridge.py``: two steps on 2
  ranks (model 2) and on 4 ranks (data 2 × model 2) against the JAX step
  on the 8-device CPU mesh with ``model_parallel=2`` on the same global
  batches, with ``test_torch_ddp.py``'s float-case tolerances (each
  step's loss to rtol 1e-5, the first step's gradient within GRAD_TOL of
  its tensor's largest |entry|, the parameters after it within
  lr·GRAD_TOL of that plus 1e-5 of their own);
- the flagship ``resnet18`` (react) at 32×32, -b 4, on 2 ranks (model 2)
  against one process of the port on the same batch, the plain, the
  stochastic, the teacher–student, the ``--remat`` and the bf16 steps: the one
  process's binary convs and RPReLUs take the job's inputs
  (``chip_smoke.InputReplay``), and its own inputs are the same bits
  (no sign crossing, difference 0: the forward is bitwise up to the
  classifier, whose logits are within FC_TOL of the largest); the loss to
  rtol 1e-5, every gradient (the sharded ones gathered) within GRAD_TOL
  (in bf16 the logits, loss and gradients to ``chip_smoke.BF16_PARITY``:
  each dx summed over ``model`` rounds to bf16 again);
  the ranks' replicated tensors (parameters, optimizer state, BN
  statistics) bitwise equal after the steps;
- ``chip_smoke.py``'s ``[train-tp]`` (a) rehearsed through ``fit`` on 2
  ranks at -b 8 (CIFAR ``resnet18``, whose layer3 and layer4 are
  sharded): one run dir, the eval ``count`` the whole val split, the
  replicated tensors bitwise equal; its mid-epoch checkpoint resumed on
  one process, and a one-process checkpoint resumed under model 2, each
  ``resharded`` and its restored state (cut and gathered) bitwise the
  saved one;
- the model-axis functions of ``parallel/tensor.py`` on 2 ranks (the
  gather and its backward, ``copy_to_model``'s summed cotangent,
  ``whole``, ``agree_replicated_grads`` on gradients that differ by rank),
  and ``load_checkpoint`` into a state already sharded (no collective:
  each parameter and Adam moment takes its slice of the whole tensors).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bdbnn_tpu.losses.kd import softmax_cross_entropy as jax_ce
from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.models.resnet import BiResNet as JBiResNet
from bdbnn_tpu.parallel import create_sharded_state as jcreate_sharded_state
from bdbnn_tpu.parallel import jit_train_step as jjit_train_step
from bdbnn_tpu.parallel import make_mesh as jmake_mesh
from bdbnn_tpu.parallel import params_shardings as jparams_shardings
from bdbnn_tpu.parallel import shard_batch as jshard_batch
from bdbnn_tpu.train import StepConfig as JStepConfig
from bdbnn_tpu.train import TrainState as JTrainState
from bdbnn_tpu.train import make_optimizer as jax_make_optimizer
from bdbnn_tpu.train import make_train_step as jax_make_train_step
from bdbnn_tpu_torch.bridge import flax_to_state_dict
from bdbnn_tpu_torch.models import create_model
from bdbnn_tpu_torch.obs.events import read_events, read_jsonl
from bdbnn_tpu_torch.parallel import Mesh, params_shardings, topology
from bdbnn_tpu_torch.utils import checkpoint as ck

GRAD_TOL = 1e-3
FC_TOL = 1e-6
STEPS_PER_EPOCH = 4
FLOAT_KW = dict(stage_sizes=(1, 1), num_classes=10, width=128, stem="cifar", variant="float")
FLOAT_BASE = dict(dataset="cifar10", synthetic=True, seed=0, device="cpu", lr=0.05, epochs=2,
                  model_parallel=2)
FLAG_BASE = dict(dataset="imagenet", arch="resnet18", synthetic=True, seed=0, device="cpu",
                 lr=1e-3, epochs=2, w_kurtosis=True, diffkurt=True)
FLAG_CASES = {
    "binary": dict(),
    "stochastic": dict(arch="resnet18_step2", binarizer="stochastic"),
    "teacher-student": dict(imagenet_setting_step_2_ts=True, arch_teacher="resnet18_float",
                            allow_random_teacher=True),
    "remat": dict(remat=True),
    "bf16": dict(dtype="bfloat16"),
}
FIT_KW = dict(arch="resnet18", dataset="cifar10", diffkurt=False, batch=8, device="cpu")


def _float_batches(steps=2, n=8, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
             rng.integers(0, 10, size=(n,)).astype(np.int64)) for _ in range(steps)]


def _flag_batches(steps, n=4, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 1000, size=(n,)).astype(np.int64)) for _ in range(steps)]


def _flag_steps(case):
    return 2 if case == "binary" else 1


def _float_variables():
    jmodel = JBiResNet(**FLOAT_KW)
    v = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)), train=True)
    return jmodel, jax.tree_util.tree_map(np.asarray, jax.device_get(v))


def _spawn(world, calls):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return chip_smoke.spawn_ranks("each", world, "cpu", "gloo", dict(calls=calls),
                                      timeout_s=240)
    finally:
        torch.set_num_threads(threads)


class _Lazy(dict):
    """Runs made on first use, each by the first test that reads it (so
    no one test carries every job of the module)."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, key):
        self[key] = value = self.make(self, key)
        return value


def _float_job(runs, world):
    """The float model's two steps on ``world`` ranks."""
    _, variables = _float_variables()
    call = ("steps", dict(cfg_kw=FLOAT_BASE, batches=_float_batches(), model_kw=FLOAT_KW,
                          variables=variables, steps_per_epoch=STEPS_PER_EPOCH))
    return [r[0] for r in _spawn(world, [call])]


def _flag_job(runs, case):
    """A flagship case on 2 ranks (each rank recording its binary convs'
    and RPReLUs' inputs), then its first step in one process on the job's
    inputs: (each rank's results, the one process's)."""
    kw = FLAG_CASES[case]
    cfg_kw = {**FLAG_BASE, **kw}
    batches = _flag_batches(_flag_steps(case))
    drawn = None
    if kw.get("binarizer") == "stochastic":
        margin = chip_smoke.MarginDraws(seed=29)
        chip_smoke.ddp_steps(cfg_kw, batches, draws=margin, steps_per_epoch=STEPS_PER_EPOCH)
        drawn = margin.drawn
    ranks = _spawn(2, [("steps", dict(cfg_kw={**cfg_kw, "model_parallel": 2}, batches=batches,
                                      draws=drawn, inputs="record", signs=True,
                                      steps_per_epoch=STEPS_PER_EPOCH))])
    ranks = [r[0] for r in ranks]
    one = chip_smoke.ddp_steps(cfg_kw, batches[:1],
                               draws=chip_smoke.ReplayDraws(drawn) if drawn else None,
                               inputs=ranks[0]["inputs"], signs=True,
                               steps_per_epoch=STEPS_PER_EPOCH)
    return ranks, one


def _fit_job(root, runs, key):
    """``tp``: [train-tp] (a) at -b 8 through ``fit`` on 2 ranks;
    ``to_one``: its step-2 checkpoint resumed on one process; ``one``: a
    one-process run; ``to_tp``: its step-2 checkpoint resumed on 2 ranks."""
    if key in ("tp", "to_tp"):
        extra = {} if key == "tp" else dict(resume=runs["one"]["old"], after_shard=[])
        ranks = [r[0] for r in _spawn(2, [("fit", dict(log_path=str(root / key),
                                                       model_parallel=2, **FIT_KW, **extra))])]
        return {"ranks": ranks, "old": f"{ranks[0]['run_dir']}/{ck.CKPT_NAME}.old"}
    extra = {} if key == "one" else dict(resume=runs["tp"]["old"], after_shard=[])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = chip_smoke.ddp_fit(str(root / key), **FIT_KW, **extra)
    finally:
        torch.set_num_threads(threads)
    return {"ranks": [run], "old": f"{run['run_dir']}/{ck.CKPT_NAME}.old"}


@pytest.fixture(scope="module")
def float_runs():
    return _Lazy(_float_job)


@pytest.fixture(scope="module")
def flag_runs():
    return _Lazy(_flag_job)


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_fit")
    return _Lazy(lambda runs, key: _fit_job(root, runs, key))


def _port_name(path) -> str:
    keys = [str(getattr(p, "key", p)) for p in path]
    return ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]])


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """The JAX package's param shapes (``jax.eval_shape`` of its init) and
    the port's model, whole, of ``arch``."""
    jmodel = jreg.create_model(arch, "imagenet")
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 224, 224, 3)), train=True))
    return shapes["params"], create_model(arch, "imagenet")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["resnet18", "resnet18_float", "resnet34_float"])
def test_param_spec_shards_the_leaves_the_reference_shards(arch, n):
    params, model = _trees(arch)
    specs = jparams_shardings(jmake_mesh(model_parallel=n), params)
    want = {_port_name(path) for path, sh in jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "spec"))[0] if any(a is not None for a in sh.spec)}
    got = {name for name, dim in params_shardings(model, n).items() if dim is not None}
    assert got == want
    # the flagship: the 10 binary convs of layer3 and layer4, and the FC
    # (resnet34: 13 convs in layer3, 7 in layer4)
    assert len(got) == {"resnet18": 11, "resnet18_float": 11, "resnet34_float": 21}[arch]
    assert all(k.startswith(("layer3", "layer4", "fc")) for k in got)


def test_mesh_of_one_and_topology_of_a_model_axis():
    mesh = Mesh(data=2, rank=3, model=2)
    assert (mesh.world, mesh.data_rank, mesh.model_rank) == (4, 1, 1)
    assert topology(mesh) == {"processes": 4, "devices": 4, "mesh": {"data": 2, "model": 2}}
    assert mesh.shape == {"data": 2, "model": 2}
    assert list(mesh.shape) == list(jmake_mesh(model_parallel=2).shape)


def _jax_tp_run(batches):
    """The JAX step on the 8-device CPU mesh with model_parallel=2: each
    step's loss, the parameters after the first step, and the first step's
    gradient (one device, the same global batch)."""
    jmodel, variables = _float_variables()
    cfg = dict(dataset="cifar10", lr=FLOAT_BASE["lr"], epochs=FLOAT_BASE["epochs"],
               steps_per_epoch=STEPS_PER_EPOCH, momentum=0.9, weight_decay=1e-4)
    tx = jax_make_optimizer(variables["params"], **cfg)
    mesh = jmake_mesh(model_parallel=2)
    state = jcreate_sharded_state(mesh, variables, tx, JTrainState)
    step = jjit_train_step(jax_make_train_step(jmodel, tx, JStepConfig()))
    tk = (jnp.float32(1.0), jnp.float32(1.0))

    @jax.jit
    def grads(v, x, y):
        def loss(params):
            logits, _ = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                     train=True, mutable=["batch_stats"])
            return jax_ce(logits, y)

        return jax.grad(loss)(v["params"])

    g = flax_to_state_dict({"params": jax.device_get(grads(variables, *batches[0])),
                            "batch_stats": variables["batch_stats"]})
    losses, first = [], None
    for x, y in batches:
        state, m = step(state, jshard_batch(mesh, x, y), tk, jnp.float32(0.0))
        losses.append(float(m["loss"]))
        if first is None:
            first = flax_to_state_dict(jax.device_get(state.variables))
    return losses, first, g


@pytest.mark.parametrize("world", [2, 4])
def test_float_model_on_the_model_axis_matches_the_jax_mesh_step(float_runs, world):
    ranks = float_runs[world]
    losses, first, g = _jax_tp_run(_float_batches())
    data = world // 2
    for i, want in enumerate(losses):
        got = sum(r["losses"][i] for r in ranks[::2]) / data
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"step {i}")
    for name, got in ranks[0]["grads"].items():
        want = g[name].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()), err_msg=name)
    got = ranks[0]["first_state"]
    assert set(got) == set(first)
    for name, want in first.items():
        want = want.numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(want).max()), err_msg=name)
            continue
        atol = (1e-5 * float(np.abs(want).max())
                + FLOAT_BASE["lr"] * GRAD_TOL * float(g[name].abs().max()))
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0, atol=atol, err_msg=name)
    # the three convs of the 256-wide stage are sharded; every rank holds
    # the replicated tensors bitwise, and the ranks of one model shard
    # (the data ranks) its slice bitwise
    assert ranks[0]["local"]["sharded"] == ["layer2_0.conv1.weight", "layer2_0.conv2.weight",
                                            "layer2_0.downsample_conv.weight"]
    for r in ranks[1:]:
        assert not chip_smoke.local_diff(ranks[0]["local"], r["local"], replicated_only=True)
        assert not chip_smoke.state_diff(ranks[0]["state"], r["state"])
    for m in range(2):
        for r in ranks[m + 2::2]:
            assert not chip_smoke.local_diff(ranks[m]["local"], r["local"], replicated_only=False)


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_flagship_step_on_the_model_axis_equals_one_process(flag_runs, case):
    ranks, ref = flag_runs[case]
    # the forward is the one process's bits up to the classifier: its own
    # inputs at every binary conv and RPReLU equal the job's, and so does
    # what the classifier reads; the logits differ by its sums' order
    assert ref["input_flips"] == {"conv": 0, "rprelu": 0} and ref["input_max_diff"] == 0.0
    assert sum(chip_smoke.sign_crossings([ranks[0]["signs"]], ref["signs"])) == 0
    assert torch.equal(ranks[0]["first"]["feat"], ref["first"]["feat"])
    bf16 = chip_smoke.BF16_PARITY if case == "bf16" else None
    lg, lg1 = ranks[0]["first"]["logits"], ref["first"]["logits"]
    fc_tol = bf16["loss_rtol"] if bf16 else FC_TOL
    assert float((lg - lg1).abs().max()) <= fc_tol * float(lg1.abs().max())
    # (both ranks read the whole batch: the crossings are counted above)
    cmp = chip_smoke.compare_ddp_step(ranks, {**ref, "signs": None})
    assert cmp["ranks_grads_equal"]
    assert cmp["loss_rel"] <= (bf16["loss_rtol"] if bf16 else 1e-5), cmp["loss_rel"]
    grad_tol = bf16["grad_tol"] if bf16 else GRAD_TOL
    bad = {n: e for n, e in cmp["grad_err"].items() if not e <= grad_tol}
    assert not bad, bad
    assert len(ranks[0]["local"]["sharded"]) == 11
    assert not chip_smoke.local_diff(ranks[0]["local"], ranks[1]["local"], replicated_only=True)
    assert not chip_smoke.state_diff(ranks[0]["state"], ranks[1]["state"])
    assert ranks[0]["state"]["step"] == _flag_steps(case)


def test_train_tp_rehearsal_through_fit_on_two_ranks(fit_runs):
    """``chip_smoke.py``'s [train-tp] (a) at -b 8 on the CPU: ``ddp_fit``
    on 2 ranks with ``--model-parallel 2`` (3 steps, a checkpoint every 2,
    eval)."""
    ranks = fit_runs["tp"]["ranks"]
    run_dir = ranks[0]["run_dir"]
    assert all(r["run_dir"] == run_dir for r in ranks)
    (ev,) = read_events(run_dir, "eval")
    (ev1,) = [e for e in read_jsonl(f"{run_dir}/events.p1.jsonl") if e["kind"] == "eval"]
    assert ev["count"] == ev1["count"] == 8
    assert all(len(r["losses"]) == 3 and np.isfinite(r["losses"]).all() for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len(ranks[0]["local"]["sharded"]) == 10
    assert not chip_smoke.local_diff(ranks[0]["local"], ranks[1]["local"], replicated_only=True)
    assert not chip_smoke.state_diff(ranks[0]["state"], ranks[1]["state"])
    assert [e["step_in_epoch"] for e in read_events(run_dir, "checkpoint")] == [2, 0]


@pytest.mark.parametrize("direction", ["model 2 -> 1", "model 1 -> 2"])
def test_checkpoint_resumes_across_the_model_axis_bitwise(fit_runs, direction):
    tp_topo = {"processes": 2, "devices": 2, "mesh": {"data": 1, "model": 2}}
    one_topo = {"processes": 1, "devices": 1, "mesh": {"data": 1, "model": 1}}
    if direction == "model 2 -> 1":
        old, runs, topos = fit_runs["tp"]["old"], fit_runs["to_one"]["ranks"], (tp_topo, one_topo)
    else:
        old, runs, topos = fit_runs["one"]["old"], fit_runs["to_tp"]["ranks"], (one_topo, tp_topo)
    saved = torch.load(f"{old}/{ck.PAYLOAD_NAME}", map_location="cpu", weights_only=True)["state"]
    # the file holds whole tensors whatever layout wrote it
    whole = create_model("resnet18", "cifar10").state_dict()
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == {
        k: tuple(v.shape) for k, v in whole.items()}
    for r in runs:
        (restore,) = read_events(r["run_dir"], "restore")
        assert restore["resharded"] is True
        assert (restore["topology_from"], restore["topology_to"]) == topos
        # restored (and cut to the rank's shards), then gathered: the saved bits
        assert not chip_smoke.state_diff(saved, r["restored"][0])
        assert len(r["losses"]) == 1 and np.isfinite(r["losses"]).all()


def test_model_axis_functions_on_two_ranks():
    """``parallel/tensor.py`` on 2 ranks (model 2): the gather, the slice
    of the cotangent, the sum of ``copy_to_model``'s cotangents, ``whole``
    and ``agree_replicated_grads`` on gradients that differ by rank."""
    ranks = _spawn(2, [("tp_primitives", dict(seed=3))])
    ranks = [r[0] for r in ranks]
    full, cot = ranks[0]["full"], ranks[0]["cot"]
    for m, r in enumerate(ranks):
        assert torch.equal(r["full"], full)
        # the forward is the whole tensor, its backward the rank's slice
        assert torch.equal(r["y"], full)
        assert torch.equal(r["dx"], cot[..., 4 * m:4 * (m + 1)])
        # copy_to_model: the identity forward; 3·(the ranks' cotangent count)
        assert torch.equal(r["dz"], torch.full((4,), 6.0))
        assert torch.equal(r["whole"], ranks[0]["whole"])
        assert torch.equal(r["dw"], 2 * r["whole"][:, 4 * m:4 * (m + 1)])
        # a sharded parameter's gradient stays the rank's own; a
        # replicated one becomes the first model rank's
        assert torch.equal(r["dw"], r["dw_before"])
        assert torch.equal(r["rep_grad"], torch.full((5,), 0.5))


def test_load_checkpoint_cuts_whole_tensors_to_a_sharded_state(tmp_path):
    """A checkpoint (whole tensors) restored into a state already sharded
    as model rank 1 of 2 (cutting needs no collective): each sharded
    parameter and its Adam moments take their slice, every other tensor
    its whole value."""
    from bdbnn_tpu_torch.parallel.tensor import shard_model
    from bdbnn_tpu_torch.train.config import RunConfig
    from bdbnn_tpu_torch.train.loop import build_training
    from bdbnn_tpu_torch.train.step import make_train_step

    cfg = RunConfig(dataset="cifar10", arch="resnet18", synthetic=True, seed=0, device="cpu",
                    lr=1e-3, epochs=2, opt_policy="adam-linear").validate()
    state, step_cfg = build_training(cfg, torch.device("cpu"), STEPS_PER_EPOCH, 32)
    rng = np.random.default_rng(2)
    batch = (torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 10, size=(2,))))
    make_train_step(state.model, state.optimizer, step_cfg)(state, batch, (1.0, 1.0), 1.0)
    ck.save_checkpoint(str(tmp_path), state, epoch=0, arch=cfg.arch, best_acc1=0.0,
                       is_best=False, step_in_epoch=1)
    saved = ck.state_payload(state)
    fresh, _ = build_training(cfg, torch.device("cpu"), STEPS_PER_EPOCH, 32)
    names = shard_model(fresh.model, Mesh(data=1, rank=1, model=2))
    assert len(names) == 10
    ck.load_checkpoint(str(tmp_path), fresh)
    params = dict(fresh.model.named_parameters())
    index = {n: i for i, n in enumerate(n for g in ck.param_group_names(fresh) for n in g)}
    for name, whole_t in saved["model"].items():
        got = fresh.model.state_dict()[name]
        if name in names:
            dim = params[name].shard_dim
            k = whole_t.shape[dim] // 2
            want = whole_t.narrow(dim, k, k)
            for key, moment in saved["optimizer"]["state"][index[name]].items():
                if moment.dim():
                    assert torch.equal(fresh.optimizer.state[params[name]][key],
                                       moment.narrow(dim, k, k)), (name, key)
        else:
            want = whole_t
        assert torch.equal(got, want), name
