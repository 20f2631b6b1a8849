"""Data-parallel train steps of the port on the CPU: two spawned ranks
over gloo (one process group for every case), each fed its half of the
same global batches, held to the JAX package and to one process:

- global-batch BatchNorm (the ranks' ``[Σx, Σx²]`` all-reduced) against
  flax's ``BatchNorm`` on the concatenated batch: the output within 1e-5
  of its largest |entry|, the input and parameter gradients within 1e-4
  of theirs, the running statistics to rtol 1e-5;
- a float model (``resnet20_float``), two steps, against the JAX
  package's single-device step on the same global batches from weights
  carried over by ``bridge.py`` — the JAX package's own proof that its
  data parallelism equals one device (``tests/test_parallel.py``): each
  step's loss to rtol 1e-5; the first step's gradient within GRAD_TOL of
  its tensor's largest |entry|, and the parameters after it within
  lr·GRAD_TOL of that gradient's largest |entry| plus 1e-5 of their own
  (the SGD step's lr·g), the running statistics to rtol 1e-5; the ranks
  bitwise equal after both steps. (After two steps port and reference
  differ by up to 1e-3 of a conv weight's largest entry in one process
  too: the first update's summation noise moves the second gradient);
- binary models against one process of the port fed the concatenated
  batches: ``resnet8_tiny`` with ``--w-kurtosis``, the stochastic family
  (draws kept off their thresholds by ``chip_smoke.MarginDraws`` in the one
  process and replayed to each rank as its rows of the global draw), the
  teacher–student step (``resnet20`` + a seeded ``resnet20_float``
  teacher) and ``--remat``: the first step's global loss to rtol 1e-5,
  every gradient within GRAD_TOL (1e-3, ROADMAP C's whole-step tolerance)
  of its tensor's largest |entry|, the ranks' gradients bitwise equal (the
  all-reduce ran), and after both steps the ranks' parameters, optimizer
  state and BN running statistics bitwise equal. The one process's binary
  convs take the job's inputs (``chip_smoke.InputReplay``): the BN
  statistics' sums in another order move the exact ties at 0 that a
  binary conv's quantized outputs make (``resnet8_tiny``'s seeded init
  puts thousands of its ``layer1_0.conv2`` inputs at exactly 0 in one
  process and at -1.2e-7 in the job), and the sign crossings that would
  follow are counted and printed, not reseeded away;
- the rehearsal of ``chip_smoke.py``'s ``[train-ddp]`` (a) on the CPU:
  two ranks through ``fit`` at -b 8, one run dir, the eval ``count`` the
  whole val split, the replicas bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import chip_smoke
from bdbnn_tpu.losses.kd import softmax_cross_entropy as jax_ce
from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.train import StepConfig as JStepConfig
from bdbnn_tpu.train import TrainState as JTrainState
from bdbnn_tpu.train import make_optimizer as jax_make_optimizer
from bdbnn_tpu.train import make_train_step as jax_make_train_step
from bdbnn_tpu_torch.bridge import flax_to_state_dict
from bdbnn_tpu_torch.obs.events import read_events, read_jsonl
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.loop import build_training

GRAD_TOL = 1e-3
STEPS_PER_EPOCH = 4
BASE = dict(dataset="cifar10", synthetic=True, seed=0, device="cpu", lr=0.05, epochs=2)
CASES = {
    "float": dict(arch="resnet20_float"),
    "binary": dict(arch="resnet8_tiny", w_kurtosis=True),
    "stochastic": dict(arch="resnet8_tiny", w_kurtosis=True, binarizer="stochastic"),
    "teacher-student": dict(arch="resnet20", imagenet_setting_step_2_ts=True,
                            arch_teacher="resnet20_float", allow_random_teacher=True,
                            w_kurtosis=True),
    "remat": dict(arch="resnet8_tiny", w_kurtosis=True, remat=True),
}
BN_SHAPE = (8, 5, 5, 6)


def _batches(steps=2, n=8, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=(n,)).astype(np.int64)) for _ in range(steps)]


def _bn_inputs():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=BN_SHAPE) * 2 + 3).astype(np.float32)
    g = rng.normal(size=BN_SHAPE).astype(np.float32)
    c = BN_SHAPE[-1]
    return dict(x=x, g=g, scale=rng.uniform(0.5, 2, c).astype(np.float32),
                bias=rng.normal(0, 0.1, c).astype(np.float32),
                mean=rng.normal(0, 0.1, c).astype(np.float32),
                var=rng.uniform(0.5, 1.5, c).astype(np.float32))


@pytest.fixture(scope="module")
def runs():
    """Every case in one 2-rank job, then the first step of each in one
    process (the binary cases' binary convs taking the job's inputs):
    (one process's results by case, each rank's results by case, the BN
    job's results)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batches = _batches()
        drawn, calls = {}, [("batchnorm", _bn_inputs())]
        for name, kw in CASES.items():
            cfg_kw = {**BASE, **kw}
            binary = not kw["arch"].endswith("_float")
            if kw.get("binarizer") == "stochastic":
                # draws kept off their thresholds in one process, replayed
                # to the ranks as their rows of each global draw
                margin = chip_smoke.MarginDraws(seed=23)
                chip_smoke.ddp_steps(cfg_kw, batches, draws=margin,
                                     steps_per_epoch=STEPS_PER_EPOCH)
                drawn[name] = margin.drawn
            calls.append(("steps", dict(cfg_kw=cfg_kw, batches=batches, draws=drawn.get(name),
                                        inputs="record" if binary else None,
                                        steps_per_epoch=STEPS_PER_EPOCH)))
        ranks = chip_smoke.spawn_ranks("each", 2, "cpu", "gloo", dict(calls=calls),
                                       timeout_s=240)
        job = {name: [ranks[r][i + 1] for r in range(2)] for i, name in enumerate(CASES)}
        one = {}
        for name, kw in CASES.items():
            if kw["arch"].endswith("_float"):
                continue
            inputs = [torch.cat(per_rank) for per_rank in zip(*(r["inputs"] for r in job[name]))]
            draws = chip_smoke.ReplayDraws(drawn[name]) if name in drawn else None
            one[name] = chip_smoke.ddp_steps({**BASE, **kw}, batches[:1], draws=draws,
                                             inputs=inputs, steps_per_epoch=STEPS_PER_EPOCH)
    finally:
        torch.set_num_threads(threads)
    return one, job, [ranks[r][0] for r in range(2)]


def test_global_batchnorm_matches_flax_on_the_concatenated_batch(runs):
    _, _, bn = runs
    inp = _bn_inputs()
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": inp["scale"], "bias": inp["bias"]},
                 "batch_stats": {"mean": inp["mean"], "var": inp["var"]}}

    def f(xx, params):
        return flax_bn.apply({**variables, "params": params}, xx, mutable=["batch_stats"])

    y, mutated = f(jnp.asarray(inp["x"]), variables["params"])
    loss = lambda xx, params: jnp.sum(f(xx, params)[0] * inp["g"])
    dx, dparams = jax.grad(loss, argnums=(0, 1))(jnp.asarray(inp["x"]), variables["params"])
    got_y = np.concatenate([r["y"].numpy() for r in bn])
    got_dx = np.concatenate([r["dx"].numpy() for r in bn])
    for got, want, tol in ((got_y, y, 1e-5), (got_dx, dx, 1e-4),
                           (bn[0]["dscale"].numpy(), dparams["scale"], 1e-4),
                           (bn[0]["dbias"].numpy(), dparams["bias"], 1e-4)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()))
    for r in bn:
        np.testing.assert_allclose(r["mean"].numpy(), mutated["batch_stats"]["mean"], rtol=1e-5)
        np.testing.assert_allclose(r["var"].numpy(), mutated["batch_stats"]["var"], rtol=1e-5)
    # the ranks' running statistics are the same bits
    assert torch.equal(bn[0]["mean"], bn[1]["mean"]) and torch.equal(bn[0]["var"], bn[1]["var"])


def test_float_model_two_ranks_match_the_jax_single_device_step(runs):
    _, job, _ = runs
    cfg = RunConfig(**{**BASE, **CASES["float"]}).validate()
    state, _ = build_training(cfg, torch.device("cpu"), STEPS_PER_EPOCH, 32)
    tree = jax.tree_util.tree_map(np.asarray, state.model.to_flax())
    jmodel = jreg.create_model("resnet20_float", "cifar10")
    tx = jax_make_optimizer(tree["params"], dataset="cifar10", lr=cfg.lr, epochs=cfg.epochs,
                            steps_per_epoch=STEPS_PER_EPOCH, momentum=cfg.momentum,
                            weight_decay=cfg.weight_decay)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, JStepConfig()))
    jstate = JTrainState.create(tree, tx)
    tk = (jnp.float32(1.0), jnp.float32(1.0))

    @jax.jit
    def grads(variables, x, y):
        def loss(params):
            logits, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     x, train=True, mutable=["batch_stats"])
            return jax_ce(logits, y)

        return jax.grad(loss)(variables["params"])

    for i, (x, y) in enumerate(_batches()):
        if i == 0:
            g = flax_to_state_dict({"params": jax.device_get(grads(jstate.variables, x, y)),
                                    "batch_stats": tree["batch_stats"]})
            # the job's first-step gradient is the global batch's
            for name, got in job["float"][0]["grads"].items():
                want = g[name].numpy()
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=GRAD_TOL * float(np.abs(want).max()),
                                           err_msg=name)
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), tk, jnp.float32(0.0))
        loss = sum(r["losses"][i] for r in job["float"]) / 2
        np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5, err_msg=f"step {i}")
        if i == 0:
            # the parameters after the first SGD step moved by lr·g: a
            # gradient held to GRAD_TOL of its tensor's largest |entry|
            # holds them to lr·GRAD_TOL of it, plus 1e-5 of the tensor's
            # largest for rounding; the running statistics, from the batch
            # statistics, to rtol 1e-5
            ref = flax_to_state_dict(jax.device_get(jstate.variables))
            got = job["float"][0]["first_state"]
            assert set(got) == set(ref)
            for name, want in ref.items():
                want = want.numpy()
                if name.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-5,
                                               atol=1e-5 * float(np.abs(want).max()), err_msg=name)
                    continue
                atol = (1e-5 * float(np.abs(want).max())
                        + cfg.lr * GRAD_TOL * float(g[name].abs().max()))
                np.testing.assert_allclose(got[name].numpy(), want, rtol=0, atol=atol,
                                           err_msg=name)
    assert not chip_smoke.state_diff(job["float"][0]["state"], job["float"][1]["state"])


@pytest.mark.parametrize("case", ["binary", "stochastic", "teacher-student", "remat"])
def test_binary_step_on_two_ranks_equals_one_process(runs, case):
    one, job, _ = runs
    cmp = chip_smoke.compare_ddp_step(job[case], one[case])
    # the sign crossings: values whose sign the one process's own inputs
    # would have taken otherwise (the BN statistics' sums in another order
    # move exact ties at 0); reported, and replayed away (its binary convs
    # take the job's inputs, as the card-vs-CPU gates of chip_smoke.py do)
    print(f"{case}: threshold crossings between the job and one process "
          f"{one[case]['input_flips']}; "
          f"loss relative {cmp['loss_rel']:.3e}; worst gradient error "
          f"{max(cmp['grad_err'].values()):.3e}")
    assert cmp["ranks_grads_equal"]
    assert cmp["loss_rel"] <= 1e-5, cmp["loss_rel"]
    bad = {n: e for n, e in cmp["grad_err"].items() if not e <= GRAD_TOL}
    assert not bad, bad
    # the replicas stay the same bits: parameters, optimizer state (Adam
    # or momentum) and BN running statistics
    assert not chip_smoke.state_diff(job[case][0]["state"], job[case][1]["state"])
    assert job[case][0]["state"]["step"] == len(_batches())


def test_train_ddp_rehearsal_through_fit_on_two_ranks(tmp_path):
    """``chip_smoke.py``'s [train-ddp] (a) at -b 8 on the CPU: ``ddp_fit``
    on two ranks through ``fit`` (3 steps, a checkpoint every 2, eval)."""
    ranks = chip_smoke.spawn_ranks(
        "fit", 2, "cpu", "gloo",
        dict(log_path=str(tmp_path), arch="resnet8_tiny", dataset="cifar10", diffkurt=False,
             batch=8, device="cpu"), timeout_s=240)
    run_dir = ranks[0]["run_dir"]
    assert all(r["run_dir"] == run_dir for r in ranks)
    (ev,) = read_events(run_dir, "eval")
    (ev1,) = [e for e in read_jsonl(f"{run_dir}/events.p1.jsonl") if e["kind"] == "eval"]
    assert ev["count"] == ev1["count"] == 8
    assert all(len(r["losses"]) == 3 and np.isfinite(r["losses"]).all() for r in ranks)
    assert not chip_smoke.state_diff(ranks[0]["state"], ranks[1]["state"])
    assert [e["step_in_epoch"] for e in read_events(run_dir, "checkpoint")] == [2, 0]
