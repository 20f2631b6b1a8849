"""``remat=True`` (``torch.utils.checkpoint`` per residual block, the
reference's ``nn.remat``) against the same model without it, on the CPU:
the loss, every gradient and the BatchNorm running-stat update equal to
the reference's own tolerance (``tests/test_models.py`` ``TestRemat``), in
f32 under EDE and in bf16; bitwise under the stochastic family (the
recompute reuses the forward's draws); the recompute runs each binary
conv's forward a second time and leaves the running statistics alone;
the parameter names unchanged; ``vgg_small`` refuses remat.
"""

import numpy as np
import pytest
import torch

from bdbnn_tpu_torch.models import registry as treg
from bdbnn_tpu_torch.nn.binarize import StepDraws, active_family
from bdbnn_tpu_torch.nn.layers import _BinaryConvBase


def _pair(arch="resnet20", dtype="float32"):
    plain = treg.create_model(arch, "cifar10", dtype=dtype,
                              generator=torch.Generator().manual_seed(0))
    rem = treg.create_model(arch, "cifar10", dtype=dtype, remat=True)
    rem.load_state_dict(plain.state_dict(), strict=True)
    return plain.train(), rem.train()


def _step(model, x, tk=None, draws=None):
    """Loss (mean of squared logits, the reference test's), gradients and
    the running statistics after one training forward and backward;
    counts each binary conv's forward calls."""
    calls = []
    hooks = [m.register_forward_hook(lambda m, a, o: calls.append(1))
             for m in model.modules() if isinstance(m, _BinaryConvBase)]
    out = model(x, tk, draws)
    loss = (out * out).mean()
    model.zero_grad(set_to_none=True)
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return loss.detach(), grads, stats, len(calls)


def _close(got, want):
    # the reference's per-leaf tolerance: rtol 1e-3, atol 1e-4 of the
    # leaf's largest |entry|
    scale = float(want.abs().max()) or 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-4 * scale)


def _x(seed=0, n=4):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_is_identity_for_loss_grads_and_running_stats(dtype):
    plain, rem = _pair(dtype=dtype)
    x = _x()
    tk = (1.2, 3.0)  # EDE, as the reference's test
    with active_family("ede"):
        l0, g0, s0, n0 = _step(plain, x, tk)
        l1, g1, s1, n1 = _step(rem, x, tk)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    assert set(g0) == set(g1)
    for k in g0:
        _close(g1[k], g0[k])
    for k in s0:
        _close(s1[k], s0[k])
    # each of resnet20's 20 binary convs runs again in the recompute, and
    # the recompute updated no running statistic a second time
    assert (n0, n1) == (20, 40)
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_is_bitwise_under_the_stochastic_family(dtype):
    """The recompute takes the draws the forward took (a fresh draw would
    sample other signs): loss, gradients and running statistics bitwise."""
    plain, rem = _pair("resnet8_tiny", dtype)
    x = _x(1)
    with active_family("stochastic"):
        l0, g0, s0, _ = _step(plain, x, None, StepDraws(3, 7))
        l1, g1, s1, n1 = _step(rem, x, None, StepDraws(3, 7))
        # another step's draws give another result: the draws matter here
        l2, _, _, _ = _step(plain, x, None, StepDraws(3, 8))
    assert n1 == 2 * 5
    assert torch.equal(l0, l1) and not torch.equal(l0, l2)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_remat_keeps_the_parameter_names_and_eval_path():
    plain, rem = _pair()
    assert list(plain.state_dict()) == list(rem.state_dict())
    assert [n for n, _ in plain.named_parameters()] == [n for n, _ in rem.named_parameters()]
    x = _x(2, 2)
    with torch.no_grad():
        assert torch.equal(plain.eval()(x), rem.eval()(x))


def test_vgg_small_refuses_remat():
    with pytest.raises(ValueError, match="remat"):
        treg.create_model("vgg_small", "cifar10", remat=True)
