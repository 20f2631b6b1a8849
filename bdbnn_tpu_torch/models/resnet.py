"""Binary ResNet model families (``torch.nn``), counterparts of
``bdbnn_tpu/models/resnet.py``.

Activations are NHWC; submodules carry the flax module names
(``conv1``/``bn1``/``layer1_0``/``downsample_conv``/``downsample_bn``/
``act1``/``fc``), so a module path here is the flax variable path and
the natural-DFS conv order matches one for one (:func:`conv_weight_paths`).

- ``BiBasicBlock`` — two 3x3 binary residual units, ``y = act(BN(conv(x))
  + shortcut)``, with an AvgPool + binary 1x1 downsample shortcut; the
  float twin is torchvision's BasicBlock.
- ``FloatBottleneck`` — torchvision's Bottleneck (expansion 4), the
  resnet50/101 float teachers' block.
- ``BiResNet``     — ResNet over react / step2 / cifar / float variants,
  imagenet (7x7/2 + maxpool) or cifar (3x3) stem, with ``twoblock``
  (odd-position blocks swap to the partner variant); basic blocks, or
  bottleneck blocks for the float variant.
- ``VGGSmallBinary`` — the binary VGG-Small CIFAR baseline.

The stem conv and the classifier stay full precision (F.conv2d and a
linear layer; the engine turns TF32 off). ``packed=True`` builds every
binary conv with a packed ``{sign, alpha}`` buffer in place of its
``float_weight``. :meth:`to_flax` / :meth:`from_flax` carry weights to
and from the flax variable tree through :mod:`bdbnn_tpu_torch.bridge`.

``model.train()`` trains every module: BatchNorm on batch statistics
and the binary convs through K2 → K1 with the K5/K6 backward
(:mod:`bdbnn_tpu_torch.nn.layers`); ``tk`` (the binarizer family's
schedule scalars) and ``draws`` (the stochastic family's draw source)
reach every conv.

``dtype=torch.bfloat16`` is the reference's ``--dtype bfloat16``: the
images are cast to bf16, every module computes in bf16 (BatchNorm's
statistics and normalize in f32), the global pool averages in f32 and
rounds to bf16, the classifier is a bf16 product plus the bf16 bias, and
the logits are f32. Parameters and running statistics stay f32.

``remat=True`` (ResNets; the reference's ``nn.remat`` of each block)
runs each residual block under ``torch.utils.checkpoint`` when autograd
records: its activations are dropped after the forward and recomputed in
the backward. The recompute takes the same stochastic draws as the
forward (:class:`_DrawTape`) and leaves the BatchNorm running statistics
alone (:func:`~bdbnn_tpu_torch.nn.layers.frozen_running_stats`), so a
step computes what it computes without remat; its binary convs launch K2
and K1 twice, K5 and K6 once.
"""

from __future__ import annotations

import contextlib
import re
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bdbnn_tpu_torch.nn.layers import (
    BN_EPS,
    BatchNorm,
    BinaryConv,
    BinaryConvCifar,
    BinaryConvReact,
    FloatConv,
    RPReLU,
    frozen_running_stats,
    lecun_normal_,
)

Tensor = torch.Tensor

_CONV_CLASSES = {
    "react": BinaryConvReact,
    "step2": BinaryConv,
    "cifar": BinaryConvCifar,
    "float": FloatConv,
}


class _Clip(nn.Module):
    """hardtanh: clip(-1, 1) (IR-Net-style plain/cifar variants)."""

    def forward(self, x: Tensor) -> Tensor:
        return torch.clamp(x, -1.0, 1.0)


def _activation(kind: str, features: int) -> nn.Module:
    if kind == "rprelu":
        return RPReLU(features)
    if kind == "hardtanh":
        return _Clip()
    if kind == "identity":
        return nn.Identity()
    raise ValueError(f"unknown activation kind: {kind!r}")


def avg_pool(x: Tensor, s: int) -> Tensor:
    """flax ``avg_pool`` with window = stride = ``s`` (VALID) on NHWC:
    the window summed in row-major order, then divided by its size —
    one fixed order, so the CPU and the card give the same bits."""
    ho, wo = x.shape[1] // s, x.shape[2] // s
    total = None
    for i in range(s):
        for j in range(s):
            tap = x[:, i : i + s * ho : s, j : j + s * wo : s, :]
            total = tap if total is None else total + tap
    return (total / float(s * s)).contiguous()


def resolve_dtype(dtype) -> torch.dtype:
    """The compute dtype of a model: None / "float32" / torch.float32,
    or "bfloat16" / torch.bfloat16."""
    if dtype in (None, "float32", torch.float32):
        return torch.float32
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unknown dtype {dtype!r}; use float32|bfloat16")


def _pool_and_classify(fc: nn.Linear, x: Tensor, dtype: torch.dtype, pool: bool) -> Tensor:
    """Global average pool (``pool``) and the classifier, f32 logits. In
    bf16 the pool averages in f32 and rounds (``jnp.mean``), and the
    classifier rounds its product and then its bias add (flax ``Dense``
    with ``dtype=bfloat16``)."""
    if dtype == torch.float32:
        return fc(x.mean(dim=(1, 2)) if pool else x)
    if pool:
        x = x.to(torch.float32).mean(dim=(1, 2)).to(dtype)
    y = nn.functional.linear(x, fc.weight.to(dtype)) + fc.bias.to(dtype)
    return y.to(torch.float32)


class _DrawTape:
    """A residual block's draw source under remat: the forward takes its
    draws from ``source`` and keeps them; the recompute in the backward
    hands the same tensors out again in the same order, so it samples the
    signs the forward sampled."""

    def __init__(self, source):
        self.source = source
        self._tape = []
        self._replay = None
        self._ran = False

    def start(self) -> "_DrawTape":
        self._replay = iter(self._tape) if self._ran else None
        self._ran = True
        return self

    def __call__(self, x: Tensor) -> Tensor:
        if self._replay is not None:
            return next(self._replay)
        u = self.source(x)
        self._tape.append(u)
        return u


def _recompute_contexts():
    # checkpoint's context_fn: nothing around the forward, the running
    # statistics held still around the recompute
    return contextlib.nullcontext(), frozen_running_stats()


def run_block(block: nn.Module, x: Tensor, tk, draws, remat: bool) -> Tensor:
    """``block(x, tk, draws)``, under ``torch.utils.checkpoint`` when
    ``remat`` and autograd records. No block reads the global RNG, so
    checkpoint does not stash it."""
    if not (remat and torch.is_grad_enabled()):
        return block(x, tk, draws)
    tape = _DrawTape(draws) if draws is not None else None

    def forward(inp: Tensor) -> Tensor:
        return block(inp, tk, tape.start() if tape is not None else None)

    return checkpoint(
        forward, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=_recompute_contexts,
    )


def _nchw(f, x: Tensor, *args, **kwargs) -> Tensor:
    """Apply an NCHW pooling op to an NHWC tensor."""
    return f(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1).contiguous()


class _FlaxBridged(nn.Module):
    """``to_flax`` / ``from_flax`` through the weight bridge."""

    def to_flax(self):
        from bdbnn_tpu_torch.bridge import state_dict_to_flax

        return state_dict_to_flax(self.state_dict())

    def from_flax(self, variables) -> "_FlaxBridged":
        from bdbnn_tpu_torch.bridge import flax_to_state_dict

        device = next(self.parameters()).device
        sd = flax_to_state_dict(variables)
        self.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True)
        return self


class BiBasicBlock(nn.Module):
    """Two 3x3 binary residual units with torch-compatible module names.

    Unit 1 (may downsample): ``y = act(BN(conv1(x)) + shortcut(x))``
    Unit 2:                  ``z = act(BN(conv2(y)) + y)``
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        strides: int = 1,
        variant: str = "react",
        act: str = "rprelu",
        *,
        packed: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.variant = variant
        self.strides = strides
        self.needs_ds = strides != 1 or in_features != features
        g = generator
        if variant == "float":
            self.conv1 = FloatConv(in_features, features, (3, 3), (strides, strides), generator=g)
            self.bn1 = BatchNorm(features)
            self.conv2 = FloatConv(features, features, (3, 3), (1, 1), generator=g)
            self.bn2 = BatchNorm(features)
            if self.needs_ds:
                self.downsample_conv = FloatConv(
                    in_features, features, (1, 1), (strides, strides), generator=g
                )
                self.downsample_bn = BatchNorm(features)
            return
        conv_cls = _CONV_CLASSES[variant]
        if self.needs_ds:
            self.downsample_conv = conv_cls(
                in_features, features, (1, 1), (1, 1), packed=packed, generator=g
            )
            self.downsample_bn = BatchNorm(features)
        self.conv1 = conv_cls(
            in_features, features, (3, 3), (strides, strides), packed=packed, generator=g
        )
        self.bn1 = BatchNorm(features)
        self.act1 = _activation(act, features)
        self.conv2 = conv_cls(features, features, (3, 3), (1, 1), packed=packed, generator=g)
        self.bn2 = BatchNorm(features)
        self.act2 = _activation(act, features)

    def forward(self, x: Tensor, tk=None, draws=None) -> Tensor:
        if self.variant == "float":
            return self._float_forward(x)
        if self.needs_ds:
            s = self.strides
            pooled = avg_pool(x, s)
            shortcut = self.downsample_bn(self.downsample_conv(pooled, tk, draws))
        else:
            shortcut = x
        y = self.act1(self.bn1(self.conv1(x, tk, draws)) + shortcut)
        z = self.act2(self.bn2(self.conv2(y, tk, draws)) + y)
        return z

    def _float_forward(self, x: Tensor) -> Tensor:
        """torchvision BasicBlock: relu(bn1(conv1)) → bn2(conv2) → add
        the block input (strided 1x1 conv + BN when shapes change) → relu."""
        identity = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.needs_ds:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + identity)


class FloatBottleneck(nn.Module):
    """torchvision's Bottleneck for the float teachers (expansion 4):
    ``relu(bn1(conv1_1x1(x)))`` → ``relu(bn2(conv2_3x3_stride(·)))`` →
    ``bn3(conv3_1x1_4w(·))`` → add the block input (strided 1x1 conv + BN
    when shapes change) → relu."""

    EXPANSION = 4

    def __init__(
        self,
        in_features: int,
        features: int,
        strides: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        g = generator
        out_features = features * self.EXPANSION
        self.needs_ds = strides != 1 or in_features != out_features
        self.conv1 = FloatConv(in_features, features, (1, 1), (1, 1), generator=g)
        self.bn1 = BatchNorm(features)
        self.conv2 = FloatConv(features, features, (3, 3), (strides, strides), generator=g)
        self.bn2 = BatchNorm(features)
        self.conv3 = FloatConv(features, out_features, (1, 1), (1, 1), generator=g)
        self.bn3 = BatchNorm(out_features)
        if self.needs_ds:
            self.downsample_conv = FloatConv(
                in_features, out_features, (1, 1), (strides, strides), generator=g
            )
            self.downsample_bn = BatchNorm(out_features)

    def forward(self, x: Tensor, tk=None, draws=None) -> Tensor:
        del tk, draws  # float teachers have no binarizer
        identity = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.needs_ds:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + identity)


class BiResNet(_FlaxBridged):
    """Generic ResNet over binary or float conv variants; NHWC f32 images
    in, f32 logits out, computing in ``dtype`` (f32 or bf16), each block
    under checkpoint with ``remat``. ``block="bottleneck"`` (float variant
    only) builds :class:`FloatBottleneck` blocks; the binary families are
    basic-block."""

    _TWOBLOCK_PARTNER = {"react": "step2", "step2": "react", "cifar": "react"}
    _VARIANT_ACT = {"react": "rprelu", "step2": "hardtanh", "cifar": "hardtanh"}

    def __init__(
        self,
        stage_sizes: Sequence[int],
        num_classes: int,
        width: int = 64,
        stem: str = "imagenet",
        variant: str = "react",
        act: str = "rprelu",
        twoblock: bool = False,
        *,
        block: str = "basic",
        dtype=None,
        remat: bool = False,
        packed: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.remat = bool(remat)
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem: {stem!r}")
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"unknown block: {block!r}")
        if block == "bottleneck" and variant != "float":
            raise ValueError(
                "bottleneck blocks are float-teacher only; the binary "
                "families are basic-block by construction"
            )
        self.stem = stem
        g = generator
        if stem == "imagenet":
            self.conv1 = FloatConv(3, width, (7, 7), (2, 2), generator=g)
        else:
            self.conv1 = FloatConv(3, width, (3, 3), (1, 1), generator=g)
        self.bn1 = BatchNorm(width)
        self.block_names = []
        in_features = width
        block_idx = 0
        for s, num_blocks in enumerate(stage_sizes):
            features = width * (2**s)
            for b in range(num_blocks):
                strides = 2 if (s > 0 and b == 0) else 1
                v, a = variant, act
                if twoblock and v != "float" and block_idx % 2 == 1:
                    v = self._TWOBLOCK_PARTNER[v]
                    a = self._VARIANT_ACT[v]
                name = f"layer{s + 1}_{b}"
                if block == "bottleneck":
                    mod = FloatBottleneck(in_features, features, strides, generator=g)
                    out_features = features * FloatBottleneck.EXPANSION
                else:
                    mod = BiBasicBlock(
                        in_features, features, strides, v, a, packed=packed, generator=g
                    )
                    out_features = features
                self.add_module(name, mod)
                self.block_names.append(name)
                in_features = out_features
                block_idx += 1
        self.fc = nn.Linear(in_features, num_classes)
        lecun_normal_(self.fc.weight, in_features, g)
        with torch.no_grad():
            self.fc.bias.zero_()

    def forward(self, x: Tensor, tk=None, draws=None) -> Tensor:
        x = torch.relu(self.bn1(self.conv1(x.to(self.dtype))))
        if self.stem == "imagenet":
            # torch MaxPool2d(3, stride=2, padding=1): -inf padding, as
            # the reference's reduce_window
            x = _nchw(nn.functional.max_pool2d, x, 3, 2, 1)
        for name in self.block_names:
            x = run_block(getattr(self, name), x, tk, draws, self.remat)
        return _pool_and_classify(self.fc, x, self.dtype, pool=True)


class VGGSmallBinary(_FlaxBridged):
    """Binary VGG-Small (6 convs 128-128-256-256-512-512 + FC), first conv
    full precision, computing in ``dtype`` (f32 logits). ``image_size``
    fixes the classifier's input width (flax infers it at init)."""

    def __init__(
        self,
        num_classes: int = 10,
        variant: str = "cifar",
        image_size: int = 32,
        *,
        dtype=None,
        packed: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        conv_cls = _CONV_CLASSES[variant]
        widths = (128, 128, 256, 256, 512, 512)
        self.n_convs = len(widths)
        in_features = 3
        for i, w in enumerate(widths):
            if i == 0 or variant == "float":
                conv = FloatConv(in_features, w, (3, 3), generator=generator)
            else:
                conv = conv_cls(in_features, w, (3, 3), packed=packed, generator=generator)
            self.add_module(f"conv{i + 1}", conv)
            self.add_module(f"bn{i + 1}", BatchNorm(w))
            in_features = w
        side = image_size // 8
        self.fc = nn.Linear(side * side * widths[-1], num_classes)
        lecun_normal_(self.fc.weight, self.fc.in_features, generator)
        with torch.no_grad():
            self.fc.bias.zero_()

    def forward(self, x: Tensor, tk=None, draws=None) -> Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i + 1}")(x, tk, draws)
            x = getattr(self, f"bn{i + 1}")(x)
            if i % 2 == 1:
                x = _nchw(nn.functional.max_pool2d, x, 2, 2)
            x = torch.clamp(x, -1.0, 1.0)
        return _pool_and_classify(self.fc, x.reshape(x.shape[0], -1), self.dtype, pool=False)


# ---------------------------------------------------------------------------
# BatchNorm folding (numpy, on flax-layout trees)
# ---------------------------------------------------------------------------


def _bn_identity_var(eps: float = BN_EPS):
    """``var = 1 - eps`` makes ``rsqrt(var + eps)`` exactly 1.0 in f32."""
    return np.float32(1.0) - np.float32(eps)


def bn_identity_stats(channels: int, eps: float = BN_EPS):
    """Identity running stats (mean 0, var 1-eps) for a folded BN."""
    return {
        "mean": np.zeros((channels,), np.float32),
        "var": np.full((channels,), _bn_identity_var(eps), np.float32),
    }


def _is_bn_stats(node) -> bool:
    return (
        isinstance(node, dict)
        and set(node.keys()) == {"mean", "var"}
        and all(hasattr(v, "shape") for v in node.values())
    )


def fold_batch_norm(variables, eps: float = BN_EPS):
    """Fold every eval-mode BatchNorm of a flax-layout tree into a
    per-channel scale/bias (``scale' = scale / sqrt(var + eps)``,
    ``bias' = bias - mean * scale'``) with identity running stats —
    a copy of the reference's ``fold_batch_norm``."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {}) or {}

    def rec(p_node, s_node):
        if _is_bn_stats(s_node):
            mean = np.asarray(s_node["mean"], np.float32)
            var = np.asarray(s_node["var"], np.float32)
            scale = np.asarray(p_node["scale"], np.float32)
            bias = np.asarray(p_node["bias"], np.float32)
            mul = scale / np.sqrt(var + np.float32(eps))
            new_p = dict(p_node)
            new_p["scale"] = mul
            new_p["bias"] = (bias - mean * mul).astype(np.float32)
            return new_p, bn_identity_stats(len(mean), eps)
        if not isinstance(s_node, dict):
            return p_node, s_node
        new_p = dict(p_node) if isinstance(p_node, dict) else p_node
        new_s = {}
        for k, sv in s_node.items():
            sub_p = p_node.get(k) if isinstance(p_node, dict) else None
            fp, fs = rec(sub_p, sv)
            if isinstance(new_p, dict):
                new_p[k] = fp
            new_s[k] = fs
        return new_p, new_s

    folded_params, folded_stats = rec(params, stats)
    return {"params": folded_params, "batch_stats": folded_stats}


# ---------------------------------------------------------------------------
# Param-tree utilities (conv ordering, weight access) on flax-layout trees
# ---------------------------------------------------------------------------


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def conv_weight_paths(params) -> list:
    """Ordered paths of all 4-D conv kernels (``float_weight`` or
    ``weight``), stem first, in natural-DFS order — e.g.
    ``('layer1_0', 'conv1', 'float_weight')``."""
    out = []

    def rec(node, prefix):
        if hasattr(node, "ndim"):
            if prefix[-1] in ("float_weight", "weight") and node.ndim == 4:
                out.append(tuple(prefix))
            return
        for k in sorted(node.keys(), key=_natural_key):
            rec(node[k], prefix + [k])

    params = params.get("params", params) if isinstance(params, dict) else params
    rec(params, [])
    return out


def get_by_path(params, path):
    node = params.get("params", params) if isinstance(params, dict) else params
    for k in path:
        node = node[k]
    return node


def conv_weight_hwio(path, w: Tensor) -> Tensor:
    """The conv weight at ``path`` in HWIO, the reference's layout: a
    binary conv's ``float_weight`` is HWIO already, a ``FloatConv``'s
    ``weight`` is OIHW and is permuted (a view)."""
    return w.permute(2, 3, 1, 0) if path[-1] == "weight" else w


def module_path_str(path) -> str:
    """'layer1_0.conv1' — path string without the trailing param name."""
    return ".".join(path[:-1])


__all__ = [
    "BN_EPS",
    "BiBasicBlock",
    "BiResNet",
    "FloatBottleneck",
    "VGGSmallBinary",
    "bn_identity_stats",
    "conv_weight_hwio",
    "conv_weight_paths",
    "fold_batch_norm",
    "get_by_path",
    "module_path_str",
    "resolve_dtype",
    "run_block",
]
