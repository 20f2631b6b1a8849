"""Binary ResNet model families (``torch.nn``), counterparts of
``bdbnn_tpu/models/resnet.py``.

Activations are NHWC; submodules carry the flax module names
(``conv1``/``bn1``/``layer1_0``/``downsample_conv``/``downsample_bn``/
``act1``/``fc``), so a module path here is the flax variable path and
the natural-DFS conv order matches one for one (:func:`conv_weight_paths`).

- ``BiBasicBlock`` — two 3x3 binary residual units, ``y = act(BN(conv(x))
  + shortcut)``, with an AvgPool + binary 1x1 downsample shortcut; the
  float twin is torchvision's BasicBlock.
- ``BiResNet``     — basic-block ResNet over react / step2 / cifar /
  float variants, imagenet (7x7/2 + maxpool) or cifar (3x3) stem, with
  ``twoblock`` (odd-position blocks swap to the partner variant).
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
reach every conv. ``FloatBottleneck`` (resnet50/101
float teachers) comes with the teacher–student step and ``remat`` with
bf16 (ROADMAP A "Later" 1 and 4).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from bdbnn_tpu_torch.nn.layers import (
    BN_EPS,
    BatchNorm,
    BinaryConv,
    BinaryConvCifar,
    BinaryConvReact,
    FloatConv,
    RPReLU,
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


class BiResNet(_FlaxBridged):
    """Generic basic-block ResNet over binary or float conv variants;
    NHWC f32 images in, f32 logits out."""

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
        packed: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem: {stem!r}")
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
                self.add_module(
                    name,
                    BiBasicBlock(
                        in_features, features, strides, v, a, packed=packed, generator=g
                    ),
                )
                self.block_names.append(name)
                in_features = features
                block_idx += 1
        self.fc = nn.Linear(in_features, num_classes)
        lecun_normal_(self.fc.weight, in_features, g)
        with torch.no_grad():
            self.fc.bias.zero_()

    def forward(self, x: Tensor, tk=None, draws=None) -> Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        if self.stem == "imagenet":
            # torch MaxPool2d(3, stride=2, padding=1): -inf padding, as
            # the reference's reduce_window
            x = _nchw(nn.functional.max_pool2d, x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, tk, draws)
        x = x.mean(dim=(1, 2))  # global average pool
        return self.fc(x)


class VGGSmallBinary(_FlaxBridged):
    """Binary VGG-Small (6 convs 128-128-256-256-512-512 + FC), first conv
    full precision. ``image_size`` fixes the classifier's input width
    (flax infers it at init)."""

    def __init__(
        self,
        num_classes: int = 10,
        variant: str = "cifar",
        image_size: int = 32,
        *,
        packed: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
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
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i + 1}")(x, tk, draws)
            x = getattr(self, f"bn{i + 1}")(x)
            if i % 2 == 1:
                x = _nchw(nn.functional.max_pool2d, x, 2, 2)
            x = torch.clamp(x, -1.0, 1.0)
        return self.fc(x.reshape(x.shape[0], -1))


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


def module_path_str(path) -> str:
    """'layer1_0.conv1' — path string without the trailing param name."""
    return ".".join(path[:-1])


__all__ = [
    "BN_EPS",
    "BiBasicBlock",
    "BiResNet",
    "VGGSmallBinary",
    "bn_identity_stats",
    "conv_weight_paths",
    "fold_batch_norm",
    "get_by_path",
    "module_path_str",
]
