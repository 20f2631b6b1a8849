"""Binarization primitives + the binarizer-family registry (PyTorch).

Counterpart of ``bdbnn_tpu/nn/binarize.py``. The sign estimators are
``torch.autograd.Function``s whose forward is the hard sign with
``sign(0) := +1`` and whose backward is the family's estimator, in plain
torch:

- ``ste_sign``    — clipped identity ``1{|x| <= 1}``;
- ``approx_sign`` — Bi-Real ``max(0, 2 - 2|x|)``;
- ``ede_sign``    — IR-Net ``k·t·sech²(t·x)`` (sech² computed directly);
- ``prox_sign``   — proximal tent ``(2/δ)·max(0, 1 - |x|/δ)``;
- ``stoch_sign``  — ±1 sampled with P(+1) = hard_sigmoid(x) from an
  explicit uniform draw ``u`` (an operand, so both packages can be fed
  the same draw), clipped-identity backward.

The stochastic family's draws in training: the reference draws ``u``
with ``jax.random`` from ``fold_in(PRNGKey(rng_seed), step)``, folded
per module path by flax. The port draws one ``u = torch.rand(x.shape)``
per binary conv, in forward order, from a ``torch.Generator`` on the
activation's device seeded with :func:`step_seed` ``(rng_seed, step)``
(:class:`StepDraws`). The draw is pure in ``(rng_seed, step)`` as the
reference's is, so a step replayed from the same state samples the same
masks bitwise; its values differ from JAX's, which the port does not
try to reproduce. The train step passes the step's draw source to the
model as ``model(x, tk, draws)`` (the reference's ``rngs``), and the
model hands it to every binary conv; any callable ``source(x) -> u``
can stand in for :class:`StepDraws` (the parity tests feed both
packages the same draws that way). Without a source (eval, serving,
``predict``) the family takes the deterministic hard sign, as the
reference does.

``torch.sign(0)`` is 0, which would add a third value to the ±1
algebra; :func:`_hard_sign` is used everywhere instead. In training the
binary convs do not call these functions: K5 applies the same backward
rules in its epilogue (``nn/kernels/binary_conv.py``); these stay the
unfused reference forms.

The family registry (``ste``, ``approx``, ``ede``, ``proximal``,
``lab``, ``stochastic``) and the process-global active family mirror the
JAX module one for one; see its docstring for the family table and
citations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from bdbnn_tpu_torch.train.ede import cpt_tk

Tensor = torch.Tensor


def step_seed(rng_seed: int, step: int) -> int:
    """The 64-bit seed of one train step's draws: the first two 32-bit
    words of numpy's ``SeedSequence([rng_seed, step])``, low word first."""
    lo, hi = np.random.SeedSequence([int(rng_seed), int(step)]).generate_state(2, np.uint32)
    return int(lo) | (int(hi) << 32)


class StepDraws:
    """The uniform draws of one train step under the stochastic family:
    each call returns ``torch.rand(x.shape)`` in [0, 1) on ``x``'s device
    from one generator per device seeded with :func:`step_seed`, so the
    n-th binary conv of the forward gets the n-th draw.

    ``shard=(rank, world)``: ``x`` holds rank ``rank``'s rows of a global
    batch of ``world`` equal shards. The draw is taken over the global
    batch and the rank keeps its rows ``[rank·B, (rank+1)·B)``, the layout
    of the reference's global array assembled from process-local data, so
    a data-parallel step samples the signs of one process fed the ranks'
    batches in rank order."""

    def __init__(self, rng_seed: int, step: int, shard: Tuple[int, int] = (0, 1)):
        self.seed = step_seed(rng_seed, step)
        self.rank, self.world = shard
        self._gens: Dict[torch.device, torch.Generator] = {}

    def __call__(self, x: Tensor) -> Tensor:
        gen = self._gens.get(x.device)
        if gen is None:
            gen = self._gens[x.device] = torch.Generator(device=x.device).manual_seed(self.seed)
        if self.world == 1:
            return torch.rand(x.shape, generator=gen, dtype=x.dtype, device=x.device)
        b = x.shape[0]
        u = torch.rand((b * self.world, *x.shape[1:]), generator=gen, dtype=x.dtype,
                       device=x.device)
        return u[self.rank * b:(self.rank + 1) * b]


# a draw source: the activation in, its uniform draw (shaped like it) out
DrawSource = Callable[[Tensor], Tensor]


def _hard_sign(x: Tensor) -> Tensor:
    """sign with sign(0) := +1, output in {-1, +1} of x.dtype."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


def _as_scalar(v, like: Tensor) -> Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _hard_sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


class _ApproxSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _hard_sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        slope = torch.clamp(2.0 - 2.0 * x.abs(), min=0.0)
        return g * slope.to(g.dtype)


class _EdeSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t, k):
        ctx.save_for_backward(x, t, k)
        return _hard_sign(x)

    @staticmethod
    def backward(ctx, g):
        x, t, k = ctx.saved_tensors
        # sech²(t·x) computed directly (1 − tanh² loses precision to
        # cancellation once |t·x| saturates tanh in f32; cosh overflow
        # rounds cleanly to the correct 0 limit)
        t_ = t.to(g.dtype)
        sech = 1.0 / torch.cosh(t_ * x)
        dx = g * (k.to(g.dtype) * t_ * sech * sech)
        return dx, torch.zeros_like(t), torch.zeros_like(k)


class _ProxSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta):
        ctx.save_for_backward(x, delta)
        return _hard_sign(x)

    @staticmethod
    def backward(ctx, g):
        x, delta = ctx.saved_tensors
        d = delta.to(g.dtype)
        slope = (2.0 / d) * torch.clamp(1.0 - x.abs() / d, min=0.0)
        return g * slope.to(g.dtype), torch.zeros_like(delta)


def hard_sigmoid(x: Tensor) -> Tensor:
    """clip((x+1)/2, 0, 1) — BinaryNet's σ̂, the P(+1) of the
    stochastic binarizer."""
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)


class _StochSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u):
        ctx.save_for_backward(x, u)
        p = hard_sigmoid(x)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return torch.where(u < p, one, -one)

    @staticmethod
    def backward(ctx, g):
        x, u = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype), torch.zeros_like(u)


def ste_sign(x: Tensor) -> Tensor:
    """sign(x) with the clipped-identity straight-through backward."""
    return _SteSign.apply(x)


def approx_sign(x: Tensor) -> Tensor:
    """sign(x) with the Bi-Real ApproxSign derivative backward."""
    return _ApproxSign.apply(x)


def ede_sign(x: Tensor, t, k) -> Tensor:
    """sign(x) with the annealed IR-Net EDE backward k·t·sech²(t·x)."""
    return _EdeSign.apply(x, _as_scalar(t, x), _as_scalar(k, x))


def prox_sign(x: Tensor, delta) -> Tensor:
    """sign(x) with the proximal-envelope backward (2/δ)·max(0, 1−|x|/δ)."""
    return _ProxSign.apply(x, _as_scalar(delta, x))


def stoch_sign(x: Tensor, u: Tensor) -> Tensor:
    """±1 sampled with P(+1) = hard_sigmoid(x) from the uniform draw
    ``u`` ∈ [0, 1); clipped-identity STE backward."""
    return _StochSign.apply(x, u)


def binarize_weight(w: Tensor, *, scaled: bool = True, estimator: str = "ste") -> Tensor:
    """sign(W) (HWIO, out-channel last) scaled by the detached
    per-output-channel mean |W|, with an STE into the latent weights."""
    if estimator == "ste":
        signed = ste_sign(w)
    elif estimator == "approx":
        signed = approx_sign(w)
    else:
        raise ValueError(f"unknown estimator: {estimator!r}")
    if not scaled:
        return signed
    reduce_dims = tuple(range(w.dim() - 1))
    alpha = w.abs().mean(dim=reduce_dims, keepdim=True)
    return signed * alpha.detach()


def binarize_act(x: Tensor, *, estimator: str = "ste", tk=None) -> Tensor:
    """Binarize activations to ±1; ``tk = (t, k)`` switches to EDE."""
    if tk is not None:
        t, k = tk
        return ede_sign(x, t, k)
    if estimator == "ste":
        return ste_sign(x)
    if estimator == "approx":
        return approx_sign(x)
    raise ValueError(f"unknown estimator: {estimator!r}")


# ---------------------------------------------------------------------------
# Binarizer-family registry
# ---------------------------------------------------------------------------

# family name -> (citation, stochastic, schedule length, param defaults)
_FAMILY_TABLE: Dict[str, Tuple[str, bool, int, Tuple[Tuple[str, float], ...]]] = {
    "ste": ("arXiv:1602.02830", False, 0, ()),
    "approx": ("arXiv:1808.00278", False, 0, ()),
    "ede": ("arXiv:1909.10788", False, 2, ()),
    "proximal": (
        "arXiv:2402.17710", False, 1,
        (("delta0", 2.0), ("delta1", 0.5)),
    ),
    "lab": ("arXiv:1611.01600", False, 0, ()),
    "stochastic": ("arXiv:1602.02830", True, 0, ()),
}

FAMILY_NAMES: Tuple[str, ...] = tuple(sorted(_FAMILY_TABLE))


def parse_binarizer(spec: str) -> Tuple[str, Dict[str, float]]:
    """Parse ``FAMILY[:PARAM=V,...]`` into ``(name, params)``, raising
    ``ValueError`` on unknown families, unknown params or bad values."""
    name, _, tail = spec.partition(":")
    name = name.strip()
    if name not in _FAMILY_TABLE:
        raise ValueError(
            f"unknown binarizer family {name!r} "
            f"(known: {', '.join(FAMILY_NAMES)})"
        )
    defaults = dict(_FAMILY_TABLE[name][3])
    params = dict(defaults)
    if tail:
        for item in tail.split(","):
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or not key:
                raise ValueError(
                    f"bad binarizer param {item!r} in {spec!r} "
                    "(want PARAM=VALUE)"
                )
            if key not in defaults:
                raise ValueError(
                    f"binarizer family {name!r} has no param {key!r} "
                    f"(known: {sorted(defaults) or 'none'})"
                )
            try:
                params[key] = float(val)
            except ValueError as e:
                raise ValueError(
                    f"binarizer param {key}={val!r} is not a number"
                ) from e
            if params[key] <= 0:
                raise ValueError(
                    f"binarizer param {key} must be > 0, got {params[key]}"
                )
    return name, params


@dataclasses.dataclass(frozen=True)
class BinarizerFamily:
    """One registered binarization regime (frozen + hashable)."""

    name: str
    citation: str
    stochastic: bool
    schedule_len: int
    params: Tuple[Tuple[str, float], ...] = ()

    def param(self, key: str) -> float:
        return dict(self.params)[key]

    @property
    def spec(self) -> str:
        """The canonical config-spec string (name + non-default params)."""
        defaults = dict(_FAMILY_TABLE[self.name][3])
        overrides = [
            f"{k}={v:g}" for k, v in self.params if defaults.get(k) != v
        ]
        return self.name + (":" + ",".join(overrides) if overrides else "")

    def schedule(self, epoch: int, total_epochs: int) -> Tuple[float, ...]:
        """Schedule values entering ``epoch`` of a ``total_epochs`` run —
        () for schedule-free families."""
        if self.name == "ede":
            return cpt_tk(epoch, total_epochs)
        if self.name == "proximal":
            lo = math.log10(self.param("delta0"))
            hi = math.log10(self.param("delta1"))
            return (10.0 ** (lo + (hi - lo) / total_epochs * epoch),)
        return ()

    def binarize_act(
        self, x: Tensor, sched=None, u: Optional[Tensor] = None
    ) -> Tensor:
        """Family-dispatched activation binarizer. ``sched`` carries the
        schedule scalars (None on the eval path); ``u`` is the uniform
        draw the stochastic family samples with (None = deterministic
        hard sign, the test-time convention)."""
        if self.name in ("ste", "ede") and sched is not None:
            t, k = sched
            return ede_sign(x, t, k)
        if self.name == "proximal" and sched is not None:
            (delta,) = sched
            return prox_sign(x, delta)
        if self.name == "approx":
            return approx_sign(x)
        if self.name == "stochastic" and u is not None:
            return stoch_sign(x, u)
        return ste_sign(x)

    def weight_sign(self, w: Tensor) -> Tensor:
        """±1 weight sign with the clipped-identity STE backward."""
        return ste_sign(w)

    def weight_alpha(self, w: Tensor) -> Tensor:
        """Per-output-channel scale over all axes but the last: mean|W|,
        or ``lab``'s ΣW²/Σ|W| (as means, + 1e-12)."""
        reduce_dims = tuple(range(w.dim() - 1))
        if self.name == "lab":
            return (w * w).mean(dim=reduce_dims) / (
                w.abs().mean(dim=reduce_dims) + 1e-12
            )
        return w.abs().mean(dim=reduce_dims)


def weight_alpha_np(name: str, w) -> np.ndarray:
    """Host (numpy) twin of :meth:`BinarizerFamily.weight_alpha` — what
    the exporter stores. Returns float32."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(range(w.ndim - 1))
    if name == "lab":
        return (
            np.mean(w * w, axis=reduce_axes)
            / (np.mean(np.abs(w), axis=reduce_axes) + 1e-12)
        ).astype(np.float32)
    return np.mean(np.abs(w), axis=reduce_axes).astype(np.float32)


def make_family(
    name: str, params: Optional[Mapping[str, float]] = None
) -> BinarizerFamily:
    citation, stochastic, sched_len, defaults = _FAMILY_TABLE[name]
    merged = dict(defaults)
    merged.update(params or {})
    return BinarizerFamily(
        name=name,
        citation=citation,
        stochastic=stochastic,
        schedule_len=sched_len,
        params=tuple(sorted(merged.items())),
    )


def resolve_family(spec: str = "", *, ede: bool = False) -> BinarizerFamily:
    """Resolve a config's ``(binarizer, ede)`` pair to a family; an
    empty spec keeps the legacy mapping (``ede`` if ``ede`` else
    ``ste``)."""
    if not spec:
        return make_family("ede" if ede else "ste")
    name, params = parse_binarizer(spec)
    if ede and name != "ede":
        raise ValueError(
            f"--ede selects the 'ede' binarizer family but --binarizer "
            f"names {name!r}; drop --ede or use --binarizer ede"
        )
    return make_family(name, params)


# the process-global active family (the JAX package's pattern): the
# layers read it at every forward
_ACTIVE_FAMILY: BinarizerFamily = make_family("ste")


def set_active_family(family) -> BinarizerFamily:
    """Install the active family (a :class:`BinarizerFamily` or a spec
    string); returns the installed family."""
    global _ACTIVE_FAMILY
    if isinstance(family, str):
        family = make_family(*parse_binarizer(family))
    _ACTIVE_FAMILY = family
    return family


def get_active_family() -> BinarizerFamily:
    return _ACTIVE_FAMILY


@contextlib.contextmanager
def active_family(family):
    """Scoped family install; restores the previous family on exit."""
    prev = get_active_family()
    try:
        yield set_active_family(family)
    finally:
        set_active_family(prev)
