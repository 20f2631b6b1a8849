"""The flagship's forward and its example arguments — the port's
counterpart of ``__graft_entry__.py`` ``entry()``.

:func:`entry` builds the ImageNet ``resnet18`` (react, 224², 19 binary
convs) in eval mode from seeded weights on the card and returns
``(forward, (model, x))``: ``forward(model, x)`` is the eval forward, each
binary conv through K2 (weight sign + alpha) then K1 (fused sign + ±1
conv), and ``x`` the reference's example input, zeros of shape
``(8, 224, 224, 3)`` in float32. The model stands where the reference
passes its variables. ``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from bdbnn_tpu_torch import resolve_device
from bdbnn_tpu_torch.models import create_model

# the reference's example batch (__graft_entry__.py entry())
EXAMPLE_SHAPE = (8, 224, 224, 3)


def forward(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Eval logits of ``model`` on NHWC float32 ``x``, without autograd."""
    model.eval()
    with torch.no_grad():
        return model(x)


def entry(device="cuda", seed: int = 0) -> Tuple[Callable, Tuple[torch.nn.Module, torch.Tensor]]:
    """``(forward, (model, x))``: the flagship in eval mode with weights
    from ``torch.Generator().manual_seed(seed)`` on ``device`` (the card
    unless the caller asks for the CPU; no card raises), and the example
    input on the same device."""
    dev = resolve_device(device)
    model = create_model("resnet18", "imagenet",
                         generator=torch.Generator().manual_seed(seed)).to(dev).eval()
    x = torch.zeros(EXAMPLE_SHAPE, dtype=torch.float32, device=dev)
    return forward, (model, x)


__all__ = ["EXAMPLE_SHAPE", "entry", "forward"]
