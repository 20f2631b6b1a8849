"""bdbnn_tpu_torch — the PyTorch / CUDA (Hopper) port of ``bdbnn_tpu``.

The JAX package is the reference; this package keeps its module names
and public layouts (NHWC activations, HWIO raw conv kernels, ``(n, H,
W, 3)`` float32 images into the engine) so every module has a
counterpart a reader can find, and parity tests compare like with like.

Every binary-conv primitive on the serving path runs on a kernel written
by hand for ``sm_90a`` (``csrc/*.cu``, built with ``nvcc`` at first use
into ``build/kernels/``, bound with ``ctypes``). Each kernel wrapper
takes its plain PyTorch version only for tensors that lie on the CPU.

This module imports torch only.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Never falls back: asking for CUDA (explicitly or by default) on a
    machine without a CUDA device raises ``RuntimeError``. Pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; bdbnn_tpu_torch entry points run "
            "on the card by default — pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
