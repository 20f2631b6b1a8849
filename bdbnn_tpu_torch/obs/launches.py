"""Launch counters of the kernel wrappers, by kernel id.

Each wrapper adds one to its ``launches`` where it launches its kernel
(``nn/kernels/_build.py`` ``count_launch``), and the wrappers with a bf16
mode also to their ``launches_bf16``. :func:`launch_counts` reads them as
``{"K1": n, ..., "K1 bf16": n, ...}`` and :func:`reset_launches` sets them
to 0, for the bench scripts (``scripts/``) and ``chip_smoke.py``. The
wrappers import on first call, so importing this module loads no torch:
``chip_smoke.py`` imports it at its top, and the processes it spawns
(decode workers, the search harness) re-import that top.
"""

from __future__ import annotations

from typing import Callable, Dict

KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")
# the kernels with a bf16 mode; each wrapper counts the mode's launches
# apart (``launches_bf16``) beside all of its launches (``launches``)
BF16_KERNELS = ("K1", "K2", "K5", "K6")


def wrappers() -> Dict[str, Callable]:
    """Each kernel id's wrapper, the function that counts its launches."""
    from bdbnn_tpu_torch.nn import packed as P
    from bdbnn_tpu_torch.nn.kernels import (
        binary_conv2d,
        binary_conv2d_dgrad,
        binary_conv2d_wgrad,
        kurtosis_grouped,
        weight_binarize,
    )

    return {
        "K1": binary_conv2d,
        "K2": weight_binarize,
        "K3": P.packed_dense_weight,
        "K4": P.popcount_binary_conv,
        "K5": binary_conv2d_dgrad,
        "K6": binary_conv2d_wgrad,
        "K7": kurtosis_grouped,
    }


def reset_launches() -> None:
    """Set every wrapper's counters to 0."""
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0


def launch_counts() -> Dict[str, int]:
    """``{"K1": launches, ..., "K7": ..., "K1 bf16": ..., "K6 bf16": ...}``:
    every launch of each wrapper, then the bf16 modes' among them."""
    w = wrappers()
    out = {k: w[k].launches for k in KERNELS}
    out.update({f"{k} bf16": w[k].launches_bf16 for k in BF16_KERNELS})
    return out


__all__ = ["BF16_KERNELS", "KERNELS", "launch_counts", "reset_launches", "wrappers"]
