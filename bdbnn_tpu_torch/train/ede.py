"""EDE (error decay estimator) annealing schedule — copy of
``bdbnn_tpu/train/ede.py``:

    t(e) = 10 ** (log10(1e-2) + (log10(1e1) - log10(1e-2)) / E * e)
    k(e) = max(1 / t(e), 1)

``t`` sweeps 1e-2 → 1e1 log-linearly over ``tot_epochs``; ``k``
compensates the early attenuation. The binarizer family registry
(:mod:`bdbnn_tpu_torch.nn.binarize`) calls it for the ``ede`` family.
"""

from __future__ import annotations

import math
from typing import Tuple

T_MIN = 1e-2
T_MAX = 1e1


def cpt_tk(epoch: int, tot_epochs: int) -> Tuple[float, float]:
    lo, hi = math.log10(T_MIN), math.log10(T_MAX)
    t = 10.0 ** (lo + (hi - lo) / tot_epochs * epoch)
    k = max(1.0 / t, 1.0)
    return t, k
