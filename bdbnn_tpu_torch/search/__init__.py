"""Recipe search: preemption-resilient sweeps over binarizer families —
the port's copy of ``bdbnn_tpu/search/``.

A trial spec (binarizer family x learning rate) fans out short budgeted
``fit()`` runs as real ``python -m bdbnn_tpu_torch.cli`` subprocesses, a
SIGTERM mid-sweep checkpoints the in-flight trials through the
resilience layer (exit 75), ``search --resume`` continues the sweep
without re-running completed trials (integrity-digested trial ledger),
and the finished sweep is ranked into a deterministic strict-JSON
leaderboard with ``obs/compare.py``'s time-to-common-accuracy judgment.

Nothing here imports torch or numpy: the harness owns no device, its
trial workers own the card.
"""

from bdbnn_tpu_torch.search.config import SearchConfig
from bdbnn_tpu_torch.search.harness import (
    LEADERBOARD_NAME,
    LEDGER_NAME,
    TrialLedger,
    build_leaderboard,
    run_search,
    search_digest,
)

__all__ = [
    "LEADERBOARD_NAME",
    "LEDGER_NAME",
    "SearchConfig",
    "TrialLedger",
    "build_leaderboard",
    "run_search",
    "search_digest",
]
