"""Project-native static analysis over the port: the ``check`` CLI's
engine — the port's copy of ``bdbnn_tpu/analysis/``, which scans only
``bdbnn_tpu/**``.

- :mod:`~bdbnn_tpu_torch.analysis.core` — the shared framework: Finding
  records (``file:line:checker-id:message``), file discovery over
  ``bdbnn_tpu_torch/**``, the suppression baseline
  (``bdbnn_tpu_torch/analysis/baseline.txt``: sorted, deduplicated,
  every entry justified — a stale suppression is itself a finding), and
  the deterministic strict-JSON report.
- :mod:`~bdbnn_tpu_torch.analysis.lockcheck` — ``lock-discipline``:
  ``# guarded-by: <lock>`` annotated attributes must only be written /
  read-modify-written / mutated under ``with self.<lock>``.
- :mod:`~bdbnn_tpu_torch.analysis.forwardpure` — ``forward-purity``:
  functions reachable from a module's ``forward``, an autograd
  function's ``forward``/``backward`` or the engine's forward must not
  call host-sync or host-nondeterminism primitives.
- :mod:`~bdbnn_tpu_torch.analysis.eventschema` — ``event-schema``:
  every ``EventWriter.emit`` kind is registered and documented in
  ``obs/events.py``, and every registered kind is emitted.
- :mod:`~bdbnn_tpu_torch.analysis.verdictcheck` — ``verdict-coherence``:
  ``obs/compare.py``'s metric flatteners vs ``METRIC_SPECS`` vs the
  golden fixture vs the verdict-producing sites.

Stdlib only: running the analyzer loads neither torch nor numpy.
"""

from bdbnn_tpu_torch.analysis.core import (
    BASELINE_PATH,
    CHECKER_IDS,
    Finding,
    load_baseline,
    render_report,
    run_check,
)

__all__ = [
    "BASELINE_PATH",
    "CHECKER_IDS",
    "Finding",
    "load_baseline",
    "render_report",
    "run_check",
]
