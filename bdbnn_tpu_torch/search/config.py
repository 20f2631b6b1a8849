"""Typed configuration of the ``search`` CLI — the port's copy of the
reference's ``SearchConfig`` (``bdbnn_tpu/configs/config.py``): the same
fields, defaults, trial ids and refusals, plus ``device``.

Stdlib only: :meth:`SearchConfig.validate` parses every family spec
through :mod:`bdbnn_tpu_torch.nn.families`, so the harness refuses a
typo'd family before any trial subprocess exists and without loading
torch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Typed configuration of the ``search`` CLI (bdbnn_tpu_torch/search/).

    Same resolve-once contract as the other configs: the trial grid
    (binarizer families x learning rates, or an explicit trial list),
    the per-trial training budget and the worker fan-out are all
    validated before any subprocess exists, so a typo'd family name
    fails at the command line — not three trials into an hour-long
    sweep.
    """

    out_dir: str  # sweep dir: ledger + events + leaderboard live here
    data: str = ""  # dataset dir ("" with --synthetic)
    # trial grid: families x lrs (family-major order). Each family
    # entry is a binarizer spec "FAMILY[:PARAM=V,...]" (nn/families.py
    # registry). `trials` ("SPEC@LR" each) REPLACES the grid with an
    # explicit list.
    families: Tuple[str, ...] = ("ste", "ede")
    lrs: Tuple[float, ...] = (0.1,)
    trials: Tuple[str, ...] = ()
    # the shared per-trial training budget — every trial runs the SAME
    # short recipe so the leaderboard compares families/lrs, nothing
    # else
    dataset: str = "cifar10"
    arch: str = "resnet20"
    epochs: int = 1
    batch_size: int = 64
    print_freq: int = 10
    synthetic: bool = False
    synthetic_train_size: int = 2048
    synthetic_val_size: int = 512
    seed: int = 0
    # subprocess fan-out: N trial workers in flight at once (each a
    # real `python -m bdbnn_tpu_torch.cli` fit riding the resilience
    # layer — SIGTERM on the harness forwards to every in-flight
    # worker, which checkpoints mid-epoch and exits 75)
    workers: int = 1
    # continue an interrupted sweep: completed trials are NEVER re-run
    # (the integrity-digested ledger is the source of truth), preempted
    # trials resume from their mid-epoch checkpoint
    resume: bool = False
    out: str = ""  # also write the leaderboard JSON here
    events_max_mb: float = 256.0
    # the torch device every trial trains on, passed as its --device
    # ("" = the CUDA card, as every port entry point defaults; no
    # fallback to the CPU)
    device: str = ""

    def expand_trials(self) -> Tuple[Tuple[str, str, float], ...]:
        """The ordered trial list as ``(trial_id, family_spec, lr)``
        tuples — deterministic (family-major over the grid, or the
        explicit ``trials`` order), so trial ids are stable across
        resumes of the same config."""
        specs = []
        if self.trials:
            for item in self.trials:
                spec, _, lr = item.rpartition("@")
                specs.append((spec, float(lr)))
        else:
            for fam in self.families:
                for lr in self.lrs:
                    specs.append((fam, float(lr)))
        out = []
        for idx, (spec, lr) in enumerate(specs):
            slug = spec.split(":", 1)[0]
            out.append((f"t{idx:03d}_{slug}_lr{lr:g}", spec, lr))
        return tuple(out)

    def validate(self) -> "SearchConfig":
        from bdbnn_tpu_torch.nn.families import parse_binarizer

        if not self.out_dir:
            raise ValueError("search needs --out-dir (the sweep dir)")
        if self.trials:
            for item in self.trials:
                spec, sep, lr = item.rpartition("@")
                if not sep or not spec:
                    raise ValueError(
                        f"bad --trial {item!r} (want "
                        "FAMILY[:PARAM=V,...]@LR)"
                    )
                parse_binarizer(spec)
                try:
                    lr_f = float(lr)
                except ValueError as e:
                    raise ValueError(
                        f"--trial {item!r}: LR {lr!r} is not a number"
                    ) from e
                if lr_f <= 0:
                    raise ValueError(f"--trial {item!r}: LR must be > 0")
        else:
            if not self.families:
                raise ValueError("search needs at least one --families entry")
            for fam in self.families:
                parse_binarizer(fam)
            if not self.lrs or any(lr <= 0 for lr in self.lrs):
                raise ValueError(
                    f"--lrs must be positive, got {self.lrs!r}"
                )
        if len(self.expand_trials()) < 1:
            raise ValueError("the trial grid is empty")
        ids = [t[0] for t in self.expand_trials()]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate trial ids in the grid: {ids!r}")
        if self.dataset not in ("cifar10", "cifar100", "imagenet"):
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.epochs < 1 or self.batch_size < 1:
            raise ValueError("--epochs and --batch-size must be >= 1")
        if self.print_freq < 1:
            raise ValueError("--print-freq must be >= 1")
        if self.workers < 1:
            raise ValueError("--workers must be >= 1")
        if self.events_max_mb < 0:
            raise ValueError("--events-max-mb must be >= 0")
        if not self.synthetic and not self.data:
            raise ValueError(
                "search needs a dataset dir (or --synthetic for a "
                "smoke sweep)"
            )
        return self


__all__ = ["SearchConfig"]
