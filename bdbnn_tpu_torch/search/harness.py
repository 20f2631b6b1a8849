"""The recipe-search harness: trial fan-out, ledger, leaderboard — the
port's copy of ``bdbnn_tpu/search/harness.py``.

Design, in the order a sweep experiences it:

- **Trials are real runs.** Each trial is one ``python -m bdbnn_tpu_torch.cli``
  fit subprocess with its own ``--log_path`` under
  ``<sweep>/trials/<trial_id>/`` — a full run dir (manifest, events,
  checkpoints), not a stripped-down inner loop. Everything the repo
  already knows how to do to a run (summarize, watch, compare, export
  the winner) works on a trial unchanged, and the resilience layer
  (``train/resilience.py``) comes for free: SIGTERM on the harness is
  FORWARDED to every in-flight worker, each commits a mid-epoch
  checkpoint and exits 75,
  and the harness itself exits 75 after recording their cursors.

- **The ledger is the source of truth** (``<sweep>/ledger.json``): one
  entry per trial — spec, status (pending → running → done / preempted
  / failed), attempts, run dirs, extracted metrics — committed
  atomically after every transition with the ``utils/checkpoint.py``
  discipline: per-entry sha256 digests plus a file digest, tmp+rename
  commit, the displaced ledger retained as ``ledger.json.old`` and used
  as the fallback when the committed file is torn. ``search --resume``
  trusts it: ``done`` trials are NEVER re-run (their metrics, digests
  and run dirs are carried verbatim), ``preempted`` trials resume from
  their mid-epoch checkpoint via ``--resume <run_dir>``.

- **The leaderboard is deterministic.** Ranking uses the metrics a
  seeded fit reproduces bitwise across preemption (best/final top-1 —
  the fault harness pins that a resumed run reaches the same final
  metrics as an uninterrupted one), ordered (best desc, final desc,
  trial id), so an interrupted-then-resumed sweep ranks IDENTICALLY to
  an uninterrupted one. Wall-clock facts (time-to-common-accuracy at
  the highest top-1 every completed trial reached — ``obs/compare.py``'s
  run-vs-run judgment applied sweep-wide — per-trial wall seconds,
  attempts) ride in the verdict as evidence, nullable where a resume
  makes them unknowable, never fabricated.

- **Telemetry rides the standard channel**: ``search`` events (sweep
  start/resume/preempted/verdict) and ``trial`` events (per-transition)
  into the sweep dir's ``events.jsonl``, so ``watch`` tails a live
  sweep and ``summarize`` renders the leaderboard + resumed-trial
  lineage post hoc. ``compare`` judges two sweeps (or a sweep vs its
  leaderboard artifact) on ``search_best_top1`` /
  ``search_time_to_common_acc_s``.

Stdlib-only (subprocess + json + signal latch): the harness imports
neither torch nor numpy and never opens a CUDA context — the workers own
the card, each with its own context and its own load of the kernels.
No threads either: one poll loop multiplexes up to ``--workers``
subprocess slots, so there is no lock discipline to get wrong.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from bdbnn_tpu_torch.obs.events import EventWriter, jsonsafe, search_digest
from bdbnn_tpu_torch.obs.manifest import config_hash
from bdbnn_tpu_torch.search.config import SearchConfig
from bdbnn_tpu_torch.train.resilience import PreemptedError, PreemptionHandler

LEDGER_NAME = "ledger.json"
LEADERBOARD_NAME = "leaderboard.json"
MANIFEST_NAME = "manifest.json"

# how long a SIGTERMed worker gets to commit its mid-epoch checkpoint
# and exit 75 before the harness escalates to SIGKILL — generous: a
# save of a smoke-scale state is sub-second, the flagship's about one
# second
WORKER_GRACE_S = 120.0

# a worker preempted WITHOUT the harness being preempted (a node-local
# reclaim SIGTERMed just that PID) is relaunched from its checkpoint —
# but a trial that keeps getting reclaimed must eventually fail loudly
# instead of spinning the sweep forever
MAX_TRIAL_ATTEMPTS = 8

# terminal trial statuses; everything else is re-runnable on resume
_TERMINAL = ("done", "failed")


def _canonical(obj: Any) -> str:
    return json.dumps(jsonsafe(obj), sort_keys=True, separators=(",", ":"))


def _digest(obj: Any) -> str:
    return hashlib.sha256(_canonical(obj).encode()).hexdigest()


def sweep_config_hash(cfg: SearchConfig) -> str:
    """Identity of a sweep for resume purposes: everything that shapes
    the TRIALS, excluding harness-side knobs that legitimately differ
    between the original invocation and its ``--resume`` — the resume
    flag itself, the leaderboard copy path, the worker fan-out
    (resuming on a smaller box with ``--workers 1`` is the normal
    case) and the events-rotation cap. ``device`` shapes the trials, so
    it is part of the identity, except at its default (the card), where
    the hash is the reference's for the same grid."""
    d = dataclasses.asdict(cfg)
    for volatile in ("resume", "out", "workers", "events_max_mb"):
        d.pop(volatile, None)
    if not d.get("device"):
        d.pop("device", None)
    return config_hash(d)


class TrialLedger:
    """The integrity-digested trial ledger (module docstring protocol).

    Entries: ``{trial_id: {spec: {family, lr}, status, attempts,
    run_dirs, metrics, curve, digest}}``. ``digest`` covers the entry
    minus itself; the file carries a top-level digest over the sorted
    entry digests — a torn or tampered commit falls back to
    ``ledger.json.old`` exactly like a corrupt checkpoint falls back to
    ``checkpoint.old``.
    """

    def __init__(self, sweep_dir: str):
        self.sweep_dir = sweep_dir
        self.path = os.path.join(sweep_dir, LEDGER_NAME)
        self.config_hash: str = ""
        self.trials: Dict[str, Dict[str, Any]] = {}
        self.loaded_from: Optional[str] = None

    # -- persistence -------------------------------------------------

    @staticmethod
    def _entry_digest(tid: str, entry: Dict[str, Any]) -> str:
        # the trial ID is INSIDE the digested payload: swapping two
        # entries' bodies (mis-attributing one recipe's results to
        # another) must fail verification, not just corrupting a body
        body = {k: v for k, v in entry.items() if k != "digest"}
        return _digest([tid, body])

    @classmethod
    def _verify(cls, data: Dict[str, Any]) -> bool:
        trials = data.get("trials")
        if not isinstance(trials, dict):
            return False
        for tid, entry in trials.items():
            if entry.get("digest") != cls._entry_digest(tid, entry):
                return False
        want = _digest(sorted(
            f"{tid}:{e.get('digest', '')}" for tid, e in trials.items()
        ))
        return data.get("digest") == want

    def load(self) -> bool:
        """Load + verify; True when an existing ledger was restored.
        The committed file is tried first, ``ledger.json.old`` second
        (a crash between the two commit renames, or a committed file
        later found torn); both failing with a file PRESENT raises —
        a sweep must never silently restart over a corrupt ledger."""
        candidates = [self.path, self.path + ".old"]
        present = [p for p in candidates if os.path.exists(p)]
        for cand in present:
            try:
                with open(cand) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                continue
            if not self._verify(data):
                continue
            self.config_hash = data.get("config_hash", "")
            self.trials = data["trials"]
            self.loaded_from = cand
            return True
        if present:
            raise RuntimeError(
                f"ledger under {self.sweep_dir!r} failed integrity "
                "verification (and no intact fallback); refusing to "
                "restart the sweep over corrupt state"
            )
        return False

    def commit(self) -> None:
        for tid, entry in self.trials.items():
            entry["digest"] = self._entry_digest(tid, entry)
        data = {
            "schema": 1,
            "config_hash": self.config_hash,
            "trials": self.trials,
            "digest": _digest(sorted(
                f"{tid}:{e.get('digest', '')}"
                for tid, e in self.trials.items()
            )),
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(jsonsafe(data), f, sort_keys=True)
        # the checkpoint.py commit order: the displaced ledger survives
        # as .old until the NEXT commit displaces it, so a torn rename
        # always leaves one verifiable ledger on disk
        if os.path.exists(self.path):
            old = self.path + ".old"
            if os.path.exists(old):
                os.remove(old)
            os.replace(self.path, old)
        os.replace(tmp, self.path)

    # -- transitions -------------------------------------------------

    def init_trials(
        self, trials: Tuple[Tuple[str, str, float], ...], cfg_hash: str
    ) -> None:
        self.config_hash = cfg_hash
        for tid, spec, lr in trials:
            self.trials[tid] = {
                "spec": {"family": spec, "lr": lr},
                "status": "pending",
                "attempts": 0,
                "run_dirs": [],
                "metrics": None,
                "curve": None,
            }
        self.commit()

    def entry(self, tid: str) -> Dict[str, Any]:
        return self.trials[tid]

    def status(self, tid: str) -> str:
        return self.trials[tid]["status"]

    def mark(self, tid: str, status: str, **fields: Any) -> None:
        self.trials[tid].update({"status": status, **fields})
        self.commit()

    def reconcile_stale(self) -> List[str]:
        """A resumed ledger may carry trials stuck in ``running`` (the
        harness was SIGKILLed around a commit). Downgrade them: a
        committed checkpoint in the last run dir means the worker got
        its SIGTERM save in -> ``preempted`` (resumable); otherwise the
        attempt is lost -> ``pending`` (re-run from scratch). Returns
        the reconciled ids."""
        out = []
        for tid, entry in self.trials.items():
            if entry["status"] != "running":
                continue
            run_dirs = entry.get("run_dirs") or []
            resumable = bool(run_dirs) and os.path.isdir(
                os.path.join(run_dirs[-1], "checkpoint")
            )
            entry["status"] = "preempted" if resumable else "pending"
            out.append(tid)
        if out:
            self.commit()
        return out


def _trial_argv(
    cfg: SearchConfig, spec: str, lr: float, trial_dir: str,
    resume_from: Optional[str],
) -> List[str]:
    """The worker command line: a REAL CLI fit, so the trial rides the
    exact resilience/telemetry path production runs do."""
    argv = [sys.executable, "-m", "bdbnn_tpu_torch.cli"]
    if cfg.data:
        argv.append(cfg.data)
    argv += [
        "--dataset", cfg.dataset,
        "-a", cfg.arch,
        "--epochs", str(cfg.epochs),
        "-b", str(cfg.batch_size),
        "-lr", repr(lr),
        "-p", str(cfg.print_freq),
        "--seed", str(cfg.seed),
        "--binarizer", spec,
        "--log_path", trial_dir,
    ]
    if cfg.synthetic:
        argv += [
            "--synthetic",
            "--synthetic-train-size", str(cfg.synthetic_train_size),
            "--synthetic-val-size", str(cfg.synthetic_val_size),
        ]
    if cfg.device:
        argv += ["--device", cfg.device]
    if resume_from:
        argv += ["--resume", resume_from]
    return argv


def _resolve_trial_run_dir(trial_dir: str) -> Optional[str]:
    from bdbnn_tpu_torch.obs.summarize import resolve_run_dir

    try:
        return resolve_run_dir(trial_dir)
    except FileNotFoundError:
        return None


def _extract_trial_metrics(run_dir: str) -> Tuple[Dict[str, Any], List]:
    """Normalize a finished trial through ``obs/compare.py``'s run
    extractor — the SAME judgment compare applies run-vs-run — keeping
    the leaderboard-relevant slice + the raw accuracy curve."""
    from bdbnn_tpu_torch.obs.compare import extract_run

    rec = extract_run(run_dir)
    m = rec["metrics"]
    return (
        {
            "best_top1": m.get("best_acc1"),
            "final_top1": m.get("final_acc1"),
            "wall_s": m.get("wall_s"),
            "alerts_critical": m.get("alerts_critical"),
        },
        rec.get("acc_curve") or [],
    )


def build_leaderboard(
    cfg: SearchConfig, ledger: TrialLedger
) -> Dict[str, Any]:
    """Rank the ledger into the strict-JSON leaderboard verdict.

    Deterministic given the same trial RESULTS: the ranking orders
    completed trials by (best top-1 desc, final top-1 desc, trial id) —
    metrics a seeded fit reproduces bitwise across preemption — so the
    resumed-sweep leaderboard ranks identically to the uninterrupted
    one. ``time_to_common_acc_s`` (elapsed seconds to the highest
    top-1 EVERY completed trial reached, from each trial's own eval
    timeline) and the per-trial attempt/wall evidence are reported but
    never rank: they are wall-clock facts, nullable for resumed trials
    whose pre-preemption timeline lives in an earlier run dir."""
    trials_meta: Dict[str, Any] = {}
    ranked: List[Dict[str, Any]] = []
    failed = preempted = 0
    alerts_critical = 0
    done_rows = []
    for tid, entry in sorted(ledger.trials.items()):
        spec = entry["spec"]
        status = entry["status"]
        metrics = entry.get("metrics") or {}
        resumed = (entry.get("attempts", 0) or 0) > 1
        if status == "failed":
            failed += 1
        if status == "preempted":
            preempted += 1
        alerts_critical += int(metrics.get("alerts_critical") or 0)
        trials_meta[tid] = {
            "family": spec["family"],
            "lr": spec["lr"],
            "status": status,
            "attempts": entry.get("attempts", 0),
            "resumed": resumed,
            "best_top1": metrics.get("best_top1"),
            "final_top1": metrics.get("final_top1"),
            # wall-clock facts come from the FINAL attempt's run dir;
            # a resumed trial's pre-preemption time lives in an earlier
            # run dir, so its wall/ttca are unknowable — reported null,
            # never fabricated from the rebased post-resume timeline
            "wall_s": None if resumed else metrics.get("wall_s"),
            "alerts_critical": metrics.get("alerts_critical"),
            "time_to_common_acc_s": None,  # filled below
        }
        if status == "done" and metrics.get("best_top1") is not None:
            done_rows.append((tid, entry))

    # the common-accuracy level: the highest top-1 EVERY completed
    # trial reached (min over bests) — compare's time-to-common-acc
    # judgment, sweep-wide
    level = (
        min(float(e["metrics"]["best_top1"]) for _, e in done_rows)
        if done_rows
        else None
    )
    if level is not None:
        for tid, entry in done_rows:
            if trials_meta[tid]["resumed"]:
                continue  # curve is rebased to the resume; unknowable
            ttca = None
            for acc, elapsed in entry.get("curve") or []:
                if float(acc) >= level:
                    ttca = elapsed
                    break
            trials_meta[tid]["time_to_common_acc_s"] = ttca

    done_rows.sort(
        key=lambda it: (
            -float(it[1]["metrics"]["best_top1"]),
            -float(it[1]["metrics"].get("final_top1") or -1e9),
            it[0],
        )
    )
    for rank, (tid, entry) in enumerate(done_rows, start=1):
        ranked.append({
            "rank": rank,
            "trial": tid,
            "family": entry["spec"]["family"],
            "lr": entry["spec"]["lr"],
            "best_top1": entry["metrics"]["best_top1"],
            "final_top1": entry["metrics"].get("final_top1"),
        })

    winner = None
    if ranked:
        wid = ranked[0]["trial"]
        winner = {
            **ranked[0],
            "time_to_common_acc_s": trials_meta[wid][
                "time_to_common_acc_s"
            ],
            "run_dir": (ledger.trials[wid].get("run_dirs") or [None])[-1],
        }
        winner.pop("rank", None)

    recipe = {
        "arch": cfg.arch,
        "dataset": cfg.dataset,
        "epochs": cfg.epochs,
        "batch_size": cfg.batch_size,
    }
    return jsonsafe({
        "search_verdict": 1,
        "provenance": {
            "config_hash": ledger.config_hash,
            "recipe": recipe,
        },
        "trials_total": len(ledger.trials),
        "completed": len(done_rows),
        "failed": failed,
        "preempted": preempted,
        "common_acc_level": level,
        "ranking": ranked,
        "winner": winner,
        "trials": trials_meta,
        "alerts_critical": alerts_critical,
    })


def _write_sweep_manifest(cfg: SearchConfig, cfg_hash: str) -> None:
    """A minimal provenance manifest for the sweep dir (hand-rolled,
    no torch: the harness owns no device). The ``config`` block
    carries the trial-invariant recipe fields, so ``compare`` aligns
    two sweeps on arch/dataset/budget while lr/binarizer — the
    SEARCHED axes — stay unknown-at-sweep-level (None, never a
    mismatch)."""
    path = os.path.join(cfg.out_dir, MANIFEST_NAME)
    if os.path.exists(path):
        return
    man = {
        "schema": "search-1",
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "config_hash": cfg_hash,
        "config": {
            "arch": cfg.arch,
            "dataset": cfg.dataset,
            "epochs": cfg.epochs,
            "batch_size": cfg.batch_size,
            "seed": cfg.seed,
            "synthetic": cfg.synthetic,
            "search": dataclasses.asdict(cfg),
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(jsonsafe(man), f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def run_search(cfg: SearchConfig) -> Dict[str, Any]:
    """Execute (or resume) a sweep; returns ``{leaderboard, sweep_dir,
    failed}``. Raises :class:`PreemptedError` after a SIGTERM/SIGINT
    landed, every in-flight worker checkpointed + exited, and the
    ledger recorded their cursors — the CLI maps it to exit 75 so a
    supervisor restarts with ``--resume``."""
    cfg = cfg.validate()
    os.makedirs(cfg.out_dir, exist_ok=True)
    trials = cfg.expand_trials()
    cfg_hash = sweep_config_hash(cfg)

    ledger = TrialLedger(cfg.out_dir)
    resuming = ledger.load()
    if resuming and not cfg.resume:
        raise RuntimeError(
            f"{cfg.out_dir!r} already holds a sweep ledger; pass "
            "--resume to continue it (completed trials will not "
            "re-run) or choose a fresh --out-dir"
        )
    if cfg.resume and not resuming:
        raise RuntimeError(
            f"--resume but no ledger under {cfg.out_dir!r}: nothing "
            "to continue"
        )
    if resuming:
        if ledger.config_hash != cfg_hash:
            raise RuntimeError(
                "--resume with a DIFFERENT search config (hash "
                f"{cfg_hash} vs ledger {ledger.config_hash}): a "
                "changed grid would silently mis-attribute completed "
                "trials; start a fresh sweep dir instead"
            )
        ledger.reconcile_stale()
    else:
        ledger.init_trials(trials, cfg_hash)

    _write_sweep_manifest(cfg, cfg_hash)
    events = EventWriter(
        cfg.out_dir, max_bytes=int(cfg.events_max_mb * 2**20)
    )
    try:
        return _run(cfg, trials, ledger, events)
    finally:
        events.close()


def _run(cfg, trials, ledger, events) -> Dict[str, Any]:
    done_already = sum(
        1 for t in ledger.trials.values() if t["status"] == "done"
    )
    events.emit(
        "search",
        phase="resume" if cfg.resume else "start",
        trials_total=len(trials),
        completed=done_already,
        families=sorted({spec for _, spec, _ in trials}),
        workers=cfg.workers,
        config_hash=ledger.config_hash,
    )

    queue = [
        (tid, spec, lr)
        for tid, spec, lr in trials
        if ledger.status(tid) not in _TERMINAL
    ]
    active: Dict[str, Dict[str, Any]] = {}

    def _launch(tid: str, spec: str, lr: float) -> None:
        entry = ledger.entry(tid)
        trial_dir = os.path.join(cfg.out_dir, "trials", tid)
        os.makedirs(trial_dir, exist_ok=True)
        resume_from = None
        if entry["status"] == "preempted" and entry["run_dirs"]:
            resume_from = entry["run_dirs"][-1]
        attempt = int(entry.get("attempts", 0)) + 1
        log_path = os.path.join(trial_dir, f"worker.{attempt}.log")
        argv = _trial_argv(cfg, spec, lr, trial_dir, resume_from)
        log_f = open(log_path, "w")
        # the worker must import bdbnn_tpu_torch regardless of the
        # harness's cwd: prepend the package root to PYTHONPATH (a no-op
        # when the package is installed)
        import bdbnn_tpu_torch as _pkg

        env = os.environ.copy()
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(_pkg.__file__))
        )
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        proc = subprocess.Popen(
            argv, stdout=log_f, stderr=subprocess.STDOUT, env=env,
        )
        active[tid] = {
            "proc": proc, "spec": spec, "lr": lr,
            "trial_dir": trial_dir, "log": log_f,
        }
        ledger.mark(tid, "running", attempts=attempt)
        events.emit(
            "trial",
            phase="resumed" if resume_from else "start",
            trial=tid, family=spec, lr=lr, attempt=attempt,
            resumed_from=resume_from,
        )

    def _finalize(tid: str, rc: int, interrupted: bool = False) -> None:
        rec = active.pop(tid)
        rec["log"].close()
        entry = ledger.entry(tid)
        run_dir = _resolve_trial_run_dir(rec["trial_dir"])
        run_dirs = list(entry.get("run_dirs") or [])
        if run_dir and run_dir not in run_dirs:
            run_dirs.append(run_dir)
        resumable = bool(run_dir) and os.path.isdir(
            os.path.join(run_dir, "checkpoint")
        )
        if rc == 0 and run_dir:
            metrics, curve = _extract_trial_metrics(run_dir)
            ledger.mark(
                tid, "done", run_dirs=run_dirs, metrics=metrics,
                curve=curve,
            )
            events.emit(
                "trial", phase="done", trial=tid, family=rec["spec"],
                lr=rec["lr"], best_top1=metrics.get("best_top1"),
                final_top1=metrics.get("final_top1"),
                wall_s=metrics.get("wall_s"), run_dir=run_dir,
            )
        elif rc == 75 or (interrupted and resumable):
            # EX_TEMPFAIL: the worker latched the forwarded signal and
            # committed a mid-epoch checkpoint (or — interrupted
            # harness-side — left a committed checkpoint despite a
            # harder death); resume continues it
            ledger.mark(tid, "preempted", run_dirs=run_dirs)
            events.emit(
                "trial", phase="preempted", trial=tid,
                family=rec["spec"], lr=rec["lr"], run_dir=run_dir,
            )
        elif interrupted:
            # the forwarded signal caught the worker before its first
            # checkpoint (e.g. mid-import): the attempt is lost but
            # NOT a trial failure — resume re-runs it from scratch
            ledger.mark(tid, "pending", run_dirs=run_dirs)
            events.emit(
                "trial", phase="interrupted", trial=tid,
                family=rec["spec"], lr=rec["lr"], rc=rc,
            )
        else:
            ledger.mark(tid, "failed", run_dirs=run_dirs, rc=rc)
            events.emit(
                "trial", phase="failed", trial=tid, family=rec["spec"],
                lr=rec["lr"], rc=rc, run_dir=run_dir,
            )

    by_id = {tid: (tid, spec, lr) for tid, spec, lr in trials}
    handler = PreemptionHandler()
    with handler:
        while queue or active:
            while (
                queue and len(active) < cfg.workers
                and not handler.preempted
            ):
                _launch(*queue.pop(0))
            for tid in list(active):
                rc = active[tid]["proc"].poll()
                if rc is not None:
                    _finalize(tid, rc)
                    # a worker preempted on its OWN (exit 75 / lost
                    # attempt while the harness keeps running — e.g. a
                    # node-local reclaim SIGTERMed just that PID) is
                    # re-enqueued: it resumes from its checkpoint, the
                    # sweep stays complete. Bounded so a repeatedly
                    # reclaimed trial fails loudly instead of spinning.
                    if not handler.preempted and ledger.status(tid) in (
                        "preempted", "pending"
                    ):
                        if (
                            ledger.entry(tid).get("attempts", 0)
                            >= MAX_TRIAL_ATTEMPTS
                        ):
                            ledger.mark(tid, "failed", rc=rc)
                            events.emit(
                                "trial", phase="failed", trial=tid,
                                family=by_id[tid][1],
                                lr=by_id[tid][2], rc=rc,
                                reason="attempt budget exhausted",
                            )
                        else:
                            queue.append(by_id[tid])
            if handler.preempted:
                break
            if active:
                time.sleep(0.05)

        if handler.preempted:
            signum = int(handler.signum or signal.SIGTERM)
            # forward the signal: every in-flight worker runs the
            # preemption protocol (mid-epoch checkpoint -> exit 75)
            for tid in list(active):
                try:
                    active[tid]["proc"].send_signal(signal.SIGTERM)
                except OSError:
                    pass
            deadline = time.monotonic() + WORKER_GRACE_S
            for tid in list(active):
                proc = active[tid]["proc"]
                try:
                    rc = proc.wait(
                        timeout=max(deadline - time.monotonic(), 1.0)
                    )
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rc = proc.wait()
                _finalize(tid, rc, interrupted=True)
            done = sum(
                1 for t in ledger.trials.values()
                if t["status"] == "done"
            )
            events.emit(
                "search", phase="preempted", signum=signum,
                completed=done, trials_total=len(trials),
            )
            raise PreemptedError(signum, 0, done)

    leaderboard = build_leaderboard(cfg, ledger)
    lb_path = os.path.join(cfg.out_dir, LEADERBOARD_NAME)
    tmp = lb_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(leaderboard, f, indent=2, sort_keys=True)
    os.replace(tmp, lb_path)
    if cfg.out:
        with open(cfg.out, "w") as f:
            json.dump(leaderboard, f, indent=2, sort_keys=True)
    events.emit("search", phase="verdict", **leaderboard)
    return {
        "leaderboard": leaderboard,
        "sweep_dir": cfg.out_dir,
        "failed": int(leaderboard["failed"]),
    }


__all__ = [
    "LEADERBOARD_NAME",
    "LEDGER_NAME",
    "MAX_TRIAL_ATTEMPTS",
    "MANIFEST_NAME",
    "TrialLedger",
    "WORKER_GRACE_S",
    "build_leaderboard",
    "run_search",
    "search_digest",
    "sweep_config_hash",
]
