"""Checkpoint save and restore — the port's copy of
``bdbnn_tpu/utils/checkpoint.py`` with ``torch.save`` in place of Orbax.

Layout, as the reference's: ``<run_dir>/checkpoint`` written at every
epoch's end (and, with ``--save-every-steps`` / ``--save-every-mins`` or
on preemption, mid-epoch), plus ``<run_dir>/model_best``, a committed
copy refreshed whenever validation top-1 improves. A checkpoint dir
holds:

- ``state.pt`` — ``{epoch, arch, best_acc1, state: {model, optimizer,
  step, param_names}}``: the model's and the optimizer's ``state_dict``
  as detached host tensors (a checkpoint written on the card loads on
  the CPU), the completed optimizer steps, and each optimizer param
  group's parameter names. Read with ``weights_only=True``: nothing in
  it needs more than tensors and plain containers;
- ``resume.json`` — the sidecar with the rest of the resume state
  (``step_in_epoch``, ``best_epoch``, the numpy host RNG, the schedule
  scalars, the writer's topology), the reference's keys;
- ``INTEGRITY.json`` — sha256 over every other file, the reference's
  algorithm, so the reference's ``verify_integrity`` calls a port
  checkpoint dir ``"ok"``.

Crash safety is the reference's: a save goes to ``checkpoint.tmp``
(payload, sidecar, then the digest), and :func:`_commit` swaps it in
by rename, keeping the displaced checkpoint as ``checkpoint.old``; a
crash between any two filesystem operations leaves at least one
complete checkpoint. :func:`load_checkpoint` verifies the digest and
falls back to ``.old`` on a mismatch or an unreadable payload. I/O
retries transient ``OSError`` (:func:`retry_io`); a save that still
fails raises.

In a job every rank calls :func:`save_checkpoint`, rank 0 writes and
commits, and barriers bracket the write and the commit as in the
reference's collective save, so no rank runs on while a checkpoint of its
step is still uncommitted. The file always holds whole tensors: under
tensor parallelism every rank first joins the gather over ``model`` of
each sharded parameter and its optimizer state (a collective), so the
payload is the layout a one-process run writes. Every rank may restore
any checkpoint, whatever layout wrote it: :func:`load_checkpoint` cuts
the whole tensors to a sharded model's slices.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from bdbnn_tpu_torch.parallel import Mesh, barrier
from bdbnn_tpu_torch.parallel.tensor import (
    full_optimizer_state,
    full_state_dict,
    shard_optimizer_state,
    shard_state_dict,
)

CKPT_NAME = "checkpoint"
BEST_NAME = "model_best"
INTEGRITY_NAME = "INTEGRITY.json"
RESUME_NAME = "resume.json"
PAYLOAD_NAME = "state.pt"

# commit-path filesystem ops, indirected so the crash-phase tests can
# inject a failure between any two of them
_rename = os.rename
_rmtree = shutil.rmtree

# retry_io defaults: 4 attempts, 0.05s doubling to a 1s cap
RETRY_ATTEMPTS = 4
RETRY_BASE_DELAY_S = 0.05
RETRY_MAX_DELAY_S = 1.0


def retry_io(
    fn: Callable[[], Any],
    *,
    attempts: int = RETRY_ATTEMPTS,
    base_delay: float = RETRY_BASE_DELAY_S,
    max_delay: float = RETRY_MAX_DELAY_S,
    retry_on=(OSError,),
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn`` with bounded exponential backoff on transient errors.
    Other exceptions propagate at once; the last attempt's error
    propagates unchanged."""
    last = None
    for attempt in range(max(attempts, 1)):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — retry loop by design
            last = e
            if attempt + 1 >= max(attempts, 1):
                raise
            sleep(min(base_delay * (2.0 ** attempt), max_delay))
    raise last  # unreachable


# ---------------------------------------------------------------------------
# Integrity digest (the reference's algorithm)
# ---------------------------------------------------------------------------


def dir_digest(path: str) -> Dict[str, Any]:
    """sha256 over every file under ``path`` (relative path + bytes),
    excluding the digest file itself, in a deterministic walk order."""
    h = hashlib.sha256()
    files = 0
    total = 0
    for root, _dirs, names in sorted(os.walk(path)):
        for name in sorted(names):
            if root == path and name == INTEGRITY_NAME:
                continue
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, path)
            h.update(rel.encode())
            h.update(b"\0")
            with open(fp, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
                    total += len(chunk)
            h.update(b"\0")
            files += 1
    return {"algo": "sha256", "digest": h.hexdigest(), "files": files, "bytes": total}


def write_integrity(ckpt_dir: str) -> Dict[str, Any]:
    """Digest ``ckpt_dir`` and write ``INTEGRITY.json`` inside it,
    atomically (a torn digest reads as missing, not as garbage)."""
    dig = dir_digest(ckpt_dir)
    path = os.path.join(ckpt_dir, INTEGRITY_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dig, f)
    os.replace(tmp, path)
    return dig


def verify_integrity(ckpt_dir: str) -> str:
    """``"ok"`` | ``"missing"`` (no digest — trusted) | ``"mismatch"``
    (corrupt or truncated — do not restore from this dir)."""
    path = os.path.join(ckpt_dir, INTEGRITY_NAME)
    if not os.path.exists(path):
        return "missing"
    try:
        with open(path) as f:
            want = json.load(f)
        got = dir_digest(ckpt_dir)
    except (OSError, ValueError):
        return "mismatch"
    if got["digest"] != want.get("digest"):
        return "mismatch"
    return "ok"


def checkpoint_bytes(ckpt_dir: str) -> Optional[int]:
    """The bytes the digest of ``ckpt_dir`` covered (None without one)."""
    try:
        with open(os.path.join(ckpt_dir, INTEGRITY_NAME)) as f:
            return int(json.load(f)["bytes"])
    except (OSError, ValueError, KeyError):
        return None


# ---------------------------------------------------------------------------
# Commit protocol (the reference's order)
# ---------------------------------------------------------------------------


def _commit(tmp: str, target: str) -> None:
    """Swap ``tmp`` into ``target``, keeping the displaced checkpoint as
    ``<target>.old``:

    1. ``rmtree(old)`` — only when a committed ``target`` exists;
    2. ``rename(target, old)`` — a crash here leaves ``old`` + ``tmp``;
    3. ``rename(tmp, target)`` — commit.

    ``old`` stays until the next save displaces it: it is the fallback
    when a committed checkpoint turns out corrupt."""
    old = target + ".old"
    if os.path.exists(target):
        if os.path.exists(old):
            _rmtree(old)
        _rename(target, old)
    _rename(tmp, target)


def _clean_stale_tmp(save_path: str) -> None:
    """Remove the ``*.tmp`` dirs a crashed save left behind."""
    for name in (CKPT_NAME, BEST_NAME):
        stale = os.path.join(save_path, name + ".tmp")
        if os.path.exists(stale):
            _rmtree(stale)


def _host(obj):
    """A detached host copy of every tensor in a nested container."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def param_group_names(state) -> List[List[str]]:
    """Each optimizer param group's parameter names, in group order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [[names[id(p)] for p in g["params"]] for g in state.optimizer.param_groups]


def state_payload(state) -> Dict[str, Any]:
    """What ``state.pt`` holds of a :class:`TrainState`: host copies of
    the model's and optimizer's ``state_dict`` (whole: a model sharded
    over ``model`` is gathered, so every model rank must call it), the
    step, and the param groups' names."""
    return {
        "model": _host(full_state_dict(state.model)),
        "optimizer": _host(full_optimizer_state(state.optimizer)),
        "step": int(state.step),
        "param_names": param_group_names(state),
    }


def save_checkpoint(
    save_path: str,
    state,
    *,
    epoch: int,
    arch: str,
    best_acc1: float,
    is_best: bool,
    step_in_epoch: int = 0,
    resume_state: Optional[Dict[str, Any]] = None,
    mesh=None,
) -> str:
    """Write ``checkpoint`` (and a committed copy to ``model_best`` when
    best); returns the committed checkpoint path.

    ``step_in_epoch`` > 0 marks a mid-epoch save: the payload records the
    current epoch (not ``epoch + 1``) so resume re-enters it, and the
    sidecar carries the step cursor. ``resume_state`` is merged into the
    sidecar. On a ``mesh`` of more than one rank every rank must call it
    (it holds barriers, and under tensor parallelism the gather of the
    shards) and rank 0 alone writes."""
    mesh = mesh or Mesh()
    barrier(mesh)
    # every model rank joins the gather; only rank 0 keeps what it made
    whole = state_payload(state) if (mesh.primary or mesh.model > 1) else None
    if mesh.primary:
        _write_checkpoint(save_path, whole, epoch=epoch, arch=arch, best_acc1=best_acc1,
                          is_best=is_best, step_in_epoch=step_in_epoch,
                          resume_state=resume_state)
    barrier(mesh)
    return os.path.join(save_path, CKPT_NAME)


def _write_checkpoint(save_path: str, state_p: Dict[str, Any], *, epoch: int, arch: str,
                      best_acc1: float, is_best: bool, step_in_epoch: int,
                      resume_state: Optional[Dict[str, Any]]) -> None:
    """One process's save of ``state_p`` (:func:`state_payload`): the
    payload, sidecar and digest into ``checkpoint.tmp``, then the commit
    (and ``model_best``)."""
    payload_epoch = epoch + 1 if step_in_epoch == 0 else epoch
    payload = {
        "epoch": payload_epoch,
        "arch": arch,
        "best_acc1": float(best_acc1),
        "state": state_p,
    }
    sidecar = {
        "epoch": payload_epoch,
        "step_in_epoch": int(step_in_epoch),
        "best_acc1": float(best_acc1),
        "saved_unix": round(time.time(), 3),
        **(resume_state or {}),
    }
    target = os.path.join(save_path, CKPT_NAME)
    tmp = target + ".tmp"
    os.makedirs(save_path, exist_ok=True)
    _clean_stale_tmp(save_path)

    def _attempt():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, PAYLOAD_NAME))
        # sidecar + digest land INSIDE tmp before commit, so the digest
        # covers them and the commit renames everything at once
        with open(os.path.join(tmp, RESUME_NAME), "w") as f:
            json.dump(sidecar, f)
        write_integrity(tmp)

    retry_io(_attempt)
    retry_io(lambda: _commit(tmp, target))
    if is_best:
        best = os.path.join(save_path, BEST_NAME)
        btmp = best + ".tmp"

        def _best_attempt():
            if os.path.exists(btmp):
                shutil.rmtree(btmp)
            shutil.copytree(target, btmp)
            _commit(btmp, best)

        retry_io(_best_attempt)


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def _candidate_dirs(path: str) -> List[str]:
    """Restore candidates in preference order: the committed checkpoint
    first, then ``.old``."""
    cands: List[str] = []
    if os.path.isdir(path):
        primary = os.path.join(path, CKPT_NAME)
        if os.path.isdir(primary) or os.path.isdir(primary + ".old"):
            for cand in (primary, primary + ".old"):
                if os.path.isdir(cand):
                    cands.append(cand)
            return cands
        cands.append(path)  # an explicit checkpoint dir
    if os.path.isdir(path + ".old"):
        cands.append(path + ".old")
    return cands or [path]


def read_resume_state(ckpt_dir: str) -> Dict[str, Any]:
    """The ``resume.json`` sidecar of a checkpoint dir ({} when absent)."""
    path = os.path.join(ckpt_dir, RESUME_NAME)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _read_payload(ckpt_dir: str) -> Dict[str, Any]:
    payload = torch.load(os.path.join(ckpt_dir, PAYLOAD_NAME), map_location="cpu",
                         weights_only=True)
    if not isinstance(payload, dict) or not isinstance(payload.get("state"), dict) \
            or "model" not in payload["state"]:
        raise ValueError("no state/model in payload")
    return payload


def _first_readable(path: str, what: str):
    """(payload, dir, integrity, fallback) of the first candidate whose
    digest holds and whose payload reads; raises naming every
    candidate's reason when none does."""
    candidates = _candidate_dirs(path)
    failures: List[str] = []
    for cand in candidates:
        integrity = verify_integrity(cand)
        if integrity == "mismatch":
            failures.append(f"{cand}: integrity digest mismatch")
            continue
        try:
            payload = _read_payload(cand)
        except Exception as e:  # a torn payload raises many types
            failures.append(f"{cand}: {type(e).__name__}: {e}")
            continue
        return payload, cand, integrity, cand != candidates[0]
    raise RuntimeError(
        f"no {what} checkpoint under {path!r}; tried:\n  "
        + "\n  ".join(failures or ["(no candidate dirs)"])
    )


def load_checkpoint(path: str, state, *, reset_resume: bool = False) -> Dict[str, Any]:
    """Restore a checkpoint (a run dir or a checkpoint dir) into
    ``state`` in place, on the devices its tensors already lie on; a
    model sharded over ``model`` takes its slices of the whole tensors.

    Returns ``{epoch, arch, best_acc1, state, step_in_epoch, best_epoch,
    host_rng, topology, source, fallback, integrity}``. With
    ``reset_resume`` only the model (weights and BN statistics) is
    taken; the optimizer, the step and the schedule restart.

    Raises ``ValueError`` when the optimizer's param groups hold other
    parameters than the checkpoint's: ``torch.optim`` matches groups by
    position, so the moments would land on the wrong tensors."""
    payload, used, integrity, fallback = _first_readable(path, "restorable")
    saved = payload["state"]
    meta = {"source": used, "fallback": fallback, "integrity": integrity}
    model_sd = shard_state_dict(state.model, saved["model"])
    if reset_resume:
        state.model.load_state_dict(model_sd, strict=True)
        return {"epoch": 0, "arch": payload.get("arch", ""), "best_acc1": 0.0, "state": state,
                "step_in_epoch": 0, "best_epoch": -1, "host_rng": None, "topology": None,
                **meta}
    want = param_group_names(state)
    got = saved.get("param_names")
    if got != want:
        raise ValueError(
            f"{used}: the optimizer's param groups differ from the checkpoint's "
            f"(checkpoint {[len(g) for g in got or []]} parameters a group, this run "
            f"{[len(g) for g in want]}; first difference "
            f"{next(((i, a, b) for i, (a, b) in enumerate(zip(got or [], want)) if a != b), None)})"
            ": a different arch, optimizer policy or decay mask"
        )
    state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    shard_optimizer_state(state.optimizer)
    state.step = int(saved["step"])
    sidecar = read_resume_state(used)
    return {
        "epoch": int(payload["epoch"]),
        "arch": payload.get("arch", ""),
        "best_acc1": float(payload["best_acc1"]),
        "state": state,
        "step_in_epoch": int(sidecar.get("step_in_epoch", 0)),
        "best_epoch": int(sidecar.get("best_epoch", -1)),
        "host_rng": sidecar.get("host_rng"),
        "topology": sidecar.get("topology"),
        **meta,
    }


def load_variables(path: str) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` (host tensors) of a port checkpoint — for
    a ``fit()``-trained float model as a frozen teacher. ``path`` is a
    run dir (``model_best`` preferred over ``checkpoint``) or a
    checkpoint dir; the digest is verified and ``.old`` is the fallback,
    as in :func:`load_checkpoint`."""
    best = os.path.join(path, BEST_NAME)
    if os.path.isdir(best):
        path = best
    payload, _, _, _ = _first_readable(path, "loadable")
    return payload["state"]["model"]


def load_export_payload(path: str) -> Dict[str, Any]:
    """Read-side restore for the exporter: weights as a flax-layout
    ``{params, batch_stats}`` tree of numpy arrays, plus ``arch``,
    ``epoch``, ``best_acc1``, ``source``, ``integrity``, ``fallback`` and
    ``resume_state``. ``model_best`` is preferred (its ``best_acc1`` is
    the exported weights' own eval top-1); candidates fall back as in
    :func:`load_checkpoint`."""
    from bdbnn_tpu_torch.bridge import state_dict_to_flax

    best = os.path.join(path, BEST_NAME)
    if os.path.isdir(best) or os.path.isdir(best + ".old"):
        path = best
    payload, used, integrity, fallback = _first_readable(path, "exportable")
    tree = state_dict_to_flax(payload["state"]["model"])
    return {
        "params": tree["params"],
        "batch_stats": tree["batch_stats"],
        "arch": payload.get("arch", ""),
        "epoch": int(payload.get("epoch", 0)),
        "best_acc1": float(payload.get("best_acc1", 0.0)),
        "source": used,
        "integrity": integrity,
        "fallback": fallback,
        "resume_state": read_resume_state(used),
    }


__all__ = [
    "BEST_NAME",
    "CKPT_NAME",
    "INTEGRITY_NAME",
    "PAYLOAD_NAME",
    "RESUME_NAME",
    "checkpoint_bytes",
    "dir_digest",
    "load_checkpoint",
    "load_export_payload",
    "load_variables",
    "param_group_names",
    "read_resume_state",
    "retry_io",
    "save_checkpoint",
    "state_payload",
    "verify_integrity",
    "write_integrity",
]
