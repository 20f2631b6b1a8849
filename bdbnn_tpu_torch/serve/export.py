"""Export artifacts: write, verify and load ``artifact.json`` +
``weights.npz`` — counterpart of ``bdbnn_tpu/serve/export.py``.

The artifact format is the reference's, byte for byte in meaning: every
binary conv's latent ``float_weight`` is stored as ``np.packbits`` of
its sign (MSB first, HWIO flatten order, sign(0) := +1) plus the
per-output-channel alpha of the active binarizer family; every
BatchNorm is folded into a scale/bias affine (only its module path is
listed); ``artifact.json`` indexes every tensor and records the sha256
of ``weights.npz``, which both loaders verify. An artifact written here
loads in the JAX engine, and one the JAX package exported loads here.

:func:`write_artifact` freezes a flax-layout variable tree (the port's
``model.to_flax()``); :func:`export_artifact` is the reference's: it
reads a port run dir or checkpoint dir (``model_best`` preferred,
``checkpoint.old`` the fallback), takes the binarizer family, config
hash and device kind from the run's manifest and the recorded accuracy
from its ``eval`` events, writes the artifact and appends an ``export``
event to the run's timeline.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bdbnn_tpu_torch.obs.events import jsonsafe

ARTIFACT_NAME = "artifact.json"
WEIGHTS_NAME = "weights.npz"
ARTIFACT_SCHEMA_VERSION = 1

# substrings that must never appear in an artifact's tensor index
FORBIDDEN_STATE = ("float_weight", "opt_state", "ede", "momentum", "rng")

_NUM_CLASSES = {"cifar10": 10, "cifar100": 100, "imagenet": 1000}

# the config fields that define a recipe (the reference's
# ``bdbnn_tpu/obs/compare.py`` RECIPE_FIELDS), copied into the artifact
RECIPE_FIELDS = (
    "arch", "dataset", "ede", "w_kurtosis", "w_kurtosis_target", "kurtosis_mode",
    "imagenet_setting_step_2_ts", "react", "twoblock", "dtype", "batch_size", "epochs", "lr",
    "opt_policy", "binarizer",
)


def _flat_leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out += _flat_leaves(tree[k], prefix + (k,))
    else:
        out.append((prefix, tree))
    return out


def _file_sha256(path: str) -> str:
    """Chunked sha256 of a file — the scheme both the writer and the
    loaders use for the weights payload."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _pack_sign(w: np.ndarray) -> np.ndarray:
    """sign(w) with sign(0) := +1 packed to 1 bit/weight: bit 1 == +1."""
    return np.packbits((np.asarray(w) >= 0).reshape(-1))


def unpack_sign(packed: np.ndarray, shape) -> np.ndarray:
    """Inverse of :func:`_pack_sign`: ±1 float32 of ``shape``."""
    n = int(np.prod(shape))
    bits = np.unpackbits(packed)[:n].reshape(shape)
    return (bits.astype(np.float32) * 2.0) - 1.0


def write_artifact(
    variables: Dict[str, Any],
    out_dir: str,
    *,
    arch: str,
    dataset: str,
    dtype: str = "float32",
    twoblock: bool = False,
    family=None,
    eval_block: Optional[Dict[str, Any]] = None,
    checkpoint: Optional[Dict[str, Any]] = None,
    provenance: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Freeze a flax-layout ``{params, batch_stats}`` tree into
    ``out_dir`` (``artifact.json`` + ``weights.npz``); returns the
    manifest. BN is folded, each binary conv is binarized once with the
    alpha of ``family`` (default: the active binarizer family), and the
    pair lands atomically: weights first (tmp + rename), then the
    manifest that records their sha256. ``eval_block``, ``checkpoint``
    and ``provenance`` replace the manifest's blocks of those names (an
    export from a run fills them)."""
    from bdbnn_tpu_torch.models.resnet import fold_batch_norm
    from bdbnn_tpu_torch.nn.binarize import get_active_family, weight_alpha_np

    if dataset not in _NUM_CLASSES:
        raise ValueError(f"unknown dataset {dataset!r}")
    to_np = lambda t: {
        k: to_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in t.items()
    }
    folded = fold_batch_norm(
        {
            "params": to_np(variables["params"]),
            "batch_stats": to_np(variables.get("batch_stats", {}) or {}),
        }
    )
    family = family or get_active_family()

    tensors: List[Dict[str, Any]] = []
    arrays: Dict[str, np.ndarray] = {}
    dense_bytes = 0
    packed_bytes = 0
    binarized = 0
    for path, leaf in _flat_leaves(folded["params"]):
        name = "/".join(path)
        leaf = np.asarray(leaf)
        if path[-1] == "float_weight" and leaf.ndim == 4:
            alpha = weight_alpha_np(family.name, leaf)
            packed = _pack_sign(leaf)
            base = "/".join(path[:-1])
            arrays[f"sign:{base}"] = packed
            arrays[f"alpha:{base}"] = alpha
            tensors.append({
                "path": base,
                "kind": "binary",
                "shape": list(leaf.shape),
                "dtype": "1bit+f32alpha",
            })
            binarized += 1
            dense_bytes += leaf.astype(np.float32).nbytes
            packed_bytes += packed.nbytes + alpha.nbytes
        else:
            arr = leaf.astype(np.float32) if leaf.dtype != np.float32 else leaf
            arrays[f"dense:{name}"] = arr
            tensors.append({
                "path": name,
                "kind": "dense",
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            })
            dense_bytes += arr.nbytes
            packed_bytes += arr.nbytes
    bn_paths = [
        "/".join(path[:-1])
        for path, _ in _flat_leaves(folded["batch_stats"])
        if path[-1] == "mean"
    ]
    for t in tensors:
        if any(f in t["path"].lower() for f in FORBIDDEN_STATE):
            raise ValueError(
                f"training-only state leaked into the artifact: {t['path']}"
            )

    config = {"arch": arch, "dataset": dataset, "dtype": dtype,
              "twoblock": bool(twoblock), "binarizer": family.spec}
    artifact = {
        "schema": ARTIFACT_SCHEMA_VERSION,
        "created_unix": round(time.time(), 3),
        "arch": arch,
        "dataset": dataset,
        "num_classes": _NUM_CLASSES[dataset],
        "image_size": 224 if dataset == "imagenet" else 32,
        "model": {"dtype": dtype, "twoblock": bool(twoblock)},
        "eval": eval_block or {
            "source": "weights",
            "checkpoint_acc1": None,
            "best_seen_acc1": None,
            "checkpoint_epoch": None,
            "final_eval_acc1": None,
            "evals_recorded": 0,
        },
        "checkpoint": checkpoint or {"source": None, "integrity": None, "fallback": None},
        "provenance": provenance or {
            "run_dir": None,
            "config_hash": None,
            "device_kind": None,
            "recipe": {},
            "config": config,
        },
        "tensors": tensors,
        "bn_folded": sorted(bn_paths),
        "stats": {
            "binarized_convs": binarized,
            "dense_bytes": int(dense_bytes),
            "artifact_bytes": int(packed_bytes),
            "compression_ratio": round(dense_bytes / max(packed_bytes, 1), 3),
        },
    }

    os.makedirs(out_dir, exist_ok=True)
    wtmp = os.path.join(out_dir, WEIGHTS_NAME + ".tmp")
    with open(wtmp, "wb") as f:
        np.savez(f, **arrays)
    artifact["weights_sha256"] = _file_sha256(wtmp)
    os.replace(wtmp, os.path.join(out_dir, WEIGHTS_NAME))
    tmp = os.path.join(out_dir, ARTIFACT_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(jsonsafe(artifact), f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(out_dir, ARTIFACT_NAME))
    return artifact


def export_artifact(
    source: str,
    out_dir: str,
    *,
    arch: Optional[str] = None,
    dataset: Optional[str] = None,
) -> Dict[str, Any]:
    """Freeze ``source`` (a port run dir or checkpoint dir) into
    ``out_dir``; returns the artifact manifest. ``arch``/``dataset``
    override what the run's manifest or the checkpoint recorded (a bare
    checkpoint dir has no manifest)."""
    from bdbnn_tpu_torch.nn.binarize import resolve_family
    from bdbnn_tpu_torch.obs.events import EventWriter, read_events
    from bdbnn_tpu_torch.obs.manifest import read_manifest
    from bdbnn_tpu_torch.utils.checkpoint import BEST_NAME, load_export_payload

    payload = load_export_payload(source)
    # the run manifest is in the source dir or its parent (a checkpoint dir)
    run_dir = manifest = None
    for cand in (source, os.path.dirname(source.rstrip(os.sep))):
        if cand and os.path.isdir(cand):
            m = read_manifest(cand)
            if m is not None:
                manifest, run_dir = m, cand
                break
    config = (manifest or {}).get("config") or {}
    arch = arch or config.get("arch") or payload["arch"]
    dataset = dataset or config.get("dataset")
    if not arch:
        raise ValueError("checkpoint records no arch and none was passed; use --arch")
    if not dataset:
        raise ValueError(
            "checkpoint records no dataset (bare checkpoint dir with no run manifest) and "
            "none was passed; use --dataset"
        )
    # alpha is the scale of the family that trained the weights
    family = resolve_family(config.get("binarizer", ""), ede=bool(config.get("ede")))
    # only a model_best payload's best_acc1 is the exported weights' own
    # recorded top-1; a rolling checkpoint's weights were never evaluated
    from_best = os.path.basename(payload["source"].rstrip(os.sep)).startswith(BEST_NAME)
    eval_events = read_events(run_dir, "eval") if run_dir else []
    recorded = {
        "source": "model_best" if from_best else "checkpoint",
        "checkpoint_acc1": payload["best_acc1"] if from_best else None,
        "best_seen_acc1": payload["best_acc1"],
        "checkpoint_epoch": payload["epoch"],
        "final_eval_acc1": eval_events[-1].get("acc1") if eval_events else None,
        "evals_recorded": len(eval_events),
    }
    artifact = write_artifact(
        {"params": payload["params"], "batch_stats": payload["batch_stats"]}, out_dir,
        arch=arch, dataset=dataset, dtype=config.get("dtype", "float32"),
        twoblock=bool(config.get("twoblock", False)), family=family, eval_block=recorded,
        checkpoint={"source": payload["source"], "integrity": payload["integrity"],
                    "fallback": payload["fallback"]},
        provenance={
            "run_dir": os.path.abspath(run_dir) if run_dir else None,
            "config_hash": (manifest or {}).get("config_hash"),
            "device_kind": (manifest or {}).get("device_kind"),
            "recipe": {k: config.get(k) for k in RECIPE_FIELDS},
            "config": config,
        },
    )
    if run_dir is not None:
        ev = EventWriter(run_dir)
        try:
            ev.emit(
                "export", artifact=os.path.abspath(out_dir), arch=arch, dataset=dataset,
                checkpoint=payload["source"], integrity=payload["integrity"],
                binarized_convs=artifact["stats"]["binarized_convs"],
                compression_ratio=artifact["stats"]["compression_ratio"],
                checkpoint_acc1=recorded["checkpoint_acc1"],
            )
        finally:
            ev.close()
    return artifact


def read_artifact(artifact_dir: str) -> Dict[str, Any]:
    """Load ``artifact.json``; raises when the dir is not an artifact."""
    path = os.path.join(artifact_dir, ARTIFACT_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{artifact_dir!r} holds no {ARTIFACT_NAME} — not an export artifact"
        )
    with open(path) as f:
        return json.load(f)


def _verified_npz(artifact_dir: str, artifact: Dict[str, Any]):
    """Open ``weights.npz`` after verifying it against the manifest's
    sha256: a torn re-export fails loudly instead of serving the wrong
    weights."""
    wpath = os.path.join(artifact_dir, WEIGHTS_NAME)
    want = artifact.get("weights_sha256")
    if want and _file_sha256(wpath) != want:
        raise RuntimeError(
            f"{wpath} does not match the sha256 recorded in "
            f"{ARTIFACT_NAME} — torn or mixed re-export; re-export into "
            "a fresh directory"
        )
    return np.load(wpath)


def _set_path(tree, path, leaf):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf


def _bn_stats(params, artifact) -> Dict[str, Any]:
    from bdbnn_tpu_torch.models.resnet import bn_identity_stats

    batch_stats: Dict[str, Any] = {}
    for bn in artifact["bn_folded"]:
        path = tuple(bn.split("/"))
        node = params
        for k in path:
            node = node[k]
        _set_path(batch_stats, path, bn_identity_stats(len(node["scale"])))
    return batch_stats


def load_artifact_variables(artifact_dir: str) -> Dict[str, Any]:
    """The DENSE loader: a flax-layout ``{params, batch_stats}`` tree
    where each binary conv's ``float_weight = sign * alpha`` (the exact
    fixed point of the binarizer) and folded BNs get identity stats."""
    artifact = read_artifact(artifact_dir)
    z = _verified_npz(artifact_dir, artifact)
    params: Dict[str, Any] = {}
    for t in artifact["tensors"]:
        path = tuple(t["path"].split("/"))
        if t["kind"] == "binary":
            sign = unpack_sign(z[f"sign:{t['path']}"], t["shape"])
            alpha = z[f"alpha:{t['path']}"]
            _set_path(params, path + ("float_weight",), sign * alpha)
        else:
            _set_path(params, path, z[f"dense:{t['path']}"])
    return {"params": params, "batch_stats": _bn_stats(params, artifact)}


def load_artifact_packed(artifact_dir: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The PACKED loader: ``(variables, spec)`` where ``variables``
    holds dense leaves only plus a ``packed`` collection of per-conv
    ``{sign: uint8 packbits, alpha: f32}``, and ``spec`` lists each
    binary conv's path, shape and packed / dense-equivalent bytes."""
    artifact = read_artifact(artifact_dir)
    z = _verified_npz(artifact_dir, artifact)
    params: Dict[str, Any] = {}
    packed: Dict[str, Any] = {}
    binary = []
    packed_bytes = 0
    dense_equiv = 0
    for t in artifact["tensors"]:
        path = tuple(t["path"].split("/"))
        if t["kind"] == "binary":
            sign = z[f"sign:{t['path']}"]
            alpha = np.asarray(z[f"alpha:{t['path']}"], np.float32)
            _set_path(packed, path + ("sign",), sign)
            _set_path(packed, path + ("alpha",), alpha)
            n_dense = int(np.prod(t["shape"])) * 4
            binary.append({
                "path": t["path"],
                "shape": list(t["shape"]),
                "packed_bytes": int(sign.nbytes + alpha.nbytes),
                "dense_bytes": n_dense,
            })
            packed_bytes += int(sign.nbytes + alpha.nbytes)
            dense_equiv += n_dense
        else:
            arr = z[f"dense:{t['path']}"]
            _set_path(params, path, arr)
            packed_bytes += int(arr.nbytes)
            dense_equiv += int(arr.nbytes)
    batch_stats = _bn_stats(params, artifact)
    for _, leaf in _flat_leaves(batch_stats):
        packed_bytes += int(leaf.nbytes)
        dense_equiv += int(leaf.nbytes)
    spec = {
        "binary": binary,
        "packed_resident_bytes": packed_bytes,
        "dense_equiv_bytes": dense_equiv,
        "ratio": round(dense_equiv / max(packed_bytes, 1), 3),
    }
    return {"params": params, "batch_stats": batch_stats, "packed": packed}, spec


__all__ = [
    "ARTIFACT_NAME",
    "ARTIFACT_SCHEMA_VERSION",
    "FORBIDDEN_STATE",
    "WEIGHTS_NAME",
    "export_artifact",
    "load_artifact_packed",
    "load_artifact_variables",
    "read_artifact",
    "unpack_sign",
    "write_artifact",
]
