"""Run provenance: one ``manifest.json`` per run dir — the port's copy of
``bdbnn_tpu/obs/manifest.py``.

The fields keep the reference's names wherever they mean the same thing
(``config_hash``, ``config``, ``backend``, ``device_kind``,
``device_count``, ``process_*``, ``python``, ``hostname``, ``argv``), so
the reference's ``summarize`` and ``compare`` read a port run dir; in
place of ``jax_version`` / ``jaxlib_version`` it records
``torch_version`` and ``cuda_version``. ``backend`` is "cuda" or "cpu":
the device ``fit`` runs on."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import sys
import time
from typing import Any, Dict, List, Optional

MANIFEST_SCHEMA_VERSION = 1
MANIFEST_NAME = "manifest.json"


def config_hash(cfg: Any) -> str:
    """Stable short hash of a run configuration (a dataclass or a dict):
    sha256 of its sorted-key JSON form, the reference's."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        payload = dataclasses.asdict(cfg)
    elif isinstance(cfg, dict):
        payload = cfg
    else:
        payload = dict(vars(cfg))
    blob = json.dumps(payload, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class RunManifest:
    """Reproducible-provenance record for one run dir."""

    schema: int
    created: str
    created_unix: float
    config_hash: str
    config: Dict[str, Any]
    torch_version: str
    cuda_version: Optional[str]
    backend: str
    device_kind: str
    device_count: int
    local_device_count: int
    process_index: int
    process_count: int
    python: str
    hostname: str
    argv: List[str]

    @classmethod
    def capture(cls, cfg: Any, device=None) -> "RunManifest":
        """Snapshot the process, ``device`` (a ``torch.device``; the
        CUDA card when None) and ``cfg``."""
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            kind = torch.cuda.get_device_name(dev)
            count = torch.cuda.device_count()
        else:
            import platform

            kind = platform.processor() or platform.machine() or "cpu"
            count = 1
        if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
            cfg_dict = dataclasses.asdict(cfg)
        else:
            cfg_dict = dict(cfg) if isinstance(cfg, dict) else dict(vars(cfg))
        now = time.time()
        return cls(
            schema=MANIFEST_SCHEMA_VERSION,
            created=time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(now)),
            created_unix=round(now, 3),
            config_hash=config_hash(cfg_dict),
            config=cfg_dict,
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            backend=dev.type,
            device_kind=kind,
            device_count=count,
            local_device_count=count,
            process_index=0,
            process_count=1,
            python=sys.version.split()[0],
            hostname=socket.gethostname(),
            argv=list(sys.argv),
        )

    def to_dict(self) -> Dict[str, Any]:
        # through JSON, so tuples in the config become lists
        return json.loads(json.dumps(dataclasses.asdict(self), default=repr))


def write_manifest(log_path: str, cfg: Any, extra: Optional[Dict[str, Any]] = None,
                   device=None, write: bool = True) -> Dict[str, Any]:
    """Capture and atomically write ``<log_path>/manifest.json``; returns
    the written dict. ``extra`` carries restart ancestry
    (``resumed_from``, ``restart_lineage``, ``topology_from``,
    ``topology_to``). ``write=False`` (the ranks but 0 of a job) only
    captures it."""
    man = RunManifest.capture(cfg, device).to_dict()
    if extra:
        man.update(extra)
    if not write:
        return man
    os.makedirs(log_path, exist_ok=True)
    path = os.path.join(log_path, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, default=repr)
    os.replace(tmp, path)
    return man


def read_manifest(run_dir: str) -> Optional[Dict[str, Any]]:
    """``manifest.json`` of a run dir; None when absent."""
    path = os.path.join(run_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


__all__ = ["MANIFEST_NAME", "RunManifest", "config_hash", "read_manifest", "write_manifest"]
