"""Artifact registry: versioned export dirs with digests + provenance —
the port's copy of ``bdbnn_tpu/serve/registry.py``. The layout, index
and digests are the reference's byte for byte, so a registry one package
publishes resolves in the other.

A rollout needs more than "a directory with weights in it": the swap
orchestration (serve/pool.py) must be able to name a version, prove the
bytes it is about to load are the bytes that were published, and record
where they came from. The registry is a directory of immutable
versioned copies of export artifacts plus one strict-JSON index:

::

    registry/
      registry.json        # the index: one entry per version
      v0001/               # artifact.json + weights.npz (a full copy)
      v0002/
      ...

Each index entry carries:

- ``version``          monotonically increasing int (v0001, v0002, ...)
- ``path``             the version dir, relative to the registry root
- ``artifact_sha256``  digest of the version's ``artifact.json`` bytes
- ``weights_sha256``   the weights digest the artifact manifest records
  (the export already chains artifact.json -> weights.npz; the registry
  adds the outer link index -> artifact.json, so the whole chain
  index -> manifest -> weights is verifiable)
- ``provenance``       arch/dataset/config-hash/recipe + the recorded
  eval accuracy, copied from the artifact manifest at publish time —
  what ``GET /admin/replicas`` and the swap events report per version

``publish`` copies the artifact in (tmp dir + atomic rename, so a
crashed publish never leaves a half-copied version visible in the
index); ``resolve`` verifies the digest chain before handing the path
to an engine. Tampered or torn versions fail loudly at resolve, never
at serve time. Registries are read and written with no device and no
torch import.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

from bdbnn_tpu_torch.serve.export import ARTIFACT_NAME, WEIGHTS_NAME, _file_sha256

REGISTRY_NAME = "registry.json"
REGISTRY_SCHEMA_VERSION = 1


def _version_dirname(version: int) -> str:
    return f"v{version:04d}"


def parse_version(spec) -> int:
    """``v0003`` / ``v3`` / ``3`` -> 3 — THE version-string parser,
    shared by the CLI, the serve-http artifact/swap-target resolution
    and the admin endpoint, so a malformed spec fails the same
    everywhere (ValueError with a pointed message, never a stray
    int() traceback or a silently over-stripped ``vv7``)."""
    import re

    m = re.fullmatch(r"v?(\d+)", str(spec).strip())
    if m is None:
        raise ValueError(
            f"not a registry version: {spec!r} (want vNNNN or an integer)"
        )
    return int(m.group(1))


def looks_like_version(spec) -> bool:
    """True when ``spec`` parses as a registry version — the decision
    serve-http uses to tell a version argument from an artifact dir."""
    try:
        parse_version(spec)
        return True
    except ValueError:
        return False


class ArtifactRegistry:
    """The versioned artifact store driving blue/green swaps."""

    def __init__(self, root: str):
        self.root = root

    # -- index i/o -----------------------------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.root, REGISTRY_NAME)

    def _read_index(self) -> Dict[str, Any]:
        path = self._index_path()
        if not os.path.exists(path):
            return {"schema": REGISTRY_SCHEMA_VERSION, "entries": []}
        with open(path) as f:
            return json.load(f)

    def _write_index(self, index: Dict[str, Any]) -> None:
        from bdbnn_tpu_torch.obs.events import jsonsafe

        os.makedirs(self.root, exist_ok=True)
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(jsonsafe(index), f, indent=2, sort_keys=True)
        os.replace(tmp, self._index_path())

    @contextlib.contextmanager
    def _publish_lock(
        self, timeout_s: float = 30.0, stale_s: float = 120.0
    ):
        """Inter-process mutual exclusion for publish: the index write
        is read-modify-write over the WHOLE entry list, so two
        concurrent publishers without a lock would each copy a version
        dir correctly and then one would overwrite the other's index
        entry — a fully-published version resolve() can never find.
        O_CREAT|O_EXCL on a sidecar lock file is atomic on every
        filesystem the registry targets; a lock older than ``stale_s``
        is presumed abandoned by a crashed publisher and stolen."""
        os.makedirs(self.root, exist_ok=True)
        path = self._index_path() + ".lock"
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                break
            except FileExistsError:
                try:
                    age = time.time() - os.stat(path).st_mtime
                except OSError:
                    continue  # holder released between open and stat
                if age > stale_s:
                    # Steal by atomic rename: of N concurrent stealers
                    # exactly ONE wins (the rest get OSError and re-enter
                    # the wait loop). Unlink-based stealing let two
                    # processes both observe the stale lock, both unlink
                    # (the second unlinking the first's FRESH lock) and
                    # both enter the critical section — the exact lost-
                    # index-entry failure the lock exists to prevent.
                    stolen = f"{path}.stale.{os.getpid()}"
                    try:
                        os.rename(path, stolen)
                    except OSError:
                        continue  # another stealer won, or holder released
                    with contextlib.suppress(OSError):
                        os.unlink(stolen)
                    continue
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"registry {self.root!r}: publish lock {path!r} "
                        f"held for {age:.1f}s — another publish is "
                        "running (or crashed; it is stolen after "
                        f"{stale_s:.0f}s)"
                    )
                time.sleep(0.05)
        try:
            yield
        finally:
            with contextlib.suppress(OSError):
                os.unlink(path)

    # -- queries -------------------------------------------------------

    def entries(self) -> List[Dict[str, Any]]:
        return list(self._read_index()["entries"])

    def get(self, version: int) -> Optional[Dict[str, Any]]:
        for e in self.entries():
            if e["version"] == int(version):
                return e
        return None

    def latest(self) -> Optional[Dict[str, Any]]:
        entries = self.entries()
        return max(entries, key=lambda e: e["version"]) if entries else None

    # -- publish / resolve ---------------------------------------------

    def publish(
        self, artifact_dir: str, lock_timeout_s: float = 30.0
    ) -> Dict[str, Any]:
        """Copy ``artifact_dir`` into the registry as the next version;
        returns the new index entry. The version dir lands via tmp-dir +
        atomic rename BEFORE the index references it, so a crash at any
        point leaves either no trace or a fully-copied version.
        Concurrent publishers serialize on a lock file so neither's
        index entry is lost."""
        art_path = os.path.join(artifact_dir, ARTIFACT_NAME)
        if not os.path.exists(art_path):
            raise FileNotFoundError(
                f"{artifact_dir!r} holds no {ARTIFACT_NAME} — not an "
                "export artifact"
            )
        with open(art_path) as f:
            manifest = json.load(f)
        # verify the inner link before publishing: a torn export must
        # not become an immutable "good" version
        want = manifest.get("weights_sha256")
        wpath = os.path.join(artifact_dir, WEIGHTS_NAME)
        if want and _file_sha256(wpath) != want:
            raise RuntimeError(
                f"{artifact_dir!r}: weights do not match the sha256 its "
                f"{ARTIFACT_NAME} records — refusing to publish a torn "
                "artifact"
            )

        # Stage the copy OUTSIDE the lock, into a per-pid tmp dir: the
        # copytree is the unbounded part of publish (big artifact, slow
        # disk), and holding the lock through it would let the staleness
        # steal in _publish_lock evict a live-but-slow publisher —
        # readmitting the two-writers race the lock exists to prevent.
        # Inside the lock only version assignment, one same-filesystem
        # rename and the index write remain, all fast and bounded.
        os.makedirs(self.root, exist_ok=True)
        staging = os.path.join(
            self.root,
            f".publish.tmp.{os.getpid()}.{threading.get_ident()}",
        )
        if os.path.exists(staging):
            shutil.rmtree(staging)
        shutil.copytree(artifact_dir, staging)
        try:
            with self._publish_lock(timeout_s=lock_timeout_s):
                index = self._read_index()
                # next version = 1 + max over the INDEX and the DISK: a
                # crash between the version-dir rename and the index
                # write leaves an orphan vNNNN dir with no entry, and
                # reusing its number would make every later publish fail
                # on the non-empty rename target
                disk_versions = []
                for name in os.listdir(self.root):
                    if (
                        len(name) == 5 and name[0] == "v"
                        and name[1:].isdigit()
                        and os.path.isdir(os.path.join(self.root, name))
                    ):
                        disk_versions.append(int(name[1:]))
                version = 1 + max(
                    [e["version"] for e in index["entries"]]
                    + disk_versions,
                    default=0,
                )
                dirname = _version_dirname(version)
                dest = os.path.join(self.root, dirname)
                os.replace(staging, dest)

                entry = {
                    "version": version,
                    "path": dirname,
                    "published_unix": round(time.time(), 3),
                    "source": os.path.abspath(artifact_dir),
                    "artifact_sha256": _file_sha256(
                        os.path.join(dest, ARTIFACT_NAME)
                    ),
                    "weights_sha256": want,
                    "provenance": {
                        "arch": manifest.get("arch"),
                        "dataset": manifest.get("dataset"),
                        "config_hash": (
                            manifest.get("provenance", {}).get(
                                "config_hash"
                            )
                        ),
                        "recipe": (
                            manifest.get("provenance", {}).get("recipe")
                        ),
                        "checkpoint_acc1": (
                            manifest.get("eval", {}).get("checkpoint_acc1")
                        ),
                    },
                }
                index["entries"].append(entry)
                self._write_index(index)
                return entry
        finally:
            # a failed publish (lock timeout, rename error) must not
            # leave its staging dir behind; a successful one already
            # renamed it away
            if os.path.exists(staging):
                shutil.rmtree(staging, ignore_errors=True)

    def pull(
        self,
        remote_root: str,
        version: Optional[int] = None,
        lock_timeout_s: float = 30.0,
    ) -> List[Dict[str, Any]]:
        """Replicate versions from a REMOTE registry into this one —
        the fleet's publish-time replication primitive (every serving
        host pulls the version it is about to swap to, so a rollout
        never trusts a path it did not verify). ``version`` limits the
        pull to one version; None pulls every remote version absent
        locally. Returns the list of local index entries written.

        The digest chain is verified TWICE: the remote side resolves
        through :meth:`resolve` (index -> artifact.json -> weights.npz
        against the remote index), and the staged local copy is
        re-hashed against the remote entry's recorded digests before
        the rename — a copy torn mid-transfer (short read, full disk)
        fails HERE and leaves the local registry untouched. Version
        numbers and digests are preserved verbatim, so every host's
        registry resolves version N to byte-identical artifacts."""
        remote = ArtifactRegistry(remote_root)
        if version is not None:
            entry = remote.get(int(version))
            if entry is None:
                known = [e["version"] for e in remote.entries()]
                raise KeyError(
                    f"remote registry {remote_root!r} has no version "
                    f"{version} (known: {known})"
                )
            wanted = [entry]
        else:
            # EVERY remote entry is considered: versions already local
            # are digest-compared below (identical -> skipped, diverged
            # -> a registry fork that must fail loudly)
            wanted = list(remote.entries())
        pulled: List[Dict[str, Any]] = []
        for entry in sorted(wanted, key=lambda e: e["version"]):
            v = int(entry["version"])
            local = self.get(v)
            if local is not None:
                # idempotent re-pull of an identical version; a DIVERGED
                # version number is a registry fork and must fail loudly
                if (
                    local.get("artifact_sha256")
                    != entry.get("artifact_sha256")
                    or local.get("weights_sha256")
                    != entry.get("weights_sha256")
                ):
                    raise RuntimeError(
                        f"pull: local version {v} exists with DIFFERENT "
                        f"digests than {remote_root!r}'s — the registries "
                        "have forked; refusing to overwrite"
                    )
                continue
            src = remote.resolve(v)  # remote-side digest verification
            os.makedirs(self.root, exist_ok=True)
            staging = os.path.join(
                self.root,
                f".pull.tmp.{os.getpid()}.{threading.get_ident()}",
            )
            if os.path.exists(staging):
                shutil.rmtree(staging)
            try:
                shutil.copytree(src, staging)
                # verify the STAGED copy against the remote entry: a
                # torn copy must never become a local "good" version
                if (
                    _file_sha256(os.path.join(staging, ARTIFACT_NAME))
                    != entry["artifact_sha256"]
                ):
                    raise RuntimeError(
                        f"pull: staged copy of version {v} does not "
                        f"match {ARTIFACT_NAME}'s published digest — "
                        "torn transfer; local registry untouched"
                    )
                if entry.get("weights_sha256") and (
                    _file_sha256(os.path.join(staging, WEIGHTS_NAME))
                    != entry["weights_sha256"]
                ):
                    raise RuntimeError(
                        f"pull: staged copy of version {v} does not "
                        "match the published weights digest — torn "
                        "transfer; local registry untouched"
                    )
                with self._publish_lock(timeout_s=lock_timeout_s):
                    index = self._read_index()
                    if any(
                        e["version"] == v for e in index["entries"]
                    ):
                        continue  # a concurrent puller won; theirs verified
                    dest = os.path.join(self.root, _version_dirname(v))
                    os.replace(staging, dest)
                    new_entry = {
                        **entry,
                        "path": _version_dirname(v),
                        "pulled_from": os.path.abspath(remote_root),
                        "pulled_unix": round(time.time(), 3),
                    }
                    index["entries"].append(new_entry)
                    index["entries"].sort(key=lambda e: e["version"])
                    self._write_index(index)
                    pulled.append(new_entry)
            finally:
                if os.path.exists(staging):
                    shutil.rmtree(staging, ignore_errors=True)
        return pulled

    def resolve(self, version: int) -> str:
        """Verified absolute path of a version's artifact dir: the index
        entry's recorded digests must match the bytes on disk (both the
        outer index -> artifact.json link and the inner artifact.json ->
        weights.npz link), so a tampered or torn version fails HERE,
        before an engine ever maps its weights."""
        entry = self.get(version)
        if entry is None:
            known = [e["version"] for e in self.entries()]
            raise KeyError(
                f"registry {self.root!r} has no version {version} "
                f"(known: {known})"
            )
        dest = os.path.join(self.root, entry["path"])
        art_path = os.path.join(dest, ARTIFACT_NAME)
        if _file_sha256(art_path) != entry["artifact_sha256"]:
            raise RuntimeError(
                f"registry version {version}: {ARTIFACT_NAME} does not "
                "match the digest recorded at publish — the version dir "
                "was modified after publish; republish instead of editing"
            )
        if entry.get("weights_sha256"):
            if (
                _file_sha256(os.path.join(dest, WEIGHTS_NAME))
                != entry["weights_sha256"]
            ):
                raise RuntimeError(
                    f"registry version {version}: weights do not match "
                    "the digest recorded at publish"
                )
        return os.path.abspath(dest)

    def label(self, version: int) -> str:
        """The display label swap/replica events and the verdict use."""
        return _version_dirname(int(version))


__all__ = [
    "REGISTRY_NAME",
    "REGISTRY_SCHEMA_VERSION",
    "ArtifactRegistry",
    "looks_like_version",
    "parse_version",
]
