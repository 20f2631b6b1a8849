"""The artifact registry on the port (``bdbnn_tpu_torch/serve/registry.py``)
against the JAX package's, on the CPU.

- Exact parity: ``parse_version``/``looks_like_version`` on good and bad
  specs; a registry the port publishes resolves in the JAX
  ``ArtifactRegistry`` and one the JAX package publishes resolves in the
  port's, with equal index entries (time stamps and source paths aside)
  and equal digests; a tampered or torn version is refused by both.
- Mirrors of the reference's registry cases (``tests/test_pool.py``
  ``TestArtifactRegistry``) on the port: round trip, tamper and torn
  weights at resolve, a torn artifact refused at publish, the orphan
  version dir, unknown versions, concurrent publishers, the held and
  the stale lock, and ``pull`` with its fork and torn-transfer checks.
- The port's CLI: ``registry publish/list/resolve/pull``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest

from bdbnn_tpu.serve import registry as jreg
from bdbnn_tpu_torch.serve import registry as treg
from bdbnn_tpu_torch.serve.registry import ArtifactRegistry

from test_torch_serve import port_artifact  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_VOLATILE = ("published_unix", "source", "pulled_unix", "pulled_from")


def _stable(entries):
    return [{k: v for k, v in e.items() if k not in _VOLATILE} for e in entries]


def _tear(path, name="weights.npz", data=b"\x00\x01\x02\x03"):
    with open(os.path.join(path, name), "r+b") as f:
        f.seek(0)
        f.write(data)


@pytest.mark.parametrize("spec", ["v0003", "v3", "3", " 12 ", "0", 7, "vv7", "v", "abc", "3.0",
                                  "-1", "v-2", ""])
def test_parse_version_equals_the_reference(spec):
    assert treg.looks_like_version(spec) == jreg.looks_like_version(spec)
    try:
        want = jreg.parse_version(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            treg.parse_version(spec)
        assert str(got.value) == str(e)
    else:
        assert treg.parse_version(spec) == want


@pytest.mark.parametrize("publisher", ["port", "jax"])
def test_a_registry_resolves_in_both_packages(port_artifact, tmp_path, publisher):  # noqa: F811
    pub_mod, other_mod = (treg, jreg) if publisher == "port" else (jreg, treg)
    root = str(tmp_path / "reg")
    e1 = pub_mod.ArtifactRegistry(root).publish(port_artifact)
    e2 = pub_mod.ArtifactRegistry(root).publish(port_artifact)
    assert (e1["version"], e2["version"]) == (1, 2)
    reader = other_mod.ArtifactRegistry(root)
    assert [e["version"] for e in reader.entries()] == [1, 2]
    assert reader.resolve(2) == pub_mod.ArtifactRegistry(root).resolve(2)
    assert reader.label(2) == "v0002"
    # the same artifact published by the other package: equal entries
    twin = str(tmp_path / "twin")
    other_mod.ArtifactRegistry(twin).publish(port_artifact)
    other_mod.ArtifactRegistry(twin).publish(port_artifact)
    assert _stable(pub_mod.ArtifactRegistry(root).entries()) == _stable(
        other_mod.ArtifactRegistry(twin).entries())
    with open(os.path.join(root, "registry.json")) as f:
        index = json.load(f)
    assert index["schema"] == treg.REGISTRY_SCHEMA_VERSION == jreg.REGISTRY_SCHEMA_VERSION
    # a torn version is refused by both, with the same message
    _tear(os.path.join(root, "v0002"))
    for mod in (treg, jreg):
        with pytest.raises(RuntimeError, match="weights do not match"):
            mod.ArtifactRegistry(root).resolve(2)
    with open(os.path.join(root, "v0001", "artifact.json"), "a") as f:
        f.write("\n")
    for mod in (treg, jreg):
        with pytest.raises(RuntimeError, match="modified after publish"):
            mod.ArtifactRegistry(root).resolve(1)


def test_a_torn_artifact_is_refused_by_both(port_artifact, tmp_path):  # noqa: F811
    torn = str(tmp_path / "torn")
    shutil.copytree(port_artifact, torn)
    _tear(torn, data=b"\xff\xff\xff\xff")
    for mod, name in ((treg, "p"), (jreg, "j")):
        reg = mod.ArtifactRegistry(str(tmp_path / name))
        with pytest.raises(RuntimeError, match="refusing to publish"):
            reg.publish(torn)
        assert reg.entries() == []


def test_pull_crosses_packages(port_artifact, tmp_path):  # noqa: F811
    """A port registry pulls from a JAX-published one and the JAX
    registry pulls from a port-published one: version numbers and
    digests verbatim; a forked version and a torn source refuse."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    jreg.ArtifactRegistry(jroot).publish(port_artifact)
    jreg.ArtifactRegistry(jroot).publish(port_artifact)
    pulled = ArtifactRegistry(troot).pull(jroot)
    assert [e["version"] for e in pulled] == [1, 2]
    assert _stable(ArtifactRegistry(troot).entries()) == _stable(
        jreg.ArtifactRegistry(jroot).entries())
    assert ArtifactRegistry(troot).pull(jroot) == []  # idempotent
    back = str(tmp_path / "back")
    assert [e["version"] for e in jreg.ArtifactRegistry(back).pull(troot, 2)] == [2]
    # fork: a local v0001 with other digests
    fork = str(tmp_path / "fork")
    other = str(tmp_path / "other_art")
    shutil.copytree(port_artifact, other)
    with open(os.path.join(other, "artifact.json")) as f:
        art = json.load(f)
    art["note"] = "fork"
    with open(os.path.join(other, "artifact.json"), "w") as f:
        json.dump(art, f)
    ArtifactRegistry(fork).publish(other)
    with pytest.raises(RuntimeError, match="forked"):
        ArtifactRegistry(fork).pull(jroot)
    with pytest.raises(KeyError, match="no version 9"):
        ArtifactRegistry(troot).pull(jroot, 9)
    _tear(os.path.join(jroot, "v0002"))
    with pytest.raises(RuntimeError, match="weights do not match"):
        ArtifactRegistry(str(tmp_path / "fresh")).pull(jroot, 2)
    assert not os.path.exists(os.path.join(str(tmp_path / "fresh"), "v0002"))


# ---------------------------------------------------------------------------
# mirrors of tests/test_pool.py TestArtifactRegistry on the port
# ---------------------------------------------------------------------------


class TestArtifactRegistry:
    def test_publish_list_resolve_roundtrip(self, port_artifact, tmp_path):  # noqa: F811
        reg = ArtifactRegistry(str(tmp_path / "reg"))
        e1, e2 = reg.publish(port_artifact), reg.publish(port_artifact)
        assert (e1["version"], e2["version"]) == (1, 2)
        assert reg.label(2) == "v0002" and reg.latest()["version"] == 2
        assert reg.get(1)["path"] == "v0001" and reg.get(5) is None
        assert e1["provenance"]["arch"] == "resnet8_tiny"
        assert e1["weights_sha256"] and len(e1["artifact_sha256"]) == 64
        resolved = reg.resolve(1)
        assert os.path.exists(os.path.join(resolved, "artifact.json"))
        assert resolved.endswith("v0001")
        with open(os.path.join(str(tmp_path / "reg"), "registry.json")) as f:
            json.loads(f.read(), parse_constant=lambda s: pytest.fail(f"bare {s}"))

    def test_orphan_version_dir_never_reused(self, port_artifact, tmp_path):  # noqa: F811
        root = str(tmp_path / "reg")
        os.makedirs(os.path.join(root, "v0001"))
        reg = ArtifactRegistry(root)
        assert reg.publish(port_artifact)["version"] == 2
        assert reg.resolve(2).endswith("v0002")

    def test_unknown_version_and_non_artifact(self, tmp_path):
        reg = ArtifactRegistry(str(tmp_path / "reg"))
        with pytest.raises(KeyError, match="no version 3"):
            reg.resolve(3)
        with pytest.raises(FileNotFoundError, match="not an export"):
            reg.publish(str(tmp_path))

    def test_concurrent_publishes_lose_no_entry(self, port_artifact, tmp_path):  # noqa: F811
        reg = ArtifactRegistry(str(tmp_path / "reg"))
        errs = []

        def one():
            try:
                reg.publish(port_artifact)
            except Exception as e:  # pragma: no cover - fails the test
                errs.append(e)

        threads = [threading.Thread(target=one) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errs == []
        assert [e["version"] for e in reg.entries()] == [1, 2, 3, 4]
        for v in (1, 2, 3, 4):
            assert reg.resolve(v).endswith(f"v{v:04d}")

    def test_held_lock_times_out_and_stale_lock_is_stolen(self, port_artifact, tmp_path):  # noqa: F811
        root = str(tmp_path / "reg")
        reg = ArtifactRegistry(root)
        os.makedirs(root, exist_ok=True)
        lock = os.path.join(root, "registry.json.lock")
        with open(lock, "w") as f:
            f.write("12345")
        with pytest.raises(TimeoutError, match="publish lock"):
            reg.publish(port_artifact, lock_timeout_s=0.2)
        old = time.time() - 3600
        os.utime(lock, (old, old))
        assert reg.publish(port_artifact, lock_timeout_s=0.2)["version"] == 1
        assert not os.path.exists(lock)


def test_registry_cli(port_artifact, tmp_path, capsys):  # noqa: F811
    """``registry publish/list/resolve/pull`` through the port's CLI, in
    process, and ``publish`` once as ``python -m``."""
    from bdbnn_tpu_torch import cli

    root = str(tmp_path / "reg")
    r = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", "registry", "publish",
                        port_artifact, "-r", root], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout)["version"] == 1
    assert cli.main(["registry", "publish", port_artifact, "-r", root]) == 0
    assert json.loads(capsys.readouterr().out)["version"] == 2
    assert cli.main(["registry", "list", "-r", root]) == 0
    assert [e["version"] for e in json.loads(capsys.readouterr().out)] == [1, 2]
    assert cli.main(["registry", "resolve", "v0002", "-r", root]) == 0
    assert capsys.readouterr().out.strip() == jreg.ArtifactRegistry(root).resolve(2)
    mirror = str(tmp_path / "mirror")
    assert cli.main(["registry", "pull", "1", "-r", mirror, "--from", root]) == 0
    assert [e["version"] for e in json.loads(capsys.readouterr().out)] == [1]
    for bad in (["registry", "resolve", "-r", root], ["registry", "resolve", "vv1", "-r", root],
                ["registry", "pull", "-r", mirror], ["registry", "publish", "-r", root]):
        with pytest.raises(SystemExit) as e:
            cli.main(bad)
        assert e.value.code == 2
