"""Seconds of ``chip_smoke.py``'s kernel build, its SASS read-out, the
flagship profile and its ``[train-bf16]`` phase, for one or more
checkouts, each from a cold kernel build in a fresh process — for
comparing two trees' cost of those phases on one card.

Each TREE (a directory holding ``chip_smoke.py`` and its package) runs
in its own interpreter, in the order given, with its own ``build/kernels``
removed first: list a parent and a change as ``parent change change
parent`` to interleave them. Every run prints one ``PHASE_TIMES`` JSON
line: ``build_s`` (``_build.build_all``), ``sass_s``
(``log_mma_instructions``), ``profile_s`` (``profile_train_step``, which
``[train-bf16]`` takes), ``train_bf16_s`` (``phase_train_bf16``), its
gates and the card's ``nvidia-smi`` name and power limit. Exits 1 when a
run failed.

Run on the card::

    python -m bdbnn_tpu_torch.scripts.smoke_phase_times TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# the body of one run, in a fresh interpreter whose working directory and
# first import path are the tree
CHILD = r"""
import json, os, shutil, subprocess, sys, time
sys.path.insert(0, os.getcwd())
shutil.rmtree(os.path.join("build", "kernels"), ignore_errors=True)
import torch
import chip_smoke as cs
from bdbnn_tpu_torch.nn.kernels import _build

out = {"tree": os.getcwd()}
with cs.shared_bytecode_cache():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _, pk = cs.peaks_for(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.log_mma_instructions()
    out["sass_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32_prof = cs.profile_train_step()
    out["profile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = cs.phase_train_bf16(pk, f32_prof)[-1]
    out["train_bf16_s"] = time.perf_counter() - t0
    out["ok"] = bool(ok)
    out["nvidia_smi"] = smi
print("PHASE_TIMES " + json.dumps(out), flush=True)
sys.exit(0 if ok else 1)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="TREE")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a run may take (default 600)")
    args = ap.parse_args(argv)
    ok = True
    for tree in args.trees:
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=os.path.abspath(tree),
                           capture_output=True, text=True, timeout=args.timeout)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("PHASE_TIMES ")]
        print(lines[-1] if lines else f"PHASE_TIMES {tree}: exit {r.returncode}\n"
              + r.stderr[-2000:], flush=True)
        ok = ok and r.returncode == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
