"""``bdbnn_tpu_torch.scripts.smoke_phase_times`` on the CPU: its help,
and a tree it cannot run (no ``chip_smoke.py``) reported as a failed run
with exit 1. Its timings need the card."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_help_exits_zero():
    r = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.scripts.smoke_phase_times",
                        "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "TREE" in r.stdout


def test_a_tree_without_the_script_fails(tmp_path, capsys):
    from bdbnn_tpu_torch.scripts import smoke_phase_times

    assert smoke_phase_times.main([str(tmp_path), "--timeout", "120"]) == 1
    out = capsys.readouterr().out
    assert out.startswith(f"PHASE_TIMES {tmp_path}: exit 1")
    assert "chip_smoke" in out
