"""The port's profile script and the pipeline bench's windows, on the CPU
(torch and the port only, beside ``tests/test_torch_scripts.py``):

- ``scripts/profile_step.py`` on ``resnet8_tiny`` writes ``PROFILE.json``
  with ``profile_r05.py``'s keys but ``r04_comparison`` and a copy of its
  trace; its by-name total is its traced steps' mean busy sum to 5% (on
  the CPU every op of the window runs inside a step), and its device rate
  and MFU are ``bench.device_rates`` of its busy median, to the rounding
  of that median to 1e-3 ms;
- ``scripts/bench_pipeline.py`` times each worker-process count over at
  least two batches a worker (``window``) and a thread count over the
  batches asked for.
"""

import io
import json
import os
from contextlib import redirect_stdout

import pytest

from bdbnn_tpu_torch.scripts import bench as tbench
from bdbnn_tpu_torch.scripts import bench_pipeline as tbench_pipeline
from bdbnn_tpu_torch.scripts import profile_step as tprofile_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# profile_r05.py's PROFILE keys; the port counts its FLOPs itself, drops the
# TPU numbers of ``r04_comparison`` and adds the rest
REFERENCE_PROFILE_KEYS = {
    "what", "captured", "device_kind", "bf16_peak_tflops", "trace_file", "gflops_per_image",
    "device_ms_per_step_median", "device_images_per_sec", "device_mfu",
    "host_fenced_median_img_per_sec", "host_fenced_ms_per_step", "host_fenced_mfu",
    "device_time_breakdown_ms_per_step", "device_attribution_ms_per_step",
    "device_attribution_mfu", "device_track_total_ms_per_step",
}


def test_the_profile_script_on_the_cpu(tmp_path, monkeypatch):
    with open(os.path.join(REPO, "profile_r05.py")) as f:
        src = f.read()
    assert all(f'"{k}"' in src for k in REFERENCE_PROFILE_KEYS | {"r04_comparison"})
    monkeypatch.setitem(tbench.BF16_PEAK_TFLOPS, "cpu", 1.0)
    out_dir = tmp_path / "profile"
    with redirect_stdout(io.StringIO()):
        prof = tprofile_step.main(["--batch", "4", "--iters", "1", "--windows", "1",
                                   "--device", "cpu", "--out-dir", str(out_dir)],
                                  arch="resnet8_tiny", dataset="cifar10", image_size=16)
    assert REFERENCE_PROFILE_KEYS <= set(prof) and "r04_comparison" not in prof
    assert json.loads((out_dir / "PROFILE.json").read_text()) == prof
    assert (out_dir / tprofile_step.TRACE_COPY).is_file()
    busy = prof["device_step_busy_ms"]
    assert len(busy) == tbench.PROFILE_TRACE_STEPS
    by_name = sum(prof["device_time_breakdown_ms_per_step"].values())
    assert abs(by_name - sum(busy) / len(busy)) <= 0.05 * sum(busy) / len(busy)
    flops = tbench.train_flops_per_step("resnet8_tiny", "cifar10", 4, 16)
    # from the busy median before its rounding to 1e-3 ms
    rate, mfu = tbench.device_rates(4, prof["device_ms_per_step_median"], flops, 1.0)
    assert prof["device_images_per_sec"] == pytest.approx(rate, rel=1e-4)
    assert prof["device_mfu"] == pytest.approx(mfu, rel=1e-3, abs=1e-4)
    assert prof["launches_in_window"]["K1"] == 0  # the plain versions launch nothing


def test_a_worker_counts_window_spans_two_waves(tmp_path, monkeypatch):
    from bdbnn_tpu_torch.data import ImageFolder

    folder = ImageFolder(tbench_pipeline.make_jpeg_folder(str(tmp_path), n_images=4, hw=32))
    timed = []
    monkeypatch.setattr(tbench_pipeline, "measure",
                        lambda pipe, n: timed.append((type(pipe).__name__, n)) or 1.0)
    with redirect_stdout(io.StringIO()):
        tbench_pipeline.run(folder, 2, 4)
    assert timed == [("ImageFolderPipeline", 4)] * 3 + [
        ("MPImageFolderPipeline", n) for n in (4, 4, 8, 16)]
    assert [tbench_pipeline.window(20, w) for w in tbench_pipeline.PROCESSES] == [20] * 4
