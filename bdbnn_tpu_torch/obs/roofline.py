"""Per-layer roofline and the ``perf`` command — the port's copy of
``bdbnn_tpu/obs/roofline.py``, with H100 ceilings.

1. **Static cost model** (:func:`model_layer_table`,
   :func:`layer_regimes`) — per-layer FLOPs and device-memory bytes for any
   registry arch, the reference's rows (names, scopes, shapes, FLOPs,
   bytes) from a model built on the ``meta`` device: forward hooks record
   each conv's input and output shapes while each binary conv's forward is
   swapped for a shape-only one, so no weight exists, no kernel launches
   and no plain version runs. Bytes are priced under three regimes —
   ``dense`` (f32 weights + activations), ``packed_weight`` (1-bit weights
   + alpha, the engine's packed residency) and ``packed_act`` (1-bit
   weights and 1-bit binary-conv inputs) — with the byte hooks
   ``engine.residency()`` reports (nn/packed.py). Each (layer, regime)
   gets an arithmetic intensity, a memory/compute bound class against the
   card's ceilings and a roof ms.

2. **Measured side** (:func:`run_perf`) — sweeps ``InferenceEngine``
   buckets × packed impls (dense K2 → K1, unpack K3 → K2 → K1, popcount
   K3 → K2 → K4), captures a profiler window per (impl, bucket) with
   ``engine.trace_step``, joins per-layer device ms back to the model
   through the layers' trace spans (:func:`~bdbnn_tpu_torch.obs.trace.
   attribute_trace_layers`), and reports per-layer efficiency
   (roof/achieved) and the reconciliation of the trace's device-op sum
   against the host wall it was captured under. A window that writes no
   trace fails the command; one whose trace lost device records (a fresh
   profiler session can drop some) is taken again, and the cell says how
   many windows it took (``windows``) and what the kept one lost
   (``lost_records``).

3. **Perf ledger** — the strict-JSON ``perf_verdict`` (schema 1, the
   reference's keys; ``perf_layers`` keyed ``name|bB|impl``, so both
   packages' ``compare`` judge it) in a stamped run dir with a manifest and
   ``perf`` events, plus one line appended to
   ``<log_path>/PERF_LEDGER.jsonl``.

Module-level imports are stdlib only; torch loads inside the functions
that need it. ``perf`` runs on the card unless the config asks for the
CPU, and raises without one.
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

PERF_SCHEMA_VERSION = 1
PERF_VERDICT_NAME = "perf_verdict.json"
PERF_LEDGER_NAME = "PERF_LEDGER.jsonl"
BENCH_ARTIFACT_NAME = "BENCH_perf.json"

_DATASHEET = "NVIDIA H100 Tensor Core GPU datasheet (dense bf16, HBM bandwidth)"

# device_kind (torch.cuda.get_device_name) -> roofline ceilings. The cpu
# row is the reference's conservative host-class stand-in, so CPU runs
# classify the same way; real CPU studies pass --ceilings.
CEILINGS: Dict[str, Dict[str, Any]] = {
    "NVIDIA H100 80GB HBM3": {"peak_flops": 989.4e12, "hbm_gbs": 3350.0, "source": _DATASHEET},
    "NVIDIA H100 PCIe": {"peak_flops": 756e12, "hbm_gbs": 2000.0, "source": _DATASHEET},
    "cpu": {
        "peak_flops": 2.0e11,
        "hbm_gbs": 50.0,
        "source": "conservative host-class default; override --ceilings",
    },
}

# packed_impl -> the byte regime whose roof it is judged against:
# popcount's 1-bit operands on both sides are the packed-activation
# regime's roof
IMPL_REGIME: Dict[str, str] = {
    "dense": "dense",
    "unpack": "packed_weight",
    "popcount": "packed_act",
}

# profiler windows taken at most for one (impl, bucket): a window whose
# trace lost device records (obs/trace.py ``lost_device_records``) is
# taken again
WINDOW_ATTEMPTS = 3


# ---------------------------------------------------------------------------
# ceilings + pure roofline math
# ---------------------------------------------------------------------------


def resolve_ceilings(device_kind: str, override: Any = None) -> Dict[str, Any]:
    """The ceilings row for ``device_kind``: exact key, else substring
    match, else the ``cpu`` fallback. ``override`` (a dict, or a path to a
    JSON file) either IS a ceilings row (has ``peak_flops``/``hbm_gbs``)
    or is a table merged over the built-in one before lookup."""
    table = dict(CEILINGS)
    if isinstance(override, str) and override:
        with open(override) as f:
            override = json.load(f)
    if isinstance(override, dict):
        if "peak_flops" in override or "hbm_gbs" in override:
            row = {**table["cpu"], "source": "--ceilings", **override}
            return _ceilings_row(device_kind, device_kind, row)
        table.update(override)
    kind = str(device_kind or "")
    if kind in table:
        return _ceilings_row(kind, kind, table[kind])
    low = kind.lower()
    for k in sorted(table):
        kl = k.lower()
        if kl != "cpu" and (kl in low or low in kl):
            return _ceilings_row(kind, k, table[k])
    return _ceilings_row(kind, "cpu", table["cpu"])


def _ceilings_row(device_kind: str, matched: str, row: Dict[str, Any]) -> Dict[str, Any]:
    peak = float(row["peak_flops"])
    bw = float(row["hbm_gbs"])
    return {
        "device_kind": device_kind,
        "matched": matched,
        "peak_flops": peak,
        "hbm_gbs": bw,
        "ridge_intensity": round(peak / (bw * 1e9), 3),
        "source": row.get("source", "unknown"),
    }


def arithmetic_intensity(flops: float, nbytes: float) -> float:
    """FLOPs per device-memory byte — the roofline x-axis."""
    return float(flops) / max(float(nbytes), 1.0)


def ridge_intensity(ceilings: Dict[str, Any]) -> float:
    """The intensity where the memory roof meets the compute roof."""
    return float(ceilings["peak_flops"]) / (float(ceilings["hbm_gbs"]) * 1e9)


def classify_bound(intensity: float, ceilings: Dict[str, Any]) -> str:
    """``"compute"`` at or above the ridge, else ``"memory"``."""
    return "compute" if float(intensity) >= ridge_intensity(ceilings) else "memory"


def roof_ms(flops: float, nbytes: float, ceilings: Dict[str, Any]) -> float:
    """Best-case ms for ``flops`` of work moving ``nbytes``:
    ``max(compute time, memory time)``."""
    t_compute = float(flops) / float(ceilings["peak_flops"])
    t_memory = float(nbytes) / (float(ceilings["hbm_gbs"]) * 1e9)
    return max(t_compute, t_memory) * 1e3


# ---------------------------------------------------------------------------
# static per-layer cost model
# ---------------------------------------------------------------------------


def _conv_shape_only(mod, x, tk=None, draws=None):
    """A binary conv's output of ``x`` on the meta device, by shape alone:
    its forward would run K2 (f64 alpha) and the plain versions."""
    from bdbnn_tpu_torch.nn.kernels.binary_conv import _symmetric_pad

    del tk, draws
    kh, kw = mod.kernel_size
    pad = _symmetric_pad(mod.padding, kh, kw)
    sh, sw = mod.strides
    n, h, w, _ = x.shape
    return x.new_empty((n, (h + 2 * pad - kh) // sh + 1, (w + 2 * pad - kw) // sw + 1,
                        mod.features))


def model_layer_table(
    arch: str,
    dataset: str,
    batch: int,
    *,
    image_size: Optional[int] = None,
    dtype: str = "float32",
    twoblock: bool = False,
) -> List[Dict[str, Any]]:
    """One row per conv/dense of ``arch`` at batch ``batch``, in call
    order (the classifier last): shapes, FLOPs, and bytes under every
    packing regime — the reference's rows. The model is built on the
    ``meta`` device and run with shape-only binary convs, so no weight
    exists and nothing launches. A binary conv is ``kind: binary``, a
    float conv ``float``, the classifier ``dense``; weights are priced in
    the reference's HWIO shape."""
    import torch

    from bdbnn_tpu_torch.models.registry import create_model
    from bdbnn_tpu_torch.nn.layers import FloatConv, _BinaryConvBase
    from bdbnn_tpu_torch.nn.packed import (
        dense_weight_bytes,
        packed_activation_bytes,
        packed_weight_bytes,
        popcount_word_bytes,
    )

    with torch.device("meta"):
        model = create_model(arch, dataset, dtype=dtype, twoblock=bool(twoblock))
    model.eval()
    size = int(image_size) if image_size else (224 if dataset == "imagenet" else 32)
    n = int(batch)
    act_bpe = 2 if str(dtype) == "bfloat16" else 4
    rows: List[Dict[str, Any]] = []

    def numel(shape) -> int:
        out = 1
        for d in shape:
            out *= int(d)
        return out

    def record(name, mod, in_shape, out_shape):
        binary = isinstance(mod, _BinaryConvBase)
        if binary:
            kh, kw, ci, co = mod.weight_shape
        else:
            co, ci, kh, kw = mod.weight.shape  # OIHW
        hwio = (int(kh), int(kw), int(ci), int(co))
        n_in, n_out = numel(in_shape), numel(out_shape)
        rows.append({
            "name": name,
            "scope": name.replace(".", "/"),
            "kind": "binary" if binary else "float",
            "batch": n,
            "in_shape": [int(d) for d in in_shape],
            "out_shape": [int(d) for d in out_shape],
            "kernel": [hwio[0], hwio[1]],
            "strides": [int(s) for s in mod.strides],
            # 2 * output elements * kernel volume (MAC = 2 FLOPs)
            "flops": 2 * n_out * hwio[0] * hwio[1] * hwio[2],
            "weight_dense_bytes": dense_weight_bytes(hwio),
            "weight_packed_bytes": packed_weight_bytes(hwio) if binary else dense_weight_bytes(hwio),
            "act_in_bytes": n_in * act_bpe,
            "act_out_bytes": n_out * act_bpe,
            "act_in_packed_bytes": packed_activation_bytes(n_in) if binary else n_in * act_bpe,
            "popcount_word_bytes": (
                (n_out // hwio[3]) * popcount_word_bytes(hwio[0], hwio[1], hwio[2])
                if binary else None
            ),
        })

    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, _BinaryConvBase):
            mod.forward = functools.partial(_conv_shape_only, mod)
        if isinstance(mod, (FloatConv, _BinaryConvBase)):
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, name=name: record(name, m, args[0].shape, out.shape)))
    try:
        with torch.no_grad():
            model(torch.empty((n, size, size, 3), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    # the classifier: a module call in f32 only (bf16 takes its weight),
    # so its row comes from its widths
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Linear):
            kshape = (mod.in_features, mod.out_features)
            rows.append({
                "name": name,
                "scope": name.replace(".", "/"),
                "kind": "dense",
                "batch": n,
                "in_shape": [n, mod.in_features],
                "out_shape": [n, mod.out_features],
                "kernel": None,
                "strides": None,
                "flops": 2 * n * mod.out_features * kshape[0],
                "weight_dense_bytes": dense_weight_bytes(kshape),
                "weight_packed_bytes": dense_weight_bytes(kshape),
                "act_in_bytes": n * mod.in_features * act_bpe,
                "act_out_bytes": n * mod.out_features * act_bpe,
                "act_in_packed_bytes": n * mod.in_features * act_bpe,
                "popcount_word_bytes": None,
            })
    return rows


def layer_regimes(row: Dict[str, Any], ceilings: Dict[str, Any]) -> Dict[str, Any]:
    """The three byte regimes of one layer row: total bytes, intensity,
    bound class, roof ms. Non-binary layers price all three regimes
    identically (packing does not apply)."""
    flops = float(row["flops"])
    wd = int(row["weight_dense_bytes"])
    wp = int(row["weight_packed_bytes"])
    ai = int(row["act_in_bytes"])
    ao = int(row["act_out_bytes"])
    aip = int(row["act_in_packed_bytes"])
    out: Dict[str, Any] = {}
    for name, nbytes in (
        ("dense", wd + ai + ao),
        ("packed_weight", wp + ai + ao),
        ("packed_act", wp + aip + ao),
    ):
        inten = arithmetic_intensity(flops, nbytes)
        out[name] = {
            "bytes": int(nbytes),
            "intensity": round(inten, 3),
            "bound": classify_bound(inten, ceilings),
            "roof_ms": round(roof_ms(flops, nbytes, ceilings), 6),
        }
    return out


def static_table(rows: List[Dict[str, Any]], ceilings: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Layer rows + their :func:`layer_regimes` — the static half of the
    verdict, one list per bucket."""
    return [{**r, "regimes": layer_regimes(r, ceilings)} for r in rows]


# ---------------------------------------------------------------------------
# measured sweep + verdict
# ---------------------------------------------------------------------------


def _write_json_atomic(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _measure_bucket(engine, tdir: str, b: int, iters: int, rows, stat_rows, regime: str,
                    tol_reconcile: float):
    """One (impl, bucket) cell: the engine's traced forwards, the
    per-layer join and the reconciliation. A window whose trace lost device
    records is taken again, up to WINDOW_ATTEMPTS windows; the cell records
    how many were taken and what the kept one lost. Raises when a window
    wrote no trace."""
    from bdbnn_tpu_torch.obs.trace import (
        attribute_trace_layers,
        find_trace_file,
        lost_device_records,
    )

    for windows in range(1, WINDOW_ATTEMPTS + 1):
        t = engine.trace_step(tdir, bucket=b, iters=iters)
        trace_file = find_trace_file(tdir)  # the newest: this window's
        if trace_file is None:
            raise RuntimeError(
                f"perf: the profiler window of bucket {b} wrote no trace under {tdir}")
        lost = lost_device_records(trace_file)
        if not lost:
            break
    att = attribute_trace_layers(trace_file, t["iters"],
                                 layers={r["name"]: r["scope"] for r in rows})
    stat_by_name = {r["name"]: r for r in stat_rows}
    layers_out: Dict[str, Any] = {}
    for name, ms in att["layers"].items():
        reg = stat_by_name[name]["regimes"][regime]
        eff = reg["roof_ms"] / ms if ms > 0 else None
        layers_out[name] = {
            "ms": ms,
            "roof_ms": reg["roof_ms"],
            "efficiency": round(eff, 4) if eff is not None else None,
            "bound": reg["bound"],
            "intensity": reg["intensity"],
        }
    wall = t["wall_ms"]
    recon = None
    if wall:
        attributed = round(sum(att["layers"].values()), 4)
        total = att["total_ms"]
        err = abs(total - wall) / wall
        recon = {
            "wall_ms": wall,
            "attributed_ms": attributed,
            "device_total_ms": total,
            "unattributed_ms": att["unattributed"],
            "abs_err_pct": round(err * 100.0, 2),
            "ok": err <= float(tol_reconcile),
        }
    return {"wall_ms": wall, "traced": True, "windows": windows, "lost_records": lost,
            "layers": layers_out, "reconciliation": recon}


def run_perf(cfg) -> Dict[str, Any]:
    """The ``perf`` command: static roofline + measured bucket/impl sweep
    + persisted ledger (``cfg`` a :class:`~bdbnn_tpu_torch.serve.config.
    PerfConfig`). Returns ``{"verdict", "run_dir"}``."""
    import torch

    from bdbnn_tpu_torch import resolve_device
    from bdbnn_tpu_torch.obs.events import EventWriter, jsonsafe
    from bdbnn_tpu_torch.obs.manifest import write_manifest
    from bdbnn_tpu_torch.serve.export import read_artifact

    device = resolve_device(cfg.device)
    artifact = read_artifact(cfg.artifact)
    arch = artifact["arch"]
    dataset = artifact["dataset"]
    model_dtype = artifact.get("model", {}).get("dtype", "float32")
    twoblock = bool(artifact.get("model", {}).get("twoblock", False))
    buckets = tuple(sorted({int(b) for b in cfg.buckets}))

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = os.path.join(cfg.log_path, stamp)
    os.makedirs(run_dir, exist_ok=True)
    manifest = write_manifest(run_dir, cfg, extra={"mode": "perf"}, device=device)
    kind = manifest["device_kind"]
    writer = EventWriter(run_dir, max_bytes=int(cfg.events_max_mb * 2**20))
    try:
        ceilings = resolve_ceilings(kind, cfg.ceilings or None)
        writer.emit("perf", phase="start", run_dir=run_dir, artifact=cfg.artifact, arch=arch,
                    dataset=dataset, device_kind=kind, buckets=list(buckets),
                    impls=list(cfg.impls), iters=int(cfg.iters))

        # static side: the cost model per bucket (batch size changes
        # activation bytes, hence intensity and bound class)
        layer_rows: Dict[int, List[Dict[str, Any]]] = {}
        static: Dict[str, Any] = {}
        for b in buckets:
            rows = model_layer_table(arch, dataset, b, image_size=int(artifact["image_size"]),
                                     dtype=model_dtype, twoblock=twoblock)
            layer_rows[b] = rows
            static[str(b)] = static_table(rows, ceilings)

        measured: Dict[str, Any] = {}
        skipped: List[Dict[str, Any]] = []
        perf_layers: Dict[str, float] = {}
        if not cfg.static_only:
            from bdbnn_tpu_torch.serve.engine import InferenceEngine

            for impl in cfg.impls:
                if impl == "popcount" and model_dtype == "bfloat16":
                    skipped.append({
                        "impl": impl,
                        "reason": "popcount needs a float32 artifact; this one records "
                                  "dtype=bfloat16",
                    })
                    continue
                engine = InferenceEngine(
                    cfg.artifact, buckets=buckets, device=device, packed=impl != "dense",
                    packed_impl=impl if impl != "dense" else "unpack",
                )
                regime = IMPL_REGIME.get(impl, "packed_weight")
                per_bucket: Dict[str, Any] = {}
                for b in buckets:
                    cell = _measure_bucket(
                        engine, os.path.join(run_dir, "traces", f"{impl}_b{b}"), b,
                        int(cfg.iters), layer_rows[b], static[str(b)], regime, cfg.tol_reconcile)
                    for name, lay in cell["layers"].items():
                        perf_layers[f"{name}|b{b}|{impl}"] = lay["ms"]
                    per_bucket[str(b)] = cell
                    recon = cell["reconciliation"] or {}
                    writer.emit("perf", phase="bucket", impl=impl, bucket=b,
                                wall_ms=cell["wall_ms"], attributed_ms=recon.get("attributed_ms"),
                                reconciled=recon.get("ok"))
                measured[impl] = per_bucket
                del engine
                if device.type == "cuda":
                    torch.cuda.empty_cache()

        summary = _summarize_measured(measured, buckets, static, ceilings)
        verdict = jsonsafe({
            "perf_verdict": PERF_SCHEMA_VERSION,
            "artifact": cfg.artifact,
            "arch": arch,
            "dataset": dataset,
            "dtype": model_dtype,
            "device_kind": kind,
            "backend": device.type,
            "buckets": list(buckets),
            "impls": list(cfg.impls),
            "iters": int(cfg.iters),
            "ceilings": ceilings,
            "static": static,
            "measured": measured,
            "skipped": skipped,
            "perf_layers": perf_layers,
            "summary": summary,
            "provenance": {
                "config_hash": manifest.get("config_hash"),
                "device_kind": manifest.get("device_kind"),
                "recipe": {"arch": arch, "dataset": dataset, "dtype": model_dtype,
                           "twoblock": twoblock},
            },
        })
        _write_json_atomic(os.path.join(run_dir, PERF_VERDICT_NAME), verdict)
        if getattr(cfg, "out", ""):
            _write_json_atomic(cfg.out, verdict)
        _write_json_atomic(os.path.join(run_dir, BENCH_ARTIFACT_NAME), _bench_artifact(verdict))
        ledger_line = jsonsafe({
            "t": round(time.time(), 3),
            "schema": PERF_SCHEMA_VERSION,
            "run_dir": run_dir,
            "config_hash": manifest.get("config_hash"),
            "device_kind": kind,
            "arch": arch,
            "dataset": dataset,
            "dtype": model_dtype,
            "summary": summary,
            "perf_layers": perf_layers,
            "skipped": [s["impl"] for s in skipped],
        })
        with open(os.path.join(cfg.log_path, PERF_LEDGER_NAME), "a") as f:
            f.write(json.dumps(ledger_line, sort_keys=True) + "\n")
        writer.emit("perf", phase="verdict", run_dir=run_dir, verdict=verdict)
    finally:
        writer.close()
    return {"verdict": verdict, "run_dir": run_dir}


def _summarize_measured(
    measured: Dict[str, Any],
    buckets: Tuple[int, ...],
    static: Dict[str, Any],
    ceilings: Dict[str, Any],
) -> Dict[str, Any]:
    """Flat aggregates ``compare`` judges (the per-layer keys are judged
    separately): best/dense/packed step ms at the LARGEST bucket, mean
    per-layer efficiency, mean attributed share, and an MFU estimate at the
    best step."""
    big = str(buckets[-1]) if buckets else None
    walls = {impl: (pb.get(big) or {}).get("wall_ms") for impl, pb in measured.items()}
    vals = [v for v in walls.values() if v is not None]
    packed_vals = [v for k, v in walls.items() if k != "dense" and v is not None]
    effs = [
        lay["efficiency"]
        for pb in measured.values()
        for bkt in pb.values()
        for lay in bkt["layers"].values()
        if lay["efficiency"] is not None
    ]
    shares = []
    for pb in measured.values():
        for bkt in pb.values():
            recon = bkt.get("reconciliation")
            if recon and recon.get("device_total_ms"):
                shares.append(recon["attributed_ms"] / recon["device_total_ms"])
    step_best = min(vals) if vals else None
    mfu = None
    if step_best and big:
        flops = sum(float(r["flops"]) for r in static.get(big, []))
        if flops:
            mfu = round(flops / (step_best / 1e3) / float(ceilings["peak_flops"]), 4)
    return {
        "bucket": int(big) if big else None,
        "step_ms_best": step_best,
        "step_ms_dense": walls.get("dense"),
        "step_ms_packed": min(packed_vals) if packed_vals else None,
        "efficiency_mean": round(sum(effs) / len(effs), 4) if effs else None,
        "attributed_share": round(sum(shares) / len(shares), 4) if shares else None,
        "mfu_best": mfu,
    }


def _bench_artifact(verdict: Dict[str, Any]) -> Dict[str, Any]:
    """``BENCH_*``-compatible top-level summary: the ``parsed`` line
    compare's bench-artifact path reads (value = img/s at the summary
    bucket, device_ms_per_step = best step ms)."""
    s = verdict.get("summary") or {}
    step = s.get("step_ms_best")
    bucket = s.get("bucket")
    value = round(float(bucket) * 1000.0 / float(step), 2) if step and bucket else None
    return {
        "bench": "perf",
        "schema": PERF_SCHEMA_VERSION,
        "parsed": {
            "metric": "img_per_s",
            "value": value,
            "device_ms_per_step": step,
            "device_mfu": s.get("mfu_best"),
            "device_kind": verdict.get("device_kind"),
            "dtype": verdict.get("dtype"),
        },
        "provenance": (verdict.get("provenance") or {}),
    }


# ---------------------------------------------------------------------------
# rendering (CLI + summarize share it)
# ---------------------------------------------------------------------------


def render_perf(verdict: Dict[str, Any]) -> str:
    """Human tables for one perf verdict: ceilings line, per-bucket
    bound-class table (static), and per-(impl, bucket) layer efficiency
    with reconciliation."""
    c = verdict.get("ceilings") or {}
    lines = [
        f"== Perf roofline: {verdict.get('arch')}/{verdict.get('dataset')} on "
        f"{verdict.get('device_kind')} ({verdict.get('dtype')})"
    ]
    if c:
        lines.append(
            f"ceilings[{c.get('matched')}]: {c.get('peak_flops', 0) / 1e12:.4g} TFLOP/s, "
            f"{c.get('hbm_gbs', 0):.4g} GB/s (ridge {c.get('ridge_intensity')} FLOP/byte)"
        )
    for b, rows in sorted((verdict.get("static") or {}).items(), key=lambda kv: int(kv[0])):
        counts: Dict[str, Any] = {}
        for r in rows:
            for reg, info in r["regimes"].items():
                counts.setdefault(reg, {"memory": 0, "compute": 0})
                counts[reg][info["bound"]] += 1
        parts = ", ".join(f"{reg}: {v['memory']}M/{v['compute']}C"
                          for reg, v in sorted(counts.items()))
        lines.append(f"bucket {b} bound classes ({parts})")
    for impl, pb in sorted((verdict.get("measured") or {}).items()):
        for b, bkt in sorted(pb.items(), key=lambda kv: int(kv[0])):
            recon = bkt.get("reconciliation") or {}
            ok = recon.get("ok")
            lines.append(
                f"-- {impl} b{b}: wall {bkt.get('wall_ms')} ms, attributed "
                f"{recon.get('attributed_ms')} ms, reconcile "
                f"{'ok' if ok else 'MISS' if ok is not None else 'n/a'}"
                f" (err {recon.get('abs_err_pct')}%)"
            )
            layers = bkt.get("layers") or {}
            if layers:
                lines.append(f"   {'layer':<24} {'ms':>8} {'roof':>9} {'eff':>6}  bound")
                for name, lay in sorted(layers.items(), key=lambda kv: -kv[1]["ms"]):
                    eff = lay.get("efficiency")
                    lines.append(
                        f"   {name:<24} {lay['ms']:>8.3f} {lay['roof_ms']:>9.4f} "
                        f"{eff if eff is not None else '-':>6}  {lay['bound']}"
                    )
    s = verdict.get("summary") or {}
    if s:
        lines.append(
            f"summary: best {s.get('step_ms_best')} ms @ bucket {s.get('bucket')} (dense "
            f"{s.get('step_ms_dense')}, packed {s.get('step_ms_packed')}), efficiency mean "
            f"{s.get('efficiency_mean')}, attributed share {s.get('attributed_share')}"
        )
    for skip in verdict.get("skipped") or []:
        lines.append(f"skipped {skip.get('impl')}: {skip.get('reason')}")
    return "\n".join(lines)


__all__ = [
    "BENCH_ARTIFACT_NAME",
    "CEILINGS",
    "IMPL_REGIME",
    "PERF_LEDGER_NAME",
    "PERF_SCHEMA_VERSION",
    "PERF_VERDICT_NAME",
    "arithmetic_intensity",
    "classify_bound",
    "layer_regimes",
    "model_layer_table",
    "render_perf",
    "resolve_ceilings",
    "ridge_intensity",
    "roof_ms",
    "run_perf",
    "static_table",
]
