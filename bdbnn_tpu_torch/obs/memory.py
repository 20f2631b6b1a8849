"""Device memory watermarks — the port's copy of ``bdbnn_tpu/obs/memory.py``.

The caching allocator's counters (``torch.cuda.memory_stats``), read at
cheap moments — after the first train step and at each epoch's end — and
emitted as ``memory`` events into the run's ``events.jsonl``. That makes
"did this config fit, and how close to the card's memory did it sail?" a
question the run dir answers, and feeds the health monitor's
``hbm_creep`` detector (obs/health.py).

The three normalized fields are the reference's:

- ``bytes_in_use``: ``allocated_bytes.all.current``;
- ``peak_bytes_in_use``: ``allocated_bytes.all.peak`` (what
  ``torch.cuda.max_memory_allocated`` reports);
- ``bytes_limit``: the card's total memory.

Reading them is host work on the allocator's own bookkeeping: nothing
here synchronises the device. A CPU device has no allocator counters and
emits the event with ``available: false``, as the reference's CPU backend
does, so the schema is the same everywhere.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

# normalized per-device fields, in emit order
_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_stats(device) -> Optional[Dict[str, int]]:
    """One device's allocator counters, normalized to the three fields
    every consumer needs — or None when the device has none (the CPU)."""
    import torch

    try:
        device = torch.device(device)
        if device.type != "cuda" or not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device).total_memory
    except Exception:
        return None
    if not stats:
        return None
    out: Dict[str, int] = {}
    for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                     ("peak_bytes_in_use", "allocated_bytes.all.peak")):
        v = stats.get(src)
        if v is not None:
            out[key] = int(v)
    out["bytes_limit"] = int(limit)
    return out


def hbm_snapshot(devices: Sequence[Any]) -> List[Dict[str, Any]]:
    """Per-device stat rows for every device that reports them."""
    rows = []
    for d in devices:
        stats = device_memory_stats(d)
        if stats is None:
            continue
        rows.append({"device": str(d), **stats})
    return rows


def emit_memory_event(events, phase: str, devices: Sequence[Any], **fields):
    """Poll ``devices`` and append one ``memory`` event.

    Schema: ``{kind: "memory", phase: "post_compile"|"epoch", available:
    bool, devices: [...], peak_bytes, limit_bytes, ...}``; ``peak_bytes``
    and ``limit_bytes`` are the max over the devices. Never raises past
    telemetry: a failing allocator query must not kill a training run."""
    try:
        rows = hbm_snapshot(devices)
    except Exception:
        rows = []
    peaks = [r["peak_bytes_in_use"] for r in rows if "peak_bytes_in_use" in r]
    limits = [r["bytes_limit"] for r in rows if "bytes_limit" in r]
    return events.emit(
        "memory",
        phase=phase,
        available=bool(rows),
        devices=rows,
        peak_bytes=max(peaks) if peaks else None,
        limit_bytes=max(limits) if limits else None,
        **fields,
    )


def hbm_watermark(memory_events: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Fold a run's ``memory`` events into the summary's memory section:
    the run-wide peak, the device limit, and their ratio."""
    peaks = [e["peak_bytes"] for e in memory_events if e.get("peak_bytes")]
    limits = [e["limit_bytes"] for e in memory_events if e.get("limit_bytes")]
    if not peaks:
        return None
    peak = max(peaks)
    limit = max(limits) if limits else None
    out: Dict[str, Any] = {
        "peak_bytes": peak,
        "peak_gib": round(peak / 2**30, 3),
        "limit_bytes": limit,
    }
    if limit:
        out["limit_gib"] = round(limit / 2**30, 3)
        out["utilization"] = round(peak / limit, 4)
    return out


__all__ = ["device_memory_stats", "emit_memory_event", "hbm_snapshot", "hbm_watermark"]
