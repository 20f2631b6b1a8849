"""Command line of the port: ``python -m bdbnn_tpu_torch.cli predict``.

``predict ARTIFACT [DATA]`` runs an export artifact over a val split
through the bucketed engine and reports top-1 against the artifact's
recorded checkpoint accuracy (``--check`` exits 3 when they differ, 2
when the artifact records none) — the counterpart of
``python -m bdbnn_tpu.cli predict``. The val split is built as the
reference's training loop builds it: synthetic images from seed 2 (with
ImageNet normalization for ``imagenet``), or the CIFAR test split from
DATA. Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_val_pipeline(artifact, *, data: str, synthetic: bool,
                       synthetic_val_size=None, batch_size=None):
    """The val split of the run the artifact came from: its recorded
    config (seed, sizes) with CLI overrides for location and size."""
    from bdbnn_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        Pipeline,
        load_cifar10,
        load_cifar100,
        normalize,
        synthetic_dataset,
    )

    cfg = dict(artifact.get("provenance", {}).get("config") or {})
    dataset = artifact["dataset"]
    batch = int(batch_size or cfg.get("batch_size") or 256)
    seed = int(cfg.get("seed") or 0)
    synthetic = synthetic or bool(cfg.get("synthetic", False)) and not data
    if synthetic:
        size = int(synthetic_val_size or cfg.get("synthetic_val_size") or 512)
        ds = synthetic_dataset(size, int(artifact["image_size"]), int(artifact["num_classes"]), seed=2)
        transform = None
        if dataset == "imagenet":
            transform = lambda im, rng: normalize(im, IMAGENET_MEAN, IMAGENET_STD)
        return Pipeline(ds, batch, transform=transform, seed=seed)
    if dataset in ("cifar10", "cifar100"):
        loader = load_cifar10 if dataset == "cifar10" else load_cifar100
        data = data or cfg.get("data") or ""
        try:
            ds = loader(data, "test")
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"{dataset} data not found under {data!r} ({e}); pass a "
                "valid DATA dir, or --synthetic for a smoke run"
            ) from e
        return Pipeline(ds, batch, seed=seed)
    raise NotImplementedError(
        "ImageNet from an image folder arrives with the training-data "
        "slice of the port; use --synthetic"
    )


def predict_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="bdbnn_tpu_torch.cli predict",
        description="Run an export artifact over a val split and report top-1.",
    )
    ap.add_argument("artifact", help="export artifact dir")
    ap.add_argument("data", nargs="?", default="", help="dataset dir")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-val-size", type=int, default=None)
    ap.add_argument("-b", "--batch-size", type=int, default=None)
    ap.add_argument(
        "--check", action="store_true",
        help="exit 3 unless top-1 matches the recorded checkpoint "
        "accuracy within --check-tol",
    )
    ap.add_argument(
        "--check-tol", type=float, default=0.0, metavar="PP",
        help="--check tolerance in percentage points (default 0 = exact)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; there is no fallback to the CPU)",
    )
    args = ap.parse_args(argv)

    from bdbnn_tpu_torch.serve.engine import InferenceEngine, evaluate_split
    from bdbnn_tpu_torch.serve.export import read_artifact

    artifact = read_artifact(args.artifact)
    pipe = build_val_pipeline(
        artifact, data=args.data, synthetic=args.synthetic,
        synthetic_val_size=args.synthetic_val_size, batch_size=args.batch_size,
    )
    engine = InferenceEngine(args.artifact, buckets=(pipe.batch_size,), device=args.device)
    result = evaluate_split(engine, pipe)
    recorded = artifact.get("eval", {}).get("checkpoint_acc1")
    out = {
        "artifact": args.artifact,
        "arch": artifact["arch"],
        "dataset": artifact["dataset"],
        "device": str(engine.device),
        "top1": result["top1"],
        "correct": result["correct"],
        "count": result["count"],
        "recorded_checkpoint_acc1": recorded,
        "match": (
            None if recorded is None else abs(result["top1"] - recorded) <= args.check_tol
        ),
    }
    print(json.dumps(out, indent=2, sort_keys=True))
    if args.check:
        if recorded is None:
            print(
                "[predict --check] artifact records no per-checkpoint "
                "accuracy; nothing to check",
                file=sys.stderr,
            )
            return 2
        if not out["match"]:
            print(
                f"[predict --check] top-1 {result['top1']} != recorded "
                f"{recorded} (tol {args.check_tol}pp)",
                file=sys.stderr,
            )
            return 3
    return 0


COMMANDS = {"predict": predict_main}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(
            f"usage: python -m bdbnn_tpu_torch.cli {{{','.join(COMMANDS)}}} ...",
            file=sys.stderr,
        )
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
