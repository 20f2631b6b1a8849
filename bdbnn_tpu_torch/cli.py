"""Command line of the port: ``python -m bdbnn_tpu_torch.cli``.

The default command trains, with the reference's flag surface
(``bdbnn_tpu/cli.py`` ``build_parser``, the same names and defaults)
plus ``--device``:

    python -m bdbnn_tpu_torch.cli --dataset imagenet -a resnet18 --synthetic \
        -b 256 --epochs 1 --w-kurtosis --diffkurt

runs :func:`bdbnn_tpu_torch.train.loop.fit` and prints its result dict
as JSON on the last line. Options the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item; the GPU/NCCL-era flags
(``--world-size`` and the like) raise too (DDP).

A run writes its run dir under ``--log_path`` (checkpoints, events,
manifest); SIGTERM makes it checkpoint and exit with code 75, and
``--resume <run dir>`` continues it. ``export RUN_DIR -o ARTIFACT``
freezes a run's checkpoint into a serving artifact.

``predict ARTIFACT [DATA]`` runs an export artifact over a val split
through the bucketed engine and reports top-1 against the artifact's
recorded checkpoint accuracy (``--check`` exits 3 when they differ, 2
when the artifact records none) — the counterpart of
``python -m bdbnn_tpu.cli predict``. The val split is built as the
reference's training loop builds it: synthetic images from seed 2 (with
ImageNet normalization for ``imagenet``), or the CIFAR test split from
DATA.

Training and ``predict`` run on the CUDA card unless ``--device cpu`` is
given, and raise without a card; ``export`` is host work.
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
        "ImageNet from an image folder is not ported yet (ROADMAP A 'Later' "
        "item 8); use --synthetic"
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


def build_parser() -> argparse.ArgumentParser:
    """The reference's training flags (same names and defaults) and
    ``--device``."""
    p = argparse.ArgumentParser(
        prog="bdbnn_tpu_torch.cli", description="BD-BNN training on the PyTorch port"
    )
    p.add_argument("data", nargs="?", default="", help="dataset directory")
    p.add_argument("-a", "--arch", default="resnet18")
    p.add_argument("-j", "--workers", type=int, default=None)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("-lr", "--learning-rate", type=float, default=0.1, dest="lr")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("-wd", "--weight-decay", type=float, default=1e-4)
    p.add_argument("-p", "--print-freq", type=int, default=10)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--pretrained", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log_path", default="log", type=str)
    p.add_argument("--custom_resnet", action="store_true", default=True)
    p.add_argument("--reset_resume", action="store_true")
    p.add_argument("--ede", action="store_true")
    p.add_argument("--binarizer", default="", metavar="FAMILY[:PARAM=V,...]")
    p.add_argument("--w-kurtosis-target", type=float, default=1.8)
    p.add_argument("--w-lambda-kurtosis", type=float, default=1.0)
    p.add_argument("--w-kurtosis", action="store_true")
    p.add_argument("--weight-name", nargs="+", default=["all"])
    p.add_argument("--remove-weight-name", nargs="+", default=[])
    p.add_argument("--kurtosis-mode", default="avg", choices=["max", "sum", "avg"])
    p.add_argument("--diffkurt", action="store_true")
    p.add_argument("--kurtepoch", type=int, default=0)
    p.add_argument("--twoblock", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--dataset", default="cifar10", choices=["cifar10", "cifar100", "imagenet"])
    p.add_argument("--w-l2-reg", action="store_true")
    p.add_argument("--w-lambda-l2", type=float, default=0.0)
    p.add_argument("--w-wr-reg", action="store_true")
    p.add_argument("--w-lambda-wr", type=float, default=0.0)
    p.add_argument("--w-lambda-ce", type=float, default=1.0)
    p.add_argument("--imagenet_setting", action="store_true")
    p.add_argument("--imagenet_setting_step_1", action="store_true")
    p.add_argument("--imagenet_setting_step_2", action="store_true")
    p.add_argument("--imagenet_setting_step_2_ts", action="store_true")
    p.add_argument("-a_teacher", "--arch_teacher", default="resnet18_float")
    p.add_argument("--custom_resnet_teacher", action="store_true")
    p.add_argument("--resume_teacher", default="", type=str)
    p.add_argument("--kd", action="store_true")
    p.add_argument("--react", action="store_true")
    p.add_argument("--alpha", type=float, default=0.9)
    p.add_argument("--temperature", type=float, default=4)
    p.add_argument("--beta", type=float, default=200)
    p.add_argument("--qk_dim", type=int, default=128)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--distributed-init", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-train-size", type=int, default=2048)
    p.add_argument("--synthetic-val-size", type=int, default=512)
    p.add_argument("--save-every-steps", type=int, default=0)
    p.add_argument("--save-every-mins", type=float, default=0.0)
    p.add_argument("--pretrained-path", default="", type=str)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--target-acc", type=float, default=0.0)
    p.add_argument("--device-normalize", action="store_true")
    p.add_argument("--input-backend", default="auto", choices=["auto", "tfdata", "mp", "threads"])
    p.add_argument("--opt-policy", default="", choices=["", "sgd-cosine", "adam-linear"])
    p.add_argument("--profile-dir", default="", type=str)
    p.add_argument("--profile-at", action="append", default=[], metavar="EPOCH:STEP[:NSTEPS]")
    p.add_argument("--no-binarization-probes", dest="probe_binarization", action="store_false")
    p.add_argument("--nonfinite-policy", default="raise", choices=["raise", "warn", "ignore"])
    p.add_argument("--no-health", dest="health", action="store_false")
    p.add_argument("--no-health-forensics", dest="health_forensics", action="store_false")
    p.add_argument("--health-forensics-steps", type=int, default=4)
    p.add_argument("--health-max-forensics", type=int, default=2)
    p.add_argument("--health-threshold", action="append", default=[], metavar="NAME=VALUE",
                   dest="health_thresholds")
    p.add_argument("--events-max-mb", type=float, default=256.0)
    for flag, kw in [
        ("--world-size", dict(type=int, default=1)),
        ("--rank", dict(type=int, default=0)),
        ("--dist-url", dict(type=str, default="")),
        ("--master-addr", dict(type=str, default="")),
        ("--dist-backend", dict(type=str, default="")),
        ("--gpu", dict(type=int, default=None)),
        ("--multiprocessing-distributed", dict(action="store_true")),
    ]:
        p.add_argument(flag, **kw)
    p.add_argument(
        "--device", default="",
        help="torch device (default: the CUDA card; there is no fallback to the CPU)",
    )
    return p


# flags the reference parses but keeps out of its RunConfig and the port
# does not run yet (--kd, --imagenet_setting, --imagenet_setting_step_1/2
# and --qk_dim are parsed and ignored, as in the reference)
_PARSED_ONLY = [
    ("world_size", 1, "item 6: DDP"),
    ("rank", 0, "item 6: DDP"),
    ("dist_url", "", "item 6: DDP"),
    ("master_addr", "", "item 6: DDP"),
    ("dist_backend", "", "item 6: DDP"),
    ("gpu", None, "item 6: DDP (pick a card with --device cuda:N)"),
    ("multiprocessing_distributed", False, "item 6: DDP"),
]


def args_to_config(args: argparse.Namespace):
    from bdbnn_tpu_torch.train.config import RunConfig

    for name, default, item in _PARSED_ONLY:
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name} is not ported yet: ROADMAP A 'Later' {item}"
            )
    fields = {f for f in RunConfig.__dataclass_fields__}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    for k in ("weight_name", "remove_weight_name", "profile_at", "health_thresholds"):
        kw[k] = tuple(kw[k])
    return RunConfig(**kw)


def train_main(argv) -> int:
    args = build_parser().parse_args(argv)
    cfg = args_to_config(args)
    from bdbnn_tpu_torch.train.loop import fit
    from bdbnn_tpu_torch.train.resilience import PREEMPT_EXIT_CODE, PreemptedError

    try:
        result = fit(cfg)
    except PreemptedError as e:
        # the checkpoint already landed (fit saves before raising): exit
        # EX_TEMPFAIL so a supervisor restarts the run with --resume
        print(
            f"[bdbnn_tpu_torch] preempted by signal {e.signum} at epoch {e.epoch} step "
            f"{e.step_in_epoch}; checkpoint saved — restart with --resume <run_dir> to "
            "continue.",
            file=sys.stderr,
        )
        return PREEMPT_EXIT_CODE
    print(json.dumps(result, sort_keys=True), flush=True)
    return 0


def export_main(argv) -> int:
    """``export RUN_DIR -o ARTIFACT``: freeze a run dir's checkpoint
    (``model_best`` preferred) into a serving artifact, and record an
    ``export`` event on the run's timeline."""
    ap = argparse.ArgumentParser(
        prog="bdbnn_tpu_torch.cli export",
        description="Freeze a run dir's checkpoint (model_best preferred) into a serving "
        "artifact.",
    )
    ap.add_argument("source", help="run dir or checkpoint dir")
    ap.add_argument("-o", "--out", required=True, help="artifact dir")
    ap.add_argument("--arch", default=None, help="override the arch recorded in the run")
    ap.add_argument("--dataset", default=None, choices=["cifar10", "cifar100", "imagenet"],
                    help="override the dataset recorded in the run")
    args = ap.parse_args(argv)

    from bdbnn_tpu_torch.serve.export import export_artifact

    artifact = export_artifact(args.source, args.out, arch=args.arch, dataset=args.dataset)
    print(json.dumps({
        "artifact": args.out,
        "arch": artifact["arch"],
        "dataset": artifact["dataset"],
        "binarized_convs": artifact["stats"]["binarized_convs"],
        "compression_ratio": artifact["stats"]["compression_ratio"],
        "checkpoint_acc1": artifact["eval"]["checkpoint_acc1"],
        "integrity": artifact["checkpoint"]["integrity"],
    }, indent=2, sort_keys=True))
    return 0


COMMANDS = {"predict": predict_main, "export": export_main}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in COMMANDS:
        return COMMANDS[argv[0]](argv[1:])
    return train_main(argv)


if __name__ == "__main__":
    sys.exit(main())
