"""Logging and scalar channels of a run dir — the port's copy of
``bdbnn_tpu/utils/logging_utils.py``: :func:`make_log_dir` (the
reference's ``<log_root>/<kurtosis_target>/<stamp>``), :func:`setup_logger`
(console + ``log.txt``) and :class:`ScalarWriter` (``scalars.jsonl``,
and TensorBoard too where one of its packages imports)."""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Optional


def make_log_dir(log_root: str, kurtosis_target, stamp: Optional[str] = None) -> str:
    """``<log_root>/<kurtosis_target>/<YYYY-mm-dd_HH-MM-SS>``, created.
    The stamp has one-second resolution: two runs started in one second
    under one root share a dir."""
    if stamp is None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(log_root, str(kurtosis_target), stamp)
    os.makedirs(path, exist_ok=True)
    return path


def setup_logger(log_path: str, name: str = "bdbnn_tpu_torch.train",
                 filename: str = "log.txt") -> logging.Logger:
    """Console (stderr) + ``<log_path>/<filename>`` handlers on logger
    ``name``, replacing the handlers an earlier run installed."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_path:
        os.makedirs(log_path, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_path, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """``scalars.jsonl`` (``{tag, value, step}`` a line, always), and a
    TensorBoard writer when ``tensorboardX`` or
    ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_path: str, name: str = "scalars.jsonl", tensorboard: bool = True):
        self.log_path = log_path
        os.makedirs(log_path, exist_ok=True)
        self._jsonl = open(os.path.join(log_path, name), "a")
        self._tb = None
        for mod in (("tensorboardX", "torch.utils.tensorboard") if tensorboard else ()):
            try:
                import importlib

                self._tb = importlib.import_module(mod).SummaryWriter(log_path)
                break
            except Exception:
                continue

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        """Idempotent: fit() closes on every exit path."""
        if not self._jsonl.closed:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None


__all__ = ["ScalarWriter", "make_log_dir", "setup_logger"]
