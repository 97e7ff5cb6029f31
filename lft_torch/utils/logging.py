"""Experiment directories and the run log (counterpart of
lft_tpu/utils/logging.py).

`create_dir` builds the reference's `<path_log>/SR_{A}x{A}_{S}x/<model>/
<data>/{checkpoints,logs}` tree; `Logger` writes `<log_dir>/<model_name>.txt`
and mirrors each line to stdout, gated on its own args' `local_rank <= 0`
(reference utils/utils.py:10-51).
"""

from __future__ import annotations

import logging
from pathlib import Path


def get_logger(log_dir, args) -> logging.Logger:
    """One logger per (model, log_dir) with one file handler on
    `<log_dir>/<model_name>.txt`."""
    logger = logging.getLogger(f"{args.model_name}@{log_dir}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        formatter = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        fh = logging.FileHandler("%s/%s.txt" % (log_dir, args.model_name))
        fh.setLevel(logging.INFO)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def create_dir(args):
    """Create and return (experiment_dir, checkpoints_dir, log_dir)
    (reference utils/utils.py:23-41)."""
    experiment_dir = Path(args.path_log)
    experiment_dir.mkdir(exist_ok=True, parents=True)
    task_path = "SR_" + str(args.angRes) + "x" + str(args.angRes) + "_" + \
        str(args.scale_factor) + "x"
    experiment_dir = experiment_dir / task_path / args.model_name / args.data_name
    experiment_dir.mkdir(exist_ok=True, parents=True)
    checkpoints_dir = experiment_dir / "checkpoints"
    checkpoints_dir.mkdir(exist_ok=True)
    log_dir = experiment_dir / "logs"
    log_dir.mkdir(exist_ok=True)
    return experiment_dir, checkpoints_dir, log_dir


class Logger:
    """The run log: file and stdout, on the process with `local_rank <= 0`
    (reference utils/utils.py:44-51)."""

    def __init__(self, log_dir, args):
        self.args = args
        self.logger = get_logger(log_dir, args)

    def log_string(self, s: str):
        if getattr(self.args, "local_rank", 0) <= 0:
            self.logger.info(s)
            print(s)
