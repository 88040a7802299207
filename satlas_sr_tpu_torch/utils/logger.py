"""Logging of the port (the JAX package's `utils/logger.py`).

- `get_root_logger`: one logger, named `satlas_sr_tpu_torch`, writing to
  stdout and, once a run names one, to its log file;
- the trainer's surface: `AvgTimer`, `MessageLogger` (a formatted line every
  print_freq with epoch, iter, lrs, iter and data time, ETA and the loss
  dict, plus a metrics.jsonl row and tb scalars), and the wandb and
  TensorBoard sinks, each guarded so that a missing package only logs a
  warning.
In a multi-process run every sink is rank 0's (the reference's master_only):
the trainer gives the other ranks no log file, no wandb or tb writer, and
their MessageLogger writes no metrics.jsonl.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

from ..parallel.mesh import is_main_process


def get_root_logger(log_file: Optional[str] = None, name: str = "satlas_sr_tpu_torch"):
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s", "%Y-%m-%d %H:%M:%S")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
    # the file handler attaches even when the logger already exists, once per path
    if log_file:
        have = {h.baseFilename for h in logger.handlers if isinstance(h, logging.FileHandler)}
        if os.path.abspath(log_file) not in have:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class AvgTimer:
    """Running-average wall-clock timer (reference AvgTimer, train.py:90)."""

    def __init__(self, window: int = 200):
        self._window = window
        self._count = 0
        self._sum = 0.0
        self._avg = 0.0
        self.start()

    def start(self) -> None:
        self._t0 = time.time()

    def record(self) -> None:
        dt = time.time() - self._t0
        self._count += 1
        self._sum += dt
        self._avg = self._sum / self._count
        if self._count > self._window:
            self._count = 0
            self._sum = 0.0
        self._t0 = time.time()

    def get_avg_time(self) -> float:
        return self._avg


class MessageLogger:
    """Formatted progress lines + tb/jsonl scalar emission."""

    def __init__(self, opt: Dict[str, Any], start_iter: int = 0, tb_logger=None):
        self.exp_name = opt["name"]
        logger_opt = opt.get("logger") or {}
        self.print_freq = int(logger_opt.get("print_freq", 100))
        self.total_iter = int(opt["train"]["total_iter"])
        self.start_iter = start_iter
        self.tb_logger = tb_logger
        self.logger = get_root_logger()
        log_dir = (opt.get("path") or {}).get("log")
        self._jsonl = None
        if log_dir and is_main_process():
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.reset_start_time()

    def reset_start_time(self) -> None:
        self.start_time = time.time()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __call__(self, log_vars: Dict[str, Any]) -> None:
        epoch = log_vars.pop("epoch")
        current_iter = log_vars.pop("iter")
        lrs = log_vars.pop("lrs")
        msg = f"[{self.exp_name[:24]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:("
        msg += ", ".join(f"{lr:.3e}" for lr in lrs) + ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time")
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter, 1)
            eta_sec = time_sec_avg * (self.total_iter - current_iter)
            if eta_sec < 3.1e7:
                days, rem = divmod(int(eta_sec), 86400)
                hms = time.strftime("%H:%M:%S", time.gmtime(rem))
                eta = f"{days} d {hms}" if days else hms
            else:
                eta = "inf"
            msg += f"[eta: {eta}, time (data): {iter_time:.3f} ({data_time:.3f})] "

        scalars = {}
        for k, v in log_vars.items():
            v = float(v)
            scalars[k] = v
            msg += f"{k}: {v:.4e} "
        self.logger.info(msg)

        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"iter": current_iter, "epoch": epoch, **scalars}) + "\n")
            self._jsonl.flush()
        if self.tb_logger is not None:
            for k, v in scalars.items():
                prefix = "losses/" if k.startswith("l_") else ""
                self.tb_logger.add_scalar(f"{prefix}{k}", v, current_iter)


def init_wandb_logger(opt: Dict[str, Any]):
    """wandb sink parity (reference train.py:12 -> basicsr init_wandb_logger).

    Initialises a wandb run with the reference's semantics — resume via
    logger.wandb.resume_id, run name = experiment name, sync_tensorboard so
    the tb scalars flow through — but defaults to OFFLINE mode (overridable
    via logger.wandb.mode or WANDB_MODE): this framework targets egress-less
    hosts, where offline runs are synced later with `wandb sync`. Returns
    the run, or None when no project is configured or wandb is not installed
    (logged, never fatal). The card machine has no wandb.
    """
    wandb_opt = (opt.get("logger") or {}).get("wandb") or {}
    project = wandb_opt.get("project")
    if not project:
        return None
    try:
        import wandb  # type: ignore
    except ImportError:
        get_root_logger().warning(
            "logger.wandb.project is set but wandb is not installed — "
            "skipping the wandb sink")
        return None
    resume_id = wandb_opt.get("resume_id")
    mode = wandb_opt.get("mode") or os.environ.get("WANDB_MODE") or "offline"
    try:
        run = wandb.init(
            project=project,
            id=resume_id,
            resume="allow" if resume_id else None,
            name=opt["name"],
            config=opt,
            mode=mode,
            sync_tensorboard=True,
        )
    except Exception as e:  # auth/disk problems must not kill training
        get_root_logger().warning(f"wandb init failed ({e}); continuing without it")
        return None
    get_root_logger().info(
        f"wandb initialised: project={project} mode={mode}"
        + (f" resume_id={resume_id}" if resume_id else ""))
    return run


def init_tb_logger(opt: Dict[str, Any]):
    """TensorBoard scalars under <root>/tb_logger/<name>, or None when not
    configured, a debug run, or tensorboard is not installed (the card
    machine has none)."""
    logger_opt = opt.get("logger") or {}
    if not logger_opt.get("use_tb_logger") or "debug" in opt["name"]:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        get_root_logger().warning("tensorboard unavailable; skipping tb logger")
        return None
    root = opt.get("root_path", ".")
    return SummaryWriter(log_dir=os.path.join(root, "tb_logger", opt["name"]))
