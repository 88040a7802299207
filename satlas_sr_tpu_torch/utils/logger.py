"""The port's root logger (the JAX package's `utils/logger.get_root_logger`).

One logger, named `satlas_sr_tpu_torch`, writing to stdout and, once a run
names one, to its log file. The trainer's message logger and its tb/wandb
sinks come with the trainer.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


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
