"""Rank-aware logging: the port's own copy of ``deepspeed_tpu/utils/
logging.py``, with the process rank read from ``torch.distributed`` (or the
``RANK`` environment variable before a process group exists)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable, Optional

LOG_LEVEL_DEFAULT = logging.INFO

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def create_logger(name: str = "DeepSpeedTPUTorch",
                  level: int = LOG_LEVEL_DEFAULT) -> logging.Logger:
    formatter = logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d:%(funcName)s] "
        "%(message)s")
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(level)
        ch.setFormatter(formatter)
        logger_.addHandler(ch)
    return logger_


logger = create_logger(level=log_levels.get(
    os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), LOG_LEVEL_DEFAULT))


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the listed ranks (``[-1]`` or None = all)."""
    my_rank = _rank()
    ranks = list(ranks) if ranks is not None else []
    if not ranks or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
