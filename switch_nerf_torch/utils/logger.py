"""Experiment logging.

Port of ``switch_nerf_tpu/utils/logger.py``: a logger with stdout and
``log.txt`` handlers, and printing gated to the main process, rank 0 of a
process group (one process without a group is the main one).
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Iterable, Optional, Union

import torch
from torch import nn

from switch_nerf_torch.parallel.host import is_main


def setup_logger(name: Optional[str], log_dir, timestamp: bool = False
                 ) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s"
                            if timestamp else "%(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir is not None and is_main():
        # the file handler on the main process only: every process would
        # write to the same log.txt
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(log_dir) / "log.txt")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def main_log(msg: str) -> None:
    if is_main():
        logging.getLogger(None).info(msg)


def main_print(msg: str) -> None:
    if is_main():
        print(msg, flush=True)


def count_parameters(params: Union[nn.Module, Iterable[torch.Tensor]]) -> int:
    """Number of scalars in a module's parameters (or in the tensors given)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    return int(sum(p.numel() for p in params))
