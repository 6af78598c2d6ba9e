"""Rank-aware logger of the port (parity:
``adapt_image_models_tpu/utils/logger.py:17-41``; the reference's
``mmaction/utils/logger.py:6``).

Rank 0 logs at the given level to stdout and, given a file, to it; the
other ranks log errors only. The rank is ``torch.distributed``'s (0
without a process group), read at each call, so call it again after
joining a group.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

from adapt_image_models_torch.parallel.distributed import get_dist_info

NAME = "adapt_image_models_torch"
FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


class _Stdout(logging.StreamHandler):
    """Writes to the ``sys.stdout`` of the moment of each record (a test
    runner may swap it)."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):
        pass


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(NAME)
    rank = get_dist_info()[0]
    if not any(isinstance(h, _Stdout) for h in logger.handlers):
        logger.propagate = False
        handler = _Stdout()
        handler.setFormatter(logging.Formatter(FORMAT))
        logger.addHandler(handler)
    if log_file is not None and rank == 0:
        path = os.path.abspath(log_file)
        if not any(isinstance(h, logging.FileHandler) and h.baseFilename == path
                   for h in logger.handlers):
            handler = logging.FileHandler(path, "a")
            handler.setFormatter(logging.Formatter(FORMAT))
            logger.addHandler(handler)
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    return logger
