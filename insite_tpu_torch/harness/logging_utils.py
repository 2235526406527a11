"""Timestamped log files whose lines double as the results database."""

from __future__ import annotations

import logging
import os
import time


def generate_log_file_path(name: str = 'run', log_folder: str = 'logs'):
    os.makedirs(log_folder, exist_ok=True)
    stamp = time.strftime('%Y%m%d-%H%M%S')
    return os.path.join(log_folder, f'{name}-{stamp}.txt')


def create_logger_in_process(log_file_path: str,
                             name: str = 'insite_tpu_torch'
                             ) -> logging.Logger:
    """The ``name`` logger, writing to stderr and to ``log_file_path``.
    The handlers of an earlier call are closed and replaced, so each sweep
    in one process writes its own file."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter('%(asctime)s %(levelname)s %(message)s')
    for h in (logging.StreamHandler(), logging.FileHandler(log_file_path)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger
