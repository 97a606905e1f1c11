"""Console+file logger (the port's own copy of `omni_pq_tpu/utils/logger.py`;
the reference's utils/logger.py:31-94: rank-0 console, per-process log
file). A later call re-points the named logger's handlers, so a second run
in one process logs to its own directory."""
from __future__ import annotations

import logging
import os
import sys


def setup_logger(output: str = None, name: str = "omni_pq_torch",
                 distributed_rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s]: %(levelname)s %(message)s",
        datefmt="%m/%d %H:%M:%S")
    if distributed_rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if output:
        os.makedirs(output, exist_ok=True)
        filename = os.path.join(output, f"log.rank{distributed_rank}.txt")
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
