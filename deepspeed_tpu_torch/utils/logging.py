"""Logger factory and rank-filtered logging.

Parity with the reference's log_utils (reference: deepspeed/pt/log_utils.py:7-60):
a single shared logger plus ``log_dist(msg, ranks=[...])`` which only emits on
the listed process ranks (-1 meaning "all ranks").
"""

import logging
import sys

_LOGGER_NAME = "DeepSpeedTPUTorch"


class LoggerFactory:
    @staticmethod
    def create_logger(name=_LOGGER_NAME, level=logging.INFO):
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"
        )
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            handler = logging.StreamHandler(stream=sys.stdout)
            handler.setFormatter(formatter)
            logger_.addHandler(handler)
        return logger_


logger = LoggerFactory.create_logger()


def _current_rank():
    """This process's rank in the initialised ``torch.distributed`` group,
    else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given process ranks (None / [-1] => all)."""
    my_rank = _current_rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, "[Rank %s] %s", my_rank, message)


_warned_keys = set()


def warn_once(key, message, *args):
    """Emit a warning once per process per ``key`` — for conditions that
    recur every step (an unwritable metrics sink, a platform without
    memory stats) where repeating the line would bury the signal."""
    if key in _warned_keys:
        return
    _warned_keys.add(key)
    logger.warning(message, *args)
