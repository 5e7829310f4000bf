"""Framework logger: ``logging.Logger('autodist_tpu_torch')`` on stderr,
level from ``AUTODIST_MIN_LOG_LEVEL``."""
import logging as _logging
import sys
import threading

from autodist_tpu_torch.const import ENV

_logger = None
_logger_lock = threading.Lock()

_FMT = "%(asctime)s %(levelname)s [pid %(process)d] %(name)s: %(message)s"


def get_logger():
    global _logger
    with _logger_lock:
        if _logger is None:
            logger = _logging.getLogger("autodist_tpu_torch")
            logger.propagate = False
            level = ENV.AUTODIST_MIN_LOG_LEVEL.val.upper()
            logger.setLevel(getattr(_logging, level, _logging.INFO))
            stream = _logging.StreamHandler(sys.stderr)
            stream.setFormatter(_logging.Formatter(_FMT))
            logger.addHandler(stream)
            _logger = logger
    return _logger


def debug(msg, *args, **kwargs):
    get_logger().debug(msg, *args, **kwargs)


def info(msg, *args, **kwargs):
    get_logger().info(msg, *args, **kwargs)


def warning(msg, *args, **kwargs):
    get_logger().warning(msg, *args, **kwargs)

