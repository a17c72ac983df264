"""The framework logger (port of `setup_logger` of `efg_tpu/utils/logger.py`):
colored console output on the main process and a per-process file sink.

efg_tpu caches one logger per (output, process) with `lru_cache`, so a
second run in the same process adds a second set of handlers. Here each
call replaces the handlers of the previous one, which lets one process run
the CLI several times (the tests, `chip_smoke.py`).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

try:
    from termcolor import colored
except ImportError:  # pragma: no cover
    def colored(text, *a, **k):
        return text

LOGGER_NAME = "efg_tpu_torch"


class _ColorFormatter(logging.Formatter):
    def formatMessage(self, record: logging.LogRecord) -> str:
        log = super().formatMessage(record)
        if record.levelno == logging.WARNING:
            prefix = colored("WARNING", "red", attrs=["blink"])
        elif record.levelno in (logging.ERROR, logging.CRITICAL):
            prefix = colored("ERROR", "red", attrs=["blink", "underline"])
        else:
            return log
        return prefix + " " + log


def setup_logger(
    output: Optional[str] = None,
    process_index: int = 0,
    *,
    color: bool = True,
    name: str = LOGGER_NAME,
) -> logging.Logger:
    """The framework logger: process 0 logs to stdout; every process logs
    to `<output>/log.txt.rank{i}` when `output` is given."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    plain = logging.Formatter(
        "[%(asctime)s] %(name)s %(levelname)s: %(message)s", datefmt="%m/%d %H:%M:%S"
    )

    if process_index == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        if color:
            ch.setFormatter(
                _ColorFormatter(
                    colored("[%(asctime)s %(name)s]: ", "green") + "%(message)s",
                    datefmt="%m/%d %H:%M:%S",
                )
            )
        else:
            ch.setFormatter(plain)
        logger.addHandler(ch)

    if output:
        filename = os.path.join(output, f"log.txt.rank{process_index}")
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        fh = logging.FileHandler(filename, mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(plain)
        logger.addHandler(fh)

    return logger
