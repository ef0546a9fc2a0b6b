"""Lightweight structured logging: the port's copy of
sign_language_nlp_tpu/utils/logging.py (log, warn, auto_log_progress)."""
from __future__ import annotations

import sys
import time

_VERBOSITY = 1


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = int(level)


def log(*args, level: int = 1, **kwargs) -> None:
    """Print a timestamped log line to stderr (so stdout stays clean for
    machine-readable output like bench.py's JSON line)."""
    if _VERBOSITY >= level:
        ts = time.strftime("%H:%M:%S")
        print(f"[{ts}]", *args, file=sys.stderr, **kwargs)
        sys.stderr.flush()


def warn(*args, **kwargs) -> None:
    log("WARNING:", *args, level=0, **kwargs)


def auto_log_progress(iterable, message: str = "", every: int = 1,
                      total: int | None = None):
    """Yield from `iterable`, periodically logging progress.

    Mirrors the role of commons-python's `auto_log_progress`
    (reference dataset_builder.py:91) without the dependency.
    """
    if total is None:
        try:
            total = len(iterable)
        except TypeError:
            total = None
    start = time.time()
    for i, item in enumerate(iterable):
        if i % max(1, every) == 0:
            frac = f"{i + 1}/{total}" if total else f"{i + 1}"
            log(f"{message}{frac} ({time.time() - start:.1f}s)", level=2)
        yield item
