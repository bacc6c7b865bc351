"""Non-fatal error envelope.

The port's own copy of ``medsegpretrainimagenet_tpu/utils/errors.py``: every
stage of a long experiment (batch, epoch, metric, plot export, run) is
wrapped so one failure never kills a multi-day sweep.  Short tracebacks go
to stderr; long ones are dumped to an ``exceptions/`` directory.
"""
from __future__ import annotations

import os
import sys
import time
import traceback
from contextlib import contextmanager

__all__ = ["handle_exception", "swallow"]

#: tracebacks longer than this (chars) are written to disk instead of stderr
_MAX_INLINE = 1000

_EXCEPTIONS_DIR = os.environ.get("MST_EXCEPTIONS_DIR", "exceptions")


def handle_exception(exc: BaseException, message: str = "") -> None:
    """Log *exc* without raising."""
    text = "".join(traceback.format_exception(type(exc), exc,
                                              exc.__traceback__))
    if message:
        print(message, file=sys.stderr)
    if len(text) <= _MAX_INLINE:
        print(text, file=sys.stderr)
        return
    print(f"{type(exc).__name__}: {exc} (full traceback on disk)",
          file=sys.stderr)
    try:
        os.makedirs(_EXCEPTIONS_DIR, exist_ok=True)
        path = os.path.join(_EXCEPTIONS_DIR, f"error_{time.time_ns()}.txt")
        with open(path, "w") as fh:
            fh.write(message + "\n" + text)
        print(f"  -> {path}", file=sys.stderr)
    except OSError:
        print(text, file=sys.stderr)


@contextmanager
def swallow(message: str = ""):
    """Run the body under the non-fatal envelope.  Catches ``Exception``
    only: KeyboardInterrupt, SystemExit and GeneratorExit propagate."""
    try:
        yield
    except Exception as exc:  # noqa: BLE001 - envelope by design
        handle_exception(exc, message)
