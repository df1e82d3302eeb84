"""Failure-visibility helpers.

Copy of ``generative_turbulence_tpu/utils/exceptions.py``.
``print_exceptions`` guarantees a traceback reaches stderr even when the
surrounding launcher swallows exceptions (SLURM wrappers, pools);
``enable_fault_handlers`` turns on segfault tracebacks.
"""

from __future__ import annotations

import faulthandler
import functools
import sys
import traceback


def enable_fault_handlers():
    faulthandler.enable()


def print_exceptions(fn):
    """Decorator: print + re-raise any exception from ``fn``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            sys.stderr.flush()
            raise

    return wrapper
