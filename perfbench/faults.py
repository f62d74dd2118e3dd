"""Faults planted under the timed path, for the tests and the calibration
that show the check failing them. Each traffic kind lists its own
(``FAULTS`` of ``perfbench/kinds/<kind>.py``: a function that breaks the
step the port builds); ``planted`` wraps the port's builder (the kind's
``ENTRY``) for the duration of a ``with`` block. No benchmark run uses
one.
"""
from __future__ import annotations

import contextlib
import importlib

from perfbench import kinds


@contextlib.contextmanager
def planted(name: str, kind: str):
    k = kinds.load(kind)
    brk = k.FAULTS[name]
    module = importlib.import_module(k.ENTRY[0])
    build = getattr(module, k.ENTRY[1])
    setattr(module, k.ENTRY[1], lambda *a, **kw: brk(build(*a, **kw)))
    try:
        yield
    finally:
        setattr(module, k.ENTRY[1], build)
