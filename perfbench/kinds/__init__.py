"""Traffic kinds, one module a kind, found by the ``kind`` a traffic file
names (``kinds/<kind>.py``). A kind module has:

* ``Kind(cell, seed, dev)``: one run's program state, with ``setup()``
  (the set-up calls), ``call()`` (one timed call, done when its result is
  on the host), ``end_to_end(calls, window_s)``, ``release()`` (frees the
  program's state), ``check()`` (the numbers compared, after the window)
  and ``control()`` (the control's numbers, after ``check``);
* ``model_flops(body, head, traffic)``: the model FLOPs of one call, from
  the weights a token passes through below the head and the head's;
* ``ENTRY``: the port's (module, function) that builds the timed step,
  and ``FAULTS``: name -> a function that breaks a built step
  (``perfbench/faults.py``).
"""
from __future__ import annotations

import importlib


def load(kind: str):
    """The module of traffic kind ``kind``."""
    return importlib.import_module(f"perfbench.kinds.{kind}")
