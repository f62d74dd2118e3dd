"""Persistent tuning cache: measured plans keyed by op/shape/dtype/ring,
the port of ``repro/autotune/cache.py``; key format and JSON layout are
the reference's, byte for byte.

Key scheme: ``op|d0xd1x...|dtype|axis0=n0,axis1=n1``: everything that
changes which plan wins. The port's rings have one axis, so its keys end
in ``model=<n_pe>``. Lookup ladder:

  1. exact key           -> cached plan, zero re-measurement;
  2. nearest shape       -> same op/dtype/ring entry minimizing L2 distance
                            in log2-space over the shape dims (same rank
                            only: a [B,S,D] activation never borrows from
                            a [M,K] weight);
  3. miss                -> None; the caller keeps its config defaults or
                            tunes online (``api.tune``).

The file keeps the measured microseconds and link bytes next to each plan,
and may name the ``device`` it was measured on (the port's committed
cache does; the reference's layout has no such field, and a file without
it is written without it). All entries of one file come from one device:
``put`` and ``load`` refuse to mix two.

The default file is the port's own, ``AUTOTUNE_CACHE_H100.json`` beside
this module, measured on an H100 (``REPRO_TORCH_AUTOTUNE_CACHE``
overrides it). It is read, never written: ``save`` refuses it, so a sweep
on another machine cannot rewrite it under the card's name. The
reference's ``AUTOTUNE_CACHE.json`` was measured on fake CPU devices and
holds ``use_kernel: false`` plans only, so it is never the default.
"""
from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Optional

from repro_torch.autotune.space import Plan

ENV_PATH = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_FILE = Path(__file__).resolve().parent / "AUTOTUNE_CACHE_H100.json"


def default_path() -> str:
    return os.environ.get(ENV_PATH, str(DEFAULT_FILE))


def check_writable(path: str) -> None:
    """Refuse the committed cache as a file to write."""
    if Path(path).resolve() == DEFAULT_FILE:
        raise ValueError(
            f"{DEFAULT_FILE.name} is the committed cache of the card it "
            f"names and is never written; tune into a TuneCache with a "
            f"path of its own, or set {ENV_PATH}")


def make_key(op: str, shape, dtype, mesh_shape) -> str:
    """op + shape dims + dtype + ring axis sizes -> one cache key."""
    sh = "x".join(str(int(s)) for s in shape)
    ms = ",".join(f"{a}={int(n)}" for a, n in mesh_shape)
    return f"{op}|{sh}|{dtype}|{ms}"


def _parse_key(key: str):
    op, sh, dtype, ms = key.split("|")
    shape = tuple(int(v) for v in sh.split("x")) if sh else ()
    return op, shape, dtype, ms


class TuneCache:
    """Dict-of-entries with JSON persistence and the nearest-shape ladder.

    entries[key] = {"plan": {...}, "us": float, "bytes": float}
    (extra fields pass through); ``device`` names the card the entries
    were measured on, or is None.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: dict[str, dict] = {}
        self.device: Optional[str] = None
        if path and os.path.exists(path):
            self.load(path)

    # ------------------------------------------------------------- persist
    def load(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        entries = data.get("entries", {})
        if entries:
            self._claim(data.get("device"))
        self.entries.update(entries)
        self.path = path

    def payload(self) -> dict:
        """The file's JSON object."""
        out = {"version": 1, "entries": self.entries}
        if self.device is not None:
            out["device"] = self.device
        return out

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path or default_path()
        check_writable(path)
        with open(path, "w") as f:
            json.dump(self.payload(), f, indent=1, sort_keys=True)
            f.write("\n")
        self.path = path

    # -------------------------------------------------------------- lookup
    def _claim(self, device: Optional[str]) -> None:
        """Entries of one cache come from one device (None: unnamed)."""
        if device == self.device:
            return
        if self.entries:
            raise ValueError(f"the cache holds entries measured on "
                             f"{self.device!r}; entries from {device!r} "
                             f"would mix two devices in one file")
        self.device = device

    def put(self, op: str, shape, dtype, mesh_shape, plan: Plan,
            device: Optional[str] = None, **extra) -> str:
        """Store ``plan`` (measured on ``device``) under its key."""
        self._claim(device)
        key = make_key(op, shape, dtype, mesh_shape)
        self.entries[key] = {"plan": plan.to_dict(), **extra}
        return key

    def get_exact(self, op: str, shape, dtype, mesh_shape) -> Optional[Plan]:
        e = self.entries.get(make_key(op, shape, dtype, mesh_shape))
        return Plan.from_dict(e["plan"]) if e else None

    def get_nearest(self, op: str, shape, dtype,
                    mesh_shape) -> Optional[Plan]:
        """Closest same-rank shape under the same op/dtype/ring: log2-space
        L2 over dims, so 4096 vs 2048 is as near as 64 vs 32."""
        shape = tuple(int(s) for s in shape)
        want = (op, str(dtype), ",".join(f"{a}={int(n)}"
                                         for a, n in mesh_shape))
        best, best_d = None, float("inf")
        for key, e in self.entries.items():
            kop, kshape, kdtype, kms = _parse_key(key)
            if (kop, kdtype, kms) != want or len(kshape) != len(shape):
                continue
            d = sum((math.log2(max(a, 1)) - math.log2(max(b, 1))) ** 2
                    for a, b in zip(kshape, shape))
            if d < best_d:
                best, best_d = e, d
        return Plan.from_dict(best["plan"]) if best else None

    def lookup(self, op: str, shape, dtype, mesh_shape) -> Optional[Plan]:
        """The cache-only ladder: exact, else nearest, else None."""
        plan = self.get_exact(op, shape, dtype, mesh_shape)
        if plan is not None:
            return plan
        return self.get_nearest(op, shape, dtype, mesh_shape)

    def __len__(self) -> int:
        return len(self.entries)
