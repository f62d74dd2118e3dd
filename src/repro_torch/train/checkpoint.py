"""Fault-tolerant checkpointing, on the reference's on-disk layout.

Mirrors ``repro/train/checkpoint.py``:
  * atomic step directories: write to ``step_N.tmp`` then rename; a LATEST
    marker is updated only after the rename, so a crash mid-save can never
    corrupt the restore point;
  * async saves: ``save`` copies the state to host memory and a writer
    thread persists it off the critical path; ``wait()`` joins before the
    next save or at exit;
  * ``step_XXXXXXXX/arrays.npz`` holds every leaf under its key in the
    reference's layout (``params/layers/attn/wq``, layers stacked along a
    leading dimension, a Zamba2 model's ``mamba`` blocks along two;
    ``opt/m/...``, ``opt/step``; a non-parametric norm has no leaf), and
    ``meta.json`` the
    step, the keys, each leaf's dtype and the caller's extras (the data
    iterator's state). npz has no bfloat16 (nor fp8): such a leaf is
    stored as its bytes, a uint8 array with a trailing dimension of its
    item size, and its dtype in ``meta.json``, as the reference stores
    them. So a checkpoint written by either package restores into the
    other;
  * restore onto a target: every leaf is placed on the device and in the
    dtype of the matching leaf of a target state (the counterpart of the
    reference's elastic restore onto a target sharding);
  * bounded retention (keep_checkpoints) with oldest-first GC;
  * SIGTERM/preemption hook: ``install_preemption_hook`` saves a final
    checkpoint before exit (cluster maintenance events).
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.convert import layer_groups

_NPZ_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16",
               "int8", "uint64", "uint32", "uint16", "uint8", "bool")


def _map_keyed(tree, fn, prefix: str = "", index: Optional[tuple] = None):
    """``fn(key, index, leaf)`` over a port state; ``key`` is the leaf's
    path in the reference's layout, where each list of the port's tree is
    one stacked tree (a list of lists stacks along two dimensions), except
    that the ``layers`` list is two when an MoE model's leading dense
    layers are ``dense_layers``; ``index`` is the leaf's position in its
    stack, a tuple (None outside any list)."""
    if isinstance(tree, dict):
        return {k: _map_keyed(v, fn, f"{prefix}{k}/", index)
                for k, v in tree.items()}
    if isinstance(tree, list) and index is None \
            and prefix.endswith("layers/"):
        base = prefix[:-len("layers/")]
        return [_map_keyed(v, fn, f"{base}{group}/", (i,))
                for v, (group, i) in zip(tree, layer_groups(tree))]
    if isinstance(tree, list):
        return [_map_keyed(v, fn, prefix, (index or ()) + (i,))
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], index, tree)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_arrays(state) -> dict:
    """A host copy of ``state``: {key: CPU tensor}, layers stacked."""
    parts: dict = {}

    def put(key, index, leaf):
        parts.setdefault(key, []).append(
            (index, leaf.detach().to("cpu", copy=True)))

    def stacked(entries):
        if entries[0][0] is None:
            return entries[0][1]
        dims = [max(ix[d] for ix, _ in entries) + 1
                for d in range(len(entries[0][0]))]
        leaves = [t for _, t in sorted(entries, key=lambda p: p[0])]
        return torch.stack(leaves).reshape(*dims, *leaves[0].shape)

    _map_keyed(state, put)
    return {k: stacked(v) for k, v in parts.items()}


def _encode(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as npz can hold it: itself, or its bytes."""
    name = _dtype_name(t.dtype)
    if name in _NPZ_DTYPES:
        return t.numpy()
    size = t.element_size()
    return t.contiguous().reshape(-1).view(torch.uint8) \
        .reshape(*t.shape, size).numpy()


def _decode(arr: np.ndarray, stored: str) -> torch.Tensor:
    """An npz array back to a CPU tensor of its stored dtype."""
    if arr.dtype == np.uint8 and stored != "uint8":
        dtype = getattr(torch, stored)
        return torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1) \
            .view(dtype).reshape(arr.shape[:-1])
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state, extra: dict | None = None):
        """Snapshot to host memory, then persist (async if configured)."""
        host_state = _host_arrays(state)
        if self.async_save:
            self.wait()
            self._worker = threading.Thread(
                target=self._persist, args=(step, host_state, extra or {}),
                daemon=True)
            self._worker.start()
        else:
            self._persist(step, host_state, extra or {})

    def _persist(self, step: int, host_state: dict, extra: dict):
        try:
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            dtypes = {k: _dtype_name(t.dtype) for k, t in host_state.items()}
            store = {k: _encode(t) for k, t in host_state.items()}
            np.savez(tmp / "arrays.npz", **store)
            meta = {"step": step, "time": time.time(),
                    "keys": sorted(host_state), "dtypes": dtypes, **extra}
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():                           # re-save of a step
                shutil.rmtree(final)
            os.replace(tmp, final)                       # atomic publish
            (self.dir / "LATEST.tmp").write_text(str(step))
            os.replace(self.dir / "LATEST.tmp", self.dir / "LATEST")
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        marker = self.dir / "LATEST"
        if marker.exists():
            try:
                step = int(marker.read_text().strip())
                if (self.dir / f"step_{step:08d}" / "meta.json").exists():
                    return step
            except ValueError:
                pass
        steps = [s for s in self.all_steps()
                 if (self.dir / f"step_{s:08d}" / "meta.json").exists()]
        return steps[-1] if steps else None

    def restore(self, step: int, target):
        """Load ``step`` onto the devices and dtypes of ``target`` (a port
        state of the same structure: every leaf is read from its key and,
        inside the layer list, its layer's row of the stacked array)."""
        path = self.dir / f"step_{step:08d}"
        meta = json.loads((path / "meta.json").read_text())
        dtypes = meta.get("dtypes", {})
        stored: dict = {}
        with np.load(path / "arrays.npz") as data:
            def load(key, index, t):
                if key not in data:
                    raise KeyError(f"checkpoint {step} missing {key}")
                if key not in stored:
                    arr = data[key]
                    stored[key] = _decode(arr, dtypes.get(key,
                                                          str(arr.dtype)))
                arr = stored[key] if index is None else stored[key][index]
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{key}: stored {tuple(arr.shape)} != "
                                     f"target {tuple(t.shape)}")
                return arr.to(device=t.device, dtype=t.dtype)

            return _map_keyed(target, load)

    def restore_meta(self, step: int) -> dict:
        return json.loads(
            (self.dir / f"step_{step:08d}" / "meta.json").read_text())


def install_preemption_hook(save_fn: Callable[[], None]):
    """SIGTERM -> checkpoint-and-exit (cloud preemption / maintenance)."""
    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
