"""One run of a cell: set-up, the timed window, the trace and the check.

Set-up builds the port's kernels (cached in the checkout's ``build/``),
makes the weights and the token pool from the seed, builds the program's
step and drives it through the traffic's ``setup_calls`` calls, which
warm every shape the window uses. The window then calls the same step
one call after another, each call ending with its result on the host,
until ``seconds`` have passed; the calls made set the rates. With
``trace`` the first ``trace_calls`` calls of the window run under
``torch.profiler``. Once the window has closed and the peak memory is
read, the program's state is freed and the reference checks what the
timed path produced.

The traffic kind (``perfbench/kinds/<kind>.py``) holds what differs
between kinds of traffic; the reference model is
``perfbench/reference/<reference>.py`` of the configuration.
"""
from __future__ import annotations

import gc
import importlib
import time

import torch

from perfbench import kinds
from perfbench.lib import check, tree, weights
from perfbench.lib import trace as trace_lib
from perfbench.reference import common as ref_ops


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference_model(cell):
    return importlib.import_module(
        f"perfbench.reference.{cell.config['reference']}")


def fp32_params(cell, seed: int, dev):
    """The benchmark's parameter values again, in fp32, for the
    reference."""
    bf = weights.make(cell.model_config(), seed, dev)
    values = {p: t.float() for p, t in tree.leaves(bf)}
    return tree.rebuild(bf, values)


def launch_counts() -> dict:
    from repro_torch import kernels
    return {k.name: k.launches for k in kernels.ALL}


def run(cell, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> dict:
    """One run: ``correct``, ``attempted``, ``failed``, the end-to-end
    numbers (``e2e``), the window's ``peak`` bytes, the ``numbers``
    compared and their ``checks``, the ``seconds`` of each part; the
    traffic kind's object under ``_kind`` and, when traced, the per-layer
    readers' context under ``_ctx``. On a CPU device (the tests) the
    kernels are not built and no memory is read."""
    card = dev.type == "cuda"
    phases = {"start": time.perf_counter() - t_start}
    torch.empty(1, device=dev)
    sync(dev)
    phases["device"] = time.perf_counter() - t_start
    if card:
        from repro_torch import kernels
        kernels.build_all(kernels.ALL)
    phases["kernels"] = time.perf_counter() - t_start
    import repro_torch.train.step  # noqa: F401  (the program's own imports)
    phases["imports"] = time.perf_counter() - t_start
    kind = kinds.load(cell.traffic["kind"]).Kind(cell, seed, dev)
    sync(dev)
    phases["inputs"] = time.perf_counter() - t_start
    kind.setup()
    sync(dev)
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    n_trace = cell.traffic["trace_calls"] if trace else 0
    prof = trace_lib.profiler() if n_trace else None
    if prof:
        prof.__enter__()
    before = launch_counts()

    def stop_trace() -> dict:
        prof.__exit__(None, None, None)
        return {k: v - before[k] for k, v in launch_counts().items()}

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    calls = 0
    while True:
        if calls < n_trace:
            with torch.profiler.record_function(trace_lib.CALL):
                kind.call()
            if calls + 1 == n_trace:
                launches = stop_trace()
        else:
            kind.call()
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if prof and calls < n_trace:
        launches = stop_trace()
    peak = torch.cuda.max_memory_allocated(dev) if card else 0
    e2e = {**kind.end_to_end(calls, window_s), "setup_s": setup_s}
    kind.release()
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    ref_ops.strict_fp32()
    t1 = time.perf_counter()
    numbers = kind.check()
    correct, checks = check.judge(numbers, cell.limits["limits"])
    seconds = {"setup": setup_s, "setup_phases": phases, "window": window_s,
               "check": time.perf_counter() - t1}
    out = {"correct": correct, "attempted": calls, "failed": 0,
           "e2e": e2e, "peak": peak, "numbers": numbers, "checks": checks,
           "seconds": seconds, "_kind": kind}
    if n_trace:
        t1 = time.perf_counter()
        t = trace_lib.read(prof.events())
        seconds["trace_read"] = time.perf_counter() - t1
        out["_ctx"] = {"cell": cell, "trace": t, "launches": launches,
                       "memory_peak_bytes": peak}
    return out
