#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build, check and time every kernel
on the card, serve qwen3-0.6b at full width on the emulated ring, run the
paper's DSP suite on an emulated 256-PE cluster, prefill and serve
mamba2-1.3b at full width and depth, train qwen3-0.6b at full width and
depth on the ring, run mixtral-8x22b's MoE family and the 2-D grid
schedules at full width, prefill, train and serve zamba2-1.2b, serve
qwen3-14b and prefill olmo-1b and granite-34b at full width, and run
internvl2-1b, deepseek-v2-lite-16b and whisper-tiny at full width and
depth, run the autotuner's sweeps and tuned paths on the card, hold
the dry run's counts (on fake tensors) against measured steps, and run
the four examples.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/csrc`` into ``build/``). Phases; any failure exits
non-zero before the result lines are printed:

1. device and build: the card's name and power limit, all six kernels
   built in parallel;
2. each kernel against its plain PyTorch twin on the card, at the main
   paths' shapes (the training hops of phase 9 included), with the
   stated tolerances; each timed (device time under ``torch.profiler``)
   beside its twin, its bound and, where one PyTorch call computes the
   same function, that call (used here as a yardstick only); at the
   training hops (qwen3-0.6b, zamba2-1.2b, internvl2-1b, whisper-tiny,
   mixtral-8x22b under its window, and qwen3's hop from zero state) the
   flash backward kernel against its closed-form twin (bf16 gradients
   within 2^-7 of the largest, fp32 state gradients within 1e-5, two
   calls bit-identical), timed beside its bound, each pass's device time
   and blocks, its twin, autograd of the forward twin (the backward the
   card ran before the kernel) and SDPA's backward (causal; mixtral's
   window as an explicit mask); each flash hop
   names the kernel body the profiler saw, and a bf16 hop with more than
   one query at head_dim 64 or 128 fails unless it ran the tensor-core
   body of its width (the backward: the prep pass, both passes' tensor-
   core bodies and, where pass B splits, the sum of its partials);
3. serving: ``ServeEngine`` over ``RingShardedBackend(n_pe=4, mode="qlr")``,
   whose ring hops run the kernels, qwen3-0.6b at full width in bf16 with
   random weights from a seed, 8 requests plus 4 admitted mid-run; every kernel's
   launch count must rise during this run; then one prefill and one decode
   step under ``torch.profiler`` for device time by kernel and idle share;
4. modes agree: one prefill and one decode step at full width, 4 layers,
   fp32, ring+kernel backends (qlr, xqueue, sw) against the dense backend;
5. the DSP suite, fp32, in baseline, sw, xqueue and qlr, at the paper's
   sizes and at card scale: ``conv2d_systolic`` on 256 PEs, the pipelined
   conv2d chains on 8 PEs, ``pipelined_fft`` on 4 PEs and
   ``systolic_cannon`` on a 16x16 fold of 256 PEs. Each run is checked
   against a plain reference, every mode must give identical values, and
   each call must launch the kernels the expected number of times; the
   conv2d, FFT-stage and tile-matmul kernels must all launch in the phase;
6. Mamba2 prefill: mamba2-1.3b at full width and depth (48 layers), bf16,
   random weights from seed 0, 4 prompts x 2048 tokens; every call must
   launch the SSD kernel once per layer; wall time, tokens/s, peak memory,
   and device time by kernel and idle share under ``torch.profiler``;
7. Mamba2 prefill/decode parity (``tests/test_parity.py`` at full width,
   4 layers, fp32): prompts of 256 and 512 tokens (one and two SSD
   chunks) through ``prefill`` and streamed through ``decode_step`` give
   the same last logits within 2e-3;
8. Mamba2 serving: ``ServeEngine`` over ``DecodeBackend``, full width and
   depth, bf16, ``prefill_chunk=256``: the model has no block prefill, so
   prompts stream through the decode step (the SSD kernel is not on this
   path); 8 requests plus 2 admitted mid-run must all complete;
9. training: ``make_train_step`` on qwen3-0.6b at full width and depth,
   bf16 with fp32 master weights, remat "full", AdamW at a constant 3e-4,
   ring of 4 PEs in qlr (every QKV/FFN hop launches the tile matmul, every
   attention hop the flash kernel, again in the remat recompute, and its
   backward kernel once), 6 steps
   of 8 x 1024 tokens from ``SyntheticLM(seed=0)``: every loss finite and
   the last below the first; each step launches each kernel as often as
   reckoned from the code; median step time, tokens/s, ``train_mfu``
   (model FLOPs over step time x 989 TFLOP/s) and peak memory; one step
   profiled (idle share, top kernels and ops, the ``*_backward`` ranges:
   the flash backward kernel, the twin backwards of the other two). Then
   parity: 4 layers at full width, fp32, B=2,
   S=512: the loss and every gradient of the ring path in sw, xqueue and
   qlr against the dense path within 1e-4 and 1e-3, the modes bit for
   bit;
10. the serving launcher: (a) ``repro_torch.launch.serve.main`` as a user
   runs it, qwen3-0.6b at full width, ring of 4 in qlr, batch 8, 1024
   slots, block prefill 256, 8 requests of 16 new tokens, with checked
   links, the health monitor and link telemetry, metrics and trace
   written to ``build/serve_launcher/``: every request done, both kernels
   launched, link pushes counted and no link error, ``decode`` and
   ``probe`` spans in the trace; (b) the same requests plain and observed
   in turns (plain, observed, observed, plain, plain, observed): the same
   greedy tokens and the same launches per prefill and per decode step; (c) chaos: each fault
   kind fired at decode tick 3, hop 1, PE 2 is caught by the probe on
   qlr, xqueue and sw, the ladder ends at ``ring-baseline`` within the
   tick, every request completes and the tokens equal bit for bit a
   clean run force-degraded at the same tick; (d) decode-tick wall ms and
   tokens/s of (b)'s runs, the observers' own costs alone (the snapshot
   clone between CUDA events, the probe on the host clock), and the
   paper's utilization model over the launcher run's counters;
11. the MoE family and the grid schedules: (a) mixtral-8x22b at full
   width, 4 of 56 layers, bf16, seed 0, ring of 4 in qlr: ``prefill`` of
   2 x 8192 tokens (the 4096 window bites), 3 timed calls, each launching
   15 ``tile_matmul`` (QKV ring 12, the expert FFN 3 over all experts)
   and 4 ``flash_carry`` a layer, finite logits, profiled; (b) 2 layers,
   fp32, 1 x 1024: the ring in qlr, xqueue and sw on ``ring`` and
   ``cannon_grid`` against the dense path (logits 2e-3, aux 1e-6, modes
   bit for bit), and layer 0's MoE in the ring harness's four modes
   against the dense dispatch; (c) 2 layers, bf16, 1 x 2048, remat
   "full": one loss and backward, finite, launches as reckoned; (d)
   ``ServeEngine`` over the ring and dense backends, 4 layers, the
   launcher's 8 prompts: the same greedy tokens; (e) qwen3-0.6b prefill
   (4 layers, fp32) on torus2d and cannon_grid rings of 4 and 8 against
   the ring, and Cannon 8192^3 with the one-hop grid skew against the
   masked skew (values bit for bit, 2 + 2(n-1) hops against 4(n-1));
12. Zamba2 and the dense configs, bf16, ring of 4 in qlr unless stated:
   (a) zamba2-1.2b at full width and depth (38 Mamba2 layers, 6 calls of
   the shared block, a tail of 2): ``prefill`` of 4 x 2048 tokens, 3
   timed calls, each launching the SSD kernel once a Mamba2 layer and, a
   shared-block call, the QKV ring's 12 tile matmuls and ring attention's
   4 flash hops (head_dim 64); profiled; (b) 2 super-blocks and a tail
   layer, fp32: the ring in qlr, xqueue and sw against the dense path on
   1 x 1024 tokens (2e-3, modes bit for bit), and prefill against 512
   streamed decode steps of 4 rows (2e-3); (c) ``ssd_chunks``' backward:
   ``mamba2_forward``'s gradients at the Zamba2 layer's shape on the card
   against the CPU twin (fp32 1e-4, bf16 2e-2), then two training steps
   of zamba2-1.2b at full width and depth (4 x 2048 tokens, remat
   "full", AdamW): finite, launches as reckoned, one profiled; (d)
   ``ServeEngine`` over ``DecodeBackend`` and ``RingShardedBackend`` in
   lockstep, (a)'s model, 8 requests plus 4 admitted mid-run into freed
   slots, 16 new tokens: the same greedy tokens but at fp near-ties, ring
   decode attention's flash launches counted; then the same lockstep on
   (b)'s fp32 model: every row's logits within 2e-3, every token equal;
   (e) qwen3-14b at full width and depth served as in phase 3, and its
   modes as in phase 4; (f) olmo-1b at full width and depth, prefill on
   the ring against dense (fp32, 2 x 1024), and the trainer's ``main``
   with ``--arch olmo-1b --steps 3 --n-pe 4 --set systolic_mode=qlr --set
   num_layers=4`` (4 of 16 layers) as a user runs it: finite losses,
   launches per step as reckoned; (g) granite-34b at full width, 4 of 88
   layers, fp32, 2 x 2048: prefill on the ring (the QKV ring refused,
   GQA-48 flash hops) against dense;
13. the VLM, MLA and Whisper families, bf16, qlr unless stated: (a)
   internvl2-1b at full width and depth (24 layers) on the ring of 2,
   where the QKV ring (14 heads, 2 KV heads), ring attention (GQA-7,
   head_dim 64) and the FFN rings all engage: ``prefill`` of 4 x 2048
   tokens with seeded patch embeds [4, 256, 1024], 3 timed calls,
   launches as reckoned, profiled; the ring in qlr, xqueue and sw against
   the dense path with patches (4 layers, fp32, 2 x 1024: 2e-3, modes bit
   for bit); two training steps with patches (2 x 2048, remat "full"):
   finite, the projector's gradient nonzero; serving as in phase 3 on the
   ring of 2; (b) deepseek-v2-lite-16b at full width and depth (27
   layers, about 31 GB): ``prefill`` of 2 x 2048 tokens (``_mla_blocked``)
   on the ring of 4, 3 timed calls, only layer 0's FFN ring launching
   (12 tile matmuls), profiled; ``ServeEngine`` over the dense and ring
   backends in lockstep, 8 prompts streamed through the absorbed decode,
   16 new tokens: every token equal, no launch; 3 layers in fp32: the ring
   against dense on 1 x 2048 (modes bit for bit) and the absorbed decode
   against the expanded prefill (2e-3) over 2 x 16 tokens (past 16 a
   prefill's MoE drops assignments that decode keeps, as in the
   reference) and, layer 0's MLA alone, over 2 x 256; two training steps
   at 2 layers; (c) whisper-tiny at full width and depth (4 + 4
   layers) on the ring of 2 (its 6 heads do not split 4 ways): ``encode``
   of 16 x 1500 frames (QKV ring hops) and ``prefill`` of 16 x 448 tokens
   (QKV ring and flash hops in the decoder), 3 timed calls each, profiled;
   in fp32 the ring against dense (2e-3, modes bit for bit), then
   ``fill_cross_cache``, 8 prompt tokens and 64 greedy decode steps of 4
   rows on the ring against the prefill of the whole sequence (2e-3); two
   training steps. Each training run times its second step;
14. the autotuner: (a) (run with phase 2's cases, while the profiler
   still records every launch) ``tile_matmul`` at blocks 0, 64 and 128 (the
   tuner's tile knob: bf16 forces the 128 x block output tile, fp32 the
   block x block tile) against its twin at qwen3-0.6b's FFN AG hop, the
   N = 64 QKV k/v sink, mixtral's expert gate/up and the fp32 ragged hop
   with carry, each block's device time beside the bound and the
   ``bmm``/``baddbmm`` time, and whether blocks 64 and 128 give block 0's
   bits; (b) ``autotune.tune`` sweeps (warmup 1, 3 timed calls a plan)
   into a temporary cache, each trial running what its plan is applied
   to (``ring_ag_matmul``; ``gqa_forward`` and ``apply_moe`` under the
   plan; a ``RingShardedBackend(plan=)`` decode step): the reference
   cache's four shapes in fp32 (``matmul``, ``attention``, ``moe`` on 8
   PEs, ``serve`` on 4), then qwen3-0.6b's FFN AG ring (x [4, 2048,
   1024]), its attention layer, one mixtral-8x22b MoE layer (x [2, 8192,
   6144], 8 PEs) and qwen3-0.6b's serving decode step at full depth (8
   slots), all four at blocks 0/64/128: each plan's time and link bytes,
   the winner and the default plan's time. The gated ops (attention,
   MoE, serving) get link-mode plans only: a ``baseline`` model takes
   the dense path, which launches no kernel; (c) every admitted plan
   must come back timed with its sweep's kernels launched, each winner
   within 5% of its default, and a second lookup must run no trial; (d)
   qwen3-0.6b prefill (4 x 2048) with ``autotune=True`` against the
   attention winner set by hand (logits bit for bit, launches and their
   blocks equal, both kernels launched), and ``RingShardedBackend(plan=)``
   with the serve winner against the hand-set backend (32 greedy tokens
   of 8 prompts, token for token, both kernels launched); (e) the cache
   as one ``[autotune-cache]`` JSON line naming the card;
15. the dry run and the roofline: (a) ``DRY_CELLS``, eleven cells of the
   reference's grid covering every shape kind and family (qwen3-0.6b's
   three kinds on the ring of 4 in qlr and its decode on the dense path;
   mixtral-8x22b and mamba2-1.3b ``long_500k``, mamba2-1.3b ``train_4k``
   (the SSD backward kernel's launches), zamba2-1.2b
   ``prefill_32k``, whisper-tiny ``decode_32k`` on a ring of 2,
   deepseek-v2-lite-16b ``decode_32k``, internvl2-1b ``prefill_32k`` on a
   ring of 2), dry-run at full width on fake tensors on the card's device
   and again on the CPU: every record ok, the kernel counts of the two
   equal, no kernel library called, no launch, ``memory_allocated``
   unchanged; (b) qwen3-0.6b at full width and depth, bf16, ring of 4 in
   qlr, remat "full", each kind at its shape cut to fit the card
   (``ROOFLINE_CUTS``: train 8 x 4096 in 8 microbatches, prefill 2 x
   32768, one decode step of 8 rows against a full 32768-slot cache): the
   dry run's argument bytes equal the real parameters', optimizer
   state's, cache's and batch's, its launches the real call's; the peak
   estimate beside ``max_memory_allocated`` (no gate); the median of 3
   synchronized calls after a warm-up, ``mfu`` (the reference's model
   FLOPs over time x 989 TFLOP/s) and the roofline share (the count's
   bound over time), beside the card's name and power limit; phase 9's
   ``train_mfu`` beside the ``mfu`` of its step; all as one
   ``[roofline]`` JSON line;
16. the examples (``repro_torch.examples``), each through its ``run``:
   (a) quickstart on qwen3-0.6b at full width, bf16, qlr on the ring of
   4: the loss finite and within 1.0 of ln V, one train step finite with
   twice the loss's launches of both kernels (the forward and its remat
   recompute), 5 greedy tokens; (b) serve_batched at full width, bf16,
   ring of 4 in qlr, 10 requests in a slot batch of 4, with the example's
   defaults (flash launches) and with block prefill of 16 tokens (both
   kernels), tokens/s beside the card; then 4 layers in fp32: the ring's
   greedy tokens equal the dense backend's but at an fp near-tie; (c)
   systolic_topologies at the reference example's shapes on 8 PEs: the
   ring matmul and the MoE within 1e-4 relative, ring attention and
   conv2d within 1e-5, the FFT within 1e-5 relative, conv2d and the FFT
   identical in every mode, each section launching its kernels, ``sw``
   counting more ops than ``xqueue`` and ``qlr``; (d) train_lm
   ``--full`` (olmo-1b at ~100M parameters, 16 x 512 tokens) cut to 20
   steps, checkpointed every 10 and resumed to 30: losses finite and
   falling from step 1 to 20, the resumed run starting at step 20;
   median step ms, tokens/s and peak memory.

The last three lines of standard output are the kernels' JSON, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

# the card's published figures and each kernel's work live in the package
from repro_torch.roofline import hw  # noqa: E402

HBM_BYTES_PER_S = hw.HBM_BW        # H100 SXM device memory
PEAK_FLOPS = hw.PEAK_FLOPS         # bf16 on the tensor cores, fp32 outside
bound = hw.bound_ms
N_PE = 4
BATCH = 8
MAX_SEQ = 1024
CHUNK = 256
TRAIN_BATCH = 8                    # phase 9: 8 x 1024 tokens a step
TRAIN_SEQ = 1024
TRAIN_STEPS = 6                    # the first is warm-up
MOE_BATCH, MOE_SEQ = 2, 8192       # phase 11: mixtral prefill, 2 x 8192
MOE_LAYERS = 4                     # of 56, at full width
MOE_WINDOW = 4096                  # mixtral's sliding window
ZAMBA_BATCH, ZAMBA_SEQ = 4, 2048   # phase 12: zamba2 prefill and training
ZAMBA_SERVE_SEQ = 64               # phase 12 (d): zamba2's serving slots
ZAMBA_WINDOW = 768                 # phase 2: a window at zamba2's hop
GRANITE_BATCH = 2                  # phase 12 (g): granite 2 x 2048 prefill
GRANITE_LAYERS = 4                 # of 88, at full width
Q14_D, Q14_FF = 5120, 17408        # qwen3-14b's widths (phase 12 (e))
VLM_NPE = 2                        # phase 13 (a), (c): the ring of 2
VLM_BATCH, VLM_SEQ = 4, 2048       # (a): internvl2 prefill, 4 x 2048
MLA_BATCH, MLA_SEQ = 2, 2048       # (b): deepseek prefill, 2 x 2048
WHISPER_BATCH, WHISPER_SEQ = 16, 448   # (c): 16 x 1500 frames, 448 tokens
# profiler ranges around the backwards of the autograd.Functions (the flash
# hop's and the SSD chunk pass's run their backward kernels, the tile
# matmul's its products)
BACKWARD_LABELS = ("flash_carry_backward", "tile_matmul_backward",
                   "ssd_chunks_backward")
# the kernels a range launches: their ctypes launches fall in no host range,
# so ``profile`` adds the kernels' device time to the range's (the SSD
# backward's passes: ssd_bwd_prep_kernel, ssd_bwd_kernel[_mma],
# ssd_bwd_rows_kernel, ssd_bwd_reduce_kernel)
LABEL_KERNELS = {"flash_carry_backward": "flash_carry_bwd_kernel",
                 "ssd_chunks_backward": "ssd_bwd_"}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _kernel_rows(averages, ops: bool = False):
    """(name, device ms, count) of every device kernel in a profile's
    ``key_averages()``; with ``ops``, of every CPU op instead, by the
    device time of the kernels it launched itself (not its children's).
    A ``record_function`` range
    (``BACKWARD_LABELS``) also appears on the device's timeline; it is no
    kernel, and skipped (``label_ms`` reads it)."""
    rows = []
    for evt in averages:
        if str(getattr(evt, "device_type", "")).endswith("CUDA") == ops \
                or getattr(evt, "is_user_annotation", False) \
                or evt.key in BACKWARD_LABELS:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3, evt.count))
    return sorted(rows, key=lambda r: -r[1])


def _whole_rows(fn, iters: int, only: str | None, attempts: int):
    """The kernel rows (``_kernel_rows``) of ``iters`` calls of ``fn``
    under ``torch.profiler`` whose names contain ``only``, from the first
    of ``attempts`` sessions in which each such kernel ran a whole
    multiple of ``iters`` times; None when no session did."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()                                         # warm
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in _kernel_rows(prof.key_averages())
                if only is None or only in r[0]]
        if rows and all(n % iters == 0 for _, _, n in rows):
            return rows
    return None


def time_ms(fn, iters: int = 20, only: str | None = None,
            attempts: int = 3) -> float:
    """Device time of one call: the kernels' durations under
    ``torch.profiler``, summed over ``iters`` calls, divided by ``iters``
    (only the kernels whose name contains ``only``, when given). CUDA
    events around the calls would time the Python wrapper instead wherever
    a kernel is shorter than its launch path, so they are only the
    fallback: now and then a profiler session on the card records no
    device activity for the calls, or (late in a long run) only some of
    their kernels. Every call launches the same kernels, so a session
    counts only if each kernel it recorded ran a whole multiple of
    ``iters`` times; after ``attempts`` sessions that do not, the calls
    are timed with CUDA events (logged). Whether a kernel launched is
    checked by its counter, not here."""
    import torch
    rows = _whole_rows(fn, iters, only, attempts)
    if rows is not None:
        return sum(ms for _, ms, _ in rows) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    log(f"[timing] {attempts} profiler sessions recorded no whole set of "
        f"launches for {only or 'a library call'}: {ms:.4f} ms from CUDA "
        f"events")
    return ms


def split_ms(fn, only: str, iters: int = 10, attempts: int = 3):
    """Device ms of one call by kernel body (``demangled_body`` of each
    kernel whose name contains ``only``), from one profiler session as
    ``time_ms`` takes it; None when no session recorded whole sets."""
    rows = _whole_rows(fn, iters, only, attempts)
    if rows is None:
        return None
    out = {}
    for name, ms, _ in rows:
        body = demangled_body(name)
        out[body] = out.get(body, 0.0) + ms / iters
    return out


def profiled_bodies(fn, only: str, attempts: int = 5,
                    bodies: int = 1) -> str | None:
    """The kernel bodies (``demangled_body``) whose names contain ``only``
    that the profiler records for one call of ``fn`` (which launches
    ``bodies`` of them), joined by ", "; None when ``attempts`` sessions
    record none. A session may lose a launch, so the bodies are gathered
    over sessions until ``bodies`` of them are seen."""
    import torch
    from torch.profiler import ProfilerActivity
    names = set()
    for _ in range(attempts):
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names |= {demangled_body(name)
                  for name, _, _ in _kernel_rows(prof.key_averages())
                  if only in name}
        if len(names) >= bodies:
            break
    return ", ".join(sorted(names)) if names else None


def demangled_body(name: str) -> str:
    """``<identifier><template arguments>`` of a kernel name: of a mangled
    one (``nvcc``'s log) the length-prefixed identifier that names a
    kernel, and what follows it up to the return type; of a demangled one
    (the profiler's) the identifier and its ``<...>``."""
    import re
    plain = re.search(r"(\w*kernel\w*)(<[^()]*>)?\(", name)
    if plain:
        return plain.group(1) + (plain.group(2) or "")
    found = []
    for i in range(len(name)):
        m = re.match(r"\d+", name[i:])
        if not m:
            continue
        end = i + m.end()
        stop = end + int(m.group())
        ident = name[end:stop]
        if "kernel" in ident and ident.isidentifier() \
                and stop < len(name) and name[stop] in "IE":
            rest = name[stop:]
            found.append(ident + (rest[:rest.find("Ev") + 1]
                                  if rest.startswith("I") else ""))
    return min(found, key=len) if found else name[:60]


def ptxas_summary(text: str):
    """(body, "registers, static shared memory; spills") for every kernel
    body ``nvcc -Xptxas -v`` compiled: the body is the mangled name cut to
    its identifier and template arguments. Dynamic shared memory is set at
    launch and is not in this log."""
    import re
    out, func, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            func = demangled_body(m.group(1))
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and func:
            used = line.split("Used", 1)[1].strip()
            out.append((func, f"Used {used}; {spill}"))
            func = None
    return out


def event_ms(torch, fn, iters: int = 10) -> float:
    """Mean ms of one call between CUDA events around ``iters`` calls
    (warmed first): the whole stream's time, launch gaps included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def ratio_text(rec) -> str:
    """Add ``of_bound`` (bound / kernel time) and ``vs_library`` (kernel
    time / library time, where one PyTorch call computes the function) to
    a kernel case record; the text for its log line."""
    rec["of_bound"] = rec["bound_ms"] / rec["ms"]
    lib = rec.get("library_ms")
    rec["vs_library"] = rec["ms"] / lib if lib else None
    vs = "n/a" if lib is None else f"{rec['vs_library']:.2f}x"
    return f"; {rec['of_bound']:.1%} of bound, vs library {vs}"


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def flash_cases(torch, fk, dev):
    """Main-path shapes of qwen3-0.6b on a ring of 4 at the serving batch:
    a prefill hop (32 PE x batch rows, 64 queries, 64 keys) and a decode
    hop (8 query rows, 256 resident slots of a [8*4, 256] cache view)."""
    g = torch.Generator(device=dev).manual_seed(0)
    h, kvh, hd = 16, 8, 128
    bf = torch.bfloat16
    rows = N_PE * BATCH
    s_l = CHUNK // N_PE
    pe = torch.arange(N_PE, device=dev).repeat_interleave(BATCH)

    def state(r, sq, fresh, h=h, d=hd):
        m = torch.full((r, h, sq), -1e30, device=dev) if fresh else \
            torch.randn(r, h, sq, generator=g, device=dev)
        l = torch.zeros(r, h, sq, device=dev) if fresh else \
            torch.rand(r, h, sq, generator=g, device=dev) + 1
        acc = torch.zeros(r, h, sq, d, device=dev) if fresh else \
            torch.randn(r, h, sq, d, generator=g, device=dev)
        return m, l, acc

    q = torch.randn(rows, s_l, h, hd, generator=g, device=dev).to(bf)
    k = torch.randn(rows, s_l, kvh, hd, generator=g, device=dev).to(bf)
    v = torch.randn(rows, s_l, kvh, hd, generator=g, device=dev).to(bf)
    big = torch.tensor(2 ** 30, device=dev).expand(rows)
    src = (pe - 1) % N_PE                      # hop 1: some blocks masked
    m, l, acc = state(rows, s_l, fresh=False)
    m[::3] = -1e30
    cases = {
        "prefill_hop": dict(
            args=(q, k, v, m, l, acc, pe * s_l, src * s_l, big, None),
            opts=dict(causal=True, window=0, normalize=False)),
        "prefill_hop_noncausal": dict(
            args=(q, k, v, m, l, acc, pe * s_l, src * s_l,
                  src * s_l + 40, None),
            opts=dict(causal=False, window=0, normalize=False)),
        "prefill_normalized": dict(
            args=(q, k, v, *state(rows, s_l, fresh=True),
                  0 * pe, 0 * pe, big, None),
            opts=dict(causal=True, window=0, normalize=True,
                      out_dtype=bf)),
    }
    # decode: the cache [8, 1024, 8, 128] viewed as [8*4, 256, 8, 128];
    # PE d folds its resident slots of the rows that originated at src
    b_loc, s_loc = BATCH // N_PE, MAX_SEQ // N_PE
    kc = torch.randn(BATCH, MAX_SEQ, kvh, hd, generator=g, device=dev).to(bf)
    vc = torch.randn(BATCH, MAX_SEQ, kvh, hd, generator=g, device=dev).to(bf)
    pos = torch.randint(64, 280, (BATCH,), generator=g, device=dev)
    dpe = torch.arange(N_PE, device=dev).repeat_interleave(b_loc)
    dsrc = (dpe - 1) % N_PE
    cache_row = dsrc * b_loc + torch.arange(b_loc, device=dev).repeat(N_PE)
    qd = torch.randn(BATCH, 1, h, hd, generator=g, device=dev)   # fp32 query
    md, ld, accd = state(BATCH, 1, fresh=False)
    md[::2] = -1e30
    cases["decode_hop"] = dict(
        args=(qd, kc.view(BATCH * N_PE, s_loc, kvh, hd),
              vc.view(BATCH * N_PE, s_loc, kvh, hd), md, ld, accd,
              0 * dpe, dpe * s_loc, pos[cache_row] + 1,
              cache_row * N_PE + dpe),
        opts=dict(causal=False, window=0, normalize=False))
    # training (phase 9): B=8, S=1024 on the ring of 4, so 256 queries and
    # keys a hop; hop 1 as above, and the normalized form against SDPA
    t_rows, t_l = N_PE * TRAIN_BATCH, TRAIN_SEQ // N_PE
    t_pe = torch.arange(N_PE, device=dev).repeat_interleave(TRAIN_BATCH)
    qt = torch.randn(t_rows, t_l, h, hd, generator=g, device=dev).to(bf)
    kt = torch.randn(t_rows, t_l, kvh, hd, generator=g, device=dev).to(bf)
    vt = torch.randn(t_rows, t_l, kvh, hd, generator=g, device=dev).to(bf)
    mt, lt, acct = state(t_rows, t_l, fresh=False)
    mt[::3] = -1e30
    big_t = torch.tensor(2 ** 30, device=dev).expand(t_rows)
    cases["train_hop"] = dict(
        args=(qt, kt, vt, mt, lt, acct, t_pe * t_l,
              (t_pe - 1) % N_PE * t_l, big_t, None),
        opts=dict(causal=True, window=0, normalize=False))
    cases["train_normalized"] = dict(
        args=(qt, kt, vt, *state(t_rows, t_l, fresh=True), 0 * t_pe,
              0 * t_pe, big_t, None),
        opts=dict(causal=True, window=0, normalize=True, out_dtype=bf))
    # mixtral-8x22b prefill on the ring of 4 (phase 11): 2 x 8192 tokens,
    # so 2048 queries and keys a hop, 48 heads over 8 KV heads (a GQA
    # group of 6), window 4096. At hop t PE d holds the block of PE
    # d - t: at hop 2 PE 3's queries 6144-8191 meet keys 2048-4095 and the
    # window boundary runs through the tile; at hop 3 they meet keys
    # 0-2047, all behind the window (and every other PE's keys are ahead
    # of its queries). After hop 0 (the causal diagonal) every row holds a
    # real running max, as here, so dead tiles are skipped (the sentinel
    # rows of the hops above, and card tests, cover the other case). The
    # normalized form folds PE 2's and PE 3's hop-2 blocks from zero state
    # (the rows where the window bites and most queries see a key).
    mh, mkv = 48, 8
    m_rows, m_l = N_PE * MOE_BATCH, MOE_SEQ // N_PE
    m_pe = torch.arange(N_PE, device=dev).repeat_interleave(MOE_BATCH)
    qm = torch.randn(m_rows, m_l, mh, hd, generator=g, device=dev).to(bf)
    km = torch.randn(m_rows, m_l, mkv, hd, generator=g, device=dev).to(bf)
    vm = torch.randn(m_rows, m_l, mkv, hd, generator=g, device=dev).to(bf)
    big_m = torch.tensor(2 ** 30, device=dev).expand(m_rows)
    for hop in (2, 3):
        cases[f"moe_window_hop{hop}"] = dict(
            args=(qm, km, vm, *state(m_rows, m_l, fresh=False, h=mh),
                  m_pe * m_l, (m_pe - hop) % N_PE * m_l, big_m, None),
            opts=dict(causal=True, window=MOE_WINDOW, normalize=False))
    late = slice(m_rows // 2, m_rows)               # PEs 2 and 3
    cases["moe_window_normalized"] = dict(
        args=(qm[late], km[late], vm[late],
              *state(m_rows // 2, m_l, fresh=True, h=mh), m_pe[late] * m_l,
              (m_pe[late] - 2) % N_PE * m_l, big_m[late], None),
        opts=dict(causal=True, window=MOE_WINDOW, normalize=True,
                  out_dtype=bf))
    # mixtral-8x22b's training hop of phase 11 (c) (1 x 2048 on the ring of
    # 4: 4 rows, 512 queries and keys, 48 heads over 8 KV heads), hop 1,
    # under its window
    mt_l = 2048 // N_PE
    cases["moe_train_hop"] = dict(
        args=(torch.randn(N_PE, mt_l, mh, hd, generator=g, device=dev).to(bf),
              torch.randn(N_PE, mt_l, mkv, hd, generator=g,
                          device=dev).to(bf),
              torch.randn(N_PE, mt_l, mkv, hd, generator=g,
                          device=dev).to(bf),
              *state(N_PE, mt_l, fresh=False, h=mh),
              torch.arange(N_PE, device=dev) * mt_l,
              (torch.arange(N_PE, device=dev) - 1) % N_PE * mt_l,
              torch.tensor(2 ** 30, device=dev).expand(N_PE), None),
        opts=dict(causal=True, window=MOE_WINDOW, normalize=False))
    cases["moe_train_hop"]["args"][3][::3] = -1e30
    # phase 12: hop 1 of zamba2-1.2b's prefill (4 x 2048 on the ring of 4:
    # 16 rows of PE x batch, 512 queries and keys, 32 heads, MHA, head_dim
    # 64) and of granite-34b's (2 x 2048: 8 rows, 48 heads over one KV
    # head, a GQA group of 48, head_dim 128); zamba2's hop again under a
    # window of ZAMBA_WINDOW (zamba2 has none: the window's tile skip and
    # masks at head_dim 64), which cuts diagonally through the block
    for name, (bsz, qh, kh, d, win) in {
            "zamba_prefill_hop": (ZAMBA_BATCH, 32, 32, 64, 0),
            "granite_gqa48_hop": (GRANITE_BATCH, 48, 1, 128, 0),
            "zamba_window_hop": (ZAMBA_BATCH, 32, 32, 64,
                                 ZAMBA_WINDOW)}.items():
        rows, s_l = N_PE * bsz, ZAMBA_SEQ // N_PE
        pe_z = torch.arange(N_PE, device=dev).repeat_interleave(bsz)
        qz = torch.randn(rows, s_l, qh, d, generator=g, device=dev).to(bf)
        kz = torch.randn(rows, s_l, kh, d, generator=g, device=dev).to(bf)
        vz = torch.randn(rows, s_l, kh, d, generator=g, device=dev).to(bf)
        mz, lz, accz = state(rows, s_l, fresh=False, h=qh, d=d)
        mz[::3] = -1e30
        cases[name] = dict(
            args=(qz, kz, vz, mz, lz, accz, pe_z * s_l,
                  (pe_z - 1) % N_PE * s_l,
                  torch.tensor(2 ** 30, device=dev).expand(rows), None),
            opts=dict(causal=True, window=win, normalize=False))
    # phase 13: hop 1 of internvl2-1b's prefill (4 x 2048 on the ring of 2:
    # 8 rows of PE x batch, 1024 queries and keys, 14 heads over 2 KV
    # heads, a GQA group of 7) and of whisper-tiny's decoder (16 x 448 on
    # the ring of 2: 32 rows, 224 queries and keys, 6 heads, MHA), both at
    # head_dim 64; then, for SDPA's yardstick, every
    # head_dim-64 and GQA-48 hop's normalized form folded from zero state
    # on aligned positions (the causal diagonal block)
    hops = {"zamba_prefill": (N_PE, ZAMBA_BATCH, ZAMBA_SEQ, 32, 32, 64),
            "granite_gqa48": (N_PE, GRANITE_BATCH, ZAMBA_SEQ, 48, 1, 128),
            "vlm_prefill": (VLM_NPE, VLM_BATCH, VLM_SEQ, 14, 2, 64),
            "whisper_prefill": (VLM_NPE, WHISPER_BATCH, WHISPER_SEQ, 6, 6,
                                64)}
    for name, (n, bsz, seq, qh, kh, d) in hops.items():
        rows, s_l = n * bsz, seq // n
        pe_h = torch.arange(n, device=dev).repeat_interleave(bsz)
        qh_ = torch.randn(rows, s_l, qh, d, generator=g, device=dev).to(bf)
        kh_ = torch.randn(rows, s_l, kh, d, generator=g, device=dev).to(bf)
        vh_ = torch.randn(rows, s_l, kh, d, generator=g, device=dev).to(bf)
        big_h = torch.tensor(2 ** 30, device=dev).expand(rows)
        if name.startswith(("vlm", "whisper")):
            mh_, lh_, acch_ = state(rows, s_l, fresh=False, h=qh, d=d)
            mh_[::3] = -1e30
            cases[f"{name}_hop"] = dict(
                args=(qh_, kh_, vh_, mh_, lh_, acch_, pe_h * s_l,
                      (pe_h - 1) % n * s_l, big_h, None),
                opts=dict(causal=True, window=0, normalize=False))
        cases[f"{name}_normalized"] = dict(
            args=(qh_, kh_, vh_, *state(rows, s_l, fresh=True, h=qh, d=d),
                  0 * pe_h, 0 * pe_h, big_h, None),
            opts=dict(causal=True, window=0, normalize=True, out_dtype=bf))
    # ring decode hops at head_dim 64, fp32 queries against the bf16 cache
    # (the key-split body): zamba2's serving run of phase 12 (d) (8 slots of
    # 64 on the ring of 4: q [8,1,32,64], the cache [8,64,32,64] viewed as
    # [32,16,32,64]) and internvl2's of phase 13 (a) (8 slots of MAX_SEQ on
    # the ring of 2: q [8,1,14,64], the cache viewed as [16,512,2,64])
    for name, (n, seq, qh, kh) in {
            "zamba_decode_hop": (N_PE, ZAMBA_SERVE_SEQ, 32, 32),
            "vlm_decode_hop": (VLM_NPE, MAX_SEQ, 14, 2)}.items():
        b_loc, s_loc = BATCH // n, seq // n
        kc = torch.randn(BATCH, seq, kh, 64, generator=g,
                         device=dev).to(bf)
        vc = torch.randn(BATCH, seq, kh, 64, generator=g,
                         device=dev).to(bf)
        pos = torch.randint(seq // 4, seq, (BATCH,), generator=g, device=dev)
        dpe = torch.arange(n, device=dev).repeat_interleave(b_loc)
        cache_row = (dpe - 1) % n * b_loc \
            + torch.arange(b_loc, device=dev).repeat(n)
        md, ld, accd = state(BATCH, 1, fresh=False, h=qh, d=64)
        md[::2] = -1e30
        cases[name] = dict(
            args=(torch.randn(BATCH, 1, qh, 64, generator=g, device=dev),
                  kc.view(BATCH * n, s_loc, kh, 64),
                  vc.view(BATCH * n, s_loc, kh, 64), md, ld, accd,
                  0 * dpe, dpe * s_loc, pos[cache_row] + 1,
                  cache_row * n + dpe),
            opts=dict(causal=False, window=0, normalize=False))
    return cases


def backward_ms(torch, apply, args, diff):
    """Device time of the backward of one ``apply(*args)`` in the inputs
    at the positions ``diff``, for random output gradients."""
    args = list(args)
    leaves = []
    for i in diff:
        args[i] = args[i].detach().requires_grad_(True)
        leaves.append(args[i])
    outs = apply(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    ups = [torch.randn(o.shape, device=o.device).to(o.dtype) for o in outs]
    return time_ms(lambda: torch.autograd.grad(outs, leaves, ups,
                                               retain_graph=True), iters=5)


def flash_bound(torch, fk, args, opts):
    """The bound of the work this call's data needs (``fk.work`` at the
    live pairs): the queries, the K/V of keys some query of the row may
    attend to, the state in and out; 4*D operations per (query, head,
    attended key)."""
    q, k, v, m, l, acc, q_off, k_off, klen, kv_row = args
    sq, t = q.shape[1], k.shape[1]
    mask = fk.key_mask(q_off.int(), k_off.int(), klen.int(), sq, t,
                       causal=opts["causal"], window=opts["window"])
    flops, moved, kind = fk.work(
        q, k, m, l, acc, normalize=opts.get("normalize", False),
        out_dtype=opts.get("out_dtype"), pairs=int(mask.sum()),
        keys=int(mask.any(dim=1).sum()))
    return bound(moved, flops, kind)


def sdpa_call(torch, q, k, v):
    """One PyTorch call computing the normalized causal attention of the
    same q/k/v (GQA), as a yardstick."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        ke = kt.repeat_interleave(rep, 1)
        ve = vt.repeat_interleave(rep, 1)
        return lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                      is_causal=True)


def sdpa_masked_call(torch, q, k, v, mask):
    """One PyTorch call computing the normalized attention of the same
    q/k/v (GQA) under an explicit [B', Sq, T] key mask, as a yardstick."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    kt, vt = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask[:, None])


def check_flash(torch, fk, dev, cases):
    out = []
    for name, case in cases.items():
        args, opts = case["args"], case["opts"]
        got = fk.flash_carry_cuda(*args, **opts)
        want = fk.flash_carry_plain(*args, **opts)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # fp32 state: both sum the same fp32 products in another order;
        # a bf16 output adds one bf16 rounding of values of order 1
        tol = 2e-2 if opts.get("normalize") else 2e-4
        ok = err <= tol * max(1.0, max(float(w.float().abs().max())
                                       for w in want[2:]))
        lib = None
        if opts.get("normalize") and opts["window"]:
            # the same mask, compared on the queries that see any key
            # (SDPA has no answer for a fully masked row)
            q, k, v, *_, q_off, k_off, klen, _ = args
            mask = fk.key_mask(q_off.int(), k_off.int(), klen.int(),
                               q.shape[1], k.shape[1], causal=True,
                               window=opts["window"])
            call = sdpa_masked_call(torch, q, k, v, mask)
            seen = mask.any(dim=-1)[:, None, :, None]
            diff = torch.where(seen, call().float() - got[2].float(), 0.0)
            ok = ok and float(diff.abs().max()) <= 2e-2
            lib = time_ms(call, iters=5)
            del mask, seen, diff
        elif opts.get("normalize"):
            call = sdpa_call(torch, args[0], args[1], args[2])
            ok = ok and float((call().float() - got[2].float())
                              .abs().max()) <= 2e-2
            lib = time_ms(call)
        b_ms, b_by = flash_bound(torch, fk, args, opts)
        launch = lambda: fk.flash_carry_cuda(*args, **opts)  # noqa: E731
        body = profiled_bodies(launch, "flash_carry_kernel")
        q, k = args[0], args[1]
        d = q.shape[-1]
        if q.dtype == k.dtype == torch.bfloat16 and q.shape[1] > 1 \
                and d in (64, 128):
            # the tensor-core body, and no other, at its widths; a hop whose
            # body no profiler session recorded fails too
            ok = ok and body is not None \
                and body.startswith(f"flash_carry_kernel_mma<{d},") \
                and "simt" not in body
        rec = {"case": name, "max_abs_err": err, "tol": tol, "ok": ok,
               "body": body, "ms": time_ms(launch, only="flash_carry_kernel"),
               "plain_ms": time_ms(lambda: fk.flash_carry_plain(*args,
                                                                 **opts),
                                   iters=3 if name.startswith("moe")
                                   else 20),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
               "shape": {"q": list(args[0].shape), "k": list(args[1].shape),
                         "dtype_q": str(args[0].dtype),
                         "dtype_kv": str(args[1].dtype)}}
        log(f"[kernels] flash_carry {name}: {body} max_abs_err={err:.3e} "
            f"(tol {tol}) kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"library {lib}" + ratio_text(rec))
        out.append(rec)
        del got, want
    return out


# phase 2's backward cases: the training hops of phases 9, 11 (c), 12 (c)
# and 13 (flash_cases' names), and qwen3's hop from zero state (the
# normalized case's inputs, the causal diagonal of the ring's hop 0)
BWD_CASES = ("train_hop", "zamba_prefill_hop", "vlm_prefill_hop",
             "whisper_prefill_hop", "moe_train_hop", "train_zero_state")


def twin_backward(torch, fk, args, ups, opts):
    """The flash hop's backward as the card ran it before its kernel:
    autograd of the forward twin, recomputed from the saved inputs; a None
    cotangent counts as zero."""
    diff = [x.detach().requires_grad_(True) for x in args[:6]]
    with torch.enable_grad():
        outs = fk.flash_carry_plain(*diff, *args[6:], **opts)
        pairs = [(o, g) for o, g in zip(outs, ups) if g is not None]
        got = torch.autograd.grad([o for o, _ in pairs], diff,
                                  [g for _, g in pairs], allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(diff, got))


def sdpa_backward_call(torch, q, k, v, mask=None):
    """SDPA's backward on the same q/k/v for a random output gradient, as
    a yardstick: one PyTorch call's kernels. Causal with GQA by
    ``enable_gqa``, or, given a [B', Sq, T] key mask (a window), under
    that mask with K/V repeated to the query heads, as ``sdpa_masked_call``
    takes the forward."""
    import torch.nn.functional as F
    leaves = [x.detach().transpose(1, 2).requires_grad_(True)
              for x in (q, k, v)]
    rep = q.shape[2] // k.shape[2]
    if mask is not None:
        out = F.scaled_dot_product_attention(
            leaves[0], leaves[1].repeat_interleave(rep, 1),
            leaves[2].repeat_interleave(rep, 1), attn_mask=mask[:, None])
    else:
        try:
            out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                 enable_gqa=True)
        except TypeError:
            out = F.scaled_dot_product_attention(
                leaves[0], leaves[1].repeat_interleave(rep, 1),
                leaves[2].repeat_interleave(rep, 1), is_causal=True)
    up = torch.randn_like(out)
    return lambda: torch.autograd.grad(out, leaves, up, retain_graph=True)


def bwd_bodies(fk, q, k, nsplit: int):
    """The kernel bodies one tensor-core backward launch runs: the prep
    pass, pass A, pass B (writing dK/dV, or fp32 partials when split)
    and, when split, the fixed-order sum of the partials."""
    d, split = q.shape[-1], nsplit > 1
    bodies = [f"flash_carry_bwd_kernel_prep<{d}>",
              f"flash_carry_bwd_kernel_rows_mma<{d}>",
              f"flash_carry_bwd_kernel_keys_mma<{d}, {str(split).lower()}>"]
    if split:
        bodies.append("flash_carry_bwd_kernel_sum")
    return bodies


def bwd_case(torch, fk, cases, name, g):
    """(args, opts, outs, ups) of backward case ``name``: the flash case's
    inputs (``train_zero_state``: the normalized case's), the forward
    kernel's outputs and random cotangents from ``g``."""
    src = "train_normalized" if name == "train_zero_state" else name
    args = cases[src]["args"]
    opts = {k: cases[src]["opts"][k] for k in ("causal", "window")}
    outs = fk.flash_carry_cuda(*args, **opts)
    ups = [torch.randn(o.shape, generator=g, device=o.device) for o in outs]
    return args, opts, outs, ups


def bwd_errors(torch, got, want):
    """(errors, bounds, all within and finite) of the six backward outputs
    against the closed-form twin's: bf16 gradients within 2^-7 of the
    largest; fp32 state gradients within 1e-5, fp32 q/K/V gradients (the
    CUDA-core body) within 1e-4, of max(1, the largest)."""
    errs, tols, ok = [], [], True
    for i, (x, y) in enumerate(zip(got, want)):
        big = float(y.float().abs().max())
        tol = 2 ** -7 * big if x.dtype == torch.bfloat16 else \
            (1e-5 if i >= 3 else 1e-4) * max(1.0, big)
        err = float((x.float() - y.float()).abs().max())
        ok = ok and err <= tol and bool(torch.isfinite(x).all())
        errs.append(err)
        tols.append(tol)
    return errs, tols, ok


def check_flash_backward(torch, fk, dev, cases):
    """The backward kernel at ``BWD_CASES``, the saved outputs the forward
    kernel's: against the closed-form twin (bf16 gradients within 2^-7 of
    the largest; fp32 state gradients within 1e-5, fp32 gradients of the
    CUDA-core body within 1e-4, of max(1, the largest)), two calls
    bit-identical, the tensor-core bodies (``bwd_bodies``, and no other)
    where the forward takes its own; timed beside its bound at the live
    pairs, each pass's device time and blocks, the twin, autograd of the
    forward twin and SDPA's backward (causal; mixtral's window as an
    explicit mask)."""
    g = torch.Generator(device=dev).manual_seed(7)
    out = []
    for name in BWD_CASES:
        args, opts, outs, ups = bwd_case(torch, fk, cases, name, g)
        q, k, v, m, l, acc, q_off, k_off, klen, kv_row = args
        call = lambda: fk.flash_carry_backward_cuda(  # noqa: E731
            *args, *outs, *ups, **opts)
        before = fk.FLASH_CARRY_BWD.launches
        got, again = call(), call()
        launched = fk.FLASH_CARRY_BWD.launches - before
        want = fk.flash_carry_backward_plain(*args, *outs, *ups, **opts)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs, tols, within = bwd_errors(torch, got, want)
        ok = same and launched == 2 and within
        del got, again, want
        mask = fk.key_mask(q_off.int(), k_off.int(), klen.int(), q.shape[1],
                           k.shape[1], causal=opts["causal"],
                           window=opts["window"])
        flops, moved, kind = fk.backward_work(q, k, m, acc,
                                              pairs=int(mask.sum()))
        b_ms, b_by = bound(moved, flops, kind)
        nsplit = fk.backward_split(q, k)
        blocks = fk.backward_blocks(q, k, nsplit)
        d = q.shape[-1]
        tc = q.dtype == k.dtype == torch.bfloat16 and q.shape[1] > 1 \
            and d in (64, 128)
        want_bodies = bwd_bodies(fk, q, k, nsplit) if tc else []
        body = profiled_bodies(call, "flash_carry_bwd_kernel",
                               bodies=max(2, len(want_bodies)))
        if tc:
            # the tensor-core bodies and no other; a hop whose bodies no
            # profiler session recorded fails too
            ok = ok and body is not None and "simt" not in body \
                and all(b in body for b in want_bodies)
        lib = time_ms(sdpa_backward_call(
            torch, q, k, v, mask if opts["window"] else None), iters=10)
        del mask
        rec = {"case": name, "max_abs_err": max(errs), "errors": errs,
               "tols": tols, "ok": ok, "bit_identical": same, "body": body,
               "ms": time_ms(call, iters=10, only="flash_carry_bwd_kernel"),
               "passes_ms": split_ms(call, "flash_carry_bwd_kernel"),
               "blocks": blocks, "nsplit": nsplit,
               "plain_ms": time_ms(lambda: fk.flash_carry_backward_plain(
                   *args, *outs, *ups, **opts), iters=3),
               "twin_backward_ms": time_ms(lambda: twin_backward(
                   torch, fk, args, ups, opts), iters=3),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
               "shape": {"q": list(q.shape), "k": list(k.shape),
                         "dtype_q": str(q.dtype), "dtype_kv": str(k.dtype),
                         "window": opts["window"]}}
        passes = {b: round(ms, 4) for b, ms in
                  (rec["passes_ms"] or {}).items()}
        log(f"[kernels] flash_carry_bwd {name}: {body} errors "
            f"{[f'{e:.3e}' for e in errs]} (tols "
            f"{[f'{t:.3e}' for t in tols]}), bit-identical {same}: kernel "
            f"{rec['ms']:.4f} ms (passes {passes}; blocks {blocks}, nsplit "
            f"{nsplit}), twin {rec['plain_ms']:.4f} ms, autograd twin "
            f"{rec['twin_backward_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), SDPA backward {lib:.4f} ms" + ratio_text(rec))
        out.append(rec)
        del outs, ups
    return out


def check_matmul(torch, mk, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    d, f, m = 1024, 3072 // N_PE, BATCH * CHUNK // N_PE    # M = 512 per PE
    tm = TRAIN_BATCH * TRAIN_SEQ // N_PE

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    cases = {
        # AG ring hop of the FFN (gate or up): x chunk @ w slice
        "ffn_ag_hop": (rnd(N_PE, m, d), rnd(N_PE, d, f), None, bf),
        # AG ring hop of the QKV ring (q sink: 4 of 16 heads per PE)
        "qkv_q_hop": (rnd(N_PE, m, d), rnd(N_PE, d, 512), None, bf),
        # RS ring hop of the FFN with the bf16 travelling accumulator
        "ffn_rs_carry_hop": (rnd(N_PE, m, f), rnd(N_PE, f, d),
                             rnd(N_PE, m, d), bf),
        # the fp32 form (phase 4) with an fp32 carry, ragged M
        "fp32_carry_ragged": (rnd(N_PE, 500, d, dtype=f32),
                              rnd(N_PE, d, 256, dtype=f32),
                              rnd(N_PE, 500, 256, dtype=f32), f32),
        # one Cannon step at card scale (phase 5): 512x512 tiles on a
        # 16x16 fold, fp32 carry
        "cannon_card_fp32_carry": (rnd(256, 512, 512, dtype=f32),
                                   rnd(256, 512, 512, dtype=f32),
                                   rnd(256, 512, 512, dtype=f32), f32),
        # training (phase 9), M = 8 x 1024 / 4 per PE: the FFN AG hop and
        # the RS hop with its bf16 travelling accumulator
        "train_ffn_ag_hop": (rnd(N_PE, tm, d), rnd(N_PE, d, f), None, bf),
        "train_ffn_rs_carry_hop": (rnd(N_PE, tm, f), rnd(N_PE, f, d),
                                   rnd(N_PE, tm, d), bf),
        # qwen3-14b serving prefill (phase 12 (e)), M = 512 per PE: the
        # QKV ring's q sink (10 of 40 heads per PE), the FFN AG hop and the
        # RS hop with its bf16 travelling accumulator
        "q14b_qkv_q_hop": (rnd(N_PE, m, Q14_D), rnd(N_PE, Q14_D, 1280),
                           None, bf),
        "q14b_ffn_ag_hop": (rnd(N_PE, m, Q14_D),
                            rnd(N_PE, Q14_D, Q14_FF // N_PE), None, bf),
        "q14b_ffn_rs_carry_hop": (rnd(N_PE, m, Q14_FF // N_PE),
                                  rnd(N_PE, Q14_FF // N_PE, Q14_D),
                                  rnd(N_PE, m, Q14_D), bf),
        # mixtral's expert FFN (phase 11): one launch a projection over the
        # 8 experts, M = 2 x 2560 capacity slots each (2 x 8192 tokens)
        "moe_expert_gate_up": (rnd(8, 5120, 6144), rnd(8, 6144, 16384),
                               None, bf),
        "moe_expert_down": (rnd(8, 5120, 16384), rnd(8, 16384, 6144), None,
                            bf),
        # phase 13: every hop shape of internvl2-1b's prefill on the ring
        # of 2 (M = 4 x 2048 / 2): the QKV ring's q sink (7 of 14 heads of
        # 64), its k/v sinks (1 of 2 KV heads: N = 64), the FFN AG hop (F/2
        # = 2432) and the RS hop with its bf16 travelling accumulator;
        # deepseek-v2-lite's leading dense FFN on the ring of 4 (M = 2 x
        # 2048 / 4, F/4 = 2736: the AG hop and the RS hop); whisper-tiny's
        # QKV ring sink on the ring of 2 (3 of 6 heads of 64; q, k and v
        # alike) in the encoder (M = 16 x 1500 / 2) and the decoder (M = 16
        # x 448 / 2)
        "vlm_qkv_q_hop": (rnd(VLM_NPE, VLM_BATCH * VLM_SEQ // VLM_NPE, 896),
                          rnd(VLM_NPE, 896, 448), None, bf),
        "vlm_qkv_kv_hop": (rnd(VLM_NPE, VLM_BATCH * VLM_SEQ // VLM_NPE,
                                896), rnd(VLM_NPE, 896, 64), None, bf),
        "vlm_ffn_ag_hop": (rnd(VLM_NPE, VLM_BATCH * VLM_SEQ // VLM_NPE, 896),
                           rnd(VLM_NPE, 896, 4864 // VLM_NPE), None, bf),
        "vlm_ffn_rs_carry_hop": (
            rnd(VLM_NPE, VLM_BATCH * VLM_SEQ // VLM_NPE, 4864 // VLM_NPE),
            rnd(VLM_NPE, 4864 // VLM_NPE, 896),
            rnd(VLM_NPE, VLM_BATCH * VLM_SEQ // VLM_NPE, 896), bf),
        "mla_dense_ffn_ag_hop": (rnd(N_PE, MLA_BATCH * MLA_SEQ // N_PE,
                                     2048),
                                 rnd(N_PE, 2048, 10944 // N_PE), None, bf),
        "mla_dense_ffn_rs_carry_hop": (
            rnd(N_PE, MLA_BATCH * MLA_SEQ // N_PE, 10944 // N_PE),
            rnd(N_PE, 10944 // N_PE, 2048),
            rnd(N_PE, MLA_BATCH * MLA_SEQ // N_PE, 2048), bf),
        "whisper_qkv_q_hop": (rnd(VLM_NPE, WHISPER_BATCH * 1500 // VLM_NPE,
                                  384), rnd(VLM_NPE, 384, 192), None, bf),
        "whisper_dec_qkv_hop": (
            rnd(VLM_NPE, WHISPER_BATCH * WHISPER_SEQ // VLM_NPE, 384),
            rnd(VLM_NPE, 384, 192), None, bf),
    }
    out = []
    for name, (a, b, c, odt) in cases.items():
        bwd = None
        if name.startswith("train"):
            from repro_torch.kernels.systolic_matmul import ops as mm_ops
            bwd = backward_ms(torch, mm_ops._TileMatmul.apply,
                              (a, b, c, odt), (0, 1) + ((2,) if c is not None
                                                        else ()))
        rec, _ = matmul_record(torch, mk, name, a, b, c, odt,
                               plain_iters=3 if name.startswith("moe")
                               else 20)
        rec["twin_backward_ms"] = bwd
        out.append(rec)
    return out


def matmul_record(torch, mk, name, a, b, c, odt, block: int = 0,
                  plain_iters: int = 20, timed=None):
    """One tile-matmul case on the card: the kernel at ``block`` against
    its twin (bf16 out: one bf16 rounding, 2^-7 of the output's scale, of
    fp32 sums that differ in order; fp32 out: 1e-5 of it, fp32 sums of K
    terms in another order: ``tests/test_kernels.py``'s bounds), the
    kernel's device time, its bound, and the twin's and ``bmm``/
    ``baddbmm``'s times (taken from ``timed`` when given: they do not
    depend on the block). Returns (record, the kernel's output)."""
    bf = torch.bfloat16
    got = mk.matmul_cuda(a, b, c, odt, block)
    want = mk.matmul_plain(a, b, c, odt)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = (2 ** -7 if odt == bf else 1e-5) * max(1.0, scale)
    del want
    if c is None:
        lib_call = lambda: torch.bmm(a, b)                     # noqa: E731
    else:
        lib_call = lambda: torch.baddbmm(c, a, b)              # noqa: E731
    if timed is None:
        timed = {"plain_ms": time_ms(lambda: mk.matmul_plain(a, b, c, odt),
                                     iters=plain_iters),
                 "library_ms": time_ms(lib_call)}
    flops, moved, kind = mk.work(a, b, c, odt)
    b_ms, b_by = bound(moved, flops, kind)
    rec = {"case": name, "block": block, "max_abs_err": err, "tol": tol,
           "ok": err <= tol,
           "ms": time_ms(lambda: mk.matmul_cuda(a, b, c, odt, block),
                         only="tile_matmul_kernel"),
           "plain_ms": timed["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": timed["library_ms"],
           "shape": {"a": list(a.shape), "b": list(b.shape),
                     "carry": c is not None, "dtype": str(a.dtype)}}
    log(f"[kernels] tile_matmul {name}: block {block} max_abs_err={err:.3e} "
        f"(tol {tol:.3e}) kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"bmm {rec['library_ms']:.4f} ms" + ratio_text(rec))
    return rec, got


# conv2d: (P, rows per PE, W) and the types — the paper's 256x256 image on
# 256 PEs, the card-scale 8192x8192 image on 256 PEs, ragged widths of both
# (the generic body), a conv chain tick (8 PEs of 512 rows) and the
# baseline's whole image (P = 1)
CONV_SHAPES = {"paper": ((256, 1, 256), ("fp32", "bf16")),
               "paper_ragged": ((256, 1, 250), ("fp32", "bf16")),
               "card": ((256, 32, 8192), ("fp32", "bf16")),
               "card_ragged": ((256, 32, 8190), ("fp32", "bf16")),
               "chain_tick": ((8, 512, 8192), ("fp32",)),
               "baseline": ((1, 8192, 8192), ("fp32",))}


def conv_halos(torch, x):
    """The halo rows the ring delivers to the blocks of one image: the
    neighbours' edge rows, zero at the image's top and bottom."""
    z = torch.zeros_like(x[:1, :1])
    return torch.cat([z, x[:-1, -1:]]), torch.cat([x[1:, :1], z])


def conv_body(ck, x, top, bot):
    """(kernel body, rows per strip) the wrapper takes for these tensors
    (its output is a fresh allocation, 16-byte aligned)."""
    strip = ck.conv_strip(tuple(x.shape), x.element_size(),
                          [t.data_ptr() for t in (x, top, bot)
                           if t is not None])
    return ("conv2d_3x3_kernel_v16" if strip else "conv2d_3x3_kernel"), strip


def conv_generic(torch, ck, x, top, bot, k, out):
    """One launch of the kernel's generic body (the earlier one-column
    design) on the same inputs, through the C entry with strip 0: the
    earlier time beside the new one in the same run. Not counted as a
    launch of the main path."""
    from repro_torch.kernels._build import stream_handle
    ptr = [t.data_ptr() if t is not None else None for t in (x, top, bot)]
    ck.CONV2D_3X3.check(ck.CONV2D_3X3.lib().conv2d_3x3(
        *ptr, k.float().contiguous().data_ptr(), out.data_ptr(),
        *x.shape, ck.DTYPE_CODES[x.dtype], 0, stream_handle(x.device)))


def check_conv(torch, ck, dev):
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(2)
    f32 = torch.float32
    ptxas = ptxas_summary(ck.CONV2D_3X3.ptxas_log)
    out = []
    for shape, ((p, r, w), kinds) in CONV_SHAPES.items():
        for kind in kinds:
            dtype = f32 if kind == "fp32" else torch.bfloat16
            x = torch.randn(p, r, w, generator=g, device=dev).to(dtype)
            k = torch.randn(3, 3, generator=g, device=dev).to(dtype)
            top, bot = conv_halos(torch, x)
            body, strip = conv_body(ck, x, top, bot)
            regs = [info for func, info in ptxas
                    if func.split("I")[0] == body
                    and ("bfloat16" in func) == (dtype != f32)]
            got = ck.conv_cuda(x, top, bot, k)
            want = ck.conv_plain(x, top, bot, k)
            image, wk = x.reshape(1, 1, p * r, w), k.reshape(1, 1, 3, 3)
            lib_call = lambda image=image, wk=wk: F.conv2d(  # noqa: E731
                image, wk, padding=1)
            lib = lib_call().reshape(p, r, w)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = max(1.0, float(want.float().abs().max()))
            # kernel and twin round every product and sum alike, in the
            # same order: fp32 bit for bit, bf16 within one bf16 rounding
            tol = 0.0 if dtype == f32 else 2 ** -7 * scale
            lib_err = float((lib.float() - want.float()).abs().max())
            lib_tol = (1e-4 if dtype == f32 else 5e-2) * scale
            flops, moved, b_kind = ck.work(x, top, bot, k)
            b_ms, b_by = bound(moved, flops, b_kind)
            name = f"{shape}_{kind}"
            rec = {"case": name, "max_abs_err": err, "tol": tol,
                   "library_err": lib_err, "library_tol": lib_tol,
                   "ok": err <= tol and lib_err <= lib_tol,
                   "body": body, "strip": strip,
                   "ptxas": regs[0] if regs else None,
                   "ms": time_ms(lambda: ck.conv_cuda(x, top, bot, k),
                                 only="conv2d_3x3_kernel"),
                   "plain_ms": time_ms(lambda: ck.conv_plain(x, top, bot, k)),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": time_ms(lib_call),
                   # a yardstick of what the card's memory system gives:
                   # PyTorch's copy of x, the same bytes less the halos
                   "copy_ms": time_ms(lambda: got.copy_(x)),
                   "generic_ms": time_ms(lambda: conv_generic(
                       torch, ck, x, top, bot, k, got),
                       only="conv2d_3x3_kernel"),
                   "shape": {"x": [p, r, w], "dtype": str(dtype)}}
            log(f"[kernels] conv2d_3x3 {name}: {body} (strip {strip}; "
                f"{rec['ptxas']}) max_abs_err={err:.3e} (tol {tol:.3e}), "
                f"F.conv2d err {lib_err:.3e} (tol {lib_tol:.3e}) kernel "
                f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), F.conv2d "
                f"{rec['library_ms']:.4f} ms, copy_ {rec['copy_ms']:.4f} ms, "
                f"generic body {rec['generic_ms']:.4f} ms" + ratio_text(rec))
            out.append(rec)
            del x, top, bot, got, want, lib, image
    return out


def check_fft(torch, ffk, fft, dev):
    """One pipeline tick (4 PEs at stages 0..3, stage 0 loading
    digit-reversed) at the paper's batch of 64 and at 4096, and the
    one-launch fft256 of a whole batch (``fft_full``, bit for bit against
    its twin) against ``torch.fft.fft`` and against the four per-stage
    launches it replaces, timed in the same run."""
    g = torch.Generator(device=dev).manual_seed(3)
    n = 256
    tw = fft.twiddle_table(n, dev)
    ticks = torch.arange(4, dtype=torch.int32, device=dev)
    stage_vecs = [torch.full((1,), s, dtype=torch.int32, device=dev)
                  for s in range(4)]

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=dev),
                             torch.randn(*shape, generator=g, device=dev))

    def fft256_stages(x):
        y = x.reshape(1, -1, n)
        for s in range(4):
            y = ffk.stage_cuda(y, stage_vecs[s], tw, reverse=(s == 0))
        return y.reshape(x.shape)

    out = []
    for b in (64, 4096):
        for kind in ("tick", "fft256"):
            if kind == "tick":
                x = crandn(4, b, n)
                call = lambda x=x: ffk.stage_cuda(x, ticks, tw,  # noqa: E731
                                                  reverse=True)
                plain = lambda x=x: ffk.stage_plain(x, ticks, tw,  # noqa
                                                    reverse=True)
                lib_call, work = None, ffk.work(x, ticks, tw)
                body, tol = "fft_stage_kernel", None
            else:
                x = crandn(b, n)
                call = lambda x=x: fft.fft256_radix4(x, n)  # noqa: E731
                plain = lambda x=x: ffk.fft_full_plain(x, tw)  # noqa: E731
                lib_call = lambda x=x: torch.fft.fft(x, dim=-1)  # noqa
                work = ffk.full_work(x, tw)
                body, tol = "fft_full_kernel", 0.0      # bit for bit
            before = ffk.FFT_STAGE.launches
            got = call()
            launched = ffk.FFT_STAGE.launches - before
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if tol is None:
                tol = 1e-5 * max(1.0, float(want.abs().max()))
            ok = err <= tol and launched == 1
            lib_err = None
            if lib_call is not None:
                lib = lib_call()
                lib_err = float((got - lib).abs().max() / lib.abs().max())
                ok = ok and lib_err <= 1e-3
            b_ms, b_by = bound(work[1], work[0], work[2])
            rec = {"case": f"{kind}_B{b}", "max_abs_err": err, "tol": tol,
                   "library_rel_err": lib_err, "ok": ok,
                   "ms": time_ms(call, only=body),
                   "plain_ms": time_ms(plain), "bound_ms": b_ms,
                   "bound_by": b_by,
                   "library_ms": time_ms(lib_call) if lib_call else None,
                   "launches_per_call": launched,
                   "shape": {"x": list(x.shape), "dtype": "complex64"}}
            extra = ""
            if kind == "fft256":
                rec["stages_ms"] = time_ms(lambda x=x: fft256_stages(x),
                                           only="fft_stage_kernel")
                extra = f", four stage launches {rec['stages_ms']:.4f} ms"
            lib_txt = "n/a" if lib_call is None else \
                f"{rec['library_ms']:.4f} ms (rel err {lib_err:.2e})"
            log(f"[kernels] fft_stage {rec['case']}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e}) kernel {rec['ms']:.4f} ms ({body}, "
                f"{launched} launch){extra}, plain {rec['plain_ms']:.4f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}), torch.fft {lib_txt}"
                + ratio_text(rec))
            out.append(rec)
    return out


# SSD chunk pass: (batch, heads, groups, seq, L, P, N, a, dt shift). The
# prefill case is mamba2-1.3b's (4 prompts of 2048 tokens, 64 heads, A = -1
# as A_log = 0 initialises it); the overflow case drives cum to about -1300
SSD_CASES = {"prefill": (4, 64, 1, 2048, 256, 64, 128, -1.0, 0.0),
             # zamba2-1.2b's prefill (phase 12): the same with N = 64
             "zamba_prefill": (4, 64, 1, 2048, 256, 64, 64, -1.0, 0.0),
             "groups2": (2, 64, 2, 512, 256, 64, 128, None, 0.0),
             "ragged_small": (4, 8, 1, 64, 16, 16, 16, None, 0.0),
             "overflow": (1, 8, 1, 512, 256, 64, 128, -4.0, 1.0)}


# the SSD backward kernel's cases (phase 2): mamba2-1.3b's and zamba2's
# training shapes, two groups, and the overflow case
SSD_BWD_CASES = ("prefill", "zamba_prefill", "groups2", "overflow")


def ssd_inputs(torch, g, dev, dtype, case):
    """x, dt, a, b, c of an ``SSD_CASES`` case in ``dtype``, from the
    generator ``g``."""
    import torch.nn.functional as F
    bsz, h, grp, seq, l, p, n, a_val, shift = SSD_CASES[case]
    nc, bh = seq // l, bsz * h

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    x = rnd(bh, nc, l, p).to(dtype)
    dt = F.softplus(rnd(bh, nc, l, 1) + shift)
    a_h = torch.full((h,), a_val, device=dev) if a_val is not None \
        else -torch.exp(rnd(h) * 0.3)
    a = a_h.repeat(bsz).reshape(bh, 1, 1, 1)
    b = (rnd(bsz * grp, nc, l, n) * 0.3).to(dtype)
    c = (rnd(bsz * grp, nc, l, n) * 0.3).to(dtype)
    return x, dt, a, b, c


def check_ssd(torch, sk, dev):
    g = torch.Generator(device=dev).manual_seed(6)
    out = []
    for case, (bsz, h, grp, seq, l, p, n, a_val, shift) in SSD_CASES.items():
        nc, bh = seq // l, bsz * h
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, b, c = ssd_inputs(torch, g, dev, dtype, case)
            opts = dict(nheads=h, ngroups=grp)
            got = sk.ssd_chunks_cuda(x, dt, a, b, c, **opts)
            want = sk.ssd_chunks_plain(x, dt, a, b, c, **opts)
            torch.cuda.synchronize()
            # the reference's bound for its kernel against the chunked
            # scan, relative to each output's largest value; kernel and
            # twin share cum (summed in float64) and widen bf16 alike
            errs = [float((u - w).abs().max() / max(1.0, float(
                w.abs().max()))) for u, w in zip(got, want)]
            tol = 1e-4
            finite = all(bool(torch.isfinite(u).all()) for u in got)
            # the function's work and the reference kernel's; the bf16
            # body runs on the tensor cores, the fp32 one on the CUDA
            # cores: each at the peak of the units it can use
            flops, moved, kind = sk.work(x, dt, a, b, c, **opts)
            flops_ref = sk.ssd_flops(bh, bsz * grp, nc, l, p, n)[1]
            b_ms, b_by = bound(moved, flops, kind)
            # yardstick: the three batched products alone, per head, fp32
            rows = sk.group_rows(bh, h, grp, dev)
            xf, bf, cf = x.float(), b.float()[rows], c.float()[rows]
            m = torch.randn(bh, nc, l, l, generator=g, device=dev)

            def products(xf=xf, bf=bf, cf=cf, m=m):
                torch.matmul(cf, bf.transpose(-1, -2))
                torch.matmul(m, xf)
                torch.matmul(xf.transpose(-1, -2), bf)
            name = f"{case}_{'fp32' if dtype == torch.float32 else 'bf16'}"
            rec = {"case": name, "max_abs_err": max(errs), "errs": errs,
                   "tol": tol, "ok": finite and max(errs) <= tol,
                   "ms": time_ms(lambda: sk.ssd_chunks_cuda(
                       x, dt, a, b, c, **opts), iters=10,
                       only="ssd_chunks_kernel"),
                   "plain_ms": time_ms(lambda: sk.ssd_chunks_plain(
                       x, dt, a, b, c, **opts), iters=5),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_reference_ms": bound(moved, flops_ref, kind)[0],
                   "bound_kind": kind,
                   "flops": flops, "flops_reference": flops_ref,
                   "library_ms": None,
                   "products_ms": time_ms(products, iters=5),
                   "shape": {"x": list(x.shape), "b": list(b.shape),
                             "dtype": str(dtype)}}
            log(f"[kernels] ssd_chunks {name}: rel errs (y, states, expcum) "
                f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol}) kernel "
                f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by} at the {kind} peak; at the "
                f"reference kernel's work "
                f"{rec['bound_reference_ms']:.4f}), library n/a, three "
                f"products alone (torch.matmul fp32, yardstick) "
                f"{rec['products_ms']:.4f} ms" + ratio_text(rec))
            out.append(rec)
            del x, dt, a, b, c, got, want, xf, bf, cf, m
    return out


def ssd_bwd_case(torch, g, dev, dtype, case):
    """(args, ups, opts) of an ``SSD_BWD_CASES`` case: the forward's
    inputs in ``dtype`` and random fp32 cotangents of its three outputs,
    from the generator ``g``."""
    bsz, h, grp, seq, l, p, n, _, _ = SSD_CASES[case]
    nc, bh = seq // l, bsz * h
    args = ssd_inputs(torch, g, dev, dtype, case)
    ups = [torch.randn(shape, generator=g, device=dev) for shape in
           ((bh, nc, l, p), (bh, nc, p, n), (bh, nc, l, 1))]
    return args, ups, dict(nheads=h, ngroups=grp)


def ssd_bwd_want(torch, sk, args, ups, opts):
    """The oracle of the SSD backward kernel: autograd of the forward
    twin taken in float64 (``cum`` the same fp32 values)."""
    wide = [t.double().requires_grad_(True) for t in args]
    return torch.autograd.grad(sk.ssd_chunks_plain(*wide, **opts), wide,
                               [u.double() for u in ups])


def ssd_bwd_errors(torch, got, want):
    """(errors, bounds, all within and finite) of the five gradients
    against the float64 oracle: bf16 dx, dB and dC within 2^-7 of the
    largest (the products take bf16 operands), ddt and da and every fp32
    gradient within 1e-4 of max(1, the largest)."""
    errs, tols, ok = [], [], True
    for x, y in zip(got, want):
        big = float(y.abs().max())
        tol = 2 ** -7 * big if x.dtype == torch.bfloat16 else \
            1e-4 * max(1.0, big)
        err = float((x.double() - y).abs().max())
        ok = ok and err <= tol and bool(torch.isfinite(x).all())
        errs.append(err)
        tols.append(tol)
    return errs, tols, ok


def check_ssd_backward(torch, sk, dev):
    """The backward kernel at ``SSD_BWD_CASES`` in fp32 and bf16 against
    the twin's autograd taken in float64 (``ssd_bwd_errors``); finite; two
    calls bit-identical. The oracle is float64 because da is
    ill-conditioned (an error in dcum[t] reaches it times sum_{s<=t}
    dt[s]): at the overflow case the fp32 twin's own da misses 1e-4 of its
    largest against the float64 value
    (``tests/test_torch_ssd_backward.py``). Timed beside its bound, each
    pass's device time, the closed-form twin and the twin's autograd in
    fp32 (the card's SSD backward before the kernel)."""
    g = torch.Generator(device=dev).manual_seed(8)
    out = []
    for case in SSD_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args, ups, opts = ssd_bwd_case(torch, g, dev, dtype, case)
            call = lambda: sk.ssd_chunks_backward_cuda(  # noqa: E731
                *args, *ups, **opts)
            before = sk.SSD_CHUNKS_BWD.launches
            got, again = call(), call()
            launched = sk.SSD_CHUNKS_BWD.launches - before
            want = ssd_bwd_want(torch, sk, args, ups, opts)
            torch.cuda.synchronize()
            same = all(torch.equal(u, w) for u, w in zip(got, again))
            errs, tols, within = ssd_bwd_errors(torch, got, want)
            ok = same and launched == 2 and within
            del got, again, want
            flops, moved, kind = sk.backward_work(*args, **opts)
            b_ms, b_by = bound(moved, flops, kind)

            def twin_autograd():
                leaves = [t.detach().requires_grad_(True) for t in args]
                return torch.autograd.grad(
                    sk.ssd_chunks_plain(*leaves, **opts), leaves, ups)
            name = f"{case}_{'fp32' if dtype == torch.float32 else 'bf16'}"
            rec = {"case": name, "max_abs_err": max(errs), "errors": errs,
                   "tols": tols, "ok": ok, "bit_identical": same,
                   "ms": time_ms(call, iters=10, only="ssd_bwd_"),
                   "passes_ms": split_ms(call, "ssd_bwd_"),
                   "plain_ms": time_ms(lambda: sk.ssd_chunks_backward_plain(
                       *args, *ups, **opts), iters=3),
                   "twin_backward_ms": time_ms(twin_autograd, iters=3),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "flops": flops, "bytes": moved,
                   "shape": {"x": list(args[0].shape),
                             "b": list(args[3].shape), "dtype": str(dtype)}}
            passes = {b: round(ms, 4) for b, ms in
                      (rec["passes_ms"] or {}).items()}
            log(f"[kernels] ssd_chunks_bwd {name}: errors (dx, ddt, da, db, "
                f"dc) {[f'{e:.3e}' for e in errs]} (tols "
                f"{[f'{t:.3e}' for t in tols]}), bit-identical {same}: "
                f"kernel {rec['ms']:.4f} ms (passes {passes}), closed-form "
                f"twin {rec['plain_ms']:.4f} ms, twin's autograd (fp32) "
                f"{rec['twin_backward_ms']:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by} at the {kind} peak), library n/a"
                + ratio_text(rec))
            out.append(rec)
            del args, ups
    return out


# ---------------------------------------------------------------------------
# phase 3 and 4: the main path
# ---------------------------------------------------------------------------


def qkv_ring_hops(cfg, n_pe: int) -> int:
    """Tile matmuls of one layer's QKV ring (n hops x 3 sinks), or 0 where
    its gate refuses the ring because the heads or the KV heads do not
    split ``n_pe`` ways (the sequence always does here)."""
    return 3 * n_pe if (cfg.num_heads % n_pe == 0
                        and cfg.num_kv_heads % n_pe == 0) else 0


def ring_expect(cfg, n_pe: int, passes: int = 1) -> dict:
    """Launches of one dense-decoder prefill (``passes`` 2: a training step
    under remat "full"), reckoned from the code: per layer the QKV ring,
    the FFN rings (AG n x 2, RS n) on the tile matmul and ring attention's
    n flash hops."""
    return {"tile_matmul": passes * cfg.num_layers
            * (qkv_ring_hops(cfg, n_pe) + 3 * n_pe),
            "flash_carry": passes * cfg.num_layers * n_pe}


def with_backward(expect: dict, remat: str) -> dict:
    """A training step's launches ``expect`` (forward and remat recompute)
    with the backward kernels': the flash backward's once per hop the step
    differentiates (the forward's flash launches; every remat but "none"
    runs each hop a second time, the kernels being no aten products), the
    SSD backward's as ``expect`` reckons it (once per Mamba2 layer; none
    without one)."""
    passes = 1 if remat == "none" else 2
    return {**expect,
            "flash_carry_bwd": expect.get("flash_carry", 0) // passes,
            "ssd_chunks_bwd": expect.get("ssd_chunks_bwd", 0)}


def serve_full_width(torch, kernels, dev, arch: str = "qwen3-0.6b",
                     n_pe: int = N_PE):
    """``ServeEngine`` over ``RingShardedBackend(n_pe, "qlr")``, ``arch`` at
    full width and depth, bf16 (phase 3; phase 12 (e) for qwen3-14b; phase
    13 (a) for internvl2-1b on the ring of 2)."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded_cache import RingShardedBackend

    cfg = get_config(arch)
    params = build_model(cfg).init(seed=0, device=dev)
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=MAX_SEQ,
                       prefill_chunk=CHUNK)
    backend = RingShardedBackend(cfg, scfg, params, n_pe, "qlr", device=dev)
    engine = ServeEngine(cfg, scfg, params, backend=backend, device=dev)
    rng = np.random.default_rng(0)

    def prompt():
        return rng.integers(0, cfg.vocab_size,
                            int(rng.integers(64, 257))).astype(np.int32)

    requests = [engine.sched.submit(prompt(), 16) for _ in range(BATCH)]
    late = [prompt() for _ in range(4)]

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick = 0
    while engine.sched.busy or late:
        if tick == 4 and late:                   # admitted mid-run
            requests += [engine.sched.submit(p, 8) for p in late]
            late = []
        engine._admit()
        engine.step()
        tick += 1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    tokens = int(engine.metrics.counter("repro_tokens_total").value)
    prefill_tokens = int(engine.metrics.counter(
        "repro_prefill_tokens_total").value)

    assert len(requests) == 12
    for r in requests:
        assert r.status == "done", (r.rid, r.status)
        assert len(r.out_tokens) == r.max_new_tokens, r.rid
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"

    # per-call launch counts, after the main path's counts were read
    per_call = {}
    slot = 0
    before = {k.name: k.launches for k in kernels}
    backend.prefill(slot, prompt()[:CHUNK])
    torch.cuda.synchronize()
    per_call["prefill"] = {k.name: k.launches - before[k.name]
                           for k in kernels}
    before = {k.name: k.launches for k in kernels}
    logits = backend.step(np.zeros((BATCH, 1), np.int32),
                          np.ones(BATCH, bool))
    torch.cuda.synchronize()
    per_call["decode_step"] = {k.name: k.launches - before[k.name]
                               for k in kernels}
    # a block prefill runs the rings as ``prefill`` does; a decode step
    # ring decode attention's n_pe flash hops
    expect = {"prefill": ring_expect(cfg, n_pe),
              "decode_step": {"tile_matmul": 0,
                              "flash_carry": n_pe * cfg.num_layers}}
    for call, want in expect.items():
        got = {k: v for k, v in per_call[call].items() if k in want}
        assert got == want, (arch, call, got, want)
    assert logits.shape == (BATCH, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    breakdown = {
        "prefill": profile(torch, lambda: backend.prefill(
            slot, prompt()[:CHUNK])),
        "decode_step": profile(torch, lambda: backend.step(
            np.zeros((BATCH, 1), np.int32), np.ones(BATCH, bool))),
    }
    result = {"arch": arch, "layers": cfg.num_layers, "n_pe": n_pe,
              "requests": len(requests), "ticks": tick, "tokens": tokens,
              "prefill_tokens": prefill_tokens, "seconds": elapsed,
              "tokens_per_s": tokens / elapsed,
              "launches": launches, "launches_per_call": per_call,
              "expected_per_call": expect,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "breakdown": breakdown}
    log(f"[serve] {json.dumps(result)}")
    return result


def label_ms(prof, label: str) -> float:
    """Device time of the kernels launched inside every host range named
    ``label`` (a ``record_function`` label), children included."""
    total = 0.0
    for evt in prof.events():
        if evt.name == label and not str(
                getattr(evt, "device_type", "")).endswith("CUDA"):
            us = getattr(evt, "device_time_total", None)
            total += us if us is not None else evt.cuda_time_total
    return total / 1e3


def profile(torch, fn, top: int = 6, labels=(), warm: bool = True) -> dict:
    """Device time by kernel and by the aten op that launched it for one
    call under ``torch.profiler``, and the device's idle share of the
    call's wall time (one stream, so kernel times add up to the busy
    time); with ``labels``, the device time under each of those
    ``record_function`` ranges (with its kernel's, ``LABEL_KERNELS``).
    ``warm=False`` when ``fn`` already ran."""
    from torch.profiler import ProfilerActivity
    if warm:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    rows = _kernel_rows(averages)
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "device": "not measured"}
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top": [{"kernel": k[:80], "ms": ms, "count": n}
                   for k, ms, n in rows[:top]],
           "top_ops": [{"op": k[:60], "ms": ms, "count": n}
                       for k, ms, n in _kernel_rows(averages,
                                                    ops=True)[:top]],
           "kernel_ms": {name: sum(ms for k, ms, _ in rows if name in k)
                         for name in ("flash_carry_kernel",
                                      "flash_carry_bwd_kernel",
                                      "tile_matmul_kernel",
                                      "ssd_chunks_kernel", "ssd_bwd_")},
           "label_ms": {label: label_ms(prof, label) + sum(
               ms for k, ms, _ in rows if label in LABEL_KERNELS
               and LABEL_KERNELS[label] in k) for label in labels}}
    log(f"[profile] {json.dumps(out)}")
    return out


def modes_agree(torch, dev, arch: str = "qwen3-0.6b"):
    """One block prefill and one decode step of ``arch`` at full width, 4
    layers, fp32: the ring backends (qlr, xqueue, sw) against the dense
    one (phase 4; phase 12 (e) for qwen3-14b)."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend

    cfg = replace(get_config(arch), num_layers=4, dtype="float32",
                  param_dtype="float32")
    params = build_model(cfg).init(seed=1, device=dev)
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=MAX_SEQ,
                       prefill_chunk=CHUNK)
    rng = np.random.default_rng(1)
    chunk = torch.as_tensor(rng.integers(0, cfg.vocab_size, CHUNK)
                            .astype(np.int32), device=dev)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
    active = np.ones(BATCH, bool)

    def run(backend):
        with torch.inference_mode():
            logit, _ = backend.model.prefill_into_cache(
                backend.params, backend.cache, chunk, 3, 200)
        return logit.clone(), backend.step(toks, active).clone()

    dense = run(DecodeBackend(cfg, scfg, params, device=dev))
    tol = 2e-3          # tests/test_parity.py's fp32 bound
    errs = {}
    for mode in ("qlr", "xqueue", "sw"):
        got = run(RingShardedBackend(cfg, scfg, params, N_PE, mode,
                                     device=dev))
        errs[mode] = [float((g - w).abs().max() /
                            max(1.0, float(w.abs().max())))
                      for g, w in zip(got, dense)]
        log(f"[modes] {arch} {mode}: prefill logits rel err "
            f"{errs[mode][0]:.3e}, "
            f"decode logits rel err {errs[mode][1]:.3e} (tol {tol})")
        assert max(errs[mode]) <= tol, (mode, errs[mode])
        assert all(bool(torch.isfinite(x).all()) for x in got)
    return errs


# ---------------------------------------------------------------------------
# phase 5: the DSP suite
# ---------------------------------------------------------------------------

DSP_MODES = ("baseline", "sw", "xqueue", "qlr")
# card scale: the conv2d image edge, the chain strips' image [H, W], the
# cfft microbatch count and the Cannon matmul edge
CARD = {"conv": 8192, "chains": (8192, 8192), "fft_m": 1024, "matmul": 8192}


def dsp_run(torch, kernels, workload, size, call, check, expect, flops,
            reps, profiled=False):
    """Run ``call(mode)`` in every mode: the first call's launches must be
    ``expect(mode)`` per kernel and its values those of the baseline and
    within ``check``; then ``reps`` calls give the wall time per call.
    ``profiled``: one more qlr call under ``torch.profiler`` gives the
    device time by kernel and the idle share."""
    rows, base = [], None
    for mode in DSP_MODES:
        before = {k.name: k.launches for k in kernels}
        y = call(mode)
        torch.cuda.synchronize()
        launched = {k.name: k.launches - before[k.name] for k in kernels}
        want = {k.name: expect(mode).get(k.name, 0) for k in kernels}
        assert launched == want, (workload, size, mode, launched, want)
        if base is None:
            base, err = y, check(y)
        else:
            assert torch.equal(y, base), (workload, size, mode,
                                          "values differ from baseline")
        del y
        t0 = time.perf_counter()
        for _ in range(reps):
            call(mode)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
        rows.append({"workload": workload, "size": size, "mode": mode,
                     "wall_ms": wall * 1e3, "gops_per_s": flops / wall / 1e9,
                     "launches_per_call": {k: v for k, v in launched.items()
                                           if v}, "max_rel_err": err})
        log(f"[dsp] {workload} {size} {mode}: {wall * 1e3:.3f} ms/call, "
            f"{flops / wall / 1e9:.2f} GOP/s, launches "
            f"{rows[-1]['launches_per_call']}, rel err vs plain ref "
            f"{err:.2e}")
        if profiled and mode == "qlr":
            rows[-1]["breakdown"] = profile(torch, lambda: call(mode))
    return rows


def dsp_suite(torch, kernels, dev):
    """The paper's three DSP kernels on the emulated PE axis, fp32, at the
    MemPool sizes of ``configs/mempool_dsp.py`` and at card scale."""
    from repro_torch.configs.mempool_dsp import CFFT, CONV2D, MATMUL
    from repro_torch.core import collective_matmul as cm
    from repro_torch.core import fft, halo, pipeline
    g = torch.Generator(device=dev).manual_seed(5)
    conv, fftk, mm = "conv2d_3x3", "fft_stage", "tile_matmul"
    kern = torch.randn(3, 3, generator=g, device=dev)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def within(tol, err):
        assert err <= tol, (err, tol)
        return err

    rows = []
    # conv2d_systolic: one conv launch per call (baseline: the whole image)
    sizes = {"mempool": (CONV2D.H, CONV2D.W, 20),
             "card": (CARD["conv"], CARD["conv"], 5)}
    for size, (h, w, reps) in sizes.items():
        x = torch.randn(h, w, generator=g, device=dev)
        want = halo.conv2d_ref(x, kern)
        rows += dsp_run(
            torch, kernels, "conv2d_systolic", f"{size} {h}x{w} P=256",
            lambda mode, x=x: halo.conv2d_systolic(x, kern, 256, mode),
            lambda y, want=want: within(1e-4, rel(y, want)),
            lambda mode: {conv: 1}, 2 * 9 * h * w, reps, size == "card")
        del x, want
    # conv2d chains (bench_conv2d_chains.py:46-60): 8 PEs, 16 microbatch
    # strips; each stage convolves its strip with zero halos
    def stage_fn(_p, x, _i):
        return halo.conv2d_3x3_local(x, None, None, kern)

    for size, (h, w, reps) in {"mempool": (256, 128, 10),
                               "card": (*CARD["chains"], 3)}.items():
        xs = torch.randn(16, h // 16, w, generator=g, device=dev)
        for n_chains in (1, 2, 4):
            n_stages = 8 // n_chains
            want = xs.clone()
            for _ in range(n_stages):
                want = torch.stack([halo.conv2d_ref(v, kern) for v in want])
            ticks = 16 // n_chains + n_stages - 1
            rows += dsp_run(
                torch, kernels, f"conv2d_chains{n_chains}",
                f"{size} 16x{h // 16}x{w} P=8",
                lambda mode, xs=xs, k=n_chains: pipeline.pipelined(
                    stage_fn, 8, 16, mode, k)(None, xs),
                lambda y, want=want: within(1e-4, rel(y, want)),
                lambda mode, s=n_stages, t=ticks: {
                    conv: s if mode == "baseline" else t},
                n_stages * 2 * 9 * h * w, reps,
                size == "card" and n_chains == 1)
            del want
        del xs
    # pipelined_fft: M + 3 stage launches per call (baseline: one fft256)
    n = CFFT.fft_points
    for size, (m, reps) in {"mempool": (8, 20),
                            "card": (CARD["fft_m"], 3)}.items():
        xs = torch.complex(
            torch.randn(m, CFFT.fft_batch, n, generator=g, device=dev),
            torch.randn(m, CFFT.fft_batch, n, generator=g, device=dev))
        want = torch.fft.fft(xs, dim=-1)
        rows += dsp_run(
            torch, kernels, "pipelined_fft",
            f"{size} {m}x{CFFT.fft_batch}x{n} P=4",
            lambda mode, xs=xs: fft.pipelined_fft(xs, 4, mode, n),
            lambda y, want=want: within(1e-3, rel(y, want)),
            lambda mode, m=m: {fftk: 1 if mode == "baseline" else m + 3},
            m * CFFT.fft_batch * 8 * n * np.log2(n), reps, size == "card")
        del xs, want
    # Cannon on a 16x16 fold: 16 tile_matmul launches per call
    for size, (d, reps) in {"mempool": (MATMUL.M, 10),
                            "card": (CARD["matmul"], 2)}.items():
        a = torch.randn(d, d, generator=g, device=dev)
        b = torch.randn(d, d, generator=g, device=dev)
        want = a @ b
        rows += dsp_run(
            torch, kernels, "cannon_matmul", f"{size} {d}^3 P=16x16",
            lambda mode, a=a, b=b: cm.systolic_cannon(a, b, 16, mode),
            lambda y, want=want: within(1e-4, rel(y, want)),
            lambda mode: {mm: 16}, 2 * d ** 3, reps, size == "card")
        del a, b, want
    return rows


# ---------------------------------------------------------------------------
# phases 6 to 8: Mamba2
# ---------------------------------------------------------------------------

MAMBA_PROMPTS, MAMBA_SEQ = 4, 2048


def mamba_prefill(torch, kernels, sk, dev, reps: int = 3):
    """Full-width, full-depth prefill, counted and timed."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-1.3b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    rng = np.random.default_rng(6)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (MAMBA_PROMPTS, MAMBA_SEQ)), device=dev)
    with torch.inference_mode():
        model.prefill(params, tokens)                # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            logits = model.prefill(params, tokens)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {k.name: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated() / 1e9
        assert launches[sk.SSD_CHUNKS.name] == reps * cfg.num_layers, \
            launches
        assert logits.shape == (MAMBA_PROMPTS, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        breakdown = profile(torch, lambda: model.prefill(params, tokens),
                            top=8)
    wall = sorted(walls)[len(walls) // 2]
    result = {"prompts": MAMBA_PROMPTS, "seq": MAMBA_SEQ,
              "layers": cfg.num_layers, "walls_s": walls, "wall_s": wall,
              "tokens_per_s": MAMBA_PROMPTS * MAMBA_SEQ / wall,
              "launches": launches,
              "launches_per_call": {k: n // reps
                                    for k, n in launches.items()},
              "peak_mem_gb": peak, "breakdown": breakdown}
    log(f"[mamba-prefill] {json.dumps(result)}")
    return result


def mamba_parity(torch, sk, dev):
    """Prefill against token-by-token decode, 4 layers, fp32."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("mamba2-1.3b"), num_layers=4, dtype="float32",
                  param_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=1, device=dev)
    rng = np.random.default_rng(7)
    tol = 2e-3               # tests/test_parity.py's bound
    errs = {}
    with torch.inference_mode():
        for seq in (256, 512):                      # one and two chunks
            tokens = torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (2, seq)), device=dev)
            before = sk.SSD_CHUNKS.launches
            want = model.prefill(params, tokens)
            assert sk.SSD_CHUNKS.launches == before + cfg.num_layers
            cache = model.init_cache(2, seq, device=dev)
            for t in range(seq):
                got, cache = model.decode_step(params, cache,
                                               tokens[:, t:t + 1])
            diff = (got - want).abs()
            excess = float((diff - tol * want.abs()).max())  # vs atol
            errs[seq] = {"max_abs_err": float(diff.max()),
                         "max_err_less_rtol_share": excess}
            log(f"[mamba-parity] {seq} tokens: prefill vs decode max abs "
                f"err {float(diff.max()):.3e} (atol {tol} + rtol {tol})")
            assert excess <= tol, (seq, errs[seq])
            assert bool(torch.isfinite(got).all())
    return errs


def mamba_serve(torch, kernels, sk, dev):
    """ServeEngine over DecodeBackend at full width and depth."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded_cache import DecodeBackend
    cfg = get_config("mamba2-1.3b")
    params = build_model(cfg).init(seed=0, device=dev)
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=128, prefill_chunk=CHUNK)
    backend = DecodeBackend(cfg, scfg, params, device=dev)
    assert backend.prefill_len(64) == 0, "Mamba2 has no block prefill"
    engine = ServeEngine(cfg, scfg, params, backend=backend, device=dev)
    rng = np.random.default_rng(8)

    def prompt():
        return rng.integers(0, cfg.vocab_size,
                            int(rng.integers(16, 65))).astype(np.int32)

    requests = [engine.sched.submit(prompt(), 16) for _ in range(BATCH)]
    late = [prompt() for _ in range(2)]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick = 0
    while engine.sched.busy or late:
        if tick == 4 and late:                   # admitted mid-run
            requests += [engine.sched.submit(p, 16) for p in late]
            late = []
        engine._admit()
        engine.step()
        tick += 1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    tokens = int(engine.metrics.counter("repro_tokens_total").value)
    assert len(requests) == BATCH + 2
    for r in requests:
        assert r.status == "done", (r.rid, r.status)
        assert len(r.out_tokens) == r.max_new_tokens, r.rid
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
    result = {"requests": len(requests), "ticks": tick, "tokens": tokens,
              "prompt_tokens_streamed": int(sum(len(r.prompt)
                                                for r in requests)),
              "seconds": elapsed, "tokens_per_s": tokens / elapsed,
              "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("[mamba-serve] prompts stream through decode_step: the reference "
        "has no Mamba block prefill, so the SSD kernel is not on this path "
        f"(launches {launches})")
    log(f"[mamba-serve] {json.dumps(result)}")
    return result


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------


def train_flops(cfg, n_nonembed: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recomputation): 6 per parameter and token outside the embedding, the
    tied LM head's 6*D*V per token, and causal attention's 6*L*H*hd*S per
    token (12*L*H*hd*S for full attention, halved)."""
    hd = cfg.resolved_head_dim
    return tokens * (6 * n_nonembed + 6 * cfg.d_model * cfg.vocab_size
                     + 6 * cfg.num_layers * cfg.num_heads * hd * seq)


def train_full_width(torch, kernels, dev):
    """qwen3-0.6b at full width and depth, bf16 with fp32 master weights,
    remat "full", on the ring of 4 in qlr: ``train_steps`` of TRAIN_STEPS
    AdamW steps of 8 x 1024 tokens from ``DataLoader(SyntheticLM(seed=0))``
    (the loss must fall), and one more step profiled; the median step
    after the first gives the rate and the MFU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataLoader, SyntheticLM

    cfg = replace(get_config("qwen3-0.6b"), systolic_mode="qlr",
                  remat="full")
    loader = DataLoader(SyntheticLM(cfg.vocab_size, seed=0), TRAIN_BATCH,
                        TRAIN_SEQ)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in next(loader).items()}
               for _ in range(TRAIN_STEPS + 1)]
    loader.close()
    # the "full" remat recomputes every block once in the backward
    fwd = ring_expect(cfg, N_PE)
    expect = {k: 2 * n for k, n in fwd.items()}
    for k in kernels:
        k.launches = 0
    result = train_steps(torch, kernels, cfg, N_PE, batches[:-1], dev,
                         expect, "train", profiled=batches[-1])
    losses = result["losses"]
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, result["params"]
                        - cfg.vocab_size * cfg.d_model, tokens, TRAIN_SEQ)
    steady = sorted(result["step_ms"][1:])
    median_ms = steady[len(steady) // 2]
    result.update({"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                   "median_step_ms": median_ms,
                   "tokens_per_s": tokens / (median_ms / 1e3),
                   "model_flops": flops,
                   "train_mfu": flops / (median_ms / 1e3
                                         * PEAK_FLOPS["bf16"])})
    log(f"[train] median step {median_ms:.1f} ms, "
        f"{result['tokens_per_s']:.0f} tokens/s, MFU "
        f"{result['train_mfu']:.4f}")
    return result


def train_parity(torch, dev):
    """4 layers of qwen3-0.6b at full width, fp32, B=2, S=512: the loss and
    every gradient of the ring path (kernels) in sw, xqueue and qlr against
    the dense path (no kernel), within 1e-4 and 1e-3
    (``tests/multidev/check_systolic_model.py``); the modes agree bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib

    cfg = replace(get_config("qwen3-0.6b"), num_layers=4, dtype="float32",
                  param_dtype="float32")
    params = build_model(cfg).init(seed=2, device=dev)
    raw = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 513))
    batch = {"tokens": torch.as_tensor(raw[:, :-1], device=dev),
             "targets": torch.as_tensor(raw[:, 1:], device=dev)}

    def run(mode, n_pe):
        model = build_model(replace(cfg, systolic_mode=mode), n_pe=n_pe)
        loss, _, grads = step_lib.value_and_grad(model, params, batch)
        return loss, opt.tree_leaves(grads)

    base_loss, base_grads = run("baseline", 0)
    out, runs = {}, {}
    for mode in ("sw", "xqueue", "qlr"):
        loss, grads = runs[mode] = run(mode, N_PE)
        dl = abs(float(loss) - float(base_loss))
        dg = max(float((a - b).abs().max())
                 for a, b in zip(grads, base_grads))
        out[mode] = {"dl": dl, "dg": dg}
        log(f"[train-parity] {mode}: loss {float(loss):.6f} (dense "
            f"{float(base_loss):.6f}), dl={dl:.3e} (tol 1e-4), "
            f"dg={dg:.3e} (tol 1e-3)")
        assert dl < 1e-4 and dg < 1e-3, (mode, dl, dg)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    ref_loss, ref_grads = runs["qlr"]
    for mode in ("sw", "xqueue"):
        loss, grads = runs[mode]
        same = bool(torch.equal(loss, ref_loss)) and all(
            torch.equal(a, b) for a, b in zip(grads, ref_grads))
        out[mode]["bit_identical_to_qlr"] = same
        assert same, f"{mode} differs from qlr"
    return out


# ---------------------------------------------------------------------------
# phase 10: the serving launcher
# ---------------------------------------------------------------------------

LAUNCH_REQUESTS = 8
LAUNCH_NEW = 16
LAUNCH_ARGS = ["--arch", "qwen3-0.6b", "--full", "--backend", "ring",
               "--n-pe", str(N_PE), "--mode", "qlr", "--max-batch",
               str(BATCH), "--max-seq", str(MAX_SEQ), "--prefill-chunk",
               str(CHUNK), "--requests", str(LAUNCH_REQUESTS), "--max-new",
               str(LAUNCH_NEW)]
OBSERVERS = ["--checked", "--monitor", "--telemetry"]
CHAOS_KINDS = ("corrupt", "drop", "stale", "slow")
CHAOS_REQUESTS = 4
CHAOS_NEW = 8
FAULT_TICK = 3                     # decode tick 3 (from 0): hop 1, PE 2


def launcher_prompts(cfg, n: int):
    """The launcher's prompts: ``np.random.default_rng(0)``, 2-11 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=rng.integers(2, 12))
            .astype(np.int32) for _ in range(n)]


def drive_engine(torch, kernels, eng, prompts, max_new, fault=None,
                 degrade_at=None):
    """Serve ``prompts`` to completion tick by tick. At tick
    ``FAULT_TICK`` arm ``fault`` for one guarded step, or (``degrade_at``)
    force the ladder down three rungs first. Per tick: the launches of the
    admissions (block prefills) and of the step, and the step's wall ms
    (the tick ends synchronized: sampling copies the tokens to the host)."""
    from repro_torch.core import faults
    reqs = [eng.sched.submit(p, max_new) for p in prompts]
    admits, steps, step_ms = [], [], []

    def counts():
        return {k.name: k.launches for k in kernels}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick = 0
    while eng.sched.busy:
        c0 = counts()
        n_pre = eng.metrics.histogram("repro_prefill_latency_seconds").count
        eng._admit()
        c1 = counts()
        n_pre = eng.metrics.histogram(
            "repro_prefill_latency_seconds").count - n_pre
        if n_pre:
            admits.append({"prefills": n_pre, **{
                k: c1[k] - c0[k] for k in c0}})
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        if tick == FAULT_TICK and degrade_at:
            for _ in range(3):
                eng.monitor.force_degrade()
            eng.step()
        elif tick == FAULT_TICK and fault is not None:
            with faults.inject(fault):
                eng.step()
        else:
            eng.step()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        steps.append({k: v - c1[k] for k, v in counts().items()})
        tick += 1
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in reqs)
    return {"reqs": reqs, "tokens": [tuple(r.out_tokens) for r in reqs],
            "admits": admits, "steps": steps, "step_ms": step_ms,
            "seconds": seconds, "tokens_per_s": tokens / seconds,
            "median_step_ms": float(np.median(step_ms)),
            "backend": eng.backend.name}


def serve_launcher(torch, kernels, dev, card: str):
    """Phase 10: (a) ``repro_torch.launch.serve.main`` at full width with
    checked links, the monitor and telemetry; (b) the same requests plain
    and observed, same tokens and launches; (c) chaos: every fault kind at
    decode tick 3, hop 1, PE 2 recovers down the ladder bitwise; (d) the
    observers' overhead, the snapshot clone's device ms and the paper's
    utilization model over the run's counters."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.core import faults
    from repro_torch.launch import serve as launch
    from repro_torch.models import build_model
    from repro_torch.obs import utilization
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.health import HealthConfig
    from repro_torch.serve.sharded_cache import RingShardedBackend
    from repro_torch.train.optimizer import tree_leaves

    out_dir = ROOT / "build" / "serve_launcher"
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics_path = out_dir / "metrics.json"
    trace_path = out_dir / "trace.json"

    # (a) the launcher, as a user runs it
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine, reqs = launch.main(
        LAUNCH_ARGS + OBSERVERS + ["--device", str(dev), "--metrics-out",
                                   str(metrics_path), "--trace-out",
                                   str(trace_path)])
    torch.cuda.synchronize()
    launcher_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    assert len(reqs) == LAUNCH_REQUESTS
    for r in reqs:
        assert r.status == "done" and len(r.out_tokens) == LAUNCH_NEW, \
            (r.rid, r.status)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched by the launcher"
    counters = json.loads(metrics_path.read_text())["counters"]
    assert counters["repro_link_pushes_total"] > 0, counters
    for err in ("tag_errors", "csum_errors", "faulty_hops"):
        assert counters[f"repro_link_{err}_total"] == 0, counters
    spans = {e["name"] for e in
             json.loads(trace_path.read_text())["traceEvents"]}
    assert {"decode", "probe"} <= spans, spans
    assert engine.monitor.events == [], engine.monitor.events
    link_stats = engine.backend.link_stats()
    del engine

    # (b) and (d): plain and observed in turns, the same requests
    cfg = get_config("qwen3-0.6b")
    params = build_model(cfg).init(seed=0, device=dev)
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=MAX_SEQ,
                       prefill_chunk=CHUNK)

    def engine_for(observed: bool):
        be = RingShardedBackend(cfg, scfg, params, N_PE, "qlr",
                                checked=observed, telemetry=observed,
                                device=dev)
        return ServeEngine(cfg, scfg, params, backend=be, device=dev,
                           health=HealthConfig() if observed else None)

    prompts = launcher_prompts(cfg, LAUNCH_REQUESTS)
    runs = {"plain": [], "observed": []}
    for side in ("plain", "observed", "observed", "plain", "plain",
                 "observed"):
        runs[side].append(drive_engine(torch, kernels,
                                       engine_for(side == "observed"),
                                       prompts, LAUNCH_NEW))
    plain, observed = runs["plain"][0], runs["observed"][0]
    for run in runs["plain"] + runs["observed"]:
        assert run["tokens"] == plain["tokens"], "observers changed tokens"
        assert run["admits"] == plain["admits"], \
            (run["admits"], plain["admits"])
        assert run["steps"] == plain["steps"], "observers changed launches"
    per_prefill = {k: v // plain["admits"][0]["prefills"]
                   for k, v in plain["admits"][0].items() if k != "prefills"}
    per_decode = plain["steps"][-1]

    # (c) chaos: the ladder recovers bitwise
    chaos_prompts = launcher_prompts(cfg, CHAOS_REQUESTS)
    clean = drive_engine(torch, kernels, engine_for(True), chaos_prompts,
                         CHAOS_NEW, degrade_at=True)
    assert clean["backend"] == "ring-baseline+checked", clean["backend"]
    chaos = {}
    for kind in CHAOS_KINDS:
        eng = engine_for(True)
        run = drive_engine(torch, kernels, eng, chaos_prompts, CHAOS_NEW,
                           fault=faults.FaultSpec(kind, hop=1, device=2,
                                                  seed=7))
        events = [(e.tick, e.kind) for e in eng.monitor.events]
        chaos[kind] = {"backend": run["backend"], "events": events,
                       "bitwise": run["tokens"] == clean["tokens"]}
        log(f"[launcher] chaos {kind}: {json.dumps(chaos[kind])}")
        assert run["backend"] == "ring-baseline+checked", (kind, run)
        assert all(r.status == "done" for r in run["reqs"]), kind
        assert events == [(FAULT_TICK + 1, k) for k in
                          ("link_fault", "degrade") * 3], (kind, events)
        assert chaos[kind]["bitwise"], (kind, run["tokens"], clean["tokens"])

    # (d) what the observers add to a tick, measured alone: the snapshot
    # clone (CUDA events over 10 clones; the profiler's sum beside it) and
    # the probe (host clock, synchronized: it reads its health)
    be = RingShardedBackend(cfg, scfg, params, N_PE, "qlr", checked=True,
                            device=dev)
    snapshot_ms = event_ms(torch, be.snapshot_cache, iters=10)
    snapshot_profiled_ms = time_ms(be.snapshot_cache, iters=10)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in be.cache["layers"].values())
    cache_gb = cache_bytes / 1e9
    snapshot_bound_ms = bound(2 * cache_bytes, 0, "bf16")[0]
    probe_ms = []
    for _ in range(20):
        t1 = time.perf_counter()
        be._probe_links(faults.no_fault_vec())
        probe_ms.append((time.perf_counter() - t1) * 1e3)
    del be
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_nonembed = n_params - params["embed"]["table"].numel()
    computed = (len(reqs) * BATCH * CHUNK
                + int(counters["repro_ticks_total"]) * BATCH)
    flops = 2.0 * (n_nonembed + cfg.d_model * cfg.vocab_size) * computed
    rep = utilization.report(link_stats, flops=flops, mode="qlr")
    table = utilization.table([rep])
    overhead = {side: {"median_step_ms": [r["median_step_ms"]
                                          for r in runs[side]],
                       "tokens_per_s": [r["tokens_per_s"] for r in runs[side]]}
                for side in runs}
    result = {"card": card, "launcher_seconds": launcher_s,
              "launches": launches, "link_stats": link_stats,
              "launches_per_call": {"prefill": per_prefill,
                                    "decode_step": per_decode},
              "overhead": overhead, "chaos": chaos,
              "snapshot_ms": snapshot_ms,
              "snapshot_profiled_ms": snapshot_profiled_ms,
              "snapshot_bound_ms": snapshot_bound_ms,
              "probe_median_ms": float(np.median(probe_ms)),
              "cache_gb": cache_gb,
              "utilization": {"flops": flops, "tokens_computed": computed,
                              "util": rep.utilization,
                              "gops_per_w_modeled": rep.gops_per_w}}
    log(f"[launcher] {card}: {json.dumps(result)}")
    log(f"[launcher] {card}: decode tick median ms plain "
        f"{overhead['plain']['median_step_ms']} vs observed "
        f"{overhead['observed']['median_step_ms']}; tokens/s plain "
        f"{overhead['plain']['tokens_per_s']} vs observed "
        f"{overhead['observed']['tokens_per_s']}; snapshot clone "
        f"{snapshot_ms:.4f} ms (CUDA events; profiler "
        f"{snapshot_profiled_ms:.4f}, bound {snapshot_bound_ms:.4f}) for "
        f"{cache_gb:.3f} GB; probe {np.median(probe_ms):.3f} ms host")
    log(f"[launcher] paper model over the launcher run's counters "
        f"(qlr, {flops:.4g} FLOPs):\n{table}")
    return result


# ---------------------------------------------------------------------------
# phase 11: the MoE family (mixtral-8x22b) and the 2-D grid schedules
# ---------------------------------------------------------------------------


def moe_prefill(torch, kernels, dev, reps: int = 3):
    """(a) mixtral-8x22b at full width, MOE_LAYERS layers, bf16, random
    weights from seed 0, on the ring of 4 in qlr: ``prefill`` of
    MOE_BATCH x MOE_SEQ tokens (the window bites past 4096). Returns the
    result and the parameters (phase 11 (d) serves with them)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import tree_leaves
    cfg = replace(get_config("mixtral-8x22b"), num_layers=MOE_LAYERS,
                  systolic_mode="qlr")
    model = build_model(cfg, n_pe=N_PE)
    params = model.init(seed=0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params["layers"]))
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ)), device=dev)
    # per layer, reckoned from the code: the QKV ring (N_PE hops x 3
    # sinks) and the expert FFN (3 launches over all experts) launch the
    # tile matmul, ring attention the flash hop N_PE times
    expect = {"tile_matmul": cfg.num_layers * (qkv_ring_hops(cfg, N_PE) + 3),
              "flash_carry": cfg.num_layers * N_PE}
    with torch.inference_mode():
        walls, per_call, peak, breakdown, logits = timed_calls(
            torch, kernels, lambda: model.prefill(params, tokens), expect,
            reps)
        assert logits.shape == (MOE_BATCH, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
    wall = sorted(walls)[len(walls) // 2]
    result = {"layers": cfg.num_layers, "batch": MOE_BATCH, "seq": MOE_SEQ,
              "layer_params": n_params, "walls_s": walls, "wall_s": wall,
              "tokens_per_s": MOE_BATCH * MOE_SEQ / wall,
              "launches": {k: sum(c[k] for c in per_call)
                           for k in per_call[0]},
              "launches_per_call": per_call[-1],
              "expected_per_call": expect, "peak_mem_gb": peak,
              "breakdown": breakdown}
    log(f"[moe-prefill] {json.dumps(result)}")
    return result, cfg, params


def serve_lockstep(torch, kernels, cfg, scfg, params, dev, prompts,
                   late=()):
    """``ServeEngine`` over ``DecodeBackend``, then over
    ``RingShardedBackend(N_PE, "qlr")``, on ``prompts`` (and ``late``,
    submitted at tick 4 into whatever slots free up), LAUNCH_NEW new
    tokens each, in lockstep: the dense backend's greedy token is
    committed to both, so both see the same tokens at every tick. Every
    request must finish. The ring backend must pick the dense token unless
    the dense top two logits are an fp near-tie (5e-3 of their scale).
    Returns (per-backend stats with each run's launches, and under
    ``agreement`` the largest logit difference of a sampled row and the
    smallest dense top-two gap, both relative to the row's scale; sampled
    positions, same tokens, the near-ties' gaps relative to their
    scale)."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded_cache import DecodeBackend, RingShardedBackend
    records, stats = {}, {}
    for name in ("dense", "ring"):
        backend = RingShardedBackend(cfg, scfg, params, N_PE, "qlr",
                                     device=dev) if name == "ring" \
            else DecodeBackend(cfg, scfg, params, device=dev)
        assert backend.prefill_len(11) == 0, "prompts must stream"
        eng = ServeEngine(cfg, scfg, params, backend=backend, device=dev)
        reqs = [eng.sched.submit(p, LAUNCH_NEW) for p in prompts]
        commit = records.get("dense")
        rec = []
        before = {k.name: k.launches for k in kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.sched.busy or len(reqs) < len(prompts) + len(late):
            if len(rec) == 4:                        # admitted mid-run
                reqs += [eng.sched.submit(p, LAUNCH_NEW) for p in late]
            eng._admit()
            toks, active, sampling = eng.sched.plan()
            logits = eng.backend.step(toks, active).float().cpu().numpy()
            nxt = logits.argmax(-1) if commit is None else \
                commit[len(rec)][2]
            eng.sched.commit(sampling, nxt)
            rec.append((sampling, logits, nxt))
        seconds = time.perf_counter() - t0
        assert all(r.status == "done" and len(r.out_tokens) == LAUNCH_NEW
                   for r in reqs), name
        records[name] = rec
        stats[name] = {"ticks": len(rec), "seconds": seconds,
                       "tick_ms": seconds / len(rec) * 1e3,
                       "tokens_per_s": len(reqs) * LAUNCH_NEW / seconds,
                       "launches": {k.name: k.launches - before[k.name]
                                    for k in kernels}}
        del backend, eng
    assert len(records["ring"]) == len(records["dense"])
    sampled = same = 0
    gaps = []
    worst_err, least_gap = 0.0, float("inf")
    for (s, lg, _), (rs, rlg, rtok) in zip(records["ring"], records["dense"]):
        assert (s == rs).all()
        for b in np.where(s)[0]:
            sampled += 1
            scale = max(1.0, abs(rlg[b].max()))
            worst_err = max(worst_err,
                            float(np.abs(lg[b] - rlg[b]).max() / scale))
            least_gap = min(least_gap, float(
                (rlg[b].max() - np.partition(rlg[b], -2)[-2]) / scale))
            if lg[b].argmax() == rtok[b]:
                same += 1
                continue
            gap = rlg[b].max() - np.partition(rlg[b], -2)[-2]
            gaps.append(float(gap / max(1.0, abs(rlg[b].max()))))
            assert gaps[-1] < 5e-3, (b, gap)
    stats["agreement"] = {"max_logit_rel_err": worst_err,
                          "min_top2_rel_gap": least_gap}
    return stats, sampled, same, gaps


def moe_serve(torch, kernels, cfg, params, dev):
    """(d) ``serve_lockstep`` of the phase-11 model (4 layers, full width,
    bf16) over the launcher's 8 prompts. The sliding window keeps both
    backends from block prefill: prompts stream through the decode step
    and no kernel is on this path; at most one near-tie."""
    from repro_torch.configs import ServeConfig
    cfg = replace(cfg, systolic_mode="baseline")
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=64, prefill_chunk=CHUNK)
    prompts = launcher_prompts(cfg, LAUNCH_REQUESTS)
    stats, sampled, same, gaps = serve_lockstep(torch, kernels, cfg, scfg,
                                                params, dev, prompts)
    result = {"requests": len(prompts), "sampled": sampled,
              "same_tokens": same, "near_ties": len(gaps), **stats}
    log(f"[moe-serve] {json.dumps(result)}")
    for name in ("dense", "ring"):
        assert not any(stats[name]["launches"].values()), stats[name]
    assert len(gaps) <= 1, gaps
    return result


def moe_parity(torch, kernels, dev):
    """(b) 2 layers of mixtral-8x22b at full width, fp32, 1 x 1024 tokens:
    the ring in qlr, xqueue and sw on ``ring`` and on ``cannon_grid``
    against the dense path (last logits within 2e-3 of their scale, aux
    within 1e-6), the modes bit for bit; and layer 0's MoE alone in the
    ring harness's four modes, ``baseline`` (the multicast form) included,
    against the dense dispatch (1e-4 of its scale)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ring_moe
    from repro_torch.models import build_model, moe
    from repro_torch.models.common import apply_norm, lm_logits
    cfg = replace(get_config("mixtral-8x22b"), num_layers=2,
                  dtype="float32", param_dtype="float32")
    params = build_model(cfg).init(seed=1, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (1, 1024)), device=dev)

    def run(mode, topo, n_pe):
        c = replace(cfg, systolic_mode=mode, systolic_topology=topo)
        model = build_model(c, n_pe=n_pe)
        with torch.inference_mode():
            x, aux = model.hidden_states(params, tokens)
            return lm_logits(params["head"], params["embed"], x[:, -1],
                             c), aux

    want, want_aux = run("baseline", "ring", 0)
    scale = max(1.0, float(want.abs().max()))
    out = {"launches_per_ring_call": {}}
    for topo in ("ring", "cannon_grid"):
        got = {}
        for mode in ("qlr", "xqueue", "sw"):
            before = {k.name: k.launches for k in kernels}
            logits, aux = got[mode] = run(mode, topo, N_PE)
            out["launches_per_ring_call"] = {
                k.name: k.launches - before[k.name] for k in kernels}
            err = float((logits - want).abs().max()) / scale
            daux = abs(float(aux) - float(want_aux))
            out[f"{topo}_{mode}"] = {"logits_rel_err": err, "aux_err": daux}
            log(f"[moe-parity] {topo} {mode}: last logits rel err "
                f"{err:.3e} (tol 2e-3), aux {float(aux):.6f} (dense "
                f"{float(want_aux):.6f}, err {daux:.1e}, tol 1e-6)")
            assert err <= 2e-3 and daux <= 1e-6, (topo, mode, err, daux)
            assert bool(torch.isfinite(logits).all())
        for mode in ("xqueue", "sw"):
            assert torch.equal(got[mode][0], got["qlr"][0]), (topo, mode)
            assert torch.equal(got[mode][1], got["qlr"][1]), (topo, mode)
        out[f"{topo}_modes_bit_identical"] = True
    # layer 0's MoE in the ring harness, the multicast baseline included
    lp = params["layers"][0]
    with torch.inference_mode():
        h = apply_norm(lp["norm2"], torch.randn(
            1, 1024, cfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(13)), cfg)
        y_dense, _ = moe.apply_moe(lp["moe"], h, cfg)
        logits = h @ lp["moe"]["router"]
        w, idx, _ = moe._topk_routing(logits, cfg)
        pos = moe._positions_in_expert(idx, cfg.num_experts)
        cap = moe.expert_capacity(cfg, 1024)
        ys = {}
        for mode in ring_moe.MODES:
            ys[mode] = ring_moe.systolic_ring_moe(
                h, idx, pos, w, lp["moe"]["w_gate"], lp["moe"]["w_up"],
                lp["moe"]["w_down"], cap, N_PE, mode)
            err = float((ys[mode] - y_dense).abs().max()) / max(
                1.0, float(y_dense.abs().max()))
            out[f"layer_ring_moe_{mode}"] = err
            log(f"[moe-parity] layer 0 ring_moe {mode}: rel err {err:.3e} "
                f"(tol 1e-4)")
            assert err <= 1e-4, (mode, err)
    for mode in ("sw", "xqueue"):
        assert torch.equal(ys[mode], ys["qlr"]), mode
    return out


def moe_train(torch, kernels, dev):
    """(c) 2 layers of mixtral-8x22b at full width, bf16, 1 x 2048 tokens,
    ring of 4 in qlr, remat "full": one ``loss`` and its backward (no
    optimizer step: AdamW's fp32 state would not fit at full width). The
    loss and every gradient finite, aux > 0, the launches as reckoned
    (forward plus the remat recompute, the flash backward kernel once a
    hop), the backwards' device time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_lib
    cfg = replace(get_config("mixtral-8x22b"), num_layers=2,
                  systolic_mode="qlr", remat="full")
    model = build_model(cfg, n_pe=N_PE)
    params = model.init(seed=2, device=dev)
    raw = np.random.default_rng(14).integers(0, cfg.vocab_size, (1, 2049))
    batch = {"tokens": torch.as_tensor(raw[:, :-1], device=dev),
             "targets": torch.as_tensor(raw[:, 1:], device=dev)}
    expect = with_backward({"tile_matmul": 2 * cfg.num_layers
                            * (qkv_ring_hops(cfg, N_PE) + 3),
                            "flash_carry": 2 * cfg.num_layers * N_PE},
                           cfg.remat)
    kernels = (*kernels, fk.FLASH_CARRY_BWD, sk.SSD_CHUNKS_BWD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k.name: k.launches for k in kernels}
    t0 = time.perf_counter()
    loss, metrics, grads = step_lib.value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k.name: k.launches - before[k.name] for k in kernels}
    leaves = opt.tree_leaves(grads)
    assert bool(torch.isfinite(loss)), float(loss)
    assert all(bool(torch.isfinite(g).all()) for g in leaves)
    assert float(metrics["aux"]) > 0, float(metrics["aux"])
    assert launched == expect, (launched, expect)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del grads, leaves
    breakdown = profile(torch, lambda: step_lib.value_and_grad(
        model, params, batch), top=8, warm=False, labels=BACKWARD_LABELS)
    result = {"layers": cfg.num_layers, "tokens": 2048,
              "loss": float(loss), "ce": float(metrics["ce"]),
              "aux": float(metrics["aux"]), "seconds": seconds,
              "launches": launched, "expected": expect, "peak_mem_gb": peak,
              "breakdown": breakdown}
    log(f"[moe-train] {json.dumps(result)}")
    return result


def grid_prefill(torch, kernels, dev):
    """(e) qwen3-0.6b ``prefill`` at full width, 4 layers, fp32, 2 x 512
    tokens, on rings of 4 (2x2 fold) and 8 (2x4) scheduled as torus2d and
    cannon_grid in sw, xqueue and qlr, against the +1 ring in qlr: last
    logits within 2e-3 of their scale, the modes bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("qwen3-0.6b"), num_layers=4, dtype="float32",
                  param_dtype="float32")
    params = build_model(cfg).init(seed=3, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, 512)), device=dev)

    def run(n, mode, topo):
        model = build_model(replace(cfg, systolic_mode=mode,
                                    systolic_topology=topo), n_pe=n)
        with torch.inference_mode():
            return model.prefill(params, tokens)

    out, launches = {}, {k.name: 0 for k in kernels}
    per_call = {}
    for n in (4, 8):
        want = run(n, "qlr", "ring")
        scale = max(1.0, float(want.abs().max()))
        for topo in ("torus2d", "cannon_grid"):
            got = {}
            for mode in ("sw", "xqueue", "qlr"):
                before = {k.name: k.launches for k in kernels}
                got[mode] = run(n, mode, topo)
                per_call[n] = {k.name: k.launches - before[k.name]
                               for k in kernels}
                for k in kernels:
                    launches[k.name] += per_call[n][k.name]
                err = float((got[mode] - want).abs().max()) / scale
                out[f"n{n}_{topo}_{mode}"] = err
                assert err <= 2e-3, (n, topo, mode, err)
            same = all(torch.equal(got[m], got["qlr"])
                       for m in ("sw", "xqueue"))
            log(f"[grid] qwen3 prefill ring of {n} on {topo}: rel err vs "
                f"ring {max(out[f'n{n}_{topo}_{m}'] for m in got):.3e} "
                f"(tol 2e-3), modes bit for bit {same}")
            assert same, (n, topo)
    assert all(launches.values()), launches
    return {"errors": out, "launches": launches,
            "launches_per_call": per_call}


def cannon_grid_skew(torch, kernels, dev, reps: int = 2):
    """(e) the DSP suite's Cannon 8192^3 on the 16x16 fold with
    ``skew="grid"`` in the four modes: values bit for bit those of
    ``skew="masked"``, hops per call 2 + 2(n-1) against 4(n-1) (from the
    link telemetry's pushes), wall ms per call of both, in turns (masked,
    grid, grid, masked)."""
    from repro_torch.core import collective_matmul as cm
    from repro_torch.obs import linkstats
    n, d = 16, CARD["matmul"]
    g = torch.Generator(device=dev).manual_seed(16)
    a = torch.randn(d, d, generator=g, device=dev)
    b = torch.randn(d, d, generator=g, device=dev)
    rows, launches = [], {k.name: 0 for k in kernels}
    for mode in DSP_MODES:
        ys, hops, walls = {}, {}, {"masked": [], "grid": []}
        for skew in ("masked", "grid"):
            before = {k.name: k.launches for k in kernels}
            with linkstats.collect() as sc:
                ys[skew] = cm.systolic_cannon(a, b, n, mode, skew=skew)
            torch.cuda.synchronize()
            for k in kernels:
                launches[k.name] += k.launches - before[k.name]
            hops[skew] = sc.stats.pushes // (n * n)
        assert torch.equal(ys["grid"], ys["masked"]), mode
        want = {"masked": 0, "grid": 0} if mode == "baseline" else \
            {"masked": 4 * (n - 1), "grid": 2 + 2 * (n - 1)}
        assert hops == want, (mode, hops, want)
        del ys
        for skew in ("masked", "grid", "grid", "masked"):
            t0 = time.perf_counter()
            for _ in range(reps):
                cm.systolic_cannon(a, b, n, mode, skew=skew)
            torch.cuda.synchronize()
            walls[skew].append((time.perf_counter() - t0) / reps * 1e3)
        rows.append({"mode": mode, "hops_per_call": hops,
                     "wall_ms": walls})
        log(f"[cannon-grid] {d}^3 16x16 {mode}: hops per call {hops}, "
            f"wall ms masked {walls['masked']} grid {walls['grid']}")
    return {"rows": rows, "launches": launches}


# ---------------------------------------------------------------------------
# phase 12: the Zamba2 hybrid; the dense configs olmo-1b, qwen3-14b and
# granite-34b
# ---------------------------------------------------------------------------

ZAMBA_PARITY_SEQ = 1024            # (b): 1 x 1024 tokens, ring against dense
ZAMBA_STREAM = (4, 512)            # (b): prefill against streamed decode
ZAMBA_GRAD_SEQ = 512               # (c): one Mamba2 layer, 1 x 512 tokens
ZAMBA_LATE = 4                     # (d): requests admitted mid-run
OLMO_PARITY = (2, 1024)            # (f): prefill, ring against dense
OLMO_TRAIN_LAYERS = 4              # (f): the launcher's depth, of 16
OLMO_TRAIN_STEPS = 3               # (f): the launcher's steps


def zamba_expect(cfg, train: bool = False) -> dict:
    """Launches of one zamba2 prefill call (or, with ``train``, of one
    training step under remat "full"), reckoned from the code: each Mamba2
    layer launches the SSD kernel once; each of the ``n_shared_attn``
    shared-block calls runs the QKV ring (N_PE hops x 3 sinks) on the tile
    matmul and ring attention's N_PE flash hops (the GELU MLP stays off
    the ring). The backward recomputes each super-block up to its last
    Mamba2 layer's input (the shared block and ``attn_every - 1`` layers:
    a non-reentrant checkpoint stops once every tensor it saved is back),
    then each Mamba2 layer once for its own checkpoint, and launches the
    SSD backward kernel once per Mamba2 layer."""
    fwd = {"ssd_chunks": cfg.num_layers,
           "tile_matmul": cfg.n_shared_attn * qkv_ring_hops(cfg, N_PE),
           "flash_carry": cfg.n_shared_attn * N_PE}
    if not train:
        return fwd
    return {"ssd_chunks": 2 * cfg.num_layers
            + cfg.n_shared_attn * (cfg.attn_every - 1),
            "ssd_chunks_bwd": cfg.num_layers,
            "tile_matmul": 2 * fwd["tile_matmul"],
            "flash_carry": 2 * fwd["flash_carry"]}


def zamba_prefill(torch, kernels, dev, reps: int = 3):
    """(a) zamba2-1.2b at full width and depth, bf16, seed 0, on the ring
    of 4 in qlr: ``prefill`` of ZAMBA_BATCH x ZAMBA_SEQ tokens, ``reps``
    timed calls, launches as reckoned, profiled. Returns the result and
    the parameters ((d) serves with them)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("zamba2-1.2b"), systolic_mode="qlr")
    model = build_model(cfg, n_pe=N_PE)
    params = model.init(seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (ZAMBA_BATCH, ZAMBA_SEQ)), device=dev)
    expect = zamba_expect(cfg)
    log(f"[zamba-prefill] reckoned per call: {cfg.num_layers} Mamba2 layers "
        f"x 1 ssd_chunks; {cfg.n_shared_attn} shared-attention calls x "
        f"({N_PE} hops x 3 sinks) tile_matmul and x {N_PE} flash_carry "
        f"hops: {expect}")
    with torch.inference_mode():
        walls, per_call, peak, breakdown, logits = timed_calls(
            torch, kernels, lambda: model.prefill(params, tokens), expect,
            reps)
        assert logits.shape == (ZAMBA_BATCH, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
    wall = sorted(walls)[len(walls) // 2]
    result = {"layers": cfg.num_layers, "batch": ZAMBA_BATCH,
              "seq": ZAMBA_SEQ, "walls_s": walls, "wall_s": wall,
              "tokens_per_s": ZAMBA_BATCH * ZAMBA_SEQ / wall,
              "launches": {k: sum(c[k] for c in per_call)
                           for k in per_call[0]},
              "launches_per_call": per_call[-1],
              "expected_per_call": expect, "peak_mem_gb": peak,
              "breakdown": breakdown}
    log(f"[zamba-prefill] {json.dumps(result)}")
    return result, cfg, params


def zamba_parity(torch, kernels, dev):
    """(b) zamba2-1.2b at full width, 2 super-blocks and a tail of 1 layer,
    fp32: the ring (qlr, xqueue, sw) against the dense path on 1 x 1024
    tokens (last logits 2e-3 of their scale, the modes bit for bit), and
    the ring's prefill against its own streamed decode (ring decode
    attention) on ZAMBA_STREAM tokens (2e-3, as ``tests/test_parity.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    full = get_config("zamba2-1.2b")
    cfg = replace(full, num_layers=2 * full.attn_every + 1, n_shared_attn=2,
                  dtype="float32", param_dtype="float32")
    params = build_model(cfg).init(seed=1, device=dev)
    rng = np.random.default_rng(22)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, ZAMBA_PARITY_SEQ)), device=dev)

    out = ring_parity(torch, kernels, "zamba-parity", cfg, N_PE,
                      lambda m: m.prefill(params, tokens), zamba_expect(cfg))
    with torch.inference_mode():
        ring = build_model(replace(cfg, systolic_mode="qlr"), n_pe=N_PE)
        stream = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              ZAMBA_STREAM), device=dev)
        want = ring.prefill(params, stream)
        cache = ring.init_cache(*ZAMBA_STREAM, device=dev)
        before = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        for t in range(ZAMBA_STREAM[1]):
            last, cache = ring.decode_step(params, cache, stream[:, t:t + 1])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        decoded = {k.name: k.launches - before[k.name] for k in kernels}
        tol = 2e-3
        diff = (last - want).abs()
        excess = float((diff - tol * want.abs()).max())
        out["prefill_vs_decode"] = {
            "tokens": list(ZAMBA_STREAM), "max_abs_err": float(diff.max()),
            "max_err_less_rtol_share": excess, "decode_s": seconds,
            "launches": decoded}
        log(f"[zamba-parity] prefill vs {ZAMBA_STREAM[1]} streamed decode "
            f"steps ({ZAMBA_STREAM[0]} rows, ring decode attention): max abs "
            f"err {float(diff.max()):.3e} (atol {tol} + rtol {tol}), "
            f"{seconds:.1f} s, launches {decoded}")
        assert excess <= tol and bool(torch.isfinite(last).all())
        assert decoded["flash_carry"] == \
            ZAMBA_STREAM[1] * cfg.n_shared_attn * N_PE, decoded
    return out


def mamba_grads_vs_cpu(torch, sk, dev):
    """(c) fault 1 on the card: ``torch.autograd.grad`` of ``mamba2_forward``
    at zamba2-1.2b's layer shape (d 2048, 64 heads of 64, N 64, chunk 256),
    1 x ZAMBA_GRAD_SEQ tokens, on the card (the forward and backward
    kernels, one launch each) against the same call on the CPU (the twins
    throughout), relative to each gradient's largest value: fp32 1e-4,
    bf16 2e-2 (``tests/test_torch_ssm.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.serve.sharded_cache import _to_device
    out = {}
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        cfg = replace(get_config("zamba2-1.2b"), dtype=dtype,
                      param_dtype=dtype)
        g = torch.Generator().manual_seed(23)
        params = ssm.init_mamba2(g, cfg)
        params["A_log"] = torch.randn(params["A_log"].shape, generator=g)
        params["dt_bias"] = torch.randn(params["dt_bias"].shape,
                                        generator=g) * 0.5
        x = torch.randn(1, ZAMBA_GRAD_SEQ, cfg.d_model, generator=g).to(
            params["w_in"].dtype)
        up = torch.randn(1, ZAMBA_GRAD_SEQ, cfg.d_model, generator=g)

        def grads(p, xx):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
            xx = xx.detach().requires_grad_(True)
            y = ssm.mamba2_forward(leaves, xx, cfg)
            got = torch.autograd.grad(y, [xx, *leaves.values()],
                                      up.to(y.device, y.dtype))
            return [t.float().cpu() for t in got]

        before = sk.SSD_CHUNKS.launches, sk.SSD_CHUNKS_BWD.launches
        got = grads(_to_device(params, dev), x.to(dev))
        assert (sk.SSD_CHUNKS.launches, sk.SSD_CHUNKS_BWD.launches) == \
            (before[0] + 1, before[1] + 1)
        want = grads(params, x)
        errs = {}
        for name, a, b in zip(["x", *params], got, want):
            assert bool(torch.isfinite(a).all()), (dtype, name)
            errs[name] = float((a - b).abs().max()) / max(
                1.0, float(b.abs().max()))
        out[dtype] = {"tol": tol, "rel_errs": errs}
        log(f"[zamba-grad] mamba2_forward grads, card against CPU twin, "
            f"{dtype}: max rel err {max(errs.values()):.3e} (tol {tol}) "
            f"{errs}")
        assert max(errs.values()) <= tol, (dtype, errs)
    return out


def zamba_train(torch, kernels, dev, steps: int = 2):
    """(c) zamba2-1.2b training at full width and depth: ``train_steps``,
    bf16 with fp32 masters, remat "full", ring of 4 in qlr, ZAMBA_BATCH x
    ZAMBA_SEQ tokens a step from ``SyntheticLM(seed=0)`` (halved, and the
    cut logged, only if the card runs out of memory): launches per step as
    reckoned (forward and remat), one more step profiled."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataLoader, SyntheticLM
    cfg = replace(get_config("zamba2-1.2b"), systolic_mode="qlr",
                  remat="full")
    expect = zamba_expect(cfg, train=True)
    log(f"[zamba-train] reckoned per step: forward "
        f"{zamba_expect(cfg)} plus the remat recompute: {expect}")
    batch_size = ZAMBA_BATCH
    while True:
        loader = DataLoader(SyntheticLM(cfg.vocab_size, seed=0), batch_size,
                            ZAMBA_SEQ)
        batches = [{k: torch.as_tensor(v, device=dev)
                    for k, v in next(loader).items()}
                   for _ in range(steps + 1)]
        loader.close()
        try:
            result = train_steps(torch, kernels, cfg, N_PE, batches[:-1],
                                 dev, expect, "zamba-train",
                                 profiled=batches[-1])
            break
        except torch.cuda.OutOfMemoryError:
            if batch_size == 1:
                raise
        # out of the handler, the failed steps' tensors are unreachable
        del batches
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[zamba-train] cut: {batch_size} x {ZAMBA_SEQ} tokens do "
            f"not fit, retrying with {batch_size // 2}")
        batch_size //= 2
    result.update({"batch": batch_size, "seq": ZAMBA_SEQ,
                   "cut": batch_size != ZAMBA_BATCH})
    return result


def zamba_serve(torch, kernels, cfg, params, dev):
    """(d) ``serve_lockstep`` of (a)'s model (full width and depth, bf16)
    over the launcher's 8 prompts and ZAMBA_LATE more admitted mid-run
    into freed slots. Zamba2 has no block prefill: prompts stream through
    the decode step, whose shared attention runs ring decode attention on
    the ring backend (n_shared_attn x N_PE flash hops a tick). Tokens may
    differ only at near-ties: bf16 activations through 38 layers of random
    weights leave the top logits close together."""
    from repro_torch.configs import ServeConfig
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=ZAMBA_SERVE_SEQ,
                       prefill_chunk=CHUNK)
    prompts = launcher_prompts(cfg, LAUNCH_REQUESTS + ZAMBA_LATE)
    stats, sampled, same, gaps = serve_lockstep(
        torch, kernels, cfg, scfg, params, dev, prompts[:LAUNCH_REQUESTS],
        late=prompts[LAUNCH_REQUESTS:])
    ring = stats["ring"]
    want = {k.name: 0 for k in kernels}
    want["flash_carry"] = ring["ticks"] * cfg.n_shared_attn * N_PE
    result = {"requests": len(prompts), "sampled": sampled,
              "same_tokens": same, "near_ties": len(gaps),
              "near_tie_rel_gaps": gaps, **stats}
    log(f"[zamba-serve] ring decode attention: "
        f"{ring['launches']['flash_carry']} flash_carry launches over "
        f"{ring['ticks']} ticks ({cfg.n_shared_attn} x {N_PE} a tick); "
        f"{json.dumps(result)}")
    assert ring["launches"] == want, (ring["launches"], want)
    assert not any(stats["dense"]["launches"].values()), stats["dense"]
    return result


def zamba_serve_fp32(torch, kernels, dev):
    """(d) the second witness of ring decode attention: ``serve_lockstep``
    of (b)'s model (full width, 2 super-blocks and a tail of 1, fp32,
    seed 1) over (d)'s 12 requests. Both backends see the same tokens at
    every tick, so every sampled row's ring logits must match the dense
    ones within 2e-3 of their scale (as (b)'s prefill against decode), and
    every token must be equal: no near-tie is allowed here."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import build_model
    full = get_config("zamba2-1.2b")
    cfg = replace(full, num_layers=2 * full.attn_every + 1, n_shared_attn=2,
                  dtype="float32", param_dtype="float32")
    params = build_model(cfg).init(seed=1, device=dev)
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=ZAMBA_SERVE_SEQ,
                       prefill_chunk=CHUNK)
    prompts = launcher_prompts(cfg, LAUNCH_REQUESTS + ZAMBA_LATE)
    stats, sampled, same, gaps = serve_lockstep(
        torch, kernels, cfg, scfg, params, dev, prompts[:LAUNCH_REQUESTS],
        late=prompts[LAUNCH_REQUESTS:])
    ring = stats["ring"]
    want = {k.name: 0 for k in kernels}
    want["flash_carry"] = ring["ticks"] * cfg.n_shared_attn * N_PE
    result = {"layers": cfg.num_layers, "requests": len(prompts),
              "sampled": sampled, "same_tokens": same, **stats}
    log(f"[zamba-serve-fp32] {json.dumps(result)}")
    assert ring["launches"] == want, (ring["launches"], want)
    assert not any(stats["dense"]["launches"].values()), stats["dense"]
    assert stats["agreement"]["max_logit_rel_err"] <= 2e-3, stats
    assert same == sampled, (same, sampled, gaps)
    del params
    return result


def dense_prefill_parity(torch, kernels, dev, arch: str, layers: int,
                         batch: int, seq: int, seed: int):
    """(f), (g) ``arch`` at full width, ``layers`` layers (0: all), fp32:
    ``prefill`` on the ring of 4 in qlr against the dense path (last
    logits 2e-3 of their scale), launches as reckoned: per layer the FFN
    rings (N_PE x 3 tile matmuls), the QKV ring where its gate takes the
    shapes (N_PE x 3) and ring attention's N_PE flash hops."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    cfg = replace(cfg, num_layers=layers or cfg.num_layers, dtype="float32",
                  param_dtype="float32")
    params = build_model(cfg).init(seed=seed, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)), device=dev)
    qkv_ring = qkv_ring_hops(cfg, N_PE) > 0
    group = cfg.num_heads // cfg.num_kv_heads
    expect = ring_expect(cfg, N_PE)
    log(f"[{arch}] QKV ring {'runs' if qkv_ring else 'refused'} "
        f"({cfg.num_heads} heads, {cfg.num_kv_heads} KV heads on {N_PE} "
        f"PEs); ring attention folds GQA-{group} hops; reckoned per call "
        f"{expect}")
    with torch.inference_mode():
        want = build_model(cfg).prefill(params, tokens)
        ring = build_model(replace(cfg, systolic_mode="qlr"), n_pe=N_PE)
        ring.prefill(params, tokens)                 # warm
        before = {k.name: k.launches for k in kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ring.prefill(params, tokens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launched = {k.name: k.launches - before[k.name] for k in kernels}
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    result = {"arch": arch, "layers": cfg.num_layers, "batch": batch,
              "seq": seq, "qkv_ring": qkv_ring, "gqa_group": group,
              "logits_rel_err": err, "ring_call_s": seconds,
              "launches_per_call": launched, "expected_per_call": expect}
    log(f"[{arch}] {json.dumps(result)}")
    assert err <= 2e-3 and bool(torch.isfinite(got).all()), (arch, err)
    assert launched == expect, (arch, launched, expect)
    del params, ring
    return result


def olmo_train_launcher(torch, kernels, dev):
    """(f) the trainer as a user runs it, in this process:
    ``repro_torch.launch.train.main`` with ``--arch olmo-1b --steps
    OLMO_TRAIN_STEPS --n-pe 4 --set systolic_mode=qlr --set
    num_layers=OLMO_TRAIN_LAYERS`` (full width, bf16, remat "full", the
    launcher's 8 x 128 tokens a step), its checkpoint and log under
    ``build/olmo_train/``. The losses are finite, and the run's launches
    are the steps times the reckoning per step: per layer the QKV ring
    (where its gate takes the shapes, N_PE x 3) and the FFN rings (N_PE x
    3) on the tile matmul and ring attention's N_PE flash hops, the block
    recomputed once in the backward under remat "full", and the flash
    backward kernel once a hop."""
    import shutil
    import signal
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.launch import train as launch
    out = ROOT / "build" / "olmo_train"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # depth cut to OLMO_TRAIN_LAYERS of 16: the launcher's final
    # checkpoint (bf16 parameters, fp32 masters and moments) is 16.5 GB at
    # full depth, and writing it took 30 of a 56 s run
    argv = ["--arch", "olmo-1b", "--steps", str(OLMO_TRAIN_STEPS),
            "--n-pe", str(N_PE), "--set", "systolic_mode=qlr", "--set",
            f"num_layers={OLMO_TRAIN_LAYERS}", "--device", str(dev),
            "--ckpt-dir", str(out / "ckpt"), "--log", str(out / "log.jsonl")]
    cfg = replace(get_config("olmo-1b"), num_layers=OLMO_TRAIN_LAYERS)
    qkv_ring = qkv_ring_hops(cfg, N_PE) > 0   # the launcher's 128 tokens split
    per_step = with_backward(
        ring_expect(cfg, N_PE, passes=1 if cfg.remat == "none" else 2),
        cfg.remat)
    kernels = (*kernels, fk.FLASH_CARRY_BWD, sk.SSD_CHUNKS_BWD)
    log(f"[olmo-train] reckoned per step ({OLMO_TRAIN_LAYERS} layers, QKV "
        f"ring {'runs' if qkv_ring else 'refused'}, remat {cfg.remat}): "
        f"{per_step}")
    handler = signal.getsignal(signal.SIGTERM)        # the launcher's hook
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        state = launch.main(argv)
    finally:
        signal.signal(signal.SIGTERM, handler)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k.name: k.launches for k in kernels}
    expect = {k: OLMO_TRAIN_STEPS * n for k, n in per_step.items()}
    assert int(state["opt"]["step"]) == OLMO_TRAIN_STEPS
    del state
    logged = [json.loads(line) for line in
              (out / "log.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in logged]
    assert [r["step"] for r in logged] == [0, OLMO_TRAIN_STEPS - 1], logged
    assert all(np.isfinite(losses)), losses
    ckpt_gb = sum(p.stat().st_size for p in (out / "ckpt").rglob("*")
                  if p.is_file()) / 1e9
    shutil.rmtree(out / "ckpt", ignore_errors=True)
    result = {"argv": argv, "seconds": seconds, "losses": losses,
              "step_s": [r["step_s"] for r in logged],
              "checkpoint_gb": ckpt_gb, "launches": launched,
              "launches_per_step": {k: n // OLMO_TRAIN_STEPS
                                    for k, n in launched.items()},
              "expected_per_step": per_step}
    log(f"[olmo-train] {json.dumps(result)}")
    assert launched == expect, (launched, expect)
    return result


def phase12(torch, kernels, sk, dev):
    """Phase 12's runs in order, each path's launches counted from zero
    just before it; returns {run: result} and {path: launches}."""
    fk_mm = [k for k in kernels if k.name in ("flash_carry", "tile_matmul")]
    path = [k for k in kernels if k.name in ("flash_carry", "tile_matmul",
                                             "ssd_chunks")]
    launches, out = {}, {}

    def counted(name, fn):
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        res = fn()
        launches[name] = {k.name: k.launches for k in kernels}
        log(f"[phase12] {name}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches[name]}")
        return res

    prefill, cfg, params = counted(
        "zamba_prefill", lambda: zamba_prefill(torch, path, dev))
    out["zamba_prefill"] = prefill
    out["zamba_serve"] = counted(
        "zamba_serve", lambda: zamba_serve(torch, path, cfg, params, dev))
    del params
    torch.cuda.empty_cache()
    out["zamba_parity"] = counted(
        "zamba_parity", lambda: zamba_parity(torch, path, dev))
    out["zamba_serve_fp32"] = counted(
        "zamba_serve_fp32", lambda: zamba_serve_fp32(torch, path, dev))
    out["zamba_grad"] = counted(
        "zamba_grad", lambda: mamba_grads_vs_cpu(torch, sk, dev))
    torch.cuda.empty_cache()
    out["zamba_train"] = counted(
        "zamba_train", lambda: zamba_train(torch, path, dev))
    torch.cuda.empty_cache()
    out["qwen3_14b_serve"] = counted(
        "qwen3_14b_serve",
        lambda: serve_full_width(torch, fk_mm, dev, "qwen3-14b"))
    torch.cuda.empty_cache()
    out["qwen3_14b_modes"] = counted(
        "qwen3_14b_modes", lambda: modes_agree(torch, dev, "qwen3-14b"))
    torch.cuda.empty_cache()
    out["olmo_prefill"] = counted(
        "olmo_prefill", lambda: dense_prefill_parity(
            torch, fk_mm, dev, "olmo-1b", 0, *OLMO_PARITY, seed=24))
    torch.cuda.empty_cache()
    out["olmo_train"] = counted(
        "olmo_train", lambda: olmo_train_launcher(torch, fk_mm, dev))
    torch.cuda.empty_cache()
    out["granite_prefill"] = counted(
        "granite_prefill", lambda: dense_prefill_parity(
            torch, fk_mm, dev, "granite-34b", GRANITE_LAYERS, GRANITE_BATCH,
            ZAMBA_SEQ, seed=25))
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# phase 13: the VLM, MLA and Whisper families
# ---------------------------------------------------------------------------

VLM_PARITY = (2, 1024)             # (a): 4 layers, fp32, ring against dense
VLM_PARITY_LAYERS = 4
VLM_TRAIN_BATCH = 2                # (a): training steps of 2 x 2048
MLA_PARITY_LAYERS = 3              # (b): the dense layer and 2 MoE layers
MLA_PARITY_SEQ = 2048              # (b): 1 x 2048, the blocked path
MLA_STREAM = (2, 16)               # (b): absorbed decode against prefill
MLA_LAYER_STREAM = (2, 256)        # (b): the same, one MLA layer alone
MLA_TRAIN_LAYERS = 2               # (b): AdamW's state at 27 would not fit
WHISPER_PARITY_BATCH = 2           # (c): fp32, ring against dense
WHISPER_DECODE = (4, 8, 64)        # (c): rows, prompt tokens, greedy steps


def patches(torch, cfg, batch: int, dev, seed: int):
    """Seeded stand-ins for the ViT's patch embeddings [B, P, vit_dim]."""
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (batch, cfg.num_patches, cfg.vit_dim)).astype(np.float32),
        device=dev)


def timed_calls(torch, kernels, fn, expect, reps: int = 3):
    """``fn`` warmed, then ``reps`` calls each timed (synchronized) and
    its launches counted, which must equal ``expect``; one more call
    profiled. Returns (walls_s, launches per call, profile, last out)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, per_call = [], []
    for _ in range(reps):
        before = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_call.append({k.name: k.launches - before[k.name]
                         for k in kernels})
    for got in per_call:
        assert got == expect, (got, expect)
    peak = torch.cuda.max_memory_allocated() / 1e9
    breakdown = profile(torch, fn, top=8, warm=False)
    return walls, per_call, peak, breakdown, out


def vlm_prefill(torch, kernels, dev):
    """(a) internvl2-1b at full width and depth, bf16, seed 0, on the ring
    of 2 in qlr: ``prefill`` of VLM_BATCH x VLM_SEQ tokens with seeded
    patch embeds, 3 timed calls (the QKV, attention and FFN rings), launches
    as reckoned, profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("internvl2-1b"), systolic_mode="qlr")
    model = build_model(cfg, n_pe=VLM_NPE)
    params = model.init(seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(31).integers(
        0, cfg.vocab_size, (VLM_BATCH, VLM_SEQ)), device=dev)
    pe = patches(torch, cfg, VLM_BATCH, dev, 32)
    expect = ring_expect(cfg, VLM_NPE)
    log(f"[vlm-prefill] reckoned per call: {cfg.num_layers} layers x (QKV "
        f"ring {VLM_NPE} x 3 + FFN rings {VLM_NPE} x 3) tile_matmul and x "
        f"{VLM_NPE} flash_carry hops (GQA-{cfg.num_heads // cfg.num_kv_heads}"
        f", head_dim {cfg.resolved_head_dim}): {expect}")
    with torch.inference_mode():
        walls, per_call, peak, breakdown, logits = timed_calls(
            torch, kernels, lambda: model.prefill(params, tokens, pe),
            expect)
        assert logits.shape == (VLM_BATCH, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
    wall = sorted(walls)[len(walls) // 2]
    result = {"layers": cfg.num_layers, "batch": VLM_BATCH, "seq": VLM_SEQ,
              "patches": list(pe.shape), "walls_s": walls, "wall_s": wall,
              "tokens_per_s": VLM_BATCH * VLM_SEQ / wall,
              "launches_per_call": per_call[-1], "expected_per_call": expect,
              "peak_mem_gb": peak, "breakdown": breakdown}
    log(f"[vlm-prefill] {json.dumps(result)}")
    return result


def ring_parity(torch, kernels, tag, cfg, n_pe, call, expect):
    """``call(model)`` of ``cfg``'s model on the ring of ``n_pe`` in qlr,
    xqueue and sw against the dense path (last logits within 2e-3 of their
    scale), the modes bit for bit, each ring call's launches as
    ``expect``."""
    from repro_torch.models import build_model

    def build(mode, n):
        return build_model(replace(cfg, systolic_mode=mode), n_pe=n)

    with torch.inference_mode():
        want = call(build("baseline", 0))
        scale = max(1.0, float(want.abs().max()))
        out, got = {}, {}
        for mode in ("qlr", "xqueue", "sw"):
            before = {k.name: k.launches for k in kernels}
            got[mode] = call(build(mode, n_pe))
            launched = {k.name: k.launches - before[k.name] for k in kernels}
            err = float((got[mode] - want).abs().max()) / scale
            out[mode] = {"logits_rel_err": err, "launches": launched}
            log(f"[{tag}] {mode}: last logits rel err {err:.3e} (tol 2e-3), "
                f"launches {launched}")
            assert err <= 2e-3 and bool(torch.isfinite(got[mode]).all()), \
                (tag, mode, err)
            assert launched == expect, (tag, mode, launched, expect)
    for mode in ("xqueue", "sw"):
        assert torch.equal(got[mode], got["qlr"]), (tag, mode)
    out["modes_bit_identical"] = True
    return out


def vlm_parity(torch, kernels, dev):
    """(a) internvl2-1b at full width, VLM_PARITY_LAYERS layers, fp32, with
    patches: the ring of 2 against the dense path."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("internvl2-1b"), num_layers=VLM_PARITY_LAYERS,
                  dtype="float32", param_dtype="float32")
    params = build_model(cfg).init(seed=1, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(33).integers(
        0, cfg.vocab_size, VLM_PARITY), device=dev)
    pe = patches(torch, cfg, VLM_PARITY[0], dev, 34)
    return ring_parity(torch, kernels, "vlm-parity", cfg, VLM_NPE,
                       lambda model: model.prefill(params, tokens, pe),
                       ring_expect(cfg, VLM_NPE))


# the twins the autograd.Functions look up as module globals: none may run
# on the card in a training step
FUNCTION_TWINS = (
    ("repro_torch.kernels.ssd.kernel", "ssd_chunks_plain"),
    ("repro_torch.kernels.ssd.kernel", "ssd_chunks_backward_plain"),
    ("repro_torch.kernels.flash_attention.kernel", "flash_carry_plain"),
    ("repro_torch.kernels.flash_attention.kernel",
     "flash_carry_backward_plain"))


@contextmanager
def card_twin_calls(torch):
    """Count, in the dict yielded, the calls of ``FUNCTION_TWINS`` that get
    a CUDA tensor."""
    calls, saved = {}, []
    for module, name in FUNCTION_TWINS:
        mod = importlib.import_module(module)
        plain = getattr(mod, name)

        def counted(*args, _plain=plain, _name=name, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in args):
                calls[_name] = calls.get(_name, 0) + 1
            return _plain(*args, **kw)
        saved.append((mod, name, plain))
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, plain in saved:
            setattr(mod, name, plain)


def train_steps(torch, kernels, cfg, n_pe, batches, dev, expect, tag,
                check=None, profiled=None):
    """``make_train_step`` (AdamW at a constant 3e-4, fp32 masters, seed 0)
    over ``batches``, at least two: finite losses and gradient norms,
    launches per step as ``expect`` and the backward kernels' (once per
    differentiated flash hop and Mamba2 layer: ``with_backward``), no call
    of a twin on the card. The step time and rate reported are
    the last step's: the first warms the allocator and the kernels'
    launch paths. ``check(model, params, batch)`` first sees the initial
    parameters and the first batch; with a ``profiled`` batch, one more
    step is profiled. Returns the result."""
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.models import build_model
    from repro_torch.train import step as step_lib
    from repro_torch.train.optimizer import tree_leaves
    assert len(batches) >= 2, "a step's time needs a warm-up step before it"
    kernels = (*kernels, *(k for k in (fk.FLASH_CARRY_BWD, sk.SSD_CHUNKS_BWD)
                           if k not in kernels))
    expect = with_backward(expect, cfg.remat)
    tcfg = TrainConfig(warmup_steps=0, schedule="constant",
                       learning_rate=3e-4)
    state = step_lib.init_state(cfg, tcfg, 0, dev)
    extra = check(build_model(cfg, n_pe=n_pe), state["params"],
                  batches[0]) if check else {}
    train_step = step_lib.make_train_step(cfg, tcfg, n_pe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s, per_step = [], [], [], []
    with card_twin_calls(torch) as twin_calls:
        for b in batches:
            before = {k.name: k.launches for k in kernels}
            t0 = time.perf_counter()
            state, metrics = train_step(state, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            per_step.append({k.name: k.launches - before[k.name]
                             for k in kernels})
    assert not twin_calls, f"twins ran on the card: {twin_calls}"
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    log(f"[{tag}] {len(batches)} steps in {sum(step_s):.1f} s")
    assert all(np.isfinite(losses)), f"non-finite loss: {losses}"
    assert all(np.isfinite(norms)), f"non-finite gradients: {norms}"
    for i, got in enumerate(per_step):
        assert got == expect, f"step {i}: launches {got}, expected {expect}"
    if profiled is not None:
        holder = {"state": state}

        def one_step():
            holder["state"], _ = train_step(holder["state"], profiled)

        t0 = time.perf_counter()
        extra["breakdown"] = profile(torch, one_step, top=8, warm=False,
                                     labels=BACKWARD_LABELS)
        log(f"[{tag}] profiled step and its analysis "
            f"{time.perf_counter() - t0:.1f} s")
        del holder
    del state
    tokens = int(batches[0]["tokens"].numel())
    result = {"layers": cfg.num_layers, "params": n_params,
              "steps": len(batches), "tokens_per_step": tokens,
              "losses": losses, "grad_norms": norms,
              "step_ms": [t * 1e3 for t in step_s],
              "last_step_ms": step_s[-1] * 1e3,
              "tokens_per_s": tokens / step_s[-1], "peak_mem_gb": peak,
              "launches": {k: sum(s[k] for s in per_step)
                           for k in per_step[0]},
              "launches_per_step": per_step[-1],
              "expected_per_step": expect, **extra}
    log(f"[{tag}] {json.dumps(result)}")
    return result


def lm_batches(torch, cfg, n: int, batch: int, seq: int, dev, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        raw = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
        out.append({"tokens": torch.as_tensor(raw[:, :-1], device=dev),
                    "targets": torch.as_tensor(raw[:, 1:], device=dev)})
    return out


def vlm_train(torch, kernels, dev, steps: int = 2):
    """(a) two training steps of internvl2-1b at full width and depth with
    patches (VLM_TRAIN_BATCH x VLM_SEQ tokens, bf16, remat "full", ring of
    2 in qlr): finite, launches as reckoned (forward and recompute); before
    them the projector's gradient at the first batch, finite and
    nonzero."""
    from repro_torch.configs import get_config
    from repro_torch.train import step as step_lib
    cfg = replace(get_config("internvl2-1b"), systolic_mode="qlr",
                  remat="full")
    batches = lm_batches(torch, cfg, steps, VLM_TRAIN_BATCH, VLM_SEQ, dev, 35)
    for i, b in enumerate(batches):
        b["patch_embeds"] = patches(torch, cfg, VLM_TRAIN_BATCH, dev, 36 + i)

    def projector_grad(model, params, batch):
        _, _, grads = step_lib.value_and_grad(model, params, batch)
        norms = {k: float(grads["projector"][k].float().norm())
                 for k in ("w1", "w2")}
        assert all(np.isfinite(v) and v > 0 for v in norms.values()), norms
        return {"projector_grad_norms": norms}

    return train_steps(torch, kernels, cfg, VLM_NPE, batches, dev,
                       ring_expect(cfg, VLM_NPE, passes=2), "vlm-train",
                       check=projector_grad)


def mla_prefill(torch, kernels, dev):
    """(b) deepseek-v2-lite-16b at full width and depth (27 layers, about
    31 GB of bf16 parameters), seed 0, on the ring of 4 in qlr: ``prefill``
    of MLA_BATCH x MLA_SEQ tokens, which takes ``_mla_blocked``; 3 timed
    calls, profiled. MLA has no ring path and the expert ring refuses
    shared experts, so only layer 0's SwiGLU (d_ff_dense 10944) runs a
    ring: N_PE x 3 tile matmuls a call. Returns the result and the
    parameters ((b)'s serving uses them)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.attention import BLOCKED_ATTN_THRESHOLD
    from repro_torch.train.optimizer import tree_leaves
    cfg = replace(get_config("deepseek-v2-lite-16b"), systolic_mode="qlr")
    assert MLA_SEQ >= BLOCKED_ATTN_THRESHOLD
    model = build_model(cfg, n_pe=N_PE)
    params = model.init(seed=0, device=dev)
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    tokens = torch.as_tensor(np.random.default_rng(41).integers(
        0, cfg.vocab_size, (MLA_BATCH, MLA_SEQ)), device=dev)
    expect = {"tile_matmul": cfg.first_k_dense * 3 * N_PE, "flash_carry": 0}
    log(f"[mla-prefill] {gb:.1f} GB of parameters; reckoned per call: "
        f"layer 0's FFN rings ({N_PE} x 3 tile_matmul), no flash hop: "
        f"{expect}")
    with torch.inference_mode():
        walls, per_call, peak, breakdown, logits = timed_calls(
            torch, kernels, lambda: model.prefill(params, tokens), expect)
        assert logits.shape == (MLA_BATCH, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
    wall = sorted(walls)[len(walls) // 2]
    result = {"layers": cfg.num_layers, "param_gb": gb, "batch": MLA_BATCH,
              "seq": MLA_SEQ, "walls_s": walls, "wall_s": wall,
              "tokens_per_s": MLA_BATCH * MLA_SEQ / wall,
              "launches_per_call": per_call[-1], "expected_per_call": expect,
              "peak_mem_gb": peak, "breakdown": breakdown}
    log(f"[mla-prefill] {json.dumps(result)}")
    return result, cfg, params


def mla_parity(torch, kernels, dev):
    """(b) deepseek-v2-lite-16b at full width, MLA_PARITY_LAYERS layers (the
    dense one first), fp32: the ring of 4 against the dense path on 1 x
    MLA_PARITY_SEQ tokens (the blocked path), and, as ``tests/
    test_parity.py``, the absorbed decode streamed over MLA_STREAM tokens
    against the expanded prefill (2e-3).

    The MoE drops assignments past an expert's capacity in a prefill (16
    slots an expert below 137 tokens at full width) and never in a
    one-token decode step, in the reference as in the port: the two paths
    compute one function only while no expert can receive more than 16 of
    the prompt's tokens. So the whole model is held over 16 tokens, and
    layer 0's MLA alone, which drops nothing, over MLA_LAYER_STREAM."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, build_model, moe
    cfg = replace(get_config("deepseek-v2-lite-16b"),
                  num_layers=MLA_PARITY_LAYERS, dtype="float32",
                  param_dtype="float32")
    params = build_model(cfg).init(seed=1, device=dev)
    rng = np.random.default_rng(42)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, MLA_PARITY_SEQ)), device=dev)

    out = ring_parity(torch, kernels, "mla-parity", cfg, N_PE,
                      lambda model: model.prefill(params, tokens),
                      {"tile_matmul": 3 * N_PE, "flash_carry": 0})
    assert moe.expert_capacity(cfg, MLA_STREAM[1]) >= MLA_STREAM[1]
    model = build_model(replace(cfg, systolic_mode="qlr"), n_pe=N_PE)
    tol = 2e-3
    lp = params["layers"][0]["attn"]
    for name, shape in (("model", MLA_STREAM), ("layer", MLA_LAYER_STREAM)):
        if name == "model":
            x = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                                device=dev)
            prefill = lambda: model.prefill(params, x)       # noqa: E731
            cache = model.init_cache(*shape, device=dev)
            step = lambda c, t: model.decode_step(           # noqa: E731
                params, c, x[:, t:t + 1])
        else:
            gen = torch.Generator(device=dev).manual_seed(44)
            x = torch.randn(*shape, cfg.d_model, device=dev, generator=gen)
            prefill = lambda: attention.mla_forward(lp, x, cfg)  # noqa
            cache = attention.init_mla_cache(cfg, *shape, dev)
            step = lambda c, t: attention.mla_decode(        # noqa: E731
                lp, x[:, t:t + 1], c, cfg)
        with torch.inference_mode():
            want = prefill()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = []
            for t in range(shape[1]):
                y, cache = step(cache, t)
                got.append(y)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        # the model's last logits; the layer's every position
        got = got[-1] if name == "model" else torch.cat(got, dim=1)
        diff = (got - want).abs()
        excess = float((diff - tol * want.abs()).max())
        out[f"prefill_vs_decode_{name}"] = {
            "tokens": list(shape), "max_abs_err": float(diff.max()),
            "max_err_less_rtol_share": excess, "decode_s": seconds}
        log(f"[mla-parity] {name}: expanded prefill vs {shape[1]} absorbed "
            f"decode steps ({shape[0]} rows): max abs err "
            f"{float(diff.max()):.3e} (atol {tol} + rtol {tol}), "
            f"{seconds:.1f} s")
        assert excess <= tol and bool(torch.isfinite(got).all()), name
    return out


def mla_serve(torch, kernels, cfg, params, dev):
    """(b) ``serve_lockstep`` of (a)'s deepseek model (full width and depth,
    bf16) over the launcher's 8 prompts, 16 new tokens each: MLA has no
    block prefill, so prompts stream through the absorbed decode; no
    kernel is on this path (MLA decode has no ring, the MoE layers take
    the dense dispatch), so the two backends compute the same function and
    every token must be equal."""
    from repro_torch.configs import ServeConfig
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=64, prefill_chunk=CHUNK)
    prompts = launcher_prompts(cfg, LAUNCH_REQUESTS)
    stats, sampled, same, gaps = serve_lockstep(torch, kernels, cfg, scfg,
                                                params, dev, prompts)
    result = {"requests": len(prompts), "sampled": sampled,
              "same_tokens": same, **stats}
    log(f"[mla-serve] {json.dumps(result)}")
    for name in ("dense", "ring"):
        assert not any(stats[name]["launches"].values()), stats[name]
    assert same == sampled, (same, sampled, gaps)
    return result


def mla_train(torch, kernels, dev, steps: int = 2):
    """(b) two training steps of deepseek-v2-lite-16b at full width,
    MLA_TRAIN_LAYERS layers (the dense one and an MoE layer; AdamW's fp32
    state would need about 250 GB at 27), 1 x 2048 tokens, bf16, remat
    "full", ring of 4 in qlr: finite; layer 0's FFN rings twice (forward
    and recompute)."""
    from repro_torch.configs import get_config
    cfg = replace(get_config("deepseek-v2-lite-16b"),
                  num_layers=MLA_TRAIN_LAYERS, systolic_mode="qlr",
                  remat="full")
    return train_steps(torch, kernels, cfg, N_PE,
                       lm_batches(torch, cfg, steps, 1, MLA_SEQ, dev, 43),
                       dev,
                       {"tile_matmul": 2 * 3 * N_PE, "flash_carry": 0},
                       "mla-train")


def whisper_expect(cfg, n_pe: int, encode: bool = True,
                   decode: bool = True, passes: int = 1) -> dict:
    """Launches of a whisper-tiny call, reckoned from the code: each
    encoder layer's QKV ring (n hops x 3 sinks) where its heads divide the
    ring; each decoder layer's self-attention QKV ring (the same) and ring
    attention's n flash hops; cross-attention, the encoder's attention and
    the GELU MLP stay off the ring."""
    qkv = qkv_ring_hops(cfg, n_pe)
    return {"tile_matmul": passes * qkv * (cfg.enc_layers * encode
                                           + cfg.num_layers * decode),
            "flash_carry": passes * n_pe * cfg.num_layers * decode}


def frames(torch, cfg, batch: int, dev, seed: int):
    """Seeded stand-ins for the conv frontend's output [B, T, D]."""
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32), device=dev)


def whisper_prefill(torch, kernels, dev):
    """(c) whisper-tiny at full width and depth (4 + 4 layers), bf16, seed
    0, on the ring of 2 in qlr: ``encode`` of WHISPER_BATCH x 1500 frames
    and ``prefill`` of WHISPER_BATCH x WHISPER_SEQ tokens against them, 3
    timed calls each, launches as reckoned, the prefill profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("whisper-tiny"), systolic_mode="qlr")
    model = build_model(cfg, n_pe=VLM_NPE)
    params = model.init(seed=0, device=dev)
    fr = frames(torch, cfg, WHISPER_BATCH, dev, 51)
    tokens = torch.as_tensor(np.random.default_rng(52).integers(
        0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_SEQ)), device=dev)
    batch = {"frames": fr, "tokens": tokens}
    out = {}
    with torch.inference_mode():
        for call, fn, expect in (
                ("encode", lambda: model.encode(params, fr),
                 whisper_expect(cfg, VLM_NPE, decode=False)),
                ("prefill", lambda: model.prefill(params, batch),
                 whisper_expect(cfg, VLM_NPE))):
            walls, per_call, peak, breakdown, y = timed_calls(
                torch, kernels, fn, expect)
            assert bool(torch.isfinite(y).all()), call
            wall = sorted(walls)[len(walls) // 2]
            out[call] = {"walls_s": walls, "wall_s": wall,
                         "launches_per_call": per_call[-1],
                         "expected_per_call": expect, "peak_mem_gb": peak,
                         "breakdown": breakdown}
    assert y.shape == (WHISPER_BATCH, cfg.vocab_size)
    out.update({"layers": [cfg.enc_layers, cfg.num_layers],
                "batch": WHISPER_BATCH, "frames": cfg.enc_frames,
                "seq": WHISPER_SEQ,
                "tokens_per_s": WHISPER_BATCH * WHISPER_SEQ
                / out["prefill"]["wall_s"]})
    log(f"[whisper-prefill] {json.dumps(out)}")
    return out


def whisper_parity(torch, kernels, dev):
    """(c) whisper-tiny at full width and depth, fp32: the ring of 2
    against the dense path on WHISPER_PARITY_BATCH x WHISPER_SEQ tokens
    and 1500 frames; then ``fill_cross_cache`` and greedy decoding on the
    ring (WHISPER_DECODE: rows, prompt tokens streamed, new tokens), whose
    last logits must equal the prefill of the whole sequence within 2e-3
    (``tests/test_parity.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("whisper-tiny"), dtype="float32",
                  param_dtype="float32")
    params = build_model(cfg).init(seed=1, device=dev)
    fr = frames(torch, cfg, WHISPER_PARITY_BATCH, dev, 53)
    tokens = torch.as_tensor(np.random.default_rng(54).integers(
        0, cfg.vocab_size, (WHISPER_PARITY_BATCH, WHISPER_SEQ)), device=dev)

    out = ring_parity(torch, kernels, "whisper-parity", cfg, VLM_NPE,
                      lambda model: model.prefill(
                          params, {"frames": fr, "tokens": tokens}),
                      whisper_expect(cfg, VLM_NPE))
    rows, prompt_len, new = WHISPER_DECODE
    model = build_model(replace(cfg, systolic_mode="qlr"), n_pe=VLM_NPE)
    fr = frames(torch, cfg, rows, dev, 55)
    seq = torch.as_tensor(np.random.default_rng(56).integers(
        0, cfg.vocab_size, (rows, prompt_len)), device=dev)
    with torch.inference_mode():
        before = {k.name: k.launches for k in kernels}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = model.fill_cross_cache(
            params, model.init_cache(rows, prompt_len + new, dev),
            model.encode(params, fr))
        for t in range(prompt_len):
            logits, cache = model.decode_step(params, cache,
                                              seq[:, t:t + 1])
        for _ in range(new):
            tok = logits.argmax(-1, keepdim=True)
            seq = torch.cat([seq, tok], dim=1)
            logits, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        decoded = {k.name: k.launches - before[k.name] for k in kernels}
        want = model.prefill(params, {"frames": fr, "tokens": seq})
    steps = prompt_len + new
    expect = whisper_expect(cfg, VLM_NPE, decode=False)
    expect["flash_carry"] = steps * cfg.num_layers * VLM_NPE
    tol = 2e-3
    diff = (logits - want).abs()
    excess = float((diff - tol * want.abs()).max())
    out["prefill_vs_decode"] = {
        "rows": rows, "prompt": prompt_len, "new_tokens": new,
        "max_abs_err": float(diff.max()), "max_err_less_rtol_share": excess,
        "decode_s": seconds, "tokens_per_s": rows * new / seconds,
        "launches": decoded, "expected": expect}
    log(f"[whisper-parity] fill_cross_cache, {prompt_len} prompt and {new} "
        f"greedy decode steps ({rows} rows, ring decode attention) against "
        f"the prefill of all {steps} tokens: max abs err "
        f"{float(diff.max()):.3e} (atol {tol} + rtol {tol}), "
        f"{seconds:.1f} s, launches {decoded}")
    assert excess <= tol and bool(torch.isfinite(logits).all())
    assert decoded == expect, (decoded, expect)
    return out


def whisper_train(torch, kernels, dev, steps: int = 2):
    """(c) two training steps of whisper-tiny at full width and depth
    (WHISPER_BATCH x 1500 frames, WHISPER_SEQ tokens, bf16, remat "full",
    ring of 2 in qlr): finite, launches as reckoned (forward and
    recompute)."""
    from repro_torch.configs import get_config
    cfg = replace(get_config("whisper-tiny"), systolic_mode="qlr",
                  remat="full")
    batches = lm_batches(torch, cfg, steps, WHISPER_BATCH, WHISPER_SEQ, dev,
                         57)
    for i, b in enumerate(batches):
        b["frames"] = frames(torch, cfg, WHISPER_BATCH, dev, 58 + i)
    return train_steps(torch, kernels, cfg, VLM_NPE, batches, dev,
                       whisper_expect(cfg, VLM_NPE, passes=2),
                       "whisper-train")


def phase13(torch, kernels, dev):
    """Phase 13's runs in order, each path's launches counted from zero
    just before it (the flash backward kernel's too); returns {run:
    result} and {path: launches}."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    launches, out = {}, {}
    every = (*kernels, fk.FLASH_CARRY_BWD, sk.SSD_CHUNKS_BWD)

    def counted(name, fn):
        for k in every:
            k.launches = 0
        t0 = time.perf_counter()
        res = fn()
        launches[name] = {k.name: k.launches for k in every}
        log(f"[phase13] {name}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches[name]}")
        torch.cuda.empty_cache()
        return res

    out["vlm_prefill"] = counted("vlm_prefill",
                                 lambda: vlm_prefill(torch, kernels, dev))
    out["vlm_parity"] = counted("vlm_parity",
                                lambda: vlm_parity(torch, kernels, dev))
    out["vlm_train"] = counted("vlm_train",
                               lambda: vlm_train(torch, kernels, dev))
    out["vlm_serve"] = counted("vlm_serve", lambda: serve_full_width(
        torch, kernels, dev, "internvl2-1b", n_pe=VLM_NPE))
    prefill, cfg, params = counted(
        "mla_prefill", lambda: mla_prefill(torch, kernels, dev))
    out["mla_prefill"] = prefill
    out["mla_serve"] = counted("mla_serve", lambda: mla_serve(
        torch, kernels, cfg, params, dev))
    del params
    torch.cuda.empty_cache()
    out["mla_parity"] = counted("mla_parity",
                                lambda: mla_parity(torch, kernels, dev))
    out["mla_train"] = counted("mla_train",
                               lambda: mla_train(torch, kernels, dev))
    out["whisper_prefill"] = counted(
        "whisper_prefill", lambda: whisper_prefill(torch, kernels, dev))
    out["whisper_parity"] = counted(
        "whisper_parity", lambda: whisper_parity(torch, kernels, dev))
    out["whisper_train"] = counted(
        "whisper_train", lambda: whisper_train(torch, kernels, dev))
    return out, launches


# ---------------------------------------------------------------------------
# phase 14: the autotuner
# ---------------------------------------------------------------------------

# (a): tile_matmul at every block, [P, M, K] @ [P, K, N] (+ carry): qwen3's
# FFN AG hop, internvl2's QKV k/v sink (N = 64), mixtral's expert gate/up,
# and the fp32 ragged hop with an fp32 carry
BLOCK_CASES = {"ffn_ag_hop": ((4, 512, 1024, 768), "bf16", False),
               "qkv_kv_hop_n64": ((2, 4096, 896, 64), "bf16", False),
               "moe_expert_gate_up": ((8, 5120, 6144, 16384), "bf16", False),
               "fp32_carry_ragged": ((4, 500, 1024, 256), "fp32", True)}
TUNE_WARMUP, TUNE_ITERS = 1, 3
# the reference bench's slack on its own default (bench_autotune.SLACK)
TUNE_SLACK = 0.05
TUNED_SERVE_NEW = 32               # (d): greedy tokens of each prompt


def block_knob(torch, mk, dev):
    """(a) ``tile_matmul`` at blocks 0, 64 and 128 against its twin at
    ``BLOCK_CASES``: device time per block beside the bound, the twin's
    and ``bmm``/``baddbmm``'s time, and whether blocks 64 and 128 give
    block 0's bits."""
    g = torch.Generator(device=dev).manual_seed(14)
    recs = []
    for name, ((p, m, k, n), kind, carry) in BLOCK_CASES.items():
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        a = torch.randn(p, m, k, generator=g, device=dev).to(dt)
        b = torch.randn(p, k, n, generator=g, device=dev).to(dt)
        c = torch.randn(p, m, n, generator=g, device=dev).to(dt) \
            if carry else None
        timed, base = None, None
        for block in (0, 64, 128):
            rec, got = matmul_record(
                torch, mk, f"block{block}_{name}", a, b, c, dt, block,
                plain_iters=3 if name.startswith("moe") else 20,
                timed=timed)
            timed = {k2: rec[k2] for k2 in ("plain_ms", "library_ms")}
            if base is None:
                base = got
            rec["bit_identical_to_block0"] = bool(torch.equal(got, base))
            recs.append(rec)
        del a, b, c, base, got
    log("[autotune] (a) " + json.dumps([
        {k2: r[k2] for k2 in ("case", "ms", "bound_ms", "library_ms",
                              "plain_ms", "max_abs_err", "ok",
                              "bit_identical_to_block0")} for r in recs]))
    return recs


def tune_builders(torch, dev):
    """(b) ``{name: (op, n_pe, dtype, key shape, blocks, kernels, make)}``:
    the reference cache's four shapes in fp32
    (``benchmarks/bench_autotune.py``'s shapes: ``model=8``, ``serve`` at
    ``model=4``), then qwen3-0.6b's FFN AG ring, its attention layer and
    its serving step at full width and depth on a ring of 4, and one
    mixtral-8x22b MoE layer at full width on the ring of 8. Each trial
    runs what the plan is applied to: ``ring_ag_matmul`` for ``matmul``,
    ``gqa_forward`` and ``apply_moe`` under ``apply_plan(cfg, plan)`` for
    the two gates, a decode step of ``RingShardedBackend(plan=)`` for
    ``serve``. ``kernels`` names the kernels every plan's trial must
    launch: a decode step's one-token QKV and FFN run dense, so only its
    ring decode launches (``flash_carry``), and the block of a ``serve``
    plan reaches the chunked prefill's rings, not the timed step. Inputs
    and weights come from seeds; ``make()`` builds them."""
    from repro_torch.autotune import Plan, apply_plan
    from repro_torch.configs import ServeConfig, get_config, get_smoke_config
    from repro_torch.core import collective_matmul as cm
    from repro_torch.core import topology as topo_lib
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model, moe as moe_lib
    from repro_torch.serve.sharded_cache import RingShardedBackend

    def rnd(g, *shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def matmul(n, b, s, d, fs, dt):
        g = torch.Generator(device=dev).manual_seed(20)
        x = rnd(g, b, s, d, dt=dt)
        # the resident weight slices [n, d, f/n] of each sink, made once
        ws = [rnd(g, d, f, dt=dt, scale=d ** -0.5)
              .reshape(d, n, f // n).transpose(0, 1).contiguous()
              for f in fs]

        def build(plan: Plan):
            topo = topo_lib.resolve_safe(plan.topology, "model", n)
            return (lambda x: cm.ring_ag_matmul(
                cm._seq_shards(x, n), ws, topo, plan.mode, plan.block),
                (x,))
        return build

    def attention(n, b, s, cfg):
        g = torch.Generator(device=dev).manual_seed(21)
        p = attn.init_gqa(g, cfg)
        x = rnd(g, b, s, cfg.d_model, dt=p["wq"].dtype)

        def build(plan: Plan):
            c = apply_plan(cfg, plan)
            return (lambda x: attn.gqa_forward(p, x, c, n_pe=n)), (x,)
        return build

    def moe(n, b, s, cfg):
        g = torch.Generator(device=dev).manual_seed(22)
        p = moe_lib.init_moe(g, cfg)
        x = rnd(g, b, s, cfg.d_model, dt=p["w_gate"].dtype)

        def build(plan: Plan):
            c = apply_plan(cfg, plan)
            return (lambda x: moe_lib.apply_moe(p, x, c, n_pe=n)[0]), (x,)
        return build

    def serve(n, cfg, max_batch, max_seq):
        params = build_model(cfg).init(seed=0, device=dev)
        scfg = ServeConfig(max_batch=max_batch, max_seq_len=max_seq,
                           temperature=0.0)
        tokens = np.ones((max_batch, 1), np.int32)
        active = np.ones(max_batch, bool)

        def build(plan: Plan):
            be = RingShardedBackend(cfg, scfg, params, n, plan=plan,
                                    device=dev)
            return (lambda: be.step(tokens, active)), ()
        return build

    f32, bf = torch.float32, torch.bfloat16
    blocks = (0, 64, 128)
    both = ("flash_carry", "tile_matmul")
    q3 = get_config("qwen3-0.6b")
    mix = get_config("mixtral-8x22b")
    # the reference bench's attention layer: 4 heads over 2 KV heads of
    # 16 (SMOKE qwen3-0.6b), whose QKV ring cannot split over 8 PEs, so
    # no block reaches a kernel there
    small_attn = replace(get_smoke_config("qwen3-0.6b"), dtype="float32",
                         param_dtype="float32")
    small_moe = replace(
        get_smoke_config("qwen3-0.6b"), name="autotune-moe", family="moe",
        d_model=32, d_ff=64, d_ff_expert=64, num_experts=8,
        experts_per_token=2, capacity_factor=2.0, dtype="float32",
        param_dtype="float32")
    return {
        "ref_matmul": ("matmul", 8, "float32", (2, 128, 64), blocks,
                       ("tile_matmul",),
                       lambda: matmul(8, 2, 128, 64, [64], f32)),
        "ref_attention": ("attention", 8, "float32", (2, 128, 64), (0,),
                          ("flash_carry",),
                          lambda: attention(8, 2, 128, small_attn)),
        "ref_moe": ("moe", 8, "float32", (2, 64, 32), blocks,
                    ("tile_matmul",), lambda: moe(8, 2, 64, small_moe)),
        "ref_serve": ("serve", 4, "float32", (8, 64, 64), blocks,
                      ("flash_carry",),
                      lambda: serve(4, small_attn, 8, 64)),
        "qwen3_matmul": ("matmul", N_PE, "bfloat16", (4, 2048, q3.d_model),
                         blocks, ("tile_matmul",),
                         lambda: matmul(N_PE, 4, 2048, q3.d_model,
                                        [q3.d_ff, q3.d_ff], bf)),
        "qwen3_attention": ("attention", N_PE, "bfloat16",
                            (4, 2048, q3.d_model), blocks, both,
                            lambda: attention(N_PE, 4, 2048, q3)),
        "mixtral_moe": ("moe", 8, "bfloat16", (MOE_BATCH, MOE_SEQ,
                                               mix.d_model), blocks,
                        ("tile_matmul",),
                        lambda: moe(8, MOE_BATCH, MOE_SEQ, mix)),
        "qwen3_serve": ("serve", N_PE, "bfloat16", (BATCH, MAX_SEQ,
                                                    q3.d_model), blocks,
                        ("flash_carry",),
                        lambda: serve(N_PE, q3, BATCH, MAX_SEQ)),
    }


def tune_sweeps(torch, kernels, dev, cache, card):
    """(b) every sweep of ``tune_builders`` through ``tune`` into
    ``cache`` (warmup 1, 3 timed calls a plan, measured on ``card``).
    Rules: every plan that ``candidates`` admits comes back timed (an
    ``error`` fails the phase) and its trial launched the sweep's
    kernels, the winner is within TUNE_SLACK of the op's default plan
    (``space.default_plan``: ``DEFAULT_PLAN`` for ``matmul``, the ring
    backend's ``qlr/ring`` for the gated ops, which get no ``baseline``
    plan), and a second ``best_plan`` of the key runs no trial."""
    from repro_torch.autotune import best_plan, candidates, measure
    from repro_torch.autotune import tune
    from repro_torch.autotune.space import default_plan
    out = {}
    for name, (op, n, dtype, shape, blocks, expect, make) in \
            tune_builders(torch, dev).items():
        t0 = time.perf_counter()
        build = make()
        launched = {}

        def counted(plan, build=build, launched=launched):
            fn, args = build(plan)

            def run(*a):
                before = {k.name: k.launches for k in kernels}
                y = fn(*a)
                launched[plan.label()] = sorted(
                    k.name for k in kernels if k.launches > before[k.name])
                return y
            return run, args

        plans = candidates(op, n, blocks=blocks)
        default = default_plan(op)
        assert default in plans, (name, default)
        measure.reset_trials()
        winner, results = tune(op, shape, dtype, n, counted, cache=cache,
                               plans=plans, warmup=TUNE_WARMUP,
                               iters=TUNE_ITERS, device=card)
        trials = measure.trial_count()
        bad = {k: r["error"] for k, r in results.items() if "error" in r}
        assert not bad, (name, bad)
        assert trials == len(plans), (name, trials, len(plans))
        idle = {k: v for k, v in launched.items()
                if not set(expect) <= set(v)}
        assert len(launched) == len(plans) and not idle, (name, expect, idle)
        win_us = results[winner.label()]["us"]
        default_us = results[default.label()]["us"]
        assert win_us <= default_us * (1 + TUNE_SLACK), \
            (name, winner.label(), win_us, default_us)
        measure.reset_trials()
        assert best_plan(op, shape, dtype, n, cache=cache) == winner
        assert measure.trial_count() == 0, (name, "cache hit re-measured")
        del build, counted
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = {"op": op, "n_pe": n, "dtype": dtype,
                     "shape": list(shape), "n_plans": len(plans),
                     "kernels_every_plan": list(expect),
                     "winner": winner.label(), "winner_us": win_us,
                     "default": default.label(), "default_us": default_us,
                     "speedup": default_us / win_us,
                     "seconds": time.perf_counter() - t0,
                     "plans": {k: {"us": r["us"], "bytes": r["bytes"]}
                               for k, r in results.items()}}
        log(f"[autotune] (b) {name}: {json.dumps(out[name])}")
    return out


def tuned_prefill(torch, kernels, mk, dev, cfg, params, tokens, plan):
    """qwen3-0.6b prefill with ``autotune=True`` and a cache that holds
    ``plan`` under the ``attention`` key of ``tokens``, against the same
    config with the plan's fields set by hand. Both configs carry the
    plan's mode and topology, so the FFN ring (which no gate reaches)
    runs alike; the tuned one starts at another block, which the gate
    must overwrite. Logits bit for bit, launches equal, and every launch
    at the same block."""
    from repro_torch.autotune import TuneCache, api, apply_plan
    from repro_torch.models import build_model
    cache = TuneCache()
    cache.put("attention", (*tokens.shape, cfg.d_model), cfg.dtype,
              api.mesh_key(N_PE), plan)
    start_block = 64 if plan.block != 64 else 128
    tuned = replace(cfg, systolic_mode=plan.mode,
                    systolic_topology=plan.topology,
                    kernel_block=start_block, autotune=True)
    hand = apply_plan(replace(tuned, autotune=False), plan)
    blocks_seen: dict = {}
    real = mk.matmul_cuda

    def recording(a, b, c=None, out_dtype=None, block=0):
        blocks_seen[block] = blocks_seen.get(block, 0) + 1
        return real(a, b, c, out_dtype, block)

    saved = api._CACHE
    api._CACHE = cache
    mk.matmul_cuda = recording
    try:
        runs = {}
        for name, c in (("tuned", tuned), ("hand", hand)):
            model = build_model(c, n_pe=N_PE)
            blocks_seen.clear()
            for k in kernels:
                k.launches = 0
            with torch.inference_mode():
                logits = model.prefill(params, tokens)
            torch.cuda.synchronize()
            runs[name] = (logits, {k.name: k.launches for k in kernels},
                          dict(blocks_seen))
    finally:
        mk.matmul_cuda = real
        api._CACHE = saved
    (lt, nt, bt), (lh, nh, bh) = runs["tuned"], runs["hand"]
    assert bool(torch.isfinite(lt).all()), "non-finite tuned logits"
    assert torch.equal(lt, lh), (plan.label(), "tuned prefill differs")
    assert nt == nh and bt == bh, (plan.label(), nt, nh, bt, bh)
    assert start_block not in bt, (plan.label(), bt)
    assert all(v > 0 for v in nt.values()), (plan.label(), nt)
    out = {"plan": plan.label(), "start_block": start_block,
           "launches": nt, "launches_by_block": bt,
           "logits_bit_identical": True}
    log(f"[autotune] (d) prefill: {json.dumps(out)}")
    return out


def tuned_serve(torch, kernels, dev, cfg, params, plan):
    """``RingShardedBackend(plan=plan)`` against a backend with the plan's
    mode, topology and block set by hand: TUNED_SERVE_NEW greedy tokens
    of 8 prompts (block prefill on), token for token, launches equal."""
    from repro_torch.configs import ServeConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharded_cache import RingShardedBackend
    scfg = ServeConfig(max_batch=BATCH, max_seq_len=MAX_SEQ,
                       prefill_chunk=CHUNK, temperature=0.0)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(64, 257)))
               .astype(np.int32) for _ in range(BATCH)]
    served = {}
    for name in ("plan", "hand"):
        if name == "plan":
            backend = RingShardedBackend(cfg, scfg, params, N_PE,
                                         plan=plan, device=dev)
        else:
            backend = RingShardedBackend(
                replace(cfg, systolic_topology=plan.topology,
                        kernel_block=plan.block), scfg, params, N_PE,
                plan.mode, device=dev)
        eng = ServeEngine(cfg, scfg, params, backend=backend, device=dev)
        reqs = [eng.sched.submit(p, TUNED_SERVE_NEW) for p in prompts]
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        eng.run(max_ticks=10 * TUNED_SERVE_NEW)
        torch.cuda.synchronize()
        assert all(r.status == "done" and
                   len(r.out_tokens) == TUNED_SERVE_NEW for r in reqs), name
        served[name] = {"backend": backend.name,
                        "tokens": [list(map(int, r.out_tokens))
                                   for r in reqs],
                        "seconds": time.perf_counter() - t0,
                        "launches": {k.name: k.launches for k in kernels}}
        del eng, backend
    assert served["plan"]["backend"] == f"ring-{plan.mode}+tuned"
    assert served["plan"]["tokens"] == served["hand"]["tokens"], \
        (plan.label(), "the tuned backend served other tokens")
    assert served["plan"]["launches"] == served["hand"]["launches"]
    assert all(v > 0 for v in served["plan"]["launches"].values()), \
        (plan.label(), served["plan"]["launches"])
    out = {"plan": plan.label(),
           **{f"{k}_{f}": v[f] for k, v in served.items()
              for f in ("backend", "seconds", "launches")},
           "tokens_equal": True, "tokens": TUNED_SERVE_NEW * BATCH}
    log(f"[autotune] (d) serving: {json.dumps(out)}")
    return out


def tuned_model_path(torch, kernels, mk, dev, cache, sweeps):
    """(d) qwen3-0.6b at full width and depth, ring of 4, bf16: the
    prefill through the attention gate with (b)'s ``attention`` winner
    (4 x 2048 tokens: an exact hit) and ``RingShardedBackend(plan=)``
    with its ``serve`` winner, each against the hand-set config, and each
    launching both kernels."""
    from repro_torch.autotune import api
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen3-0.6b")
    params = build_model(cfg).init(seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (4, 2048)), device=dev)
    winners = {}
    for op, sweep, key in (
            ("attention", sweeps["qwen3_attention"],
             (4, 2048, cfg.d_model)),
            ("serve", sweeps["qwen3_serve"], (BATCH, MAX_SEQ, cfg.d_model))):
        winner = cache.get_exact(op, key, "bfloat16", api.mesh_key(N_PE))
        assert winner is not None and winner.label() == sweep["winner"]
        winners[op] = winner
    out = {"prefill": tuned_prefill(torch, kernels, mk, dev, cfg, params,
                                    tokens, winners["attention"]),
           "serve": tuned_serve(torch, kernels, dev, cfg, params,
                                winners["serve"])}
    del params
    return out


def phase14(torch, kernels, mk, dev, card, recs):
    """(b) the sweeps into a temporary cache, (c) their rules (in
    ``tune_sweeps``), (d) the tuned model path, (e) the cache as one JSON
    line, with the card's name and power limit; ``recs`` are (a)'s
    records (``block_knob``, run beside phase 2). Returns (results,
    launches by path)."""
    import tempfile
    from repro_torch.autotune import TuneCache
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cache = TuneCache(str(Path(tmp) / "AUTOTUNE_CACHE_H100.json"))
        for k in kernels:
            k.launches = 0
        sweeps = tune_sweeps(torch, kernels, dev, cache, card)
        launches = {"autotune_sweeps": {k.name: k.launches
                                        for k in kernels}}
        tuned = tuned_model_path(torch, kernels, mk, dev, cache, sweeps)
        launches["autotune_tuned_prefill"] = tuned["prefill"]["launches"]
        launches["autotune_tuned_serve"] = tuned["serve"]["plan_launches"]
        log("[autotune-cache] " + json.dumps(cache.payload(),
                                             sort_keys=True))
    out = {"block_knob": [{k: r[k] for k in ("case", "ms", "bound_ms",
                                             "library_ms",
                                             "bit_identical_to_block0")}
                          for r in recs],
           "sweeps": sweeps, "tuned": tuned,
           "seconds": time.perf_counter() - t0}
    log(f"[autotune] phase 14 {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------------------
# phase 15: the dry run and the roofline
# ---------------------------------------------------------------------------

# (a): every shape kind and family at least once, on fake tensors. Cut
# for host time (each cell runs twice, about 100 s in all): qwen3-0.6b's
# dense train_4k and prefill_32k (23 and 16 s a pass; no kernel on the
# dense path), mixtral-8x22b train_4k (43 s) and deepseek-v2-lite-16b
# train_4k (28 s); the 33-cell sweep is ``launch/dryrun.py --all``
DRY_CELLS = [("qwen3-0.6b", "decode_32k", "baseline", 0),
             ("qwen3-0.6b", "train_4k", "qlr", 4),
             ("qwen3-0.6b", "prefill_32k", "qlr", 4),
             ("qwen3-0.6b", "decode_32k", "qlr", 4),
             ("mixtral-8x22b", "long_500k", "qlr", 4),
             ("mamba2-1.3b", "long_500k", "baseline", 0),
             ("mamba2-1.3b", "train_4k", "baseline", 0),
             ("zamba2-1.2b", "prefill_32k", "qlr", 4),
             ("whisper-tiny", "decode_32k", "qlr", 2),
             ("deepseek-v2-lite-16b", "decode_32k", "qlr", 4),
             ("internvl2-1b", "prefill_32k", "qlr", 2)]
# (b): qwen3-0.6b's three kinds at shapes cut to fit the card
ROOFLINE_CUTS = {
    "train_4k": (8, 8, "batch 256 -> 8 (8 microbatches of 1 x 4096)"),
    "prefill_32k": (2, None, "batch 32 -> 2"),
    "decode_32k": (8, None, "batch 128 -> 8 (128 rows of bf16 KV cache "
                   "at 32768 positions are about 481 GB)")}


def dry_run_cells(torch, kernels, dev):
    """(a) Each of ``DRY_CELLS`` dry-run on fake tensors on the card's
    device and again on the CPU: every record ok, the kernel counts of the
    two equal, no kernel library called, no launch and no byte of device
    memory allocated."""
    from repro_torch.launch import dryrun
    libs_called = []

    def refuse(kern):
        def lib():
            libs_called.append(kern.name)
            raise AssertionError(f"the dry run called {kern.name}'s library")
        return lib
    launches0 = {k.name: k.launches for k in kernels}
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    out = []
    t0 = time.perf_counter()
    for k in kernels:
        k.lib = refuse(k)
    try:
        for arch, shape, mode, n_pe in DRY_CELLS:
            card = dryrun.run_cell(arch, shape, mode, n_pe, dev, out_dir=None)
            cpu = dryrun.run_cell(arch, shape, mode, n_pe, "cpu",
                                  out_dir=None)
            assert card["ok"] and cpu["ok"], (card.get("traceback"),
                                              cpu.get("traceback"))
            got, want = (r["counts"]["by_kernel"] for r in (card, cpu))
            assert got == want, (card["cell"], got, want)
            out.append({"cell": card["cell"], "device": card["device"],
                        "by_kernel": got,
                        "flops": card["counts"]["flops_per_device"],
                        "bytes": card["counts"]["hbm_bytes_per_device"],
                        "peak_bytes": card["memory"]["peak_bytes"],
                        "host_s": card["timings"]["host_s"],
                        "cpu_host_s": cpu["timings"]["host_s"]})
    finally:
        for k in kernels:
            del k.lib
    torch.cuda.synchronize()
    assert not libs_called, libs_called
    assert {k.name: k.launches for k in kernels} == launches0
    assert torch.cuda.memory_allocated() == mem0, \
        (torch.cuda.memory_allocated(), mem0)
    seconds = time.perf_counter() - t0
    log(f"[roofline] (a) {len(out)} cells on fake {dev} and cpu in "
        f"{seconds:.1f} s: kernel counts equal, nothing allocated or "
        f"launched")
    return {"cells": out, "seconds": seconds}


def measured_cell(torch, kernels, dev, shape_name: str, card: str):
    """(b) One of qwen3-0.6b's kinds at full width and depth, bf16, ring
    of 4 in qlr, at ``ROOFLINE_CUTS``' shape: the dry run's count, then
    the real step on the card: the same argument bytes and launches, the
    peak estimate beside ``max_memory_allocated``, the median of 3
    synchronized calls after one warm-up, ``mfu`` and the roofline
    share; a prefill or decode call profiled after them."""
    from repro_torch.configs import TrainConfig, get_config, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.roofline import analysis
    from repro_torch.train import step as step_lib
    cfg = replace(get_config("qwen3-0.6b"), systolic_mode="qlr",
                  remat="full")
    batch_rows, micro, reduced = ROOFLINE_CUTS[shape_name]
    shape = replace(get_shape(shape_name), global_batch=batch_rows)
    tcfg = TrainConfig(microbatches=micro or 1, warmup_steps=0,
                       schedule="constant", learning_rate=3e-4)
    t0 = time.perf_counter()
    counted = dryrun.count_cell(cfg, shape, tcfg, N_PE, dev)
    dry_s = time.perf_counter() - t0
    rec = {"cell": f"qwen3-0.6b__{shape_name}__1xH100__qlr-pe{N_PE}__cut",
           "arch": "qwen3-0.6b", "shape": shape_name, "kind": shape.kind,
           "chips": 1, "device": torch.cuda.get_device_name(dev),
           "n_active_params": cfg.n_active_params, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch, "ok": True, **counted}
    roof = analysis.analyze_cell(rec)

    g = torch.Generator(device=dev).manual_seed(0)
    specs, _ = step_lib.batch_shapes(cfg, shape, dev)
    batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                               device=dev, dtype=v.dtype)
                 if k != "active" else torch.ones(v.shape, dtype=v.dtype,
                                                  device=dev))
             for k, v in specs.items()}
    holder = {}
    if shape.kind == "train":
        holder["state"] = step_lib.init_state(cfg, tcfg, 0, dev)
        train = step_lib.make_train_step(cfg, tcfg, N_PE)
        args = (holder["state"], batch)

        def call():
            holder["state"], metrics = train(holder["state"], batch)
            return metrics["loss"]
    elif shape.kind == "prefill":
        params = build_model(cfg).init(0, dev)
        prefill = step_lib.make_prefill_step(cfg, N_PE)
        args = (params, batch)

        def call():
            return prefill(params, batch)
    else:
        params = build_model(cfg).init(0, dev)
        cache = build_model(cfg).init_cache(shape.global_batch,
                                            shape.seq_len, dev)
        # one token against a full cache: every row at its last position
        cache["layers"]["pos"].fill_(shape.seq_len - 1)
        serve = step_lib.make_serve_step(cfg, N_PE)
        args = (params, cache, batch["tokens"], batch["active"])

        def call():
            cache["layers"]["pos"].fill_(shape.seq_len - 1)
            return serve(params, cache, batch["tokens"], batch["active"])[0]
    arg_bytes = dryrun.tree_bytes(args)
    del args
    assert arg_bytes == counted["memory"]["argument_bytes"], \
        (arg_bytes, counted["memory"]["argument_bytes"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    for k in kernels:
        k.launches = 0
    out = call()                                    # warm-up, counted
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels if k.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {k: v["launches"]
            for k, v in counted["counts"]["by_kernel"].items()}
    assert launches == want, (shape_name, launches, want)
    assert bool(torch.isfinite(out.float()).all()), f"{shape_name}: non-finite"
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    median = sorted(walls)[1]
    # where a call's time goes (the train step's trace, 12k launches,
    # would take minutes to analyse)
    breakdown = None if shape.kind == "train" else profile(
        torch, call, top=6, warm=False)
    result = {
        "cell": rec["cell"], "kind": shape.kind, "reduced": reduced,
        "shape": {"global_batch": shape.global_batch,
                  "seq_len": shape.seq_len,
                  "microbatches": micro},
        "argument_bytes": arg_bytes, "launches": launches,
        "peak_estimate_bytes": counted["memory"]["peak_bytes"],
        "max_memory_allocated": peak, "memory_before_call": base_mem,
        "walls_s": walls, "median_s": median,
        "model_flops": roof["model_flops"],
        "counted_flops": roof["flops_per_device"],
        "flops_by_kind": roof["flops_by_kind"],
        "hbm_bytes": roof["hbm_bytes_per_device"],
        "link_bytes": roof["link_bytes"],
        "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
        "link_s": roof["link_s"], "dominant": roof["dominant"],
        "step_s_bound": roof["step_s_bound"],
        "useful_ratio": roof["useful_ratio"],
        "mfu": analysis.mfu(rec, median),
        "roofline_share": roof["step_s_bound"] / median,
        "breakdown": breakdown, "dry_run_host_s": dry_s, "card": card}
    log(f"[roofline] (b) {shape_name} cut ({reduced}): {median * 1e3:.1f} "
        f"ms median, mfu {result['mfu']:.4f}, roofline share "
        f"{result['roofline_share']:.4f} ({roof['dominant']}-bound "
        f"{roof['step_s_bound'] * 1e3:.1f} ms), launches {launches}, peak "
        f"{peak / 1e9:.2f} GB against the estimate "
        f"{counted['memory']['peak_bytes'] / 1e9:.2f} GB; {card}")
    del holder, out
    if shape.kind != "train":
        del params
    if shape.kind == "decode":
        del cache
    torch.cuda.empty_cache()
    return result


def phase15(torch, kernels, dev, card, train):
    """The dry run on the card's path (a), then measured against the
    count (b); phase 9's ``train_mfu`` beside the dry run's ``mfu`` of
    the same step."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import analysis
    t0 = time.perf_counter()
    dry = dry_run_cells(torch, kernels, dev)
    torch.cuda.empty_cache()
    measured, launches = {}, {}
    for name in ROOFLINE_CUTS:
        measured[name] = measured_cell(torch, kernels, dev, name, card)
        launches[f"roofline_{name}"] = measured[name]["launches"]
    meta = {"kind": "train", "global_batch": TRAIN_BATCH,
            "seq_len": TRAIN_SEQ,
            "n_active_params": get_config("qwen3-0.6b").n_active_params}
    phase9 = {"train_mfu": train["train_mfu"],
              "mfu": analysis.mfu(meta, train["median_step_ms"] / 1e3)}
    log(f"[roofline] phase 9's step: train_mfu {phase9['train_mfu']:.4f} "
        f"(non-embedding 6N, the LM head and causal attention), mfu "
        f"{phase9['mfu']:.4f} (the reference's 6N with the embeddings, no "
        f"attention)")
    out = {"dry_run": dry, "measured": measured, "phase9": phase9,
           "card": card, "seconds": time.perf_counter() - t0}
    log(f"[roofline] phase 15 {out['seconds']:.1f} s")
    print("[roofline] " + json.dumps(out), flush=True)
    return out, launches


# ---------------------------------------------------------------------------
# phase 16: the examples
# ---------------------------------------------------------------------------

EXAMPLE_CHUNK = 16                 # (b): block prefill (the QKV ring's path)
EXAMPLE_PARITY_LAYERS = 4          # (b): fp32, the ring against dense
EXAMPLE_TRAIN = (20, 30)           # (d): steps of the cut run, then resumed
TIE_GAP = 5e-3                     # tests/test_torch_serve.py's near-tie


def launch_counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def example_quickstart(torch, kernels, dev):
    """(a) ``examples.quickstart.run`` at full width: qwen3-0.6b, bf16,
    qlr on the ring of 4. The loss is finite and within 1.0 of ln V; the
    train step's launches are the loss's times the forward passes (two
    under remat "full": the forward and its recompute), and the flash
    backward kernel's once per hop of the loss; 5 tokens decode."""
    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    cfg = replace(get_config("qwen3-0.6b"), systolic_mode="qlr")
    marks = []

    def stage(name):
        torch.cuda.synchronize()
        marks.append((name, launch_counts(kernels), time.perf_counter()))

    forward = kernels
    kernels = (*kernels, fk.FLASH_CARRY_BWD, sk.SSD_CHUNKS_BWD)
    out = quickstart.run(cfg, n_pe=N_PE, device=dev, on_stage=stage)
    per_stage, seconds = {}, {}
    for (name, c0, t0), (_, c1, t1) in zip(marks, marks[1:]):
        per_stage[name] = {k: c1[k] - c0[k] for k in c0}
        seconds[name] = t1 - t0
    out.update(launches_per_stage=per_stage, seconds=seconds)
    log(f"[examples] quickstart: {json.dumps(out)}")
    assert np.isfinite(out["loss"]) and np.isfinite(out["step_loss"])
    assert abs(out["loss"] - out["ln_vocab"]) <= 1.0, out["loss"]
    passes = 1 if cfg.remat == "none" else 2
    for k in forward:
        fwd = per_stage["loss"][k.name]
        assert fwd > 0, f"{k.name} never launched in the quickstart's loss"
        assert per_stage["train_step"][k.name] == passes * fwd, \
            (k.name, per_stage)
    assert per_stage["loss"]["flash_carry_bwd"] == 0
    assert per_stage["train_step"]["flash_carry_bwd"] == \
        per_stage["loss"]["flash_carry"], per_stage
    # qwen3 has no Mamba2 layer
    assert per_stage["loss"]["ssd_chunks_bwd"] == 0
    assert per_stage["train_step"]["ssd_chunks_bwd"] == 0, per_stage
    assert len(out["tokens"]) == quickstart.DECODE_TOKENS
    assert all(0 <= t < cfg.vocab_size for t in out["tokens"])
    return out


def sampled_gaps(torch):
    """Patch ``ServeEngine._sample_and_commit`` to record, per request id,
    the top-two logit gap at every token it samples; returns (gaps,
    restore)."""
    from repro_torch.serve.engine import ServeEngine
    original = ServeEngine._sample_and_commit
    gaps: dict = {}

    def recording(self, logits, sampling):
        top2 = logits.float().topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        for slot, req in enumerate(self.sched.slot_req):
            if req is not None and sampling[slot]:
                gaps.setdefault(req.rid, []).append(float(gap[slot]))
        return original(self, logits, sampling)

    ServeEngine._sample_and_commit = recording

    def restore():
        ServeEngine._sample_and_commit = original
    return gaps, restore


def example_serve(torch, kernels, dev, card):
    """(b) ``examples.serve_batched.run`` at full width: qwen3-0.6b, bf16,
    ring of 4 in qlr, 10 requests, slot batch 4, first with the example's
    defaults (every prompt streams through the decode step: ring decode
    attention's flash hops alone) and then with block prefill of
    ``EXAMPLE_CHUNK`` tokens (the QKV ring's tile matmuls too). Then 4
    layers in fp32 with block prefill: the ring's greedy tokens against
    the dense backend's, equal but at an fp near-tie of dense's logits."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_batched
    from repro_torch.models import build_model
    cfg = get_config("qwen3-0.6b")
    params = build_model(cfg).init(seed=0, device=dev)
    out = {}
    for name, chunk in (("default", 0), ("block_prefill", EXAMPLE_CHUNK)):
        c0 = launch_counts(kernels)
        res = serve_batched.run(cfg, ring=True, mode="qlr",
                                prefill_chunk=chunk, n_pe=N_PE,
                                params=params, device=dev)
        torch.cuda.synchronize()
        res["launches"] = {k: v - c0[k]
                           for k, v in launch_counts(kernels).items()}
        out[name] = res
        log(f"[examples] serve_batched {name} (prefill chunk {chunk}): "
            f"{res['done']}/{res['requests']} requests ({res['backend']}), "
            f"{res['tokens']} tokens in {res['ticks']} ticks, "
            f"{res['tok_per_s']:.2f} tok/s on {card}; launches "
            f"{res['launches']}")
        assert res["done"] == res["requests"] == 10, res
    assert out["default"]["launches"]["flash_carry"] > 0
    for k in kernels:
        assert out["block_prefill"]["launches"][k.name] > 0, \
            f"{k.name} never launched in serve_batched"
    del params
    torch.cuda.empty_cache()

    cfg32 = replace(cfg, num_layers=EXAMPLE_PARITY_LAYERS, dtype="float32",
                    param_dtype="float32")
    params = build_model(cfg32).init(seed=0, device=dev)
    gaps, restore = sampled_gaps(torch)
    try:
        dense = serve_batched.run(cfg32, prefill_chunk=EXAMPLE_CHUNK,
                                  params=params, device=dev)
        dense_gaps = dict(gaps)
        gaps.clear()
        ring = serve_batched.run(cfg32, ring=True, mode="qlr",
                                 prefill_chunk=EXAMPLE_CHUNK, n_pe=N_PE,
                                 params=params, device=dev)
    finally:
        restore()
    want = {r["rid"]: r["tokens"] for r in dense["out"]}
    ties, equal = [], 0
    for r in ring["out"]:
        for i, (a, b) in enumerate(zip(r["tokens"], want[r["rid"]])):
            if a != b:
                gap = dense_gaps[r["rid"]][i]
                assert gap < TIE_GAP, (r["rid"], i, a, b, gap)
                ties.append({"rid": r["rid"], "token": i, "gap": gap})
                break
        else:
            equal += r["tokens"] == want[r["rid"]]
    assert len(ties) <= 1, ties
    assert dense["done"] == ring["done"] == 10
    out["fp32_parity"] = {"layers": EXAMPLE_PARITY_LAYERS,
                          "requests_equal": equal, "near_ties": ties,
                          "min_gap": min(min(g) for g in dense_gaps.values())}
    log(f"[examples] serve_batched fp32 ring against dense: "
        f"{json.dumps(out['fp32_parity'])}")
    for res in out.values():
        res.pop("out", None)
    return out


def example_topologies(torch, kernels, dev):
    """(c) ``examples.systolic_topologies.run`` at the reference example's
    shapes on 8 PEs: each section within its bound in every mode, conv2d
    and the FFT identical across modes, each section's kernels launched
    (counted per call by ``roofline.count.Counter``), ``sw`` counting more
    ops than ``xqueue`` and ``qlr`` in each ring section."""
    from repro_torch.examples import systolic_topologies as st
    c0 = launch_counts(kernels)
    out = st.run(dev)
    torch.cuda.synchronize()
    launched = {k: v - c0[k] for k, v in launch_counts(kernels).items()}
    bounds = {"matmul": ("rel_err", 1e-4, "tile_matmul"),
              "attention": ("err", 1e-5, "flash_carry"),
              "moe": ("rel_err", 1e-4, "tile_matmul"),
              "conv2d": ("err", 1e-5, "conv2d_3x3"),
              "fft": ("rel_err", 1e-5, "fft_stage")}
    summary = {"topologies": out["topologies"]}
    for section, (key, tol, kern) in bounds.items():
        recs = out[section]
        summary[section] = {m: {f: recs[m][f] for f in
                                ("err", "rel_err", "ops", "launches")}
                            for m in st.MODES}
        for mode in st.MODES:
            assert recs[mode][key] <= tol, (section, mode, recs[mode][key])
            # the MoE's baseline is the dense dispatch, which launches none
            if not (section == "moe" and mode == "baseline"):
                assert recs[mode]["launches"].get(kern, 0) > 0, \
                    (section, mode, recs[mode]["launches"])
        if section in ("matmul", "attention", "moe"):
            assert recs["sw"]["ops"] > recs["xqueue"]["ops"], section
            assert recs["sw"]["ops"] > recs["qlr"]["ops"], section
        else:
            summary[section]["identical"] = recs["identical"]
            assert recs["identical"], f"{section}: modes differ"
    for k in kernels:           # no Mamba2 layer, no backward here
        if k.name not in ("ssd_chunks", "ssd_chunks_bwd", "flash_carry_bwd"):
            assert launched[k.name] > 0, f"{k.name} never launched"
    summary["launches"] = launched
    log(f"[examples] systolic_topologies: {json.dumps(summary)}")
    return summary


def example_train(torch, kernels, dev):
    """(d) ``examples.train_lm.run(full=True)``: olmo-1b cut to ~100M
    parameters, 16 x 512 tokens a step, cut to ``EXAMPLE_TRAIN[0]`` steps
    (checkpoint every 10) and resumed to ``EXAMPLE_TRAIN[1]``; checkpoints
    and a per-step log under ``build/examples_train_lm/`` (deleted after).
    Losses finite and falling from step 1 to the cut; the resumed run
    starts at the cut. Step ms and tokens/s are
    medians past the first step of the cut run."""
    import shutil
    import signal
    from repro_torch.examples import train_lm
    out = ROOT / "build" / "examples_train_lm"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cut, total = EXAMPLE_TRAIN
    log_path = out / "log.jsonl"

    def extra(steps):
        return ["--steps", str(steps), "--train-set", "checkpoint_every=10",
                "--ckpt-dir", str(out / "ckpt"), "--train-set",
                "log_every=1", "--log", str(log_path)]

    def logged():
        return [json.loads(line) for line in
                log_path.read_text().splitlines()]

    handler = signal.getsignal(signal.SIGTERM)        # the launcher's hook
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        first = train_lm.run(full=True, device=str(dev), extra=extra(cut))
        n_first = len(logged())
        resumed = train_lm.run(full=True, resume=True, device=str(dev),
                               extra=extra(total))
    finally:
        signal.signal(signal.SIGTERM, handler)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    recs = logged()
    shutil.rmtree(out / "ckpt", ignore_errors=True)
    losses = [r["loss"] for r in recs]
    step_s = [r["step_s"] for r in recs[1:cut]]
    argv = first["argv"]

    def last(flag):
        return int(argv[len(argv) - argv[::-1].index(flag)])
    tokens = last("--batch") * last("--seq")
    result = {"argv": argv, "resumed_argv": resumed["argv"],
              "seconds": seconds, "losses": losses, "tokens_per_step": tokens,
              "step_ms": float(np.median(step_s)) * 1e3,
              "tokens_per_s": tokens / float(np.median(step_s)),
              "peak_mem_gb": peak, "resumed_from": recs[n_first]["step"]}
    log(f"[examples] train_lm --full: {json.dumps(result)}")
    assert [r["step"] for r in recs] == list(range(total)), recs
    assert n_first == cut and result["resumed_from"] == cut
    assert int(resumed["state"]["opt"]["step"]) == total
    assert all(np.isfinite(losses)), losses
    assert losses[cut - 1] < losses[0], losses
    return result


def phase16(torch, kernels, dev, card):
    """The four examples through their ``run`` functions, each path's
    launches counted from zero just before it; returns {run: result} and
    {path: launches}."""
    fk_mm = [k for k in kernels if k.name in ("flash_carry", "tile_matmul")]
    launches, out = {}, {}
    t_phase = time.perf_counter()

    def counted(name, fn):
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        res = fn()
        launches[name] = launch_counts(kernels)
        log(f"[phase16] {name}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launches[name]}")
        return res

    out["quickstart"] = counted(
        "examples_quickstart", lambda: example_quickstart(torch, fk_mm, dev))
    torch.cuda.empty_cache()
    out["serve_batched"] = counted(
        "examples_serve", lambda: example_serve(torch, fk_mm, dev, card))
    torch.cuda.empty_cache()
    out["systolic_topologies"] = counted(
        "examples_topologies",
        lambda: example_topologies(torch, kernels, dev))
    out["train_lm"] = counted(
        "examples_train", lambda: example_train(torch, kernels, dev))
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card
    log(f"[phase16] phase 16 {out['seconds']:.1f} s")
    return out, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.core import fft
    from repro_torch.kernels.conv2d import kernel as ck
    from repro_torch.kernels.fft import kernel as ffk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.systolic_matmul import kernel as mk

    dev = torch.device("cuda")
    card = gpu_name_and_limit()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build_all(kernels.ALL)
    log(f"[build] {len(kernels.ALL)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for k in kernels.ALL:
        for func, info in ptxas_summary(k.ptxas_log):
            log(f"[build] {k.name}: {func}: {info}")

    cases = flash_cases(torch, fk, dev)
    flash = check_flash(torch, fk, dev, cases)
    flash_bwd = check_flash_backward(torch, fk, dev, cases)
    del cases
    for rec in flash:           # each training hop's backward beside it
        for b in flash_bwd:
            if b["case"] == rec["case"]:
                rec["backward"] = {k: b[k] for k in (
                    "ms", "passes_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "plain_ms", "twin_backward_ms")}
    mm = check_matmul(torch, mk, dev)
    # phase 14 (a) runs here, beside phase 2's cases: late in a long run
    # the profiler loses launches (time_ms then falls back to events)
    blocks = block_knob(torch, mk, dev)
    conv = check_conv(torch, ck, dev)
    ffts = check_fft(torch, ffk, fft, dev)
    ssds = check_ssd(torch, sk, dev)
    ssd_bwd = check_ssd_backward(torch, sk, dev)
    for rec in ssds:            # each training shape's backward beside it
        for b in ssd_bwd:
            if b["case"] == rec["case"]:
                rec["backward"] = {k: b[k] for k in (
                    "ms", "passes_ms", "bound_ms", "bound_by",
                    "max_abs_err", "plain_ms", "twin_backward_ms")}
    bad = [r["case"] for r in flash + flash_bwd + mm + blocks + conv + ffts
           + ssds + ssd_bwd if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")

    served = serve_full_width(torch, (fk.FLASH_CARRY, mk.TILE_MATMUL), dev)
    modes_agree(torch, dev)

    for k in kernels.ALL:
        k.launches = 0
    t0 = time.perf_counter()
    dsp = dsp_suite(torch, kernels.ALL, dev)
    dsp_launches = {k.name: k.launches for k in kernels.ALL}
    log(f"[dsp] phase {time.perf_counter() - t0:.1f} s, launches "
        f"{dsp_launches}")
    for k in (mk.TILE_MATMUL, ck.CONV2D_3X3, ffk.FFT_STAGE):
        assert dsp_launches[k.name] > 0, \
            f"kernel {k.name} never launched on the DSP path"

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prefill = mamba_prefill(torch, kernels.ALL, sk, dev)
    parity = mamba_parity(torch, sk, dev)
    mserve = mamba_serve(torch, kernels.ALL, sk, dev)
    log(f"[mamba] phases 6-8 {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_full_width(torch, (fk.FLASH_CARRY, mk.TILE_MATMUL), dev)
    t1 = time.perf_counter()
    tparity = train_parity(torch, dev)
    log(f"[train-parity] {time.perf_counter() - t1:.1f} s")
    log(f"[train] phase 9 {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launcher = serve_launcher(torch, (fk.FLASH_CARRY, mk.TILE_MATMUL), dev,
                              card)
    log(f"[launcher] phase 10 {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    main_path = (fk.FLASH_CARRY, mk.TILE_MATMUL)
    for k in kernels.ALL:
        k.launches = 0
    mprefill, mcfg, mparams = moe_prefill(torch, main_path, dev)
    moeserve = moe_serve(torch, main_path, mcfg, mparams, dev)
    del mparams
    torch.cuda.empty_cache()
    mparity_launch0 = {k.name: k.launches for k in main_path}
    mparity = moe_parity(torch, main_path, dev)
    mparity_launches = {k.name: k.launches - mparity_launch0[k.name]
                        for k in main_path}
    torch.cuda.empty_cache()
    mtrain = moe_train(torch, main_path, dev)
    torch.cuda.empty_cache()
    gprefill = grid_prefill(torch, main_path, dev)
    cgrid = cannon_grid_skew(torch, kernels.ALL, dev)
    log(f"[moe-grid] phase 11 {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p12, p12_launches = phase12(torch, kernels.ALL, sk, dev)
    log(f"[phase12] phase 12 {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p13, p13_launches = phase13(torch, main_path, dev)
    log(f"[phase13] phase 13 {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    p14, p14_launches = phase14(torch, main_path, mk, dev, card, blocks)

    torch.cuda.empty_cache()
    p15, p15_launches = phase15(torch, kernels.ALL, dev, card, train)

    torch.cuda.empty_cache()
    p16, p16_launches = phase16(torch, kernels.ALL, dev, card)

    def entry(kern, source, replaces, recs, primary):
        top = next(r for r in recs if r["case"] == primary)
        by_path = {"serve": served["launches"].get(kern.name, 0),
                   "dsp": dsp_launches[kern.name],
                   "mamba_prefill": prefill["launches"][kern.name],
                   "mamba_serve": mserve["launches"][kern.name],
                   "train": train["launches"].get(kern.name, 0),
                   "serve_launcher": launcher["launches"].get(kern.name, 0),
                   "moe_prefill": mprefill["launches"].get(kern.name, 0),
                   "moe_parity": mparity_launches.get(kern.name, 0),
                   "moe_train": mtrain["launches"].get(kern.name, 0),
                   "moe_serve": moeserve["dense"]["launches"].get(
                       kern.name, 0)
                   + moeserve["ring"]["launches"].get(kern.name, 0),
                   "grid_prefill": gprefill["launches"].get(kern.name, 0),
                   "cannon_grid": cgrid["launches"][kern.name],
                   **{name: got[kern.name]
                      for name, got in p12_launches.items()
                      if name != "zamba_grad"},
                   **{name: got.get(kern.name, 0)
                      for name, got in p13_launches.items()},
                   **{name: got.get(kern.name, 0)
                      for name, got in p14_launches.items()},
                   **{name: got.get(kern.name, 0)
                      for name, got in p15_launches.items()},
                   **{name: got.get(kern.name, 0)
                      for name, got in p16_launches.items()}}
        per_call = {c: v[kern.name] for c, v in
                    served["launches_per_call"].items() if kern.name in v}
        per_call.update({
            f"{r['workload']} {r['size'].split()[0]} {r['mode']}":
            r["launches_per_call"][kern.name]
            for r in dsp if kern.name in r["launches_per_call"]})
        if prefill["launches_per_call"][kern.name]:
            per_call["mamba_prefill"] = \
                prefill["launches_per_call"][kern.name]
        if train["launches_per_step"].get(kern.name):
            per_call["train_step"] = train["launches_per_step"][kern.name]
        # phase 11: a prefill call, a ring call of the parity check, a
        # training step, a decode step, a grid prefill on 4 PEs (and 8),
        # a Cannon call
        per_call["moe_prefill"] = mprefill["launches_per_call"].get(
            kern.name, 0)
        per_call["moe_parity"] = \
            mparity["launches_per_ring_call"].get(kern.name, 0)
        per_call["moe_train"] = mtrain["launches"].get(kern.name, 0)
        per_call["moe_serve"] = 0
        per_call["grid_prefill"] = \
            gprefill["launches_per_call"][4].get(kern.name, 0)
        per_call["grid_prefill_8pe"] = \
            gprefill["launches_per_call"][8].get(kern.name, 0)
        per_call["cannon_grid"] = cgrid["launches"][kern.name] // 8
        # phase 12: a zamba2 prefill call and training step, a ring decode
        # tick, a qwen3-14b block prefill and decode step, an olmo-1b and
        # a granite-34b (4 layers) prefill call
        per_call["zamba_prefill"] = p12["zamba_prefill"][
            "launches_per_call"].get(kern.name, 0)
        per_call["zamba_train_step"] = p12["zamba_train"][
            "launches_per_step"].get(kern.name, 0)
        ring = p12["zamba_serve"]["ring"]
        per_call["zamba_serve_tick"] = ring["launches"].get(kern.name, 0) \
            // ring["ticks"]
        for call in ("prefill", "decode_step"):
            per_call[f"qwen3_14b_{call}"] = p12["qwen3_14b_serve"][
                "launches_per_call"][call].get(kern.name, 0)
        ring = p12["zamba_serve_fp32"]["ring"]
        per_call["zamba_serve_fp32_tick"] = \
            ring["launches"].get(kern.name, 0) // ring["ticks"]
        for run in ("olmo_prefill", "granite_prefill"):
            per_call[run] = p12[run]["launches_per_call"].get(kern.name, 0)
        per_call["olmo_train_step"] = p12["olmo_train"][
            "launches_per_step"].get(kern.name, 0)
        # phase 13: an internvl2 prefill call, training step, block prefill
        # and decode step; a deepseek prefill call and training step; a
        # whisper encode, prefill, decode step and training step
        for run in ("vlm_prefill", "mla_prefill"):
            per_call[run] = p13[run]["launches_per_call"].get(kern.name, 0)
        for run in ("vlm_train", "mla_train", "whisper_train"):
            per_call[f"{run}_step"] = p13[run]["launches_per_step"].get(
                kern.name, 0)
        for call in ("prefill", "decode_step"):
            per_call[f"vlm_serve_{call}"] = p13["vlm_serve"][
                "launches_per_call"][call].get(kern.name, 0)
        for call in ("encode", "prefill"):
            per_call[f"whisper_{call}"] = p13["whisper_prefill"][call][
                "launches_per_call"].get(kern.name, 0)
        # the decode run's tile matmuls are its one encode's
        dec = p13["whisper_parity"]["prefill_vs_decode"]
        per_call["whisper_decode_step"] = \
            dec["launches"]["flash_carry"] // (dec["prompt"]
                                               + dec["new_tokens"]) \
            if kern.name == "flash_carry" else 0
        # phase 14: the tuned qwen3-0.6b prefill call
        per_call["autotune_tuned_prefill"] = \
            p14["tuned"]["prefill"]["launches"].get(kern.name, 0)
        # phase 16: the quickstart's loss and its train step
        for stage in ("loss", "train_step"):
            per_call[f"examples_quickstart_{stage}"] = p16["quickstart"][
                "launches_per_stage"][stage].get(kern.name, 0)
        return {"name": kern.name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"], "primary_case": primary,
                "of_bound": top["of_bound"], "vs_library": top["vs_library"],
                "launches_per_call": per_call, "cases": recs}

    report = {"kernels": [
        entry(fk.FLASH_CARRY, "src/repro_torch/csrc/flash_carry.cu",
              "src/repro/kernels/flash_attention/kernel.py:140", flash,
              "decode_hop"),
        # no Pallas kernel: the reference's custom VJP of its flash hop
        entry(fk.FLASH_CARRY_BWD, "src/repro_torch/csrc/flash_carry_bwd.cu",
              "src/repro/kernels/flash_attention/ops.py:129", flash_bwd,
              "train_zero_state"),
        entry(mk.TILE_MATMUL, "src/repro_torch/csrc/tile_matmul.cu",
              "src/repro/kernels/systolic_matmul/kernel.py:104",
              mm + blocks, "ffn_ag_hop"),
        entry(sk.SSD_CHUNKS, "src/repro_torch/csrc/ssd_chunks.cu",
              "src/repro/kernels/ssd/kernel.py:74", ssds, "prefill_bf16"),
        # no Pallas kernel: jnp autodiff of the reference's chunked SSD
        entry(sk.SSD_CHUNKS_BWD, "src/repro_torch/csrc/ssd_chunks_bwd.cu",
              "src/repro/models/ssm.py:81", ssd_bwd, "zamba_prefill_bf16"),
        entry(ck.CONV2D_3X3, "src/repro_torch/csrc/conv2d_3x3.cu",
              "src/repro/kernels/conv2d/kernel.py:50", conv, "card_fp32"),
        entry(ffk.FFT_STAGE, "src/repro_torch/csrc/fft_stage.cu",
              "src/repro/kernels/fft/kernel.py:58", ffts, "fft256_B4096"),
    ], "serve": served, "dsp": dsp, "mamba_prefill": prefill,
        "mamba_parity": parity, "mamba_serve": mserve, "train": train,
        "train_parity": tparity, "serve_launcher": launcher,
        "moe_prefill": mprefill, "moe_parity": mparity, "moe_train": mtrain,
        "moe_serve": moeserve, "grid_prefill": gprefill,
        "cannon_grid": cgrid, "phase12": p12, "phase13": p13,
        "phase14": p14, "phase15": p15, "phase16": p16}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
