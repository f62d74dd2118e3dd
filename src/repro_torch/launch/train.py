"""Training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 30 --batch 8 --seq 128 --device cpu

The reference's CLI (``repro/launch/train.py``) on one card: config
overrides (--set k=v, --train-set k=v), the deterministic data pipeline,
async atomic checkpoints + auto-resume (--resume), the preemption hook
(SIGTERM), the straggler watchdog and metrics JSONL (--log).

Against the reference: ``--mesh`` and ``--multihost`` are gone (one card
has no device mesh and no hosts to join); ``--n-pe`` sets the emulated
systolic ring the model's ring paths run on (default 4, and 0 for
mamba2-1.3b, which has no ring: asking it for one raises; they engage when
``--set systolic_mode=...`` names a link mode and the shapes divide), and
``--device`` the device (default ``cuda``; it raises when there is no
GPU, and runs on the CPU only when asked to with ``--device cpu``).
``--arch`` takes the ported decoder configs: qwen3-0.6b, qwen3-14b,
olmo-1b, granite-34b, mixtral-8x22b, mamba2-1.3b, zamba2-1.2b,
deepseek-v2-lite-16b and internvl2-1b (on tokens alone). The token stream
carries no audio frames, so whisper-tiny trains through
``train.step.make_train_step`` with ``frames`` in its batch, as in the
reference.

Observability: --metrics-out FILE.json snapshots the run's registry
(steps/tokens counters, loss/lr gauges, step-time histogram) as JSON plus
a FILE.prom Prometheus twin; --trace-out FILE.json writes a Chrome trace
of the step phases (data / step / checkpoint) for Perfetto.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.configs import (
    TrainConfig,
    apply_overrides,
    config_summary,
    get_config,
    get_smoke_config,
)
from repro_torch.data.pipeline import DataLoader, SyntheticLM
from repro_torch.models.common import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import NullTracer, Tracer
from repro_torch.train import step as step_lib
from repro_torch.train.checkpoint import (
    CheckpointManager,
    install_preemption_hook,
)
from repro_torch.train.metrics import MetricLogger, StepTimer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-pe", type=int, default=None,
                    help="PEs of the emulated systolic ring (default 4; "
                         "0 for the ssm family, which has no ring)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' only on request)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="model config overrides key=value")
    ap.add_argument("--train-set", action="append", default=[],
                    dest="train_overrides")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log", default="")
    ap.add_argument("--metrics-out", default="",
                    help="write metrics snapshot JSON here (+ .prom twin)")
    ap.add_argument("--trace-out", default="",
                    help="write Chrome trace-event JSON here (Perfetto)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = apply_overrides(cfg, args.overrides)
    ckpt_dir = args.ckpt_dir or str(Path(tempfile.gettempdir())
                                    / f"repro_torch_ckpt_{args.arch}")
    tcfg = TrainConfig(total_steps=args.steps, checkpoint_dir=ckpt_dir)
    tcfg = apply_overrides(tcfg, args.train_overrides)

    n_pe = args.n_pe
    if n_pe is None:
        # Mamba2 has no ring path (its SSD chain runs inside each layer)
        n_pe = 0 if cfg.family == "ssm" else 4
    train_step = step_lib.make_train_step(cfg, tcfg, n_pe)
    state = step_lib.init_state(cfg, tcfg, tcfg.seed, dev)
    print(config_summary(cfg))

    ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints,
                             async_save=tcfg.async_checkpoint)
    start_step = 0
    loader = DataLoader(SyntheticLM(cfg.vocab_size, seed=tcfg.seed),
                        global_batch=args.batch, seq_len=args.seq)

    latest = ckpt.latest_step() if args.resume else None
    if latest is not None:
        state = ckpt.restore(latest, state)
        meta = ckpt.restore_meta(latest)
        loader.load_state_dict(meta.get("data_state", {"step": 0}))
        start_step = latest
        print(f"resumed from step {latest}")

    def emergency_save():
        step = int(state["opt"]["step"])
        print(f"[preempt] checkpointing at step {step}")
        ckpt.save(step, state, extra={"data_state": loader.state_dict()})
        ckpt.wait()

    install_preemption_hook(emergency_save)

    logger = MetricLogger(args.log or None)
    timer = StepTimer(deadline_s=tcfg.straggler_deadline_s)
    tokens_per_step = args.batch * args.seq

    registry = obs_metrics.Registry()
    tracer = Tracer() if args.trace_out else NullTracer()
    step_hist = registry.histogram("repro_train_step_seconds",
                                   "train step wall time")

    for step_i in range(start_step, args.steps):
        with tracer.span("data", cat="train"):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in next(loader).items()}
        timer.start()
        with tracer.span("step", cat="train", args={"step": step_i}):
            state, metrics = train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
        dt, slow = timer.stop()
        step_hist.observe(dt)
        registry.counter("repro_train_steps_total", "train steps run").inc()
        registry.counter("repro_train_tokens_total",
                         "tokens consumed").inc(tokens_per_step)
        registry.gauge("repro_train_loss", "last logged loss").set(
            metrics["loss"])
        registry.gauge("repro_train_lr", "last learning rate").set(
            metrics["lr"])
        registry.gauge("repro_train_tokens_per_second",
                       "tokens / step wall time").set(
            tokens_per_step / max(dt, 1e-9))
        if slow:
            tracer.instant("straggler", cat="train",
                           args={"step": step_i, "seconds": dt})
            registry.counter("repro_train_stragglers_total",
                             "steps past the watchdog deadline").inc()
            print(f"[watchdog] step {step_i} took {dt:.2f}s "
                  f"(deadline {tcfg.straggler_deadline_s}s)")
        if step_i % tcfg.log_every == 0 or step_i == args.steps - 1:
            logger.log(step_i, loss=metrics["loss"],
                       grad_norm=metrics["grad_norm"], lr=metrics["lr"],
                       tok_per_s=tokens_per_step / max(dt, 1e-9),
                       step_s=dt)
        if tcfg.checkpoint_every and (step_i + 1) % tcfg.checkpoint_every == 0:
            with tracer.span("checkpoint", cat="train",
                             args={"step": step_i + 1}):
                ckpt.save(step_i + 1, state,
                          extra={"data_state": loader.state_dict()})
    with tracer.span("checkpoint", cat="train", args={"step": args.steps}):
        ckpt.save(args.steps, state,
                  extra={"data_state": loader.state_dict()})
        ckpt.wait()
    loader.close()
    logger.close()
    if args.metrics_out:
        registry.dump_json(args.metrics_out)
        prom = args.metrics_out.rsplit(".", 1)[0] + ".prom"
        registry.dump_prometheus(prom)
        print(f"wrote {args.metrics_out}\nwrote {prom}")
    if args.trace_out:
        tracer.dump(args.trace_out)
        print(f"wrote {args.trace_out}")
    print(f"done: {args.steps} steps; watchdog {timer.summary()}")
    return state


if __name__ == "__main__":
    main()
