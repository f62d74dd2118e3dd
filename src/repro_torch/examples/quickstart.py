"""Quickstart: build an assigned architecture, run a forward/loss, take one
optimizer step, and decode a few tokens, all through the public API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch qwen3-0.6b] [--device cpu]

The SMOKE config of ``--arch``, as in the JAX package's
``examples/quickstart.py``; ``run`` takes any config. One card has no
device mesh: ``n_pe`` (the emulated systolic ring the model's ring paths
run on) stands in for the reference's 1x1 mesh, and ``n_pe=0`` keeps its
meaning (no ring). ``--device`` defaults to ``cuda`` and raises where
there is no GPU.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs import TrainConfig, config_summary, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.common import adtype, resolve_device
from repro_torch.train import optimizer
from repro_torch.train import step as step_lib

BATCH, SEQ = 4, 64
DECODE_TOKENS = 5
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=0, schedule="constant")


def make_batch(cfg, device):
    """The [4, 64] token and target batch from two seeded generators (the
    reference's keys 1 and 2), with zero ``frames`` (encdec) or
    ``patch_embeds`` (vlm)."""
    dev = resolve_device(device)
    batch = {}
    for name, s in (("tokens", 1), ("targets", 2)):
        gen = torch.Generator(device=dev).manual_seed(s)
        batch[name] = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                    generator=gen, device=dev,
                                    dtype=torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((BATCH, cfg.enc_frames, cfg.d_model),
                                      dtype=adtype(cfg), device=dev)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (BATCH, cfg.num_patches, cfg.vit_dim), dtype=adtype(cfg),
            device=dev)
    return batch


def run(cfg, n_pe: int = 0, params=None, batch=None, device="cuda",
        on_stage=None) -> dict:
    """Loss, one ``make_train_step`` step and ``DECODE_TOKENS`` greedy
    tokens of ``cfg`` on a ring of ``n_pe`` PEs. ``params`` default to
    ``init(seed=0)``, ``batch`` to :func:`make_batch`; ``on_stage(name)``,
    when given, is called before each stage (``loss``, ``train_step``,
    ``decode``) and at the ``end``."""
    dev = resolve_device(device)
    stage = on_stage or (lambda name: None)
    model = build_model(cfg, n_pe)
    if params is None:
        params = model.init(seed=0, device=dev)
    if batch is None:
        batch = make_batch(cfg, dev)

    stage("loss")
    with torch.no_grad():
        loss, _ = model.loss(params, batch)
    loss = float(loss)

    stage("train_step")
    train_step = step_lib.make_train_step(cfg, TCFG, n_pe)
    state = {"params": params, "opt": optimizer.init_opt_state(params, TCFG)}
    state, metrics = train_step(state, batch)

    stage("decode")
    cache = model.init_cache(1, 32, device=dev)
    tok = torch.ones((1, 1), dtype=torch.int32, device=dev)
    tokens = []
    with torch.no_grad():
        for _ in range(DECODE_TOKENS):
            logits, cache = model.decode_step(state["params"], cache, tok)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            tokens.append(int(tok[0, 0]))
    stage("end")
    return {"summary": config_summary(cfg), "loss": loss,
            "ln_vocab": math.log(cfg.vocab_size),
            "step_loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "tokens": tokens}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' only on request)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    out = run(cfg, device=args.device)
    print(out["summary"])
    print(f"initial loss: {out['loss']:.3f} (ln V = {out['ln_vocab']:.3f})")
    print(f"after 1 step: loss={out['step_loss']:.3f} "
          f"grad_norm={out['grad_norm']:.2f}")
    print("greedy tokens:", out["tokens"])
    return out


if __name__ == "__main__":
    main()
