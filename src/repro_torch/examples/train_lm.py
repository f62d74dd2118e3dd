"""End-to-end training example: train a ~10M-parameter LM for 30
steps (``--full``: ~100M parameters, 300 steps) with the full substrate of
the port's launcher (data pipeline, AdamW, remat, checkpoints, resume,
watchdog).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full

The launcher's arguments are those the JAX package's
``examples/train_lm.py`` hands its launcher; the shapes are the only
difference between the two runs. Checkpoints go to
``repro_torch_train_lm[_full]`` under the temporary directory, apart from
the JAX package's, so that ``--resume`` never reads a checkpoint of the
other package.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from repro_torch.launch.train import main as train_main


def ckpt_dir(full: bool) -> str:
    name = "repro_torch_train_lm" + ("_full" if full else "")
    return str(Path(tempfile.gettempdir()) / name)


def launcher_argv(full: bool = False, resume: bool = False,
                  device: str = "cuda") -> list[str]:
    """The argument list handed to ``repro_torch.launch.train.main``."""
    if full:
        # ~100M params: olmo-family dense, 8 layers, d=768, ff=3072, 32k vocab
        argv = [
            "--arch", "olmo-1b", "--steps", "300", "--batch", "16",
            "--seq", "512",
            "--set", "num_layers=8", "--set", "d_model=768",
            "--set", "num_heads=12", "--set", "num_kv_heads=12",
            "--set", "head_dim=64", "--set", "d_ff=3072",
            "--set", "vocab_size=32768",
            "--train-set", "checkpoint_every=100",
            "--train-set", "warmup_steps=20",
            "--train-set", "learning_rate=0.0006",
            "--ckpt-dir", ckpt_dir(full),
        ]
    else:
        argv = [
            "--arch", "olmo-1b", "--steps", "30", "--batch", "8",
            "--seq", "128",
            "--set", "num_layers=4", "--set", "d_model=256",
            "--set", "num_heads=8", "--set", "num_kv_heads=8",
            "--set", "head_dim=32", "--set", "d_ff=1024",
            "--set", "vocab_size=8192",
            "--train-set", "checkpoint_every=10",
            "--train-set", "warmup_steps=5",
            "--train-set", "learning_rate=0.001",
            "--train-set", "log_every=5",
            "--ckpt-dir", ckpt_dir(full),
        ]
    if resume:
        argv.append("--resume")
    return argv + ["--device", device]


def run(full: bool = False, resume: bool = False, device: str = "cuda",
        extra=()) -> dict:
    """Run the launcher on :func:`launcher_argv` followed by ``extra``
    (later flags win: ``--steps``, ``--ckpt-dir``, ``--train-set``);
    returns the argument list and the final train state."""
    argv = launcher_argv(full, resume, device) + list(extra)
    return {"argv": argv, "state": train_main(argv)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' only on request)")
    args = ap.parse_args(argv)
    return run(args.full, args.resume, args.device)


if __name__ == "__main__":
    main()
