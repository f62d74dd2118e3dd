"""Parameters from the seed, made on the device.

The port's parameter tree gives the structure, shapes and types
(``train/step.params_shapes``: fake tensors, nothing allocated). The
values are the benchmark's: one standard normal draw for the whole tree
on a ``torch.Generator`` of the device, cut into the leaves and shaped per
leaf by the rules below, in each leaf's own type. The program and the
reference get the same values. No leaf is left at zero or one, so every
leaf takes part in the comparison.

Rules, by leaf name (the Mamba2 ones follow the Mamba2 release's
initialisation: A in [1, 16], dt in [1e-3, 1e-1] through the inverse
softplus):

* ``table`` (embedding, tied head): 0.02 N;
* ``A_log``: log(1 + 15 U); ``dt_bias``: softplus⁻¹(exp(log 1e-3 + U log
  100)); ``D``: 1 + 0.1 N (U is N through the normal CDF);
* ``wo`` [H, hd, D]: N / sqrt(H hd); an adapter's ``b``: 0.1 N / sqrt(rank);
* any other leaf of two or more dimensions: N / sqrt(shape[0]);
* a vector named like a norm scale: 1 + 0.1 N; any other vector: 0.02 N.
"""
from __future__ import annotations

import hashlib
import math

import torch

from perfbench.lib.tree import leaves, rebuild


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _shape(path, n: torch.Tensor, shape) -> torch.Tensor:
    name = path[-1]
    u = lambda: 0.5 * (1.0 + torch.erf(n / math.sqrt(2.0)))  # noqa: E731
    if name == "table":
        return 0.02 * n
    if name == "A_log":
        return torch.log1p(15.0 * u())
    if name == "dt_bias":
        dt = torch.exp(math.log(1e-3) + u() * math.log(100.0))
        return dt + torch.log(-torch.expm1(-dt))
    if name == "D":
        return 1.0 + 0.1 * n
    if len(shape) >= 2:
        if name == "wo":
            return n / math.sqrt(shape[0] * shape[1])
        gain = 0.1 if name == "b" and "adapters" in path else 1.0
        return gain * n / math.sqrt(shape[0])
    if "scale" in name:
        return 1.0 + 0.1 * n
    return 0.02 * n


def make(cfg, seed: int, device) -> dict:
    """The parameter tree of ``cfg`` with the benchmark's values."""
    from repro_torch.train.step import params_shapes
    tree = params_shapes(cfg, device="cpu")
    shapes = leaves(tree)
    total = sum(t.numel() for _, t in shapes)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    values, off = {}, 0
    for path, fake in shapes:
        n = flat[off:off + fake.numel()].view(fake.shape)
        values[path] = _shape(path, n, fake.shape).to(fake.dtype)
        off += fake.numel()
    del flat
    return rebuild(tree, values)
