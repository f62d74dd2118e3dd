"""Loader for the JAX reference, shared by the port's parity tests.

The reference's ``repro/compat.py`` registers a vmap rule for
``optimization_barrier`` unless ``batching.primitive_batchers`` already
holds one, and on newer jax that container is a proxy that cannot be
searched, so importing ``repro.compat`` raises ``TypeError``. Newer jax
already batches the barrier, so skipping the registration is what
compat.py means to do there: the loader swaps the container for one that
claims every rule exists, imports ``repro.compat``, and puts the original
back. It runs from fixtures only, never at import, so the reference's own
test files collect exactly as they would without it.
"""
from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

SRC = Path(__file__).resolve().parent.parent / "src"


class _AnyRule:
    def __contains__(self, key):
        return True


def load_reference():
    """Import ``repro.compat`` under the workaround; returns the
    ``repro`` package."""
    from jax.interpreters import batching
    if "repro.compat" not in sys.modules:
        original = batching.primitive_batchers
        batching.primitive_batchers = _AnyRule()
        try:
            importlib.import_module("repro.compat")
        finally:
            batching.primitive_batchers = original
    return importlib.import_module("repro")


@pytest.fixture(scope="module")
def ref():
    """The reference package, importable through ``repro.*`` afterwards."""
    return load_reference()


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def smoke_fp32(arch: str = "qwen3-0.6b"):
    """(reference config, port config): the SMOKE model pinned to fp32, as
    ``tests/test_parity.py`` pins it."""
    from dataclasses import replace
    from repro.configs import get_smoke_config as r_smoke
    from repro_torch.configs import get_smoke_config
    fp32 = dict(dtype="float32", param_dtype="float32")
    return replace(r_smoke(arch), **fp32), replace(get_smoke_config(arch),
                                                   **fp32)


def reference_model(cfg, seed: int = 0):
    """(reference model, its jax parameters, the same as numpy leaves)."""
    from repro.models import build_model, split_tree
    model = build_model(cfg)
    params, _ = split_tree(model.init(jax.random.PRNGKey(seed)))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def perturbed(tree, seed: int = 0, scale: float = 0.1):
    """``tree`` (numpy leaves) with noise added to every leaf that holds
    one value throughout (biases at zero, norm scales at one), so that
    parity checks see them count."""
    rng = np.random.default_rng(seed)

    def bump(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(bump, tree)


def test_loader_restores_batching_rules(ref):
    from jax.interpreters import batching
    assert not isinstance(batching.primitive_batchers, _AnyRule)
    from repro.kernels.flash_attention import ops  # noqa: F401
    from repro.serve import engine  # noqa: F401


def test_port_imports_no_jax():
    """The port package and chip_smoke.py load without jax or repro."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import repro_torch.serve.engine, repro_torch.kernels\n"
        "import repro_torch.core.ring_attention, repro_torch.models\n"
        "import repro_torch.core.halo, repro_torch.core.fft\n"
        "import repro_torch.configs.mempool_dsp, repro_torch.kernels.fft.ops\n"
        "import repro_torch.models.moe, repro_torch.core.ring_moe\n"
        "import repro_torch.autotune\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n" % str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True)
    root = SRC.parent
    for path in [root / "chip_smoke.py", *sorted(
            (SRC / "repro_torch").rglob("*.py"))]:
        text = path.read_text()
        for banned in ("import jax", "from jax", "from repro ",
                       "from repro.", "import repro\n", "import repro."):
            assert banned not in text, (path, banned)


def test_cuda_entry_points_raise_without_gpu():
    """Asking for the card where there is none raises; nothing silently
    runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_model(get_smoke_config("qwen3-0.6b")).init(0)
