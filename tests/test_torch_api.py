"""The reference's last public names, held against the port on the CPU.

``ModelConfig.is_attention_free`` on every shipped config and its SMOKE
twin: equal to the reference's, and true for the attention-free Mamba2
model alone.
"""
from __future__ import annotations

import pytest

from test_torch_reference import ref  # noqa: F401 (fixture)

from repro_torch.configs import ARCHS, get_config, get_smoke_config


@pytest.mark.parametrize("arch", ARCHS)
def test_is_attention_free_equals_reference(ref, arch):
    from repro.configs import get_config as r_config
    from repro.configs import get_smoke_config as r_smoke
    assert get_config(arch).is_attention_free == \
        r_config(arch).is_attention_free
    assert get_smoke_config(arch).is_attention_free == \
        r_smoke(arch).is_attention_free
    assert get_config(arch).is_attention_free == (arch == "mamba2-1.3b")
