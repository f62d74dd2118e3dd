from repro_torch.models.convert import (
    params_from_reference,
    params_to_reference,
    state_from_reference,
    state_to_reference,
)
from repro_torch.models.model import build_model, input_specs

__all__ = ["build_model", "input_specs", "params_from_reference",
           "params_to_reference", "state_from_reference",
           "state_to_reference"]
