from repro_torch.models.model import (
    Transformer,
    build_plan,
    forward_decode,
    forward_prefill,
    forward_train,
    init_cache,
    param_spec,
)
from repro_torch.models.params import (
    abstract_params,
    init_params,
    param_count,
    params_from_arrays,
    params_to_arrays,
)

__all__ = [
    "Transformer",
    "build_plan",
    "forward_decode",
    "forward_prefill",
    "forward_train",
    "init_cache",
    "param_spec",
    "abstract_params",
    "init_params",
    "param_count",
    "params_from_arrays",
    "params_to_arrays",
]
