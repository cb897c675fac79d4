from repro_torch.optim.adamw import (
    OptState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_schedule,
)

__all__ = [
    "OptState",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_opt_state",
    "lr_schedule",
]
