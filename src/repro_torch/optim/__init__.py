from repro_torch.optim.adamw import (
    OptimConfig, adamw_update, cosine_lr, global_norm, init_opt_state)

__all__ = ["OptimConfig", "adamw_update", "cosine_lr", "global_norm",
           "init_opt_state"]
