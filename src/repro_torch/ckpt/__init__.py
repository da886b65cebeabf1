from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer, all_steps, latest_step, restore, save,
)

__all__ = ["AsyncCheckpointer", "all_steps", "latest_step", "restore", "save"]
