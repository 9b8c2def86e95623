from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore,
    restore_elastic,
    save,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "restore_elastic",
           "save"]
