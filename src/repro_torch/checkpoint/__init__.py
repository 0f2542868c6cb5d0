"""Federation checkpoints in the reference's msgpack format."""
from repro_torch.checkpoint.io import (ZooMismatchError, latest_step,
                                       restore_federation, restore_pytree,
                                       save_federation, save_pytree)

__all__ = ["ZooMismatchError", "latest_step", "restore_pytree",
           "save_pytree", "restore_federation", "save_federation"]
