from repro_torch.checkpoint.io import (AsyncCheckpointer, restore,
                                       restore_sharded, save, save_sharded,
                                       saved_topology)

__all__ = ["AsyncCheckpointer", "restore", "restore_sharded", "save",
           "save_sharded", "saved_topology"]
