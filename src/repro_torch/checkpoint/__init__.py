from repro_torch.checkpoint.store import (latest_step, list_steps,
                                          manifest_paths, restore_checkpoint,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps", "manifest_paths"]
