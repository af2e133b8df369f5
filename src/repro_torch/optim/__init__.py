"""AdamW with a cosine schedule and global-norm clipping."""
from repro_torch.optim.adamw import (OptConfig, OptState, abstract_state,
                                     apply_updates, clip_by_global_norm,
                                     global_norm, init, schedule)

__all__ = ["OptConfig", "OptState", "abstract_state", "apply_updates",
           "clip_by_global_norm", "global_norm", "init", "schedule"]
