"""Optimizers of the port (plain torch functions on dicts of tensors)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     apply_updates, clip_by_global_norm,
                                     cosine_schedule)
