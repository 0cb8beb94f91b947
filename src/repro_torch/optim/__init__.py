"""AdamW with its WSD schedule (port of ``repro.optim``)."""
from repro_torch.optim.adamw import (OptState, adamw_init_specs, adamw_update,
                                     global_norm)
from repro_torch.optim.schedule import lr_schedule

__all__ = ["OptState", "adamw_init_specs", "adamw_update", "global_norm",
           "lr_schedule"]
