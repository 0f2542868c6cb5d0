from repro_torch.optim.optimizers import (AdamState, Optimizer, SGDState,
                                          adam, adamw, apply_updates,
                                          clip_by_global_norm,
                                          clip_tree_by_global_norm, sgd,
                                          single_model, state_tensors)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)

__all__ = [
    "AdamState", "Optimizer", "SGDState", "adam", "adamw", "apply_updates",
    "clip_by_global_norm", "clip_tree_by_global_norm", "sgd",
    "single_model", "state_tensors", "constant",
    "cosine_decay", "linear_warmup", "warmup_cosine",
]
