"""Per-client minibatch gathering for stacked cohort shards."""
from __future__ import annotations

from typing import Dict

import torch


def cohort_batch(data: Dict[str, torch.Tensor],
                 idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gather each client's minibatch from its own shard.

    data: {x (n_c, M, L), y (n_c, M)}, idx (n_c, B) sample indices per
    client -> {x (n_c, B, L), y (n_c, B)}. The index layout is the
    reference's ``take_along_axis`` one; drawing ``idx`` is the caller's
    business (a ``torch.Generator``, or indices replayed from elsewhere)."""
    idx = idx.to(device=data["y"].device, dtype=torch.long)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {"x": data["x"][rows, idx], "y": data["y"][rows, idx]}
