"""Per-client minibatch gathering for stacked cohort shards, and the LM
trainer's next-token batches."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def draw_batch_indices(generator: torch.Generator, n_real: int, m: int,
                       batch: int) -> torch.Tensor:
    """(n_real, batch) sample indices in [0, m), one row a REAL client,
    drawn from ``generator`` on its device. A ghost-padded cohort draws
    here at its real row count and pads the indices after
    (``cohort_batch_padded``), so the real rows' draws do not depend on
    the padding."""
    return torch.randint(0, m, (n_real, batch), generator=generator,
                         device=generator.device)


def cohort_batch(data: Dict[str, torch.Tensor],
                 idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gather each client's minibatch from its own shard.

    data: {x (n_c, M, L), y (n_c, M)}, idx (n_c, B) sample indices per
    client -> {x (n_c, B, L), y (n_c, B)}. The index layout is the
    reference's ``take_along_axis`` one; ``idx`` comes from
    ``draw_batch_indices`` or is replayed from elsewhere."""
    idx = idx.to(device=data["y"].device, dtype=torch.long)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {"x": data["x"][rows, idx], "y": data["y"][rows, idx]}


def cohort_batch_padded(data: Dict[str, torch.Tensor],
                        idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``cohort_batch`` for a ghost-padded stack: ``idx`` (n_real, B) is
    drawn at the REAL row count, so the draws of the real rows do not
    depend on the padding, then edge-replicated to data's rows. Ghost
    rows therefore gather the last real client's batch from their own
    (replicated) data rows."""
    pad = data["y"].shape[0] - idx.shape[0]
    if pad:
        idx = torch.cat([idx, idx[-1:].expand(pad, idx.shape[1])])
    return cohort_batch(data, idx)


def lm_batches(tokens: torch.Tensor, batch: int, seq: int,
               seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """Iterate {tokens, labels} next-token batches (B, seq) from a flat
    stream, on the stream's device: each row a random (seq+1)-token
    window, its starts drawn by numpy from ``seed`` as the reference
    draws them, so the same stream and seed give the reference's batches
    bit for bit. The stream must hold at least ``seq + 2`` tokens."""
    n = tokens.shape[0]
    if n < seq + 2:
        raise ValueError(
            f"token stream too short for seq={seq}: need at least seq + 2 "
            f"= {seq + 2} tokens for a random (seq+1)-token window, got "
            f"{n}; shorten seq or provide more tokens")
    rng = np.random.default_rng(seed)
    window = torch.arange(seq + 1, device=tokens.device)
    while True:
        starts = torch.from_numpy(rng.integers(0, n - seq - 1, size=batch))
        rows = tokens[starts.to(tokens.device)[:, None] + window]
        yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
