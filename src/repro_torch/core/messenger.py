"""Messengers (paper Def. 2): soft decisions on the shared reference set,
stored as LOG-probabilities ``(R, C)``; the repository stacks them into
``S (N, R, C)``."""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.core import wire


@torch.no_grad()
def cohort_messengers(model, ref_x: torch.Tensor,
                      codec: Union[None, str, wire.Codec] = None
                      ) -> Union[torch.Tensor, wire.Payload]:
    """(n_c, R, C) log-prob messengers of a stacked cohort; with ``codec``
    the stack is wire-encoded before it leaves the function."""
    ref_in = ref_x.expand((model.n_clients,) + tuple(ref_x.shape))
    logp = F.log_softmax(model(ref_in).float(), dim=-1)
    if codec is None:
        return logp
    return wire.encode(codec, logp, domain="log")
