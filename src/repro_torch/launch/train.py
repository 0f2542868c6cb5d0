"""End-to-end LM training for the architecture zoo.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --steps 20 --device cpu

``--full`` trains the architecture at its published widths; ``--device``
defaults to ``cuda`` and fails without a card. Prints the reference's
summary (arch, n_params, final_ce, initial_ce) as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Iterator, Optional, Sequence

import torch

from repro_torch import Device, resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import lm_batches, lm_token_stream
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import ModelConfig, tree_leaves
from repro_torch.models.frontends import frontend_dim
from repro_torch.models.transformer import init_params
from repro_torch.optim import adam, single_model, warmup_cosine


def train_batches(cfg: ModelConfig, stream: torch.Tensor, batch: int,
                  seq: int, seed: int, generator: torch.Generator,
                  embeds: Optional[Sequence[torch.Tensor]] = None
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """``train()``'s batches on the stream's device: ``lm_batches`` of the
    stream, and for a frontend ``min(8, seq // 4)`` frames of embeds in
    front (``embeds[step]``, or N(0, 1) drawn from ``generator``), the
    tokens cut to ``seq - prefix`` and the labels kept at ``seq``."""
    dev = stream.device
    for step, b in enumerate(lm_batches(stream, batch, seq, seed=seed)):
        if cfg.frontend is not None:
            prefix = min(8, seq // 4)
            if embeds is None:
                e = torch.randn((batch, prefix, frontend_dim(cfg.frontend)),
                                generator=generator, device=dev)
            else:
                e = embeds[step]
            b["embeds"] = e.to(device=dev, dtype=cfg.param_dtype)
            b["tokens"] = b["tokens"][:, :seq - prefix]
            b["labels"] = b["labels"][:, :seq]
        yield b


def train(arch: str, reduced: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, seed: int = 0,
          moe_path: str = "dropless", log_every: int = 10,
          ckpt: Optional[str] = None, verbose: bool = True,
          device: Device = None, params=None,
          stream: Optional[torch.Tensor] = None,
          embeds: Optional[Sequence[torch.Tensor]] = None):
    """``steps`` Adam steps (warmup-cosine to ``lr``, clip 1.0, no remat)
    on ``batch`` x ``seq`` next-token batches of a synthetic token stream.

    Params, the stream and (for a frontend) each step's embeds are drawn
    from ``seed`` on the device unless given: the seams through which a
    test feeds the reference's draws (``embeds[step]``, one
    (batch, prefix, frontend dim) tensor a step). A frontend's prefix is
    ``min(8, seq // 4)`` frames; the tokens are cut to ``seq - prefix``
    and the labels kept at ``seq``, so the logits (frames, then tokens)
    line up with the labels, as in the reference. Given params set the
    config's ``param_dtype``. Each step's ce is read on the host (one sync a step,
    as the reference's ``float(metrics["ce"])``).

    With ``ckpt`` the final params and the losses are saved to
    ``{ckpt}/step_{steps}.msgpack``. Returns the reference's keys (arch,
    n_params, losses, final_ce, initial_ce), the final ``params`` and
    each step's host seconds (``step_s``)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if params is not None:
        cfg = dataclasses.replace(cfg, param_dtype=params["embed"].dtype)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = init_params(cfg, dev, gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    optimizer = single_model(adam(warmup_cosine(lr, steps // 10, steps)))
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer, moe_path=moe_path,
                              remat=False)
    if stream is None:
        stream = lm_token_stream(cfg.vocab_size,
                                 max(200_000, batch * (seq + 1) * 4),
                                 torch.Generator(device=dev).manual_seed(
                                     seed + 1), dev)
    it = train_batches(cfg, stream.to(dev), batch, seq, seed, gen, embeds)
    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, next(it))
        losses.append(float(metrics["ce"]))
        step_s.append(time.perf_counter() - t_step)
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"  step {step:5d}  ce={losses[-1]:.4f}  "
                  f"({time.perf_counter() - t0:.1f}s, "
                  f"{n_params / 1e6:.1f}M params)", flush=True)
    if ckpt:
        save_pytree(f"{ckpt}/step_{steps}.msgpack",
                    {"params": params, "losses": losses})
    return {"arch": cfg.name, "n_params": n_params, "losses": losses,
            "final_ce": losses[-1], "initial_ce": losses[0],
            "params": params, "step_s": step_s}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moe-path", default="dropless")
    ap.add_argument("--ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
                moe_path=args.moe_path, ckpt=args.ckpt, device=args.device)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("losses", "params", "step_s")},
                     indent=2))


if __name__ == "__main__":
    main()
