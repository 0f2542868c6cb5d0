"""Batched serving driver: prefill + greedy decode against the cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --reduced --batch 4 --prompt-len 64 --decode 32

``--no-reduced`` runs the architecture at full width; ``--device``
defaults to ``cuda`` and fails without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from repro_torch import Device, resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch.steps import (greedy_sample, make_prefill_step,
                                      make_serve_step)
from repro_torch.models.common import ModelConfig
from repro_torch.models.frontends import frontend_dim
from repro_torch.models.transformer import init_params


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(arch: str, reduced: bool = True, batch: int = 4,
          prompt_len: int = 64, decode_len: int = 32, seed: int = 0,
          verbose: bool = True, device: Device = None, params=None,
          prompts: Optional[torch.Tensor] = None,
          embeds: Optional[torch.Tensor] = None,
          cfg: Optional[ModelConfig] = None, keep_logits: bool = False):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``decode_len`` tokens greedily. Params, prompts and (for a frontend)
    8 frames of embeds are drawn from ``seed`` on the device unless
    given: the seam through which a test feeds the reference's draws.
    Given prompts set the prompt length (``prompts.shape[1]``, whatever
    ``prompt_len`` says), and the cache holds it plus ``decode_len``
    positions. The prefill's MoE FFN takes the dropless path, as the
    reference's serve does.
    A given ``cfg`` replaces the arch's preset (a depth cut); given
    params set its ``param_dtype``. Returns the reference's keys (arch,
    generated shape, prefill_s, decode_s), the generated ``tokens``
    (B, decode_len) and the final ``cache``; with ``keep_logits`` also
    each step's fp32 ``logits`` (B, decode_len, V), the prefill's last
    position first."""
    if cfg is None:
        cfg = get_reduced(arch) if reduced else get_config(arch)
    if params is not None:
        cfg = dataclasses.replace(cfg, param_dtype=params["embed"].dtype)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = init_params(cfg, dev, gen)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=gen, dtype=torch.int32, device=dev)
    batch, prompt_len = prompts.shape
    prefill_fn = make_prefill_step(cfg, moe_path="dropless",
                                   cache_seq=prompt_len + decode_len)
    serve_fn = make_serve_step(cfg)
    batch_in = {"tokens": prompts.to(dev)}
    if cfg.frontend is not None:
        if embeds is None:
            embeds = torch.randn((batch, 8, frontend_dim(cfg.frontend)),
                                 generator=gen, device=dev)
        batch_in["embeds"] = embeds.to(device=dev, dtype=cfg.param_dtype)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, batch_in)
    tok = greedy_sample(logits)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens, steps = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for _ in range(decode_len - 1):
        logits, cache = serve_fn(params, tok, cache)
        tok = greedy_sample(logits)
        out_tokens.append(tok)
        if keep_logits:
            steps.append(logits[:, 0])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    seqs = torch.cat(out_tokens, dim=1)
    if bool(torch.isnan(logits).any()):
        # RuntimeError (not assert): the NaN check must survive python -O
        raise RuntimeError("NaN logits during decode")
    if verbose:
        print(f"  prefill {prompt_len} toks x{batch}: {t_prefill:.2f}s; "
              f"decode {decode_len} toks: {t_decode:.2f}s "
              f"({t_decode/max(decode_len-1,1)*1e3:.1f} ms/tok)")
    out = {"arch": cfg.name, "generated": tuple(seqs.shape),
           "prefill_s": t_prefill, "decode_s": t_decode, "tokens": seqs,
           "cache": cache}
    if keep_logits:
        out["logits"] = torch.stack(steps, dim=1)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, decode_len=args.decode,
                device=args.device)
    for key in ("tokens", "cache"):
        del out[key]
    print(json.dumps({k: str(v) for k, v in out.items()}, indent=2))


if __name__ == "__main__":
    main()
