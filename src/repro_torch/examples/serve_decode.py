"""Serving example on the port: batched prefill + greedy decode for any
assigned architecture, the reduced config by default (``--no-reduced``:
the published widths).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        --arch mamba2-780m [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        --arch gemma3-1b --no-reduced
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import Device, resolve_device
from repro_torch.configs import ARCH_IDS
from repro_torch.launch.serve import serve


def banner(arch: str, reduced: bool, dev: torch.device) -> str:
    """Which config is served, and where."""
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else dev.type.upper())
    return (f"serving {arch} "
            f"({'reduced config' if reduced else 'full width'}, {where})")


def run(*, device: Device = None, arch: str = "gemma3-1b",
        reduced: bool = True, batch: int = 4, prompt_len: int = 48,
        decode: int = 24) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens and decode
    ``decode`` tokens on ``device`` (None: the card) through
    ``repro_torch.launch.serve.serve``. Returns the grid's shape, the
    tokens (batch, decode) and the prefill and decode seconds."""
    dev = resolve_device(device)
    print(banner(arch, reduced, dev))
    out = serve(arch, reduced=reduced, batch=batch, prompt_len=prompt_len,
                decode_len=decode, device=dev)
    print(f"generated token grid: {out['generated']}")
    return {key: out[key] for key in ("generated", "tokens", "prefill_s",
                                      "decode_s")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--decode", type=int, default=24)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device, arch=args.arch, reduced=args.reduced,
        batch=args.batch, prompt_len=args.prompt_len, decode=args.decode)


if __name__ == "__main__":
    main()
