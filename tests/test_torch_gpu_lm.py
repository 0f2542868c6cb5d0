"""The LM serving path on the card (``gpu``-marked: skips without an
sm_90 card). This file imports no JAX, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \
        tests/test_torch_gpu_lm.py

qwen2-0.5b at full width (24 layers, d_model 896, vocab 151936): the
``serve`` entry point in bf16 (no NaN, the generated shape, tokens on
the card); its fp32 twin, params drawn on the CPU, whose greedy tokens
on the card equal the CPU's with logits within 1e-4 of the largest and
every cache tensor on the card; and its bf16 greedy decode against the
teacher-forced ``forward`` within 5e-2 of the largest logit
(chip_smoke's phase 20 holds it at batch 4 and prompt 64 within 2e-2:
it reads 1.04e-2 there, and 0.74 with one token swapped).

The MoE and MLA architectures: mixtral-8x7b and deepseek-v2-236b at their
published widths cut to one layer serve in bf16; the reduced configs'
fp32 twins, params drawn on the CPU, route every token to the CPU's
experts and generate the CPU's tokens, logits within 1e-4; ``route`` on
the card breaks ties by the lowest index and refuses TF32 matmuls.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.serve import serve
from repro_torch.models import ffn
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.transformer import forward, init_params

EXPERT = ("mixtral-8x7b", "deepseek-v2-236b")

B, PROMPT = 2, 32


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _generate(params, prompts, steps, device):
    """``serve`` at qwen2-0.5b's full width on the given params and
    prompts, each step's logits kept."""
    return serve("qwen2-0.5b", reduced=False, batch=B, prompt_len=PROMPT,
                 decode_len=steps, device=device, params=params,
                 prompts=prompts, verbose=False, keep_logits=True)


@pytest.mark.gpu
def test_qwen2_serves_at_full_width(hopper):
    cfg = get_config("qwen2-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 896, 151936)
    out = serve("qwen2-0.5b", reduced=False, batch=B, prompt_len=PROMPT,
                decode_len=8, device=hopper, verbose=False)
    assert out["generated"] == (B, 8) and out["tokens"].is_cuda
    assert int(out["tokens"].max()) < cfg.vocab_size


@pytest.mark.gpu
def test_qwen2_fp32_card_equals_cpu(hopper):
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, "cpu", gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                            dtype=torch.int32)
    cpu = _generate(params, prompts, 4, "cpu")
    card = _generate(tree_map(lambda t: t.to(hopper), params), prompts, 4,
                     hopper)
    assert all(t.is_cuda for t in tree_leaves(card["cache"]))
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    want = cpu["logits"]
    err = (card["logits"].cpu() - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-4


@pytest.mark.gpu
def test_qwen2_bf16_decode_matches_forward(hopper):
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=hopper).manual_seed(1)
    params = init_params(cfg, hopper, gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                            dtype=torch.int32, device=hopper)
    out = _generate(params, prompts, 8, hopper)
    toks, logits = out["tokens"], out["logits"]
    assert bool(torch.isfinite(logits).all())
    full, _ = forward(params, cfg, tokens=torch.cat([prompts, toks[:, :-1]],
                                                    1))
    want = full[:, PROMPT - 1:]
    assert float((logits - want).abs().max() / want.abs().max()) <= 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", EXPERT)
def test_expert_archs_serve_at_full_width(hopper, arch):
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    out = serve(arch, batch=B, prompt_len=PROMPT, decode_len=4,
                device=hopper, cfg=cfg, verbose=False, keep_logits=True)
    assert out["generated"] == (B, 4) and out["tokens"].is_cuda
    assert bool(torch.isfinite(out["logits"]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", EXPERT)
def test_expert_smoke_fp32_card_equals_cpu(hopper, arch, monkeypatch):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, "cpu", gen)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                            dtype=torch.int32)
    plain, routes = ffn.route, []

    def recorded(p, c, x):
        out = plain(p, c, x)
        routes[-1].append(out[1].cpu())
        return out

    monkeypatch.setattr(ffn, "route", recorded)
    runs = []
    for device, p in (("cpu", params),
                      (hopper, tree_map(lambda t: t.to(hopper), params))):
        routes.append([])
        runs.append(serve(arch, batch=B, prompt_len=PROMPT, decode_len=4,
                          device=device, params=p, prompts=prompts, cfg=cfg,
                          verbose=False, keep_logits=True))
    cpu, card = runs
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    assert len(routes[0]) == len(routes[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*routes))
    want = cpu["logits"]
    err = (card["logits"].cpu() - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-4


@pytest.mark.gpu
def test_route_on_card_breaks_ties_by_lowest_index(hopper):
    cfg = get_reduced("mixtral-8x7b")
    d = cfg.d_model
    w = torch.full((d,), 1.0 / d, device=hopper)
    x = torch.rand((2, 3, d), device=hopper) + 0.1
    for router, want in ((torch.stack([w, 2 * w, 2 * w, 2 * w], 1), [1, 2]),
                         (torch.zeros((d, 4), device=hopper), [0, 1])):
        _, idx, _ = ffn.route({"router": router}, cfg, x)
        assert idx.reshape(-1, 2).cpu().tolist() == [want] * 6
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            ffn.route({"router": router}, cfg, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
