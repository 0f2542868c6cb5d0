"""LM training on the card (``gpu``-marked: skips without an sm_90 card).
This file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \
        tests/test_torch_gpu_train.py

The reduced qwen2 and mixtral configs in fp32 (mixtral on both MoE
paths, with remat): three ``make_train_step`` steps on the card against
the same steps on the CPU from the same params and batches, each step's
ce and gnorm within 1e-4 of the CPU's, every param and optimizer tensor
on the card; ``train()`` on the card lowers qwen2's reduced ce by more
than 0.3 in 30 steps and its bf16 checkpoint restores onto the card bit
for bit; a MoE train step refuses TF32 matmuls on the card.
"""
import dataclasses

import pytest
import torch

from repro_torch.checkpoint import restore_pytree
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.data import lm_batches, lm_token_stream
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.transformer import init_params
from repro_torch.optim import adam, single_model, warmup_cosine

CPU = torch.device("cpu")


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _steps(cfg, params, batches, device, moe_path, remat):
    opt = single_model(adam(warmup_cosine(1e-3, 0, len(batches))))
    p = tree_map(lambda t: t.to(device), params)
    state = opt.init(p)
    step = make_train_step(cfg, opt, moe_path=moe_path, remat=remat)
    metrics = []
    for b in batches:
        p, state, m = step(p, state, {k: v.to(device) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return p, state, metrics


@pytest.mark.gpu
@pytest.mark.parametrize("arch,moe_path,remat", [
    ("qwen2-0.5b", "gshard", False), ("mixtral-8x7b", "gshard", True),
    ("mixtral-8x7b", "dropless", False)])
def test_train_steps_on_card_match_cpu(hopper, arch, moe_path, remat):
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    params = init_params(cfg, CPU, gen)
    it = lm_batches(lm_token_stream(cfg.vocab_size, 4096, gen, CPU), 4, 32)
    batches = [next(it) for _ in range(3)]
    _, _, cpu = _steps(cfg, params, batches, CPU, moe_path, remat)
    p, state, card = _steps(cfg, params, batches, hopper, moe_path, remat)
    assert all(t.is_cuda for t in tree_leaves(p) + tree_leaves(list(state)))
    for a, b in zip(card, cpu):
        for name in ("ce", "gnorm"):
            assert abs(a[name] - b[name]) <= 1e-4 * abs(b[name]), name


@pytest.mark.gpu
def test_train_on_card_learns_and_checkpoints(hopper, tmp_path):
    out = train("qwen2-0.5b", reduced=True, steps=30, batch=4, seq=32,
                lr=1e-3, verbose=False, device=hopper, ckpt=str(tmp_path))
    assert out["final_ce"] < out["initial_ce"] - 0.3
    assert out["params"]["embed"].dtype == torch.bfloat16
    restored = lm_tree_from_numpy(
        restore_pytree(str(tmp_path / "step_30.msgpack"))["params"], hopper)
    for a, b in zip(tree_leaves(restored), tree_leaves(out["params"])):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.gpu
def test_moe_train_step_refuses_tf32(hopper):
    cfg = dataclasses.replace(get_reduced("mixtral-8x7b"),
                              param_dtype=torch.float32)
    params = init_params(cfg, hopper, torch.Generator(hopper).manual_seed(2))
    opt = single_model(adam(1e-3))
    step = make_train_step(cfg, opt, remat=False)
    tokens = torch.zeros((2, 8), dtype=torch.int32, device=hopper)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="IEEE fp32"):
            step(params, opt.init(params), {"tokens": tokens,
                                            "labels": tokens})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
