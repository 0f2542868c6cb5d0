"""The LM dry run on the card's machine (``gpu``-marked: skips without an
sm_90 card). This file imports no JAX, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \\
        tests/test_torch_gpu_dryrun.py

On fake CUDA tensors: the reduced qwen2-0.5b train step (bf16, Adam, no
remat) traced on a 1x1 mesh against the same step run on the card:
argument bytes and FLOPs equal, the predicted peak within 15 % of the
step's ``max_memory_allocated``; every reduced architecture's train,
prefill and decode steps traced on a fake (2,4) mesh of the card; a
production-mesh row (gemma3-1b long_500k, the sequence-sharded cache)
from ``trace_combo`` with the card as the shards' device.
"""
import pytest
import torch

from repro_torch.configs import (ARCH_IDS, InputShape, concrete_inputs,
                                 get_reduced)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group, make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import init_params
from repro_torch.optim import adam, single_model

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card")
    yield torch.device("cuda")
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_trace_matches_a_real_step(hopper):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_reduced("qwen2-0.5b")
    shape = InputShape("t", 64, 4, "train")
    with fake_process_group(1):
        row = dryrun.trace_step(cfg, shape, make_host_mesh(device=hopper),
                                remat=False, donate=False, device=hopper)
    gen = torch.Generator(device=hopper).manual_seed(0)
    params = init_params(cfg, device=hopper, generator=gen)
    opt = single_model(adam(1e-4))
    state = opt.init(params)
    batch = concrete_inputs(gen, cfg, shape, device=hopper)
    args = tree_leaves(params) + tree_leaves(state) + tree_leaves(batch)
    arg_bytes = sum(t.numel() * t.element_size() for t in args)
    step = make_train_step(cfg, opt, remat=False)
    step(params, state, batch)     # cuBLAS's workspace, allocated once
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - other
    assert row["memory"]["argument_bytes"] == arg_bytes
    assert row["hlo_flops_per_dev"] == fc.get_total_flops()
    assert abs(row["bytes_per_device"] - peak) <= 0.15 * peak


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_steps_trace_on_a_fake_mesh_of_the_card(hopper, arch):
    from torch.distributed.device_mesh import init_device_mesh
    cfg = get_reduced(arch)
    for kind in ("train", "prefill", "decode"):
        with fake_process_group(8):
            mesh = init_device_mesh("cuda", (2, 4),
                                    mesh_dim_names=("data", "model"))
            row = dryrun.trace_step(cfg, InputShape("t", 32, 8, kind), mesh,
                                    device=hopper)
        assert row["status"] == "OK" and row["hlo_flops_per_dev"] > 0
        assert row["chips"] == 8


def test_long_context_row_on_the_card(hopper):
    row = dryrun.trace_combo("gemma3-1b", "long_500k", False)
    assert row["status"] == "OK" and row["mesh"] == "16x16"
    # the global layers' 524288-slot caches shard their sequence over
    # "data": the softmax is combined with all-reduces
    assert row["coll_counts"]["all-reduce"] > 0
    assert row["memory"]["argument_bytes"] > 0
