"""The port's LM dry run against the reference's.

  * the GSPMD spec rules: ``param_specs`` on ``abstract_params`` for all
    ten archs x {16x16, 2x16x16} x {baseline, fsdp, dp_over_model}, path
    for path and entry by entry against the reference's PartitionSpecs
    (duck-typed meshes, as ``test_sharding_small.py`` builds them); the
    same for Adam's ``opt_specs``, ``batch_specs`` and ``cache_specs`` over
    every supported input shape;
  * ``to_placements`` and the local shard shapes on a small fake mesh;
  * ``graph_cost`` on hand-counted graphs: one product, and a
    row-parallel product whose all-reduce is read at 2x its bytes;
  * on a 1x1 host mesh, the reduced qwen2-0.5b train step (remat on) and
    prefill: per-device FLOPs equal ``FlopCounterMode`` of the plain port
    step exactly, and the reference's ``hlo_cost`` count of its compiled
    step within 2 %;
  * on a fake (2,4) mesh (2 rows, one a data rank), every product of the
    prefill step is 1/4 (tensor-parallel) or 1 (replicated attention) of
    its per-device FLOPs in the 1-row step on a 1x1 mesh;
  * ``trace_combo(mesh=)`` returns a row with the reference's keys; the
    dropless MoE path traces on the production mesh;
  * the reduced mixtral-8x7b's dropless train step on a 1x1 host mesh:
    per-device FLOPs equal ``FlopCounterMode`` of a real CPU step.

Every test that starts a process group ends it (the autouse fixture also
destroys any left behind).
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as JC
from repro import sharding as JS
from repro.launch import steps as JSteps
from repro.launch.hlo_cost import analyze_hlo_text
from repro.models import cache as JCache
from repro.models import transformer as JT
from repro.optim import adam as jadam
from repro_torch import configs as TC
from repro_torch import sharding as TS
from repro_torch.launch import dryrun
from repro_torch.launch.graph_cost import CostCounter
from repro_torch.launch.mesh import fake_process_group, make_host_mesh
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models.cache import init_cache
from repro_torch.models.transformer import abstract_params
from repro_torch.optim import AdamState, adam, single_model

CPU = torch.device("cpu")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
POLICIES = {"baseline": (False, False), "fsdp": (False, True),
            "dp_over_model": (True, False)}


@pytest.fixture(autouse=True)
def _no_process_group_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class RefMesh:
    """Duck-typed reference mesh: ``.shape`` dict, ``.axis_names``."""

    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


class PortMesh:
    """Duck-typed ``DeviceMesh``: ``.mesh_dim_names``, ``.shape`` tuple."""

    def __init__(self, axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


def _norm(entries):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _norm(tuple(s)) for path, s in flat}


def _port_flat(tree, prefix=""):
    if isinstance(tree, TS.P):
        return {prefix.strip("/"): _norm(tuple(tree))}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}/{k}"))
    return out


def _same(port_tree, ref_tree):
    port, ref = _port_flat(port_tree), _ref_flat(ref_tree)
    assert port.keys() == ref.keys()
    bad = {k: (port[k], ref[k]) for k in ref if port[k] != ref[k]}
    assert not bad, list(bad.items())[:5]


_TREES = {}


def _trees(aid):
    """(port params, reference params, port Adam, reference Adam) of one
    arch, abstract, built once."""
    if aid not in _TREES:
        tp = abstract_params(TC.get_config(aid))
        jp = JT.abstract_params(JC.get_config(aid))
        _TREES[aid] = (tp, jp, single_model(adam(1e-4)).init(tp),
                       jax.eval_shape(jadam(1e-4).init, jp))
    return _TREES[aid]


@pytest.mark.parametrize("aid", TC.ARCH_IDS)
def test_spec_rules_match_reference(aid):
    tcfg, jcfg = TC.get_config(aid), JC.get_config(aid)
    tp, jp, topt, jopt = _trees(aid)
    shapes = [(n, s) for n, s in TC.INPUT_SHAPES.items()
              if not TC.skip_reason(tcfg, s)]
    batches, caches = [], []
    for name, shape in shapes:
        tin = TC.input_specs(tcfg, shape)
        jin = JC.input_specs(jcfg, JC.INPUT_SHAPES[name])
        if shape.kind == "decode":
            tin, jin = {"token": tin["token"]}, {"token": jin["token"]}
        batches.append((tin, jin))
        b, s = shape.global_batch, shape.seq_len
        caches.append((init_cache(tcfg, b, s, device="meta"),
                       jax.eval_shape(lambda: JCache.init_cache(jcfg, b, s))))
    for axes in MESHES.values():
        tm, jm = PortMesh(axes), RefMesh(axes)
        for dp, fsdp in POLICIES.values():
            tpol = TS.ShardingPolicy(dp_over_model=dp, fsdp=fsdp)
            jpol = JS.ShardingPolicy(dp_over_model=dp, fsdp=fsdp)
            tps = TS.param_specs(tp, tcfg, tm, tpol)
            jps = JS.param_specs(jp, jcfg, jm, jpol)
            _same(tps, jps)
            tos = TS.opt_specs(topt, tps, tm, tpol)
            jos = JS.opt_specs(jopt, jps, jm, jpol)
            assert tuple(tos.step) == tuple(jos.step) == ()
            _same(tos.mu, jos.mu)
            _same(tos.nu, jos.nu)
            for tin, jin in batches:
                _same(TS.batch_specs(tin, tm, tpol),
                      JS.batch_specs(jin, jm, jpol))
        for tc, jc in caches:
            _same(TS.cache_specs(tc, tcfg, tm), JS.cache_specs(jc, jcfg, jm))


def test_to_placements_local_shards():
    from torch.distributed.tensor import Replicate, Shard
    with fake_process_group(8):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        specs = {"w": TS.P(None, "model"), "b": TS.P(("data", "model"), None),
                 "x": TS.P("data", None, None), "r": TS.P(),
                 "o": AdamState(step=TS.P(), mu=[TS.P("model")],
                                nu=[TS.P("model")])}
        pl = TS.to_placements(specs, mesh)
        assert pl["w"] == [Replicate(), Shard(1)]
        assert pl["b"] == [Shard(0), Shard(0)]
        assert pl["x"] == [Shard(0), Replicate()]
        assert pl["r"] == [Replicate(), Replicate()]
        assert pl["o"].step == [Replicate(), Replicate()]
        assert pl["o"].mu == pl["o"].nu == [[Replicate(), Shard(0)]]
        shapes = {"w": (8, 16), "b": (16, 3), "x": (6, 5, 7), "r": (3,)}
        want = {"w": (8, 4), "b": (2, 3), "x": (3, 5, 7), "r": (3,)}
        metas = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
        sub = {k: specs[k] for k in shapes}
        with dryrun._fake_mode():
            dts = dryrun.distribute(metas, sub, mesh, CPU)
        for k in shapes:
            assert TS.local_shape(shapes[k], specs[k], mesh) == want[k]
            assert tuple(dts[k]._local_tensor.shape) == want[k]
            assert tuple(dts[k].shape) == shapes[k]
        with pytest.raises(ValueError):
            TS.local_shape((6, 3), TS.P("model"), mesh)


def test_graph_cost_hand_counted():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with CostCounter() as c:
        torch.mm(a, b)
    assert c.cost.flops == 2 * 8 * 4 * 16
    assert c.cost.hbm_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert c.cost.coll_bytes == 0

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
        fake = dryrun._fake_mode()
        with fake:
            x = DTensor.from_local(torch.empty(8, 4), mesh,
                                   [Replicate(), Shard(1)], run_check=False)
            w = DTensor.from_local(torch.empty(4, 4), mesh,
                                   [Replicate(), Shard(0)], run_check=False)
            c = CostCounter(fake)
            with c:
                y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
            assert tuple(y._local_tensor.shape) == (8, 4)
    # the shard's product, (8,4)x(4,4), not the global (8,16)x(16,4)
    assert c.cost.flops == 2 * 8 * 4 * 4
    assert c.products == [("mm", 2 * 8 * 4 * 4)]
    assert c.cost.coll_counts["all-reduce"] == 1
    assert c.cost.coll_raw_bytes["all-reduce"] == 8 * 4 * 4
    assert c.cost.coll_bytes == c.cost.coll_bytes_by_kind["all-reduce"] \
        == 2.0 * 8 * 4 * 4


def _reference_flops(cfg_id, kind):
    jcfg = JC.get_reduced(cfg_id)
    shape = JC.registry.InputShape("t", 32, 4, kind)
    params = JT.abstract_params(jcfg)
    batch = JC.input_specs(jcfg, shape)
    if kind == "train":
        opt = jadam(1e-4)
        step = JSteps.make_train_step(jcfg, opt, remat=True)
        lowered = jax.jit(step).lower(
            params, jax.eval_shape(opt.init, params), batch)
    else:
        step = JSteps.make_prefill_step(jcfg, cache_seq=32)
        lowered = jax.jit(step).lower(params, batch)
    return analyze_hlo_text(lowered.compile().as_text()).flops


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_host_mesh_flops_equal_plain_and_reference(kind):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = TC.get_reduced("qwen2-0.5b")
    shape = TC.InputShape("t", 32, 4, kind)
    with fake_process_group(1):
        row = dryrun.trace_step(cfg, shape, make_host_mesh(device="cpu"),
                                device="cpu")
    params = abstract_params(cfg)              # the plain step, on meta
    batch = TC.input_specs(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            opt = single_model(adam(1e-4))
            make_train_step(cfg, opt, remat=True)(params, opt.init(params),
                                                  batch)
        else:
            make_prefill_step(cfg, cache_seq=32)(params, batch)
    assert row["hlo_flops_per_dev"] == fc.get_total_flops()
    ref = _reference_flops("qwen2-0.5b", kind)
    # the products are the same; what is left is the reference's one-hot
    # CE contraction, which XLA may lower to a dot (2*B*S*V)
    assert abs(row["hlo_flops_per_dev"] - ref) <= 0.02 * ref


def test_host_mesh_dropless_moe_flops_equal_a_real_step():
    """The reduced mixtral-8x7b's train step on the dropless path traced on
    a 1x1 host mesh reads the FLOPs ``FlopCounterMode`` reads over the
    same step run on the CPU: the grouped products forward and backward
    at 2 M K N each, as the reference's ``hlo_cost`` counts ragged-dot."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.transformer import init_params
    cfg = TC.get_reduced("mixtral-8x7b")
    shape = TC.InputShape("t", 16, 2, "train")
    with fake_process_group(1):
        row = dryrun.trace_step(cfg, shape, make_host_mesh(device="cpu"),
                                moe_path="dropless", remat=False,
                                device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, "cpu", gen)
    batch = TC.concrete_inputs(gen, cfg, shape, device="cpu")
    opt = single_model(adam(1e-4))
    step = make_train_step(cfg, opt, moe_path="dropless", remat=False)
    with FlopCounterMode(display=False) as fc:
        step(params, opt.init(params), batch)
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts["repro_torch.ragged_dot"] > 0
    assert counts["repro_torch.ragged_dot_wgrad"] > 0
    assert row["hlo_flops_per_dev"] == fc.get_total_flops()


def test_tensor_parallel_products_are_a_quarter():
    from torch.distributed.device_mesh import init_device_mesh
    cfg = TC.get_reduced("qwen2-0.5b")
    counts = {}
    # the (2,4) mesh's 2 rows split over "data": a rank runs 1 row, as the
    # 1x1 mesh's 1-row step does
    for ms, rows in (((1, 1), 1), ((2, 4), 2)):
        with fake_process_group(ms[0] * ms[1]):
            mesh = init_device_mesh("cpu", ms,
                                    mesh_dim_names=("data", "model"))
            c = CostCounter()
            dryrun.trace_step(cfg, TC.InputShape("t", 32, rows, "prefill"),
                              mesh, device="cpu", counter=c)
        counts[ms] = c.products
    one, tp = counts[(1, 1)], counts[(2, 4)]
    assert [n for n, _ in one] == [n for n, _ in tp]
    ratios = [f / g for (_, g), (_, f) in zip(one, tp)]
    # qwen2's reduced FFN (d_ff 448) and vocab (512) split 4 ways; its 14
    # heads do not, so its attention products are whole on every rank
    assert set(ratios) == {0.25, 1.0}
    ffn = [r for (n, f), r in zip(one, ratios) if f == max(g for _, g in one)]
    assert ffn and set(ffn) == {0.25}           # the head, the largest


def test_trace_combo_row_keys(monkeypatch):
    ref_keys = {"arch", "shape", "mesh", "chips", "compute_s", "memory_s",
                "collective_s", "dominant", "hlo_flops_per_dev",
                "hlo_bytes_per_dev", "coll_bytes_per_dev", "model_flops",
                "useful_flops_frac", "bytes_per_device", "coll_counts",
                "coll_bytes_by_kind", "raw_cost_analysis", "status",
                "memory"}
    with fake_process_group(1):
        row = dryrun.trace_combo("gemma3-1b", "long_500k", False,
                                 device="cpu",
                                 mesh=make_host_mesh(device="cpu"))
    assert ref_keys <= set(row) and "trace_s" in row
    assert row["status"] == "OK" and row["arch"] == "gemma3-1b"
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes"} <= set(row["memory"])
    assert row["hlo_flops_per_dev"] > 0 and row["chips"] == 1
    # the cache is updated in place: every output byte but the logits'
    # (1 x 1 x 262144 fp32) is an argument's
    mem = row["memory"]
    assert mem["output_bytes"] - mem["alias_bytes"] == 262144 * 4
    skip = dryrun.trace_combo("qwen2-0.5b", "long_500k", False, device="cpu")
    assert skip["status"] == "SKIP"
    # the dropless MoE path traces (its group sizes never reach the host):
    # mixtral's reduced widths on the production 16x16 mesh of fake ranks,
    # its experts' columns over "model"
    monkeypatch.setattr(dryrun, "get_config", TC.get_reduced)
    row = dryrun.trace_combo("mixtral-8x7b", "prefill_32k", False,
                             moe_path="dropless", device="cpu")
    assert row["status"] == "OK" and row["chips"] == 256
    assert row["hlo_flops_per_dev"] > 0 and row["coll_bytes_per_dev"] > 0
