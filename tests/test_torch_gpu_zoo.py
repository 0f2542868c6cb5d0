"""The mixed-architecture federation on the card against the same run on
the CPU (``gpu``-marked: skips without an sm_90 card). This file imports
no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu --noconftest \
        tests/test_torch_gpu_zoo.py

Both runs get the same numpy-made weights (in the reference's layout,
through ``init_params``) and batch draws; the History bookkeeping must be
equal and the eval logits within 1e-3, the card's run must launch B1, B2
and the gather, and every cohort's state (Adam's moments and step
counters included) must live on the card. Each wire codec encodes the
card's messengers byte for byte as the CPU does.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import numpy_cohort_inputs
from repro_torch.core import (AsyncFederationEngine, FederationConfig,
                              FederationEngine, Quorum, StragglerLatency,
                              sqmd, wire)
from repro_torch.data import make_splits, pad_like
from repro_torch.kernels import ops
from repro_torch.models import build_zoo, parse_assignment
from repro_torch.optim import state_tensors

ZOO = "mlp-s,resnet,transformer,ssm,rglru"
SPEC = "mlp-s:0.3,resnet:0.3,transformer:0.2,ssm:0.1,rglru:0.1"
PATH = ("pairwise_kl_split", "pairwise_kl_pair", "soft_ce",
        "neighbor_gather")


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 card (kernels build for sm_90a)")
    return torch.device("cuda")


def _run(device, asynchronous, logits, payloads):
    ds = pad_like(samples_per_client=30, ref_size=30, length=24)
    splits = make_splits(ds, seed=0)
    zoo = build_zoo(ZOO, ds.feature_len, ds.n_classes)
    assignment = parse_assignment(SPEC, list(zoo), ds.n_clients)
    init, draws = numpy_cohort_inputs(zoo, assignment, splits, 8, seed=2)

    def record(engine, rnd, metrics):
        out = {}
        for coh in engine.fed.cohorts:
            xs = torch.from_numpy(np.stack(
                [splits[i].test_x for i in coh.client_ids])).to(device)
            with torch.no_grad():
                out[coh.family_name] = coh.model(xs).cpu().numpy()
        logits.append(out)

    common = dict(config=FederationConfig(rounds=4, batch_size=8,
                                          eval_every=2),
                  seed=7, callbacks=[record], device=device,
                  init_params=init, batch_indices=draws)
    if asynchronous:
        eng = AsyncFederationEngine.build(
            ds, splits, zoo, SPEC, sqmd(q=8, k=4),
            arrivals=StragglerLatency(fraction=0.3, delay=2.5, seed=1),
            trigger=Quorum(frac=0.5), **common)
    else:
        eng = FederationEngine.build(ds, splits, zoo, SPEC, sqmd(q=8, k=4),
                                     **common)
    collect = eng.clients.collect_messengers

    def keep(mask):
        msg = collect(mask)
        payloads.append(wire.decode(msg).clone())
        return msg

    eng.clients.collect_messengers = keep
    ops.reset_launch_counts()
    hist = eng.fit(splits, until=4.0) if asynchronous else eng.fit(splits)
    return eng, hist, ops.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("asynchronous", [False, True])
def test_zoo_federation_on_card_matches_cpu(hopper, asynchronous):
    glog, clog, gmsg, cmsg = [], [], [], []
    geng, ghist, counts = _run(hopper, asynchronous, glog, gmsg)
    assert all(counts[k] > 0 for k in PATH), counts
    tensors = [geng.fed.targets, *geng.fed.server]
    for coh in geng.fed.cohorts:
        tensors += [*coh.model.parameters(), *state_tensors(coh.opt_state),
                    *coh.data.values()]
    assert all(t.is_cuda for t in tensors)
    _, chist, _ = _run("cpu", asynchronous, clog, cmsg)
    for key in ("rounds", "times", "server_rounds", "staleness", "bytes_up",
                "bytes_down"):
        assert getattr(ghist, key) == getattr(chist, key), key
    assert len(glog) == len(clog) >= 2
    for g, c in zip(glog, clog):
        for fam in g:
            np.testing.assert_allclose(g[fam], c[fam], atol=1e-3, rtol=0)
    # the card's messengers of the last upload, encoded on the card and on
    # the CPU: byte for byte the same payload under every codec
    msg = gmsg[-1]
    for spec in ("dense32", "dense16", "int8", "topk", "topk:2"):
        got = wire.encode(spec, msg)
        want = wire.encode(spec, msg.cpu())
        for name, a in got.arrays.items():
            assert a.is_cuda
            g, w = a.cpu(), want.arrays[name]
            if g.dtype == torch.bfloat16:
                g, w = g.view(torch.int16), w.view(torch.int16)
            assert torch.equal(g, w), (spec, name)


@pytest.mark.gpu
def test_resnet_forward_on_card_is_fp32(hopper):
    """RESNET50's forward on the card, with the process's default math
    flags (cuDNN's TF32 on), within 1e-5 of its largest logit of the same
    forward in fp64: fp32 sums read ~1e-6 there, TF32 ones ~1e-4."""
    from repro_torch.models import RESNET50, resnet1d_family
    model = resnet1d_family(RESNET50)(
        3, device=hopper, generator=torch.Generator(hopper).manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 16, 64)).astype(np.float32))
    with torch.no_grad():
        got = model(x.to(hopper)).double().cpu()
        exact = model.cpu().double()(x.double())
    assert float((got - exact).abs().max()) \
        < 1e-5 * float(exact.abs().max())
