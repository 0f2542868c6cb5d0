"""The port's wire codecs against the reference's ``repro.core.wire``.

Identical numpy-seeded messengers go through both packages. The int8
encode must be byte-identical: the same uint8 codes and the same bf16 bit
patterns of scale and zero point, in both domains (both quantize against
the bf16-rounded parameters, round half to even and cast to bf16 with
round-to-nearest-even). Decodes agree to 1e-6: the two frameworks'
log_softmax round differently in the last fp32 bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro_torch.core import ServerBus, init_server, sqmd, upload_messengers
from repro_torch.core import wire
from repro_torch.core.policies import as_policy


def _log_softmax_np(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _messengers(shape, seed, domain="log"):
    x = _log_softmax_np(np.random.default_rng(seed).normal(size=shape) * 3.0)
    return np.exp(x) if domain == "prob" else x


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


SHAPES = [(6, 12, 7), (3, 4, 40, 10), (17, 5, 2)]


def test_registry_and_coercion():
    assert set(wire.registered_codecs()) >= {"dense32", "int8"}
    assert wire.get_codec("int8") is wire.Int8
    assert isinstance(wire.as_codec(None), wire.Dense32)
    assert isinstance(wire.as_codec("int8"), wire.Int8)
    codec = wire.Int8()
    assert wire.as_codec(codec) is codec
    with pytest.raises(KeyError, match="unknown codec"):
        wire.as_codec("no-such-codec")
    with pytest.raises(ValueError, match="no argument"):
        wire.as_codec("int8:3")
    with pytest.raises(ValueError, match="domain"):
        wire.encode("int8", torch.zeros(2, 3, 4), domain="nonsense")
    with pytest.raises(ValueError, match="already registered"):
        wire.register_codec("int8")(wire.Int8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("domain", ["log", "prob"])
def test_int8_encode_is_byte_identical(shape, domain):
    x = _messengers(shape, sum(shape), domain)
    want = jwire.encode("int8", jnp.asarray(x), domain=domain)
    got = wire.encode("int8", torch.from_numpy(x), domain=domain)
    assert got.codec == "int8" and got.domain == domain
    assert got.shape == tuple(want.shape) == shape
    assert got.arrays["q"].dtype == torch.uint8
    assert got.arrays["scale"].dtype == got.arrays["zp"].dtype \
        == torch.bfloat16
    np.testing.assert_array_equal(got.arrays["q"].numpy(),
                                  np.asarray(want.arrays["q"]))
    for name in ("scale", "zp"):
        np.testing.assert_array_equal(
            _bits(got.arrays[name]),
            np.asarray(want.arrays[name]).view(np.uint16))
    np.testing.assert_allclose(wire.decode(got).numpy(),
                               np.asarray(jwire.decode(want)), atol=1e-6,
                               rtol=0)


def test_int8_encode_degenerate_rows():
    """A constant row floors its scale at 1e-8 (in bf16) like the
    reference; a spread beyond 255 steps clips to [0, 255]."""
    x = np.zeros((2, 3, 4), np.float32)
    x[1] = np.array([-1e4, 0.0, 1.0, 2.0], np.float32)
    want = jwire.encode("int8", jnp.asarray(x))
    got = wire.encode("int8", torch.from_numpy(x))
    np.testing.assert_array_equal(got.arrays["q"].numpy(),
                                  np.asarray(want.arrays["q"]))
    np.testing.assert_array_equal(_bits(got.arrays["scale"]),
                                  np.asarray(want.arrays["scale"])
                                  .view(np.uint16))


def test_payload_bytes_and_dense32_identity():
    n, r, c = 5, 20, 32
    x = torch.from_numpy(_messengers((n, r, c), 1))
    assert wire.payload_bytes(wire.encode("dense32", x)) == n * r * c * 4
    # int8: C code bytes + bf16 scale + bf16 zero point per row
    p = wire.encode("int8", x)
    assert wire.payload_bytes(p) == n * r * (c + 4)
    assert wire.bytes_per_messenger(p) == r * (c + 4)
    assert wire.payload_bytes(p) == jwire.payload_bytes(
        jwire.encode("int8", jnp.asarray(x.numpy())))
    d = wire.encode("dense32", x)
    assert wire.decode(d) is d.arrays["data"]
    np.testing.assert_array_equal(wire.decode(d).numpy(), x.numpy())


@pytest.mark.parametrize("domain", ["log", "prob"])
def test_int8_decode_is_normalized(domain):
    x = torch.from_numpy(_messengers((6, 12, 7), 3, domain))
    dec = wire.decode(wire.encode("int8", x, domain=domain))
    if domain == "log":
        np.testing.assert_allclose(torch.logsumexp(dec, -1).numpy(), 0.0,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(dec.sum(-1).numpy(), 1.0, atol=1e-5)
        assert bool((dec >= 0).all())


def test_gather_and_assemble_are_row_independent():
    x = torch.from_numpy(_messengers((8, 6, 5), 4))
    p = wire.encode("int8", x)
    rows = [6, 1, 3]
    np.testing.assert_array_equal(wire.decode(wire.gather(p, rows)).numpy(),
                                  wire.decode(p)[rows].numpy())
    parts = [wire.gather(p, [0, 1, 2]), wire.gather(p, [3, 4])]
    whole = wire.assemble(parts, [[5, 0, 7], [2, 3]], 8)
    assert whole.shape == (8, 6, 5)
    np.testing.assert_array_equal(whole.arrays["q"][[5, 0, 7, 2, 3]].numpy(),
                                  p.arrays["q"][:5].numpy())
    assert int(whole.arrays["q"][[1, 4, 6]].sum()) == 0


def test_int8_pairwise_kl_matches_reference():
    """The wire helper (the square B4 entry) against the reference's."""
    x = _messengers((9, 10, 4), 5)
    want = jwire.Int8().pairwise_kl(jwire.encode("int8", jnp.asarray(x)),
                                    backend="jnp")
    got = wire.Int8().pairwise_kl(wire.encode("int8", torch.from_numpy(x)))
    assert got.shape == (9, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="log-domain"):
        wire.Int8().pairwise_kl(wire.encode("int8", torch.from_numpy(x),
                                            domain="prob"))


def test_server_bus_meters_int8_bytes_both_ways():
    """One delivery + fire on the int8 wire: every uploader pays R*(C+4)
    bytes up, every active receiver the same down, and the repository
    holds the DECODED upload."""
    n, r, c = 12, 5, 3
    rng = np.random.default_rng(6)
    labels = torch.from_numpy(rng.integers(0, c, r).astype(np.int32))

    class _Fed:
        server = init_server(n, r, c, device="cpu")
        ref_y = labels
        n_clients = n
        targets = None
        uplink = downlink = "int8"

    fed = _Fed()
    bus = ServerBus(fed, as_policy(sqmd(q=4, k=2)), delta=True)
    msg = torch.from_numpy(_messengers((n, r, c), 7))
    up = np.arange(n) < 7
    payload = bus.uplink.encode(msg)
    assert bus.deliver(0.0, payload, up)
    np.testing.assert_array_equal(bus.bytes_up, np.where(up, r * (c + 4), 0))
    np.testing.assert_array_equal(bus.bytes_down,
                                  np.where(up, r * (c + 4), 0))
    want = upload_messengers(init_server(n, r, c, device="cpu"),
                             wire.decode(payload), torch.from_numpy(up))
    np.testing.assert_array_equal(fed.server.repo_logp.numpy(),
                                  want.repo_logp.numpy())
    assert float(fed.targets[~torch.from_numpy(up)].abs().sum()) == 0.0
    assert bus.uploads_since_fire == 0 and not bus.fresh_since_fire.any()


# --- dense16 and topk ---------------------------------------------------------
#
# Both encodes are byte for byte the reference's: the bf16 casts round to
# nearest even in both frameworks, top-k keeps the lowest class index
# first among ties, and the tail is summed in XLA's CPU order (rows of up
# to 32 left to right, longer rows in windows of 32). The log domain's exp is
# each framework's own: the port's is fp64 rounded once to fp32, the
# reference's XLA's fp32 polynomial, and they differ in the last bit. So
# for the log domain the port encodes the reference's exp of the
# messengers as probabilities, and its own exp is held to one bf16 ulp of
# the reference's by test_topk_log_encode_over_every_magnitude. Decodes
# agree to 1e-5: log_softmax, log and the renormalizing division round
# differently in the last fp32 bit.

def _with_ties(x, domain):
    """Rows of exact ties in both domains: a uniform row, a row whose top
    two are equal, a row that is all one value but one."""
    x = x.copy()
    c = x.shape[-1]
    flat = x.reshape(-1, x.shape[-2], c)
    uniform = np.full(c, 1.0 / c, np.float32)
    top2 = np.full(c, 0.5 / max(c - 2, 1), np.float32)
    top2[[1, c - 1]] = 0.25
    rows = [uniform, top2 / top2.sum()]
    for i, row in enumerate(rows):
        flat[0, i] = np.log(row) if domain == "log" else row
    return flat.reshape(x.shape)


# C=3 (every class sent: the tail is the rounding residue), C=10 with
# leading dims, C=32 (the longest row the reference sums in order)
WIRE_SHAPES = [(32, 24, 3), (3, 4, 40, 10), (5, 9, 32)]
WIRE_SPECS = ["dense16", "topk", "topk:1", "topk:3", "topk:32"]


@pytest.mark.parametrize("spec", WIRE_SPECS)
@pytest.mark.parametrize("shape", WIRE_SHAPES)
@pytest.mark.parametrize("domain", ["log", "prob"])
def test_dense16_and_topk_encode_is_byte_identical(spec, shape, domain):
    _assert_encode_is_byte_identical(spec, shape, domain)


@pytest.mark.parametrize("k", [48, 64])
@pytest.mark.parametrize("domain", ["log", "prob"])
def test_topk_long_tail_is_byte_identical(k, domain):
    """k > 32 at C = 80: XLA's CPU backend sums a row longer than 32 in
    zero-padded windows of 32, and the tail follows that order."""
    _assert_encode_is_byte_identical(f"topk:{k}", (4, 30, 80), domain)


def _assert_encode_is_byte_identical(spec, shape, domain):
    x = _with_ties(_messengers(shape, sum(shape) + len(spec), domain),
                   domain)
    want = jwire.encode(spec, jnp.asarray(x), domain=domain)
    if spec.startswith("topk") and domain == "log":
        got = dataclasses.replace(wire.encode(
            spec, torch.from_numpy(np.array(jnp.exp(x))), domain="prob"),
            domain="log")
    else:
        got = wire.encode(spec, torch.from_numpy(x), domain=domain)
    assert got.codec == want.codec and got.domain == domain
    assert got.shape == tuple(want.shape) == shape
    assert sorted(got.arrays) == sorted(want.arrays)
    for name, a in got.arrays.items():
        b = np.asarray(want.arrays[name])
        if a.dtype == torch.bfloat16:
            assert b.dtype.name == "bfloat16"
            np.testing.assert_array_equal(_bits(a), b.view(np.uint16))
        else:
            assert a.numpy().dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b)
    assert wire.payload_bytes(got) == jwire.payload_bytes(want)
    np.testing.assert_allclose(wire.decode(got).numpy(),
                               np.asarray(jwire.decode(want)), atol=1e-5,
                               rtol=0)


def test_topk_ties_keep_the_lowest_class_first():
    p = torch.tensor([[[0.1, 0.3, 0.3, 0.3]]])
    got = wire.encode("topk:2", p, domain="prob")
    assert got.arrays["idx"].tolist() == [[[1, 2]]]
    assert got.arrays["idx"].dtype == torch.int16
    want = jwire.encode("topk:2", jnp.asarray(p.numpy()), domain="prob")
    np.testing.assert_array_equal(got.arrays["idx"].numpy(),
                                  np.asarray(want.arrays["idx"]))


def test_topk_and_dense16_registry_and_bytes():
    assert set(wire.registered_codecs()) == set(jwire.registered_codecs())
    assert wire.as_codec("topk:4") == wire.TopK(k=4)
    assert wire.as_codec("topk").k == wire.TopK().k == jwire.TopK().k
    assert isinstance(wire.as_codec("dense16"), wire.Dense16)
    with pytest.raises(ValueError, match=">= 1"):
        wire.as_codec("topk:0")
    with pytest.raises(ValueError, match="no argument"):
        wire.as_codec("dense16:2")
    n, r, c = 5, 20, 32
    x = torch.from_numpy(_messengers((n, r, c), 8))
    assert wire.payload_bytes(wire.encode("dense16", x)) == n * r * c * 2
    # k bf16 values + k int16 ids + one bf16 tail a row
    assert wire.bytes_per_messenger(wire.encode("topk:4", x)) \
        == r * (4 * 2 + 4 * 2 + 2)


@pytest.mark.parametrize("domain", ["log", "prob"])
def test_topk_decode_is_normalized_and_spreads_the_tail(domain):
    x = torch.from_numpy(_messengers((4, 6, 7), 9, domain))
    dec = wire.decode(wire.encode("topk:3", x, domain=domain))
    p = torch.exp(dec) if domain == "log" else dec
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)
    # the four unsent classes share the tail equally
    probs = torch.exp(x) if domain == "log" else x
    unsent = torch.sort(probs, dim=-1, descending=True,
                        stable=True).indices[..., 3:]
    spread = torch.gather(p, -1, unsent)
    assert torch.allclose(spread, spread[..., :1].expand_as(spread),
                          rtol=1e-6)


def test_topk_log_encode_over_every_magnitude():
    """The port's own log-domain exp, over log-probabilities of every
    magnitude down to the subnormal range the reference flushes to zero:
    values within one bf16 ulp of the reference's (rtol 2**-7; atol the
    smallest normal fp32, for the flushed subnormals), and the
    reference's class ids wherever its value is normal (among its
    flushed zeros it keeps the lowest ids, the port the largest
    subnormals)."""
    tiny = float(np.finfo(np.float32).tiny)
    rng = np.random.default_rng(10)
    x = np.concatenate([rng.normal(size=20_000) * 3 - 3,
                        rng.uniform(-104, 0, 20_000),
                        np.linspace(-88, -86, 1000)]).astype(np.float32)
    x = x.reshape(41, 25, 40)
    got = wire.encode("topk:6", torch.from_numpy(x))
    want = jwire.encode("topk:6", jnp.asarray(x))
    vals = got.arrays["vals"].float().numpy()
    want_vals = np.asarray(want.arrays["vals"]).astype(np.float32)
    np.testing.assert_allclose(vals, want_vals, rtol=2.0 ** -7, atol=tiny)
    normal = want_vals >= tiny
    assert (~normal).any() and normal.mean() > 0.9
    np.testing.assert_array_equal(got.arrays["idx"].numpy()[normal],
                                  np.asarray(want.arrays["idx"])[normal])
    assert (vals[~normal] < tiny).all()
