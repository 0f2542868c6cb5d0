"""The port's wire codecs against the reference's ``repro.core.wire``.

Identical numpy-seeded messengers go through both packages. The int8
encode must be byte-identical: the same uint8 codes and the same bf16 bit
patterns of scale and zero point, in both domains (both quantize against
the bf16-rounded parameters, round half to even and cast to bf16 with
round-to-nearest-even). Decodes agree to 1e-6: the two frameworks'
log_softmax round differently in the last fp32 bit.
"""
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
