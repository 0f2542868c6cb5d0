"""The port's LM trainer against live runs of the reference's
(``make_train_step`` and the clip: ``tests/test_torch_lm_step.py``).

  * ``lm_batches`` bit for bit, and its error for a short stream;
    ``lm_token_stream``'s construction.
  * ``train()`` with the reference's params, stream and frontend embeds
    injected: each step's ce against the reference's ``train()`` on
    qwen2-0.5b reduced (bf16, its default) and musicgen-medium reduced
    (within TRAIN_CE); the port's own
    ``train("qwen2-0.5b", steps=30, batch=4, seq=32, lr=1e-3)`` lowers
    the ce by more than 0.3, the reference test's criterion.
  * bf16 checkpoints cross both ways bit for bit, ``train(ckpt=)`` on
    both sides; the CLI prints the reference CLI's keys.
"""
import json
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro import configs as JC
from repro import data as JD
from repro.launch import train as JTRAIN
from repro.models import transformer as JT
from repro.models.frontends import frontend_dim
from repro_torch import checkpoint as TCK
from repro_torch import data as TD
from repro_torch.convert import lm_tree_from_numpy, lm_tree_to_numpy
from repro_torch.launch import train as TTRAIN
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
# per-step ce of train() against the reference's, bf16 (absolute, on ce
# values of ~6.0-6.7): the frameworks round bf16 at different points; it
# reads at most 1.3e-3 over 6 steps of both architectures
TRAIN_CE = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_cache():
    jax.clear_caches()


def _bits(a):
    """A leaf's bits as numpy (bf16 as uint16), whichever package made
    it."""
    if isinstance(a, torch.Tensor):
        a = lm_tree_to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_lm_batches_are_the_reference_batches():
    stream = np.asarray(JD.lm_token_stream(jax.random.key(4), 300, 2000))
    want = JD.lm_batches(jnp.asarray(stream), 5, 24, seed=7)
    got = TD.lm_batches(torch.from_numpy(np.array(stream)), 5, 24, seed=7)
    for _ in range(4):
        w, g = next(want), next(got)
        for name in ("tokens", "labels"):
            assert g[name].dtype == torch.int32
            np.testing.assert_array_equal(g[name].numpy(),
                                          np.asarray(w[name]))
    with pytest.raises(ValueError, match="seq \\+ 2"):
        next(TD.lm_batches(torch.arange(25, dtype=torch.int32), 2, 24))
    next(TD.lm_batches(torch.arange(26, dtype=torch.int32), 2, 24))


def test_lm_token_stream_construction():
    """Zipf draws (token 0 the most frequent, about 1/H_V of the draws
    that are not mixed) in [0, V), int32, one stream per generator seed,
    on the requested device."""
    v, n = 1000, 200_000
    a = TD.lm_token_stream(v, n, torch.Generator().manual_seed(1), "cpu")
    b = TD.lm_token_stream(v, n, torch.Generator().manual_seed(1), "cpu")
    c = TD.lm_token_stream(v, n, torch.Generator().manual_seed(2), "cpu")
    assert a.dtype == torch.int32 and a.shape == (n,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < v
    counts = torch.bincount(a.long(), minlength=v).double() / n
    ref = np.asarray(JD.lm_token_stream(jax.random.key(1), v, n))
    ref_counts = np.bincount(ref, minlength=v) / n
    assert int(counts.argmax()) == int(ref_counts.argmax()) == 0
    assert abs(float(counts[0]) - ref_counts[0]) < 0.01


# --------------------------------------------------------------------------
# train()
# --------------------------------------------------------------------------

def _reference_draws(cfg, steps, batch, seq, seed=0):
    """The reference train()'s params, stream and per-step embeds."""
    key = jax.random.key(seed)
    params = JT.init_params(key, cfg)
    stream = JD.lm_token_stream(jax.random.key(seed + 1), cfg.vocab_size,
                                max(200_000, batch * (seq + 1) * 4))
    embeds = []
    if cfg.frontend is not None:
        prefix = min(8, seq // 4)
        for _ in range(steps):
            key, sub = jax.random.split(key)
            embeds.append(np.asarray(jax.random.normal(
                sub, (batch, prefix, frontend_dim(cfg.frontend)),
                cfg.param_dtype)))
    return jax.tree.map(np.asarray, params), np.asarray(stream), embeds


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "musicgen-medium"])
def test_train_matches_reference_ce(arch):
    steps, batch, seq = 6, 4, 32
    want = JTRAIN.train(arch, reduced=True, steps=steps, batch=batch,
                        seq=seq, lr=1e-3, verbose=False)
    params, stream, embeds = _reference_draws(JC.get_reduced(arch), steps,
                                              batch, seq)
    got = TTRAIN.train(arch, reduced=True, steps=steps, batch=batch,
                       seq=seq, lr=1e-3, verbose=False, device="cpu",
                       params=lm_tree_from_numpy(params, CPU),
                       stream=torch.from_numpy(np.array(stream)),
                       embeds=lm_tree_from_numpy(embeds, CPU) or None)
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert {k: want[k] for k in ("arch", "n_params")} == {
        k: got[k] for k in ("arch", "n_params")}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=TRAIN_CE)
    assert got["initial_ce"] == got["losses"][0]
    assert got["final_ce"] == got["losses"][-1]
    assert len(got["step_s"]) == steps


def test_port_train_reduces_loss():
    out = TTRAIN.train("qwen2-0.5b", reduced=True, steps=30, batch=4, seq=32,
                       lr=1e-3, verbose=False, device="cpu")
    assert all(np.isfinite(out["losses"]))
    assert out["final_ce"] < out["initial_ce"] - 0.3


def test_bf16_checkpoints_cross_both_ways(tmp_path):
    """A bf16 LM tree saved by either package restores in the other bit
    for bit (the port reads it through a uint16 view, never
    ``np.dtype("bfloat16")``); so does ``train(ckpt=)``'s file, either
    side's."""
    cfg = JC.get_reduced("qwen2-0.5b")
    params = JT.init_params(jax.random.key(2), cfg)
    want = [_bits(a) for a in jax.tree.leaves(params)]
    JCK.save_pytree(str(tmp_path / "ref.msgpack"), {"params": params})
    got = TCK.restore_pytree(str(tmp_path / "ref.msgpack"))["params"]
    assert got["embed"].dtype == torch.bfloat16
    port = lm_tree_from_numpy(got, CPU)
    assert port["embed"].dtype == torch.bfloat16
    for g, w in zip(tree_leaves(port), want):
        np.testing.assert_array_equal(_bits(g), w)
    TCK.save_pytree(str(tmp_path / "port.msgpack"), {"params": port})
    back = JCK.restore_pytree(str(tmp_path / "port.msgpack"))["params"]
    for g, w in zip(jax.tree.leaves(back), want):
        assert g.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(g), w)
    assert (tmp_path / "port.msgpack").read_bytes() == (
        tmp_path / "ref.msgpack").read_bytes()

    out = TTRAIN.train("qwen2-0.5b", steps=2, batch=2, seq=16, verbose=False,
                       device="cpu", ckpt=str(tmp_path / "port_run"))
    saved = JCK.restore_pytree(str(tmp_path / "port_run/step_2.msgpack"))
    for g, w in zip(jax.tree.leaves(saved["params"]),
                    tree_leaves(out["params"])):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert list(map(float, saved["losses"])) == out["losses"]
    JTRAIN.train("qwen2-0.5b", steps=2, batch=2, seq=16, verbose=False,
                 ckpt=str(tmp_path / "ref_run"))
    path = str(tmp_path / "ref_run/step_2.msgpack")
    mine, theirs = TCK.restore_pytree(path), JCK.restore_pytree(path)
    for g, w in zip(tree_leaves(lm_tree_from_numpy(mine["params"], CPU)),
                    jax.tree.leaves(theirs["params"])):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_cli_prints_the_reference_keys(capsys, monkeypatch):
    """The same flags give the reference CLI's summary keys, arch and
    parameter count; without ``--device`` the CLI wants the card."""
    argv = ["--arch", "qwen2-0.5b", "--steps", "2", "--batch", "2",
            "--seq", "16"]

    def summary(text):
        return json.loads(text[text.index("{"):])

    TTRAIN.main(argv + ["--device", "cpu"])
    got = summary(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    JTRAIN.main()
    want = summary(capsys.readouterr().out)
    assert set(got) == set(want) == {"arch", "n_params", "final_ce",
                                     "initial_ce"}
    assert (got["arch"], got["n_params"]) == (want["arch"], want["n_params"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TTRAIN.main(argv)
