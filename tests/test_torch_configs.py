"""The port's LM configs, param trees and serving CLI against the
reference's.

Every architecture's ``ModelConfig`` equals the reference's field for
field (``param_dtype`` by name), at full and at reduced size, with the
same derived values. At full width the port's ``init_params`` on the
``meta`` device gives the leaf paths, shapes and dtypes of
``jax.eval_shape(init_params)`` for all ten architectures, MoE and MLA
included. The ``serve`` CLI prints the reference CLI's keys and
generated shape; bf16 params cross ``convert`` bit for bit, the MoE
experts' stacked (G, E, D, F) leaves and fp32 router too; the serving
path imports neither JAX nor the reference.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.models.common import _full_pattern
from repro_torch import configs as TC
from repro_torch.convert import lm_tree_from_numpy, lm_tree_to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.common import full_pattern, tree_leaves

EXPERT = ("mixtral-8x7b", "deepseek-v2-236b")
# full-width param counts of jax.eval_shape(init_params)
COUNTS = {"qwen2-0.5b": 494032768, "gemma3-1b": 999812736,
          "recurrentgemma-9b": 8578519040, "mixtral-8x7b": 46702792704,
          "deepseek-v2-236b": 239375447040}


def test_registry_matches_reference():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert TC.LONG_CONTEXT_OK == JC.LONG_CONTEXT_OK
    assert {k: dataclasses.astuple(v) for k, v in TC.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in JC.INPUT_SHAPES.items()}
    for arch in JC.ARCH_IDS:
        for name, shape in JC.INPUT_SHAPES.items():
            assert TC.skip_reason(TC.get_config(arch), TC.INPUT_SHAPES[name]) \
                == JC.skip_reason(JC.get_config(arch), shape)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_config_fields_equal_reference(arch, reduced):
    get_j = JC.get_reduced if reduced else JC.get_config
    get_t = TC.get_reduced if reduced else TC.get_config
    jcfg, tcfg = get_j(arch), get_t(arch)
    jf, tf = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert jnp.dtype(jf.pop("param_dtype")).name == "bfloat16"
    assert tf.pop("param_dtype") is torch.bfloat16
    assert tf == jf
    for prop in ("hd", "is_moe", "n_groups", "n_remainder", "d_inner"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert tcfg.active_params_per_token() == jcfg.active_params_per_token()
    assert full_pattern(tcfg) == list(_full_pattern(jcfg))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_meta_params_match_eval_shape(arch):
    """Full width, no storage: every leaf's path, shape and dtype."""
    tp = TT.init_params(TC.get_config(arch), device="meta")
    jp = jax.eval_shape(lambda k: JT.init_params(k, JC.get_config(arch)),
                        jax.random.key(0))
    got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for p, t in _paths(tp).items()}
    want = {p: (tuple(s.shape), jnp.dtype(s.dtype).name)
            for p, s in _paths(jp).items()}
    assert got == want
    n = TC.get_config(arch).param_count(tp)
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jp))
    if arch in COUNTS:
        assert n == COUNTS[arch]
    assert all(t.device.type == "meta" for t in tree_leaves(tp))


@pytest.mark.parametrize("shape", list(JC.INPUT_SHAPES))
def test_input_specs_match_reference(shape):
    """gemma3 (ring buffers and remainder layers) and internvl2 (the
    vision prefix): every spec's shape and dtype, the decode cache's
    leaves included, batch cut to 2."""
    for arch in ("gemma3-1b", "internvl2-76b"):
        got = TC.input_specs(TC.get_config(arch), TC.INPUT_SHAPES[shape], 2)
        want = JC.input_specs(JC.get_config(arch), JC.INPUT_SHAPES[shape],
                              2)
        g = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for p, t in _paths(got).items()}
        w = {p: (tuple(s.shape), jnp.dtype(s.dtype).name)
             for p, s in _paths(want).items()}
        assert g == w
        assert all(t.device.type == "meta" for t in tree_leaves(got))


def test_concrete_inputs_match_specs():
    cfg = TC.get_reduced("musicgen-medium")
    shape = TC.INPUT_SHAPES["train_4k"]
    specs = TC.input_specs(cfg, shape, 2)
    a = TC.concrete_inputs(torch.Generator().manual_seed(0), cfg, shape, 2,
                           device="cpu")
    b = TC.concrete_inputs(torch.Generator().manual_seed(0), cfg, shape, 2,
                           device="cpu")
    assert set(a) == set(specs) == {"tokens", "labels", "embeds"}
    for k in a:
        assert a[k].shape == specs[k].shape and a[k].dtype == specs[k].dtype
        assert torch.equal(a[k], b[k])
    assert int(a["tokens"].max()) < cfg.vocab_size


def test_concrete_inputs_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = TC.get_reduced("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.concrete_inputs(torch.Generator().manual_seed(0), cfg,
                           TC.INPUT_SHAPES["decode_32k"], 2)


def test_frontend_stand_ins_match_reference_shapes():
    from repro.models import frontends as JF
    from repro_torch.models import frontends as TFR
    assert TFR.VLM_IMAGE_TOKENS == JF.VLM_IMAGE_TOKENS
    gen = torch.Generator().manual_seed(0)
    for kind in ("vision", "audio"):
        assert TFR.frontend_dim(kind) == JF.frontend_dim(kind)
    v = TFR.precomputed_vision_embeddings(gen, 2)
    a = TFR.precomputed_audio_embeddings(gen, 2, 5, dtype=torch.float32)
    jv = JF.precomputed_vision_embeddings(jax.random.key(0), 2)
    ja = JF.precomputed_audio_embeddings(jax.random.key(0), 2, 5,
                                         jnp.float32)
    assert (tuple(v.shape), v.dtype) == (jv.shape, torch.bfloat16)
    assert tuple(a.shape) == ja.shape and a.dtype == torch.float32


def _cli_outputs(monkeypatch, arch):
    """The reference serve CLI's JSON and the port's (``--device cpu``)
    on one reduced architecture, batch 2, prompt 8, 4 tokens."""
    argv = ["--arch", arch, "--reduced", "--batch", "2",
            "--prompt-len", "8", "--decode", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    outs = []
    for run in (jserve.main, lambda: tserve.main([*argv, "--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            run()
        outs.append(json.loads(buf.getvalue()[buf.getvalue().index("{"):]))
    return outs


def test_serve_cli_prints_the_reference_keys(monkeypatch):
    want, got = _cli_outputs(monkeypatch, "qwen2-0.5b")
    assert set(got) == set(want)
    assert got["generated"] == want["generated"] == "(2, 4)"
    assert got["arch"] == want["arch"] == "qwen2-smoke"


@pytest.mark.parametrize("arch,name", [("mixtral-8x7b", "mixtral-smoke"),
                                       ("deepseek-v2-236b", "dsv2-smoke")])
def test_serve_cli_serves_the_expert_archs(monkeypatch, arch, name):
    want, got = _cli_outputs(monkeypatch, arch)
    assert set(got) == set(want)
    assert got["generated"] == want["generated"] == "(2, 4)"
    assert got["arch"] == want["arch"] == name


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve("qwen2-0.5b", verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen2-0.5b"])


def _cross_bit_for_bit(arch):
    """The reference's bf16 params of ``arch`` through ``convert`` both
    ways: (the reference's numpy tree, the port's tensors)."""
    cfg = JC.get_reduced(arch)
    params = jax.tree.map(np.asarray, jax.jit(
        JT.init_params, static_argnums=1)(jax.random.key(3), cfg))
    tp = lm_tree_from_numpy(params, "cpu")
    back = lm_tree_to_numpy(tp)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        if b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == np.uint16
            assert np.array_equal(a, b.view(np.uint16))
            assert np.array_equal(a.view(ml_dtypes.bfloat16), b)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    return params, tp


def test_bf16_params_cross_bit_for_bit():
    """The reference's bf16 params (ml_dtypes on its side) become bf16
    tensors and come back as uint16 bits equal to the reference's."""
    _, tp = _cross_bit_for_bit("recurrentgemma-9b")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["groups"]["pos0"]["mixer"]["w_a"].dtype == torch.float32


def test_expert_params_cross_bit_for_bit():
    """dsv2-smoke's MoE leaves: the fp32 router, the experts stacked
    (G, E, D, F) in bf16, the shared expert, and MLA's projections."""
    params, tp = _cross_bit_for_bit("deepseek-v2-236b")
    cfg = TC.get_reduced("deepseek-v2-236b")
    ffn = tp["groups"]["pos0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["router"].shape) == (cfg.n_groups, cfg.d_model,
                                          cfg.n_experts)
    assert ffn["w_gate"].dtype == torch.bfloat16
    assert tuple(ffn["w_gate"].shape) == (cfg.n_groups, cfg.n_experts,
                                          cfg.d_model, cfg.d_ff)
    assert set(ffn["shared"]) == {"w_gate", "w_up", "w_down"}
    assert "w_uq" in tp["groups"]["pos0"]["mixer"]


def test_serving_path_imports_neither_jax_nor_the_reference():
    """With jax and repro blocked, the serving modules import and reduced
    gemma3, mixtral and deepseek-v2 (MoE, MLA) serve on the CPU;
    chip_smoke.py names neither."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "from repro_torch.launch.serve import serve; "
            "import repro_torch.configs, repro_torch.convert; "
            "[print(serve(a, batch=1, prompt_len=20, decode_len=3, "
            "device='cpu', verbose=False)['generated']) for a in "
            "('gemma3-1b', 'mixtral-8x7b', 'deepseek-v2-236b')]")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(1,", "3)"] * 3
    smoke = os.path.join(os.path.dirname(__file__), os.pardir,
                         "chip_smoke.py")
    with open(smoke) as f:
        text = f.read()
    assert "import jax" not in text and "from repro." not in text
