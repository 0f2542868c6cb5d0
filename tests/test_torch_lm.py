"""The port's LM serving path against live runs of the reference's.

Every architecture at its reduced size with fp32 params: the
reference's ``init_params`` draws them (vectors and biases then moved off
their trivial init by numpy noise), ``repro_torch.convert`` carries them
across, and both packages prefill the same prompts (the MoE FFN on the
dropless path, as the reference's serve runs it) and take five greedy
decode steps. Logits agree within 1e-4 of the largest logit, caches leaf
for leaf (positions exactly), and caches cross both ways: the port
decodes from the reference's cache and the reference from the port's.
``serve()`` fed the reference's params and prompts through its seam
generates the reference's tokens, and the port's decode agrees with its
own teacher-forced ``forward`` (dropless: GShard may drop choices). The
whole-stack ``forward`` of the two MoE architectures matches the
reference's on both MoE paths, its summed aux loss too.

The pieces: the chunked online softmax (chunk 16, with and without a
window), one-token attention decode past a ring buffer's wrap and past a
full cache's capacity, SSD and RG-LRU decode and their ``return_state``
forms, ``full_kv_to_cache`` with prompts shorter and longer than the
window. One bf16 case per layer kind (global, local, mla, ssd, rec,
and a MoE FFN) and one bf16 stack (qwen2's tied head and QKV bias) hold the port to a looser
limit, BF16_REL of the largest output: the frameworks round bf16 at
different points (XLA's CPU fusions keep fp32 between elementwise ops).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import steps as JS
from repro.models import attention as JA
from repro.models import cache as JCACHE
from repro.models import ffn as JF
from repro.models import rglru as JR
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.models.common import ModelConfig as JModelConfig
from repro.models.frontends import frontend_dim
from repro_torch import configs as TC
from repro_torch.convert import lm_tree_from_numpy, lm_tree_to_numpy
from repro_torch.launch import steps as TS
from repro_torch.launch.serve import serve
from repro_torch.models import attention as TA
from repro_torch.models import cache as TCACHE
from repro_torch.models import ffn as TF
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT
from repro_torch.models.common import ModelConfig as TModelConfig

CPU = torch.device("cpu")
REL = 1e-4
BF16_REL = 3e-2
ARCHS = list(JC.ARCH_IDS)
EXPERT = ("mixtral-8x7b", "deepseek-v2-236b")
# prompt 20 > the reduced gemma3/recurrentgemma window (16): the ring
# buffers wrap while the prefill is packed and again while decoding;
# mamba2's 16-token chunks leave a padded tail
BATCH, PROMPT, DECODE, FRAMES = 2, 20, 6, 3
_NUDGED = {"scale", "bq", "bk", "bv", "conv_b", "b_a", "b_i", "dt_bias",
           "a_log", "d_skip", "norm_scale"}


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_cache():
    jax.clear_caches()


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, jdt=jnp.float32, tdt=torch.float32):
    return (dataclasses.replace(JC.get_reduced(arch), param_dtype=jdt),
            dataclasses.replace(TC.get_reduced(arch), param_dtype=tdt))


def _reference_params(cfg, seed=0):
    """The reference's params with every vector and bias nudged by
    N(0, 0.1), as numpy."""
    rng = np.random.default_rng(seed)

    def nudge(path, leaf):
        a = np.asarray(leaf)
        if getattr(path[-1], "key", None) in _NUDGED:
            a = (a.astype(np.float32)
                 + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(
        nudge, JT.init_params(jax.random.key(seed), cfg))


def _assert_cache(port, ref, rel=REL):
    """Every leaf of the port's cache against the reference's: integer
    positions exactly, values within ``rel`` of the leaf's largest."""
    got, want = jax.tree_util.tree_flatten_with_path(port)[0], \
        jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, path
        if b.dtype == ml_dtypes.bfloat16:            # the port's bits
            a = a.view(ml_dtypes.bfloat16)
        if np.issubdtype(b.dtype, np.integer):
            assert a.dtype == b.dtype == np.int32, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            _close(a, b, rel)


# --------------------------------------------------------------------------
# the whole stack, per architecture
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def ref_run(request):
    """The reference serving ``arch``: prefill, then five greedy decode
    steps, jitted; its logits, caches and tokens as numpy."""
    arch = request.param
    jcfg, tcfg = _configs(arch)
    params = _reference_params(jcfg)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)
    embeds = None
    if jcfg.frontend is not None:
        embeds = rng.normal(size=(BATCH, FRAMES, frontend_dim(
            jcfg.frontend))).astype(np.float32)
    cache_seq = PROMPT + DECODE
    pre = jax.jit(lambda p, b: JT.prefill(p, jcfg, tokens=b["tokens"],
                                          embeds=b.get("embeds"),
                                          cache_seq=cache_seq,
                                          moe_path="dropless"))
    step = jax.jit(JS.make_serve_step(jcfg))
    batch = {"tokens": prompts}
    if embeds is not None:
        batch["embeds"] = embeds
    logits, cache = pre(params, batch)
    tok = JS.greedy_sample(logits[:, -1:])
    out = {"prefill_logits": np.asarray(logits), "caches": [_np(cache)],
           "tokens": [np.asarray(tok)], "logits": []}
    for _ in range(DECODE - 1):
        logits, cache = step(params, tok, cache)
        tok = JS.greedy_sample(logits)
        out["logits"].append(np.asarray(logits))
        out["caches"].append(_np(cache))
        out["tokens"].append(np.asarray(tok))
    return dict(out, arch=arch, jcfg=jcfg, tcfg=tcfg, params=params,
                prompts=prompts, embeds=embeds, step=step)


def _port_params(run):
    return lm_tree_from_numpy(run["params"], CPU)


def _port_embeds(run):
    return None if run["embeds"] is None else _t(run["embeds"])


def _port_prefill(run, params):
    return TT.prefill(params, run["tcfg"], tokens=_t(run["prompts"]),
                      embeds=_port_embeds(run), cache_seq=PROMPT + DECODE,
                      moe_path="dropless")


def test_prefill_logits_and_cache_match_reference(ref_run):
    logits, cache = _port_prefill(ref_run, _port_params(ref_run))
    _close(logits.numpy(), ref_run["prefill_logits"])
    _assert_cache(lm_tree_to_numpy(cache), ref_run["caches"][0])
    # the reference's cache crosses and comes back bit for bit
    back = lm_tree_to_numpy(lm_tree_from_numpy(ref_run["caches"][0], CPU))
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(ref_run["caches"][0])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_decode_steps_match_reference_and_own_forward(ref_run):
    """Five decode steps on the reference's tokens: logits and the final
    cache against the reference's, and each step's logits against the
    port's teacher-forced forward at that position (while the cache holds
    every position)."""
    cfg, params = ref_run["tcfg"], _port_params(ref_run)
    _, cache = _port_prefill(ref_run, params)
    toks = ref_run["tokens"]
    got = []
    for t in range(DECODE - 1):
        logits, cache = TT.decode_step(params, cfg, _t(toks[t]), cache)
        _close(logits.numpy(), ref_run["logits"][t])
        got.append(logits[:, 0])
    _assert_cache(lm_tree_to_numpy(cache), ref_run["caches"][-1])
    seq = np.concatenate([ref_run["prompts"], *toks[:-1]], axis=1)
    full, aux = TT.forward(params, cfg, tokens=_t(seq),
                           embeds=_port_embeds(ref_run), moe_path="dropless")
    assert aux.dtype == torch.float32
    assert (float(aux) > 0.0) == (ref_run["arch"] in EXPERT)
    # serve's cache holds prompt + decode positions; a frontend's frames
    # come first, so its last steps run past the capacity and overwrite
    # the last slot (as the reference's do): forward is held where the
    # cache still holds every position
    off = full.shape[1] - (DECODE - 1)
    held = [t for t in range(DECODE - 1) if off + t < PROMPT + DECODE]
    assert len(held) == (DECODE - 1 if ref_run["embeds"] is None
                         else PROMPT + DECODE - off)
    for t in held:
        _close(got[t].numpy(), full[:, off + t].numpy())


def test_caches_cross_both_ways(ref_run):
    """The port's first decode step from the reference's prefill cache,
    and the reference's from the port's, each give the reference's
    logits."""
    cfg, params = ref_run["tcfg"], _port_params(ref_run)
    tok = ref_run["tokens"][0]
    logits, _ = TT.decode_step(params, cfg, _t(tok), lm_tree_from_numpy(
        ref_run["caches"][0], CPU))
    _close(logits.numpy(), ref_run["logits"][0])
    _, cache = _port_prefill(ref_run, params)
    want, _ = ref_run["step"](ref_run["params"], tok,
                              lm_tree_to_numpy(cache))
    _close(np.asarray(want), ref_run["logits"][0])


def test_serve_generates_the_reference_tokens(ref_run):
    out = serve(ref_run["arch"], reduced=True, batch=BATCH,
                prompt_len=PROMPT, decode_len=DECODE, verbose=False,
                device="cpu", params=_port_params(ref_run),
                prompts=_t(ref_run["prompts"]),
                embeds=_port_embeds(ref_run))
    np.testing.assert_array_equal(
        out["tokens"].numpy(), np.concatenate(ref_run["tokens"], axis=1))
    assert out["generated"] == (BATCH, DECODE)
    assert out["arch"] == ref_run["jcfg"].name


def test_serve_sizes_its_cache_from_the_given_prompts():
    """Prompts of 20 tokens given with ``prompt_len=8``: the cache holds
    the 20 prompt positions and every decoded one, so each step's logits
    equal the teacher-forced forward's (a cache sized from prompt_len
    would overwrite its last slot from the first steps on)."""
    cfg = dataclasses.replace(TC.get_reduced("qwen2-0.5b"),
                              param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    params = TT.init_params(cfg, CPU, gen)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, dtype=torch.int32)
    out = serve("qwen2-0.5b", batch=BATCH, prompt_len=8, decode_len=DECODE,
                verbose=False, device="cpu", params=params, prompts=prompts,
                keep_logits=True)
    cache = out["cache"]["groups"]["pos0"]           # (G, B, S, KV, hd)
    assert cache["k"].shape[2] == cache["k_pos"].shape[1] == PROMPT + DECODE
    full, _ = TT.forward(params, cfg, tokens=torch.cat(
        [prompts, out["tokens"][:, :-1]], dim=1))
    _close(out["logits"].numpy(), full[:, PROMPT - 1:].numpy())


@pytest.mark.parametrize("moe_path", ["gshard", "dropless"])
@pytest.mark.parametrize("arch", EXPERT)
def test_forward_and_aux_match_reference(arch, moe_path):
    """The whole-stack forward of the MoE architectures on both paths:
    logits, and the aux loss summed over the layers in fp32."""
    jcfg, tcfg = _configs(arch)
    params = _reference_params(jcfg)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    want, aux = jax.jit(lambda p, t: JT.forward(p, jcfg, tokens=t,
                                                moe_path=moe_path))(
        params, tokens)
    got, taux = TT.forward(lm_tree_from_numpy(params, CPU), tcfg,
                           tokens=_t(tokens), moe_path=moe_path)
    _close(got.numpy(), want)
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert float(aux) > 1.0 and abs(float(taux) - float(aux)) <= 1e-5


def test_bf16_stack_matches_reference():
    """qwen2's tied head and QKV bias in bf16: prefill and two decode
    steps, the embedding scale rounded to bf16 first, logits fp32 from
    the upcast head."""
    jcfg, tcfg = _configs("qwen2-0.5b", jnp.bfloat16, torch.bfloat16)
    params = _reference_params(jcfg)
    tp = lm_tree_from_numpy(params, CPU)
    assert tp["embed"].dtype == torch.bfloat16
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (BATCH, 8)).astype(np.int32)
    want, jcache = JT.prefill(params, jcfg, tokens=prompts, cache_seq=12)
    got, cache = TT.prefill(tp, tcfg, tokens=_t(prompts), cache_seq=12)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, BF16_REL)
    _assert_cache(lm_tree_to_numpy(cache), _np(jcache), BF16_REL)
    tok = np.asarray(JS.greedy_sample(want[:, -1:]))
    for _ in range(2):
        want, jcache = JT.decode_step(params, jcfg, tok, jcache)
        got, cache = TT.decode_step(tp, tcfg, _t(tok), cache)
        _close(got.numpy(), want, BF16_REL)
        tok = np.asarray(JS.greedy_sample(want))


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

def _qkv(rng, b, sq, sk, h, kvh, hd):
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 8])
def test_chunked_attention_matches_reference(window):
    """40 keys in chunks of 16 (the last padded with INT_MAX positions),
    queries at the last 24 positions, GQA 4 heads on 2: the reference's
    chunked path, and the port's direct path on the same inputs."""
    q, k, v = _qkv(np.random.default_rng(3), 2, 24, 40, 4, 2, 8)
    q_pos = np.arange(16, 40, dtype=np.int32)
    k_pos = np.arange(40, dtype=np.int32)
    want = JA.chunked_attention(q, k, v, q_pos, k_pos, window, chunk=16)
    args = (_t(q), _t(k), _t(v), _t(q_pos), _t(k_pos), window)
    _close(TA.chunked_attention(*args, chunk=16).numpy(), want, 1e-6)
    _close(TA.direct_attention(*args).numpy(), want, 1e-6)


def _attn_cfg(jdt=jnp.float32, tdt=torch.float32, **kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=0, vocab_size=7,
                qkv_bias=True, rope_theta=1000.0, sliding_window=4)
    base.update(kw)
    return (JModelConfig(**base, param_dtype=jdt),
            TModelConfig(**base, param_dtype=tdt))


def _mixer_params(init_fn, cfg):
    """One mixer's reference params, vectors and biases nudged, as numpy
    and as the port's tensors."""
    rng = np.random.default_rng(5)
    p = {k: np.asarray(v) for k, v in init_fn(jax.random.key(4),
                                                cfg).items()}
    p = {k: (v.astype(np.float32) + 0.1 * rng.normal(size=v.shape)
             ).astype(v.dtype) if k in _NUDGED else v for k, v in p.items()}
    return p, lm_tree_from_numpy(p, CPU)


@pytest.mark.parametrize("window,start,slots", [(4, 6, 4), (0, 5, 4)],
                         ids=["ring-wrap", "full-past-capacity"])
def test_attn_decode_matches_reference(window, start, slots):
    """Three one-token steps from a cache of ``slots`` slots at position
    ``start``: the ring buffer's slot pos % 4 wraps, the full cache
    overwrites its last slot once pos > 3."""
    jcfg, tcfg = _attn_cfg()
    jp, tp = _mixer_params(JA.init_attention, jcfg)
    rng = np.random.default_rng(6)
    k_pos = np.full((slots,), np.iinfo(np.int32).max, np.int32)
    k_pos[: slots - 1] = np.arange(start - slots + 1, start)
    cache = {"k": rng.normal(size=(2, slots, 2, 8)).astype(np.float32),
             "v": rng.normal(size=(2, slots, 2, 8)).astype(np.float32),
             "k_pos": k_pos, "pos": np.asarray(start, np.int32)}
    tcache = lm_tree_from_numpy(cache, CPU)
    for _ in range(3):
        x = rng.normal(size=(2, 1, 32)).astype(np.float32)
        want, cache = jax.jit(functools.partial(
            JA.attn_decode, cfg=jcfg, window=window))(jp, x=x, cache=cache)
        got, tcache = TA.attn_decode(tp, tcfg, _t(x), tcache, window)
        _close(got.numpy(), want, 1e-6)
        _assert_cache(lm_tree_to_numpy(tcache), _np(cache), 1e-6)


def _ssm_cfg(jdt=jnp.float32, tdt=torch.float32):
    base = dict(name="s", family="ssm", n_layers=1, d_model=32, n_heads=0,
                n_kv_heads=0, d_ff=0, vocab_size=7, ssm_state=8,
                ssm_heads=4, ssm_chunk=8, lru_width=32, conv_width=4)
    return (JModelConfig(**base, param_dtype=jdt),
            TModelConfig(**base, param_dtype=tdt))


RECURRENT = {"ssd": (JSSM.init_ssd, JSSM.ssd_forward, JSSM.ssd_decode,
                     TSSM.ssd_forward, TSSM.ssd_decode),
             "rec": (JR.init_rglru, JR.rglru_forward, JR.rglru_decode,
                     TR.rglru_forward, TR.rglru_decode)}


@pytest.mark.parametrize("kind", list(RECURRENT))
@pytest.mark.parametrize("return_state", [False, True])
def test_recurrent_forward_and_decode_match_reference(kind, return_state):
    """11 tokens (SSD: one full chunk of 8 and a padded one): the output,
    and with ``return_state`` the decode cache, then three decode steps
    from it."""
    jinit, jfwd, jdec, tfwd, tdec = RECURRENT[kind]
    jcfg, tcfg = _ssm_cfg()
    jp, tp = _mixer_params(jinit, jcfg)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 11, 32)).astype(np.float32)
    want = jax.jit(functools.partial(jfwd, cfg=jcfg,
                                     return_state=return_state))(jp, x=x)
    got = tfwd(tp, tcfg, _t(x), return_state=return_state)
    if not return_state:
        _close(got.numpy(), want, 1e-5)
        return
    _close(got[0].numpy(), want[0], 1e-5)
    cache, tcache = _np(want[1]), got[1]
    _assert_cache(lm_tree_to_numpy(tcache), cache, 1e-5)
    step = jax.jit(functools.partial(jdec, cfg=jcfg))
    for _ in range(3):
        x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
        want, cache = step(jp, x=x1, cache=cache)
        got, tcache = tdec(tp, tcfg, _t(x1), tcache)
        _close(got.numpy(), want, 1e-5)
        _assert_cache(lm_tree_to_numpy(tcache), _np(cache), 1e-5)


@pytest.mark.parametrize("s,window", [(5, 8), (13, 8), (13, 0)],
                         ids=["shorter-than-window", "longer-than-window",
                              "full"])
def test_full_kv_to_cache_matches_reference(s, window):
    rng = np.random.default_rng(8)
    k = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
    want = _np(JCACHE.full_kv_to_cache(k, v, 16, window))
    got = lm_tree_to_numpy(TCACHE.full_kv_to_cache(_t(k), _t(v), 16,
                                                    window))
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def _bf16_mla():
    """MLA in bf16 (dsv2-smoke's ranks at d_model 32): the full sequence
    packs its latents into a 16-slot cache."""
    jcfg, tcfg = _attn_cfg(jnp.bfloat16, torch.bfloat16, kv_lora_rank=16,
                           q_lora_rank=12, rope_head_dim=4, head_dim=8,
                           v_head_dim=6)
    pos = np.arange(12, dtype=np.int32)

    def jfwd(p, cfg, x, return_state):
        y, (ckv, krope) = JA.mla_forward(p, cfg, x, pos, return_kv=True)
        return y, JCACHE.mla_kv_to_cache(ckv, krope, 16)

    def tfwd(p, c, x, return_state):
        y, (ckv, krope) = TA.mla_forward(p, c, x, _t(pos), return_kv=True)
        return y, TCACHE.mla_kv_to_cache(ckv, krope, 16)

    return (jcfg, tcfg, JA.init_mla, jfwd, JA.mla_decode, tfwd,
            TA.mla_decode)


def _bf16_moe():
    """The MoE FFN in bf16 (4 experts, top 2): the full sequence on the
    dropless path (the reference's bf16 GShard does not run on XLA's CPU
    runtime), decode on ``moe_decode``; no cache."""
    jcfg, tcfg = _attn_cfg(jnp.bfloat16, torch.bfloat16, d_ff=16,
                           n_experts=4, moe_top_k=2)

    def jfwd(p, cfg, x, return_state):
        return JF.moe_dropless_forward(p, cfg, x)[0], {}

    def tfwd(p, c, x, return_state):
        return TF.moe_dropless_forward(p, c, x)[0], {}

    def jdec(p, cfg, x, cache):
        return JF.moe_decode(p, cfg, x)[0], cache

    def tdec(p, c, x, cache):
        return TF.moe_decode(p, c, x)[0], cache

    return jcfg, tcfg, JF.init_moe, jfwd, jdec, tfwd, tdec


@pytest.mark.parametrize("kind", ["global", "local", "mla", "ssd", "rec",
                                  "moe"])
def test_bf16_layer_kind_matches_reference(kind):
    """Each layer kind with bf16 params and activations: 12 tokens in
    full, then three decode steps, within BF16_REL of the largest
    output."""
    if kind == "mla":
        jcfg, tcfg, jinit, jfwd, jdec, tfwd, tdec = _bf16_mla()
    elif kind == "moe":
        jcfg, tcfg, jinit, jfwd, jdec, tfwd, tdec = _bf16_moe()
    elif kind in ("global", "local"):
        jcfg, tcfg = _attn_cfg(jnp.bfloat16, torch.bfloat16)
        jinit = JA.init_attention
        window = 4 if kind == "local" else 0
        pos = np.arange(12, dtype=np.int32)

        def jfwd(p, cfg, x, return_state):
            y, (k, v) = JA.attn_forward(p, cfg, x, pos, window,
                                        return_kv=True)
            return y, JCACHE.full_kv_to_cache(k, v, 16, window)

        def tfwd(p, c, x, return_state):
            y, (k, v) = TA.attn_forward(p, c, x, _t(pos), window,
                                        return_kv=True)
            return y, TCACHE.full_kv_to_cache(k, v, 16, window)

        def jdec(p, cfg, x, cache):
            return JA.attn_decode(p, cfg, x, cache, window)

        def tdec(p, c, x, cache):
            return TA.attn_decode(p, c, x, cache, window)
    else:
        jcfg, tcfg = _ssm_cfg(jnp.bfloat16, torch.bfloat16)
        jinit, jfwd, jdec, tfwd, tdec = RECURRENT[kind]
    jp, tp = _mixer_params(jinit, jcfg)
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=(2, 12, 32)), jnp.bfloat16)
    tx = lm_tree_from_numpy(np.asarray(x), CPU)
    want, cache = jax.jit(functools.partial(jfwd, cfg=jcfg,
                                            return_state=True))(jp, x=x)
    step = jax.jit(functools.partial(jdec, cfg=jcfg))
    got, tcache = tfwd(tp, tcfg, tx, return_state=True)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16_REL)
    for _ in range(3):
        x1 = jnp.asarray(rng.normal(size=(2, 1, 32)), jnp.bfloat16)
        want, cache = step(jp, x=x1, cache=cache)
        got, tcache = tdec(tp, tcfg, lm_tree_from_numpy(np.asarray(x1),
                                                          CPU), tcache)
        _close(got.float().numpy(), np.asarray(want, np.float32), BF16_REL)
    back = lm_tree_to_numpy(tcache)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(cache))):
        if b.dtype == ml_dtypes.bfloat16:
            a = a.view(ml_dtypes.bfloat16)
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            _close(a.astype(np.float32), b.astype(np.float32), BF16_REL)


def test_greedy_ties_go_to_the_first_maximum():
    logits = np.zeros((3, 1, 50), np.float32)
    logits[0, 0, [4, 9]] = 1.0
    logits[1, 0, [0, 49]] = 2.0
    logits[2, 0, 17] = 3.0
    got = TS.greedy_sample(_t(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), JS.greedy_sample(logits))
    assert got[:, 0].tolist() == [4, 0, 17]


def test_param_tree_round_trip_is_the_reference_tree():
    """lm_tree_to_numpy(lm_tree_from_numpy(tree)) is the tree,
    leaf for leaf: gemma3's groups and its two remainder layers."""
    jcfg, _ = _configs("gemma3-1b")
    params = _np(JT.init_params(jax.random.key(0), jcfg))
    back = lm_tree_to_numpy(lm_tree_from_numpy(params, CPU))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    assert len(back["rem"]) == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
