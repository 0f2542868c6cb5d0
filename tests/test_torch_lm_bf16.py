"""bf16's own drift at mamba2-780m's published widths, in both packages.

mamba2-780m (d_model 1536, 48 SSD heads, state 128, vocab 50280) with
only the depth cut to DEPTH layers and bf16 params drawn by the
reference's ``init_params``, which both packages run. Two readings, each
as a share of the largest fp32 logit: the bf16 forward against the fp32
forward of the same (upcast) params, and the bf16 greedy decode against
the bf16 teacher-forced forward of the same tokens. Each reading of the
port's stays within PORT_OVER of the reference's own: the gap is bf16's,
and not the port's rounding. The fp32 forwards agree within 1e-4. Run
with ``-s`` to print the readings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as JC
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models.common import tree_map

ARCH, DEPTH = "mamba2-780m", 8
BATCH, PROMPT, DECODE = 2, 64, 6
PORT_OVER = 1.5


def _gap(got, want, scale):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / scale)


@torch.no_grad()
def test_mamba2_bf16_drift_is_the_references_own():
    jcfg = dataclasses.replace(JC.get_config(ARCH), n_layers=DEPTH)
    jcfg32 = dataclasses.replace(jcfg, param_dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.get_config(ARCH), n_layers=DEPTH)
    tcfg32 = dataclasses.replace(tcfg, param_dtype=torch.float32)
    assert (tcfg.d_model, tcfg.ssm_heads, tcfg.vocab_size) == (1536, 48,
                                                               50280)
    p16 = JT.init_params(jax.random.key(0), jcfg)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)

    # the reference: prefill, DECODE - 1 greedy steps, then the forwards
    pre = jax.jit(lambda p, t: JT.prefill(p, jcfg, tokens=t,
                                          cache_seq=PROMPT + DECODE))
    step = jax.jit(JS.make_serve_step(jcfg))
    logits, cache = pre(p16, prompts)
    tok = JS.greedy_sample(logits[:, -1:])
    toks, steps = [np.asarray(tok)], [np.asarray(logits[:, -1])]
    for _ in range(DECODE - 1):
        logits, cache = step(p16, tok, cache)
        tok = JS.greedy_sample(logits)
        toks.append(np.asarray(tok))
        steps.append(np.asarray(logits[:, 0]))
    seq = np.concatenate([prompts, *toks[:-1]], axis=1)
    fwd = jax.jit(lambda p, t, c: JT.forward(p, c, tokens=t)[0],
                  static_argnums=2)
    ref16 = np.asarray(fwd(p16, seq, jcfg))[:, PROMPT - 1:]
    ref32 = np.asarray(fwd(p32, seq, jcfg32))[:, PROMPT - 1:]
    scale = float(np.abs(ref32).max())
    ref_drift = _gap(ref16, ref32, scale)
    ref_decode = _gap(np.stack(steps, axis=1), ref16, scale)

    # the port, on the same params and the reference's tokens
    tp16 = lm_tree_from_numpy(jax.tree.map(np.asarray, p16), "cpu")
    tp32 = tree_map(lambda t: t.float(), tp16)
    tseq = torch.from_numpy(seq)
    port16 = TT.forward(tp16, tcfg, tokens=tseq)[0][:, PROMPT - 1:]
    port32 = TT.forward(tp32, tcfg32, tokens=tseq)[0][:, PROMPT - 1:]
    logits, cache = TT.prefill(tp16, tcfg, tokens=torch.from_numpy(prompts),
                               cache_seq=PROMPT + DECODE)
    got = [logits[:, -1]]
    for t in toks[:-1]:
        logits, cache = TT.decode_step(tp16, tcfg, torch.tensor(t),
                                       cache)
        got.append(logits[:, 0])
    port_drift = _gap(port16.numpy(), port32.numpy(), scale)
    port_decode = _gap(torch.stack(got, dim=1).numpy(), port16.numpy(),
                       scale)

    print(f"\n{ARCH} at {DEPTH} layers, bf16 against fp32 forward: "
          f"reference {ref_drift:.3e}, port {port_drift:.3e}; bf16 decode "
          f"against bf16 forward: reference {ref_decode:.3e}, port "
          f"{port_decode:.3e}")
    assert _gap(port32.numpy(), ref32, scale) <= 1e-4
    assert 0 < port_drift <= PORT_OVER * ref_drift
    assert 0 < port_decode <= PORT_OVER * ref_decode
