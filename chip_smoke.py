#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no result line is printed:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   nvcc per source, all started together;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, fp32 and bf16 inputs, at the server-round shape
   (N=4096, R=240, C=10), the federation's (32, 240, 3) and a ragged one
   (37, 13, 5); then times (CUDA events, warm L2) of kernel, plain version
   and one library call as a yardstick, beside each kernel's bound;
4. server round: ``policy_round`` with sqmd(q=64, k=8) on a numpy-seeded
   N=4096 repository, held against the same round on the plain versions;
5. federation (the main path): ``FederationEngine.fit`` on ``sc_like()``
   (32 clients, R=240, C=3), the three MLP tiers, sqmd(q=16, k=8),
   5 rounds, with launch counts read around it, every state tensor
   checked to be on the card, and the eval logits held against the same
   federation run on the CPU with the same numpy-made weights and draws;
6. a ``{"kernels": [...]}`` summary line, then the last line
   ``{"ok": true, "device": {...}}``.

The measured numbers also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W); every
# timed kernel runs on fp32 inputs and fp32 CUDA-core FMAs
PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12           # HBM3

SERVER = (4096, 240, 10)
FEDERATION = (32, 240, 3)
RAGGED = (37, 13, 5)
# fp32 reductions in another order than the plain version's: relative to
# the magnitudes (divergences ~1-10, grades ~R log C, targets <= 1)
TOL = {"pairwise_kl_pair": (1e-4, 1e-4), "soft_ce": (1e-3, 1e-5),
       "neighbor_mean": (1e-6, 1e-5)}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def log_softmax_np(x: np.ndarray) -> np.ndarray:
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """Max abs error, and max rel error over entries with |want| >= 1e-3
    (a divergence matrix's diagonal is ~0, where relative error says
    nothing)."""
    d = (got - want).abs()
    big = want.abs() >= 1e-3
    if not bool(big.any()):
        return float(d.max()), 0.0
    return float(d.max()), float((d[big] / want.abs()[big]).max())


def sparse_weights(n: int, k: int, rng, dev) -> torch.Tensor:
    """A row-stochastic W with k nonzeros of 1/k per row, no self-edge:
    the shape of the selection matrix the main path hands neighbor_mean."""
    w = np.zeros((n, n), np.float32)
    for i in range(n):
        others = np.delete(np.arange(n), i)
        w[i, rng.choice(others, size=k, replace=False)] = 1.0 / k
    return torch.from_numpy(w).to(dev)


def kernel_inputs(shape, dtype, dev, seed):
    from repro_torch.kernels.ops import CHUNK_ROWS
    n, r, c = shape
    rng = np.random.default_rng(seed)
    logp = torch.from_numpy(
        log_softmax_np(rng.normal(size=shape) * 2.0)).to(dev)
    labels = rng.integers(0, c, r).astype(np.int32)
    if shape == RAGGED:
        labels[::4] = -1                       # padded reference rows
    return {
        "logp": logp.to(dtype),
        "strip": logp[:min(n, CHUNK_ROWS)].to(dtype).contiguous(),
        "labels": torch.from_numpy(labels).to(dev),
        "w": sparse_weights(n, min(8, n - 1), rng, dev),
        "probs": torch.exp(logp).to(dtype),
    }


def kernel_phase(dev) -> dict:
    from repro_torch.kernels import neighbor_mean as nm
    from repro_torch.kernels import pairwise_kl as pk
    from repro_torch.kernels import soft_ce as sc
    from repro_torch.kernels import ref
    cases = {
        "pairwise_kl_pair": (lambda a: pk.pairwise_kl_pair(a["strip"],
                                                           a["logp"]),
                             lambda a: ref.pairwise_kl_pair_ref(a["strip"],
                                                                a["logp"])),
        "soft_ce": (lambda a: sc.soft_ce(a["logp"], a["labels"]),
                    lambda a: ref.soft_ce_ref(a["logp"], a["labels"])),
        "neighbor_mean": (lambda a: nm.neighbor_mean(a["w"], a["probs"]),
                          lambda a: ref.neighbor_mean_ref(a["w"],
                                                          a["probs"])),
    }
    err = {}
    for shape in (SERVER, FEDERATION, RAGGED):
        for dtype in (torch.float32, torch.bfloat16):
            a = kernel_inputs(shape, dtype, dev, seed=sum(shape))
            for name, (kern, plain) in cases.items():
                got, want = kern(a), plain(a)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == torch.float32,
                      f"{name} {shape}: shape/dtype {tuple(got.shape)} "
                      f"{got.dtype}")
                ea, er = errors(got, want)
                atol, rtol = TOL[name]
                ok = torch.allclose(got, want, atol=atol, rtol=rtol)
                print(f"  {name:17s} {str(shape):16s} "
                      f"{str(dtype)[6:]:9s} max_abs={ea:.3e} "
                      f"max_rel={er:.3e} atol={atol:g} rtol={rtol:g} "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"{name} {shape} {dtype} disagrees with its "
                          f"plain version")
                if shape == SERVER and dtype == torch.float32:
                    err[name] = ea

    # times at the server-round shape, fp32 (the main path's dtype)
    a = kernel_inputs(SERVER, torch.float32, dev, seed=sum(SERVER))
    n, r, c = SERVER
    u, k = a["strip"].shape[0], r * c
    pa = torch.exp(a["strip"].reshape(u, k))
    lb_t = a["logp"].reshape(n, k).T
    z = a["logp"]
    y_idx = a["labels"].long()[None, :, None].expand(n, -1, 1)
    s_flat = a["probs"].reshape(n, k)
    nnz = int((a["w"] != 0).sum())
    w_csr = a["w"].to_sparse_csr()
    library = {
        "pairwise_kl_pair": lambda: torch.matmul(pa, lb_t),
        "soft_ce": lambda: (torch.logsumexp(z, dim=-1),
                            torch.gather(z, 2, y_idx)),
        "neighbor_mean": lambda: torch.matmul(a["w"], s_flat),
    }
    work = {   # (flops, bytes) the function needs on these inputs
        "pairwise_kl_pair": (2.0 * u * n * k + 2.0 * u * k,
                             4.0 * (u * k + n * k + u * n)),
        "soft_ce": (4.0 * n * r * c, 4.0 * (n * r * c + r + n)),
        # W has k nonzeros per row: the product needs 2 nnz RC flops;
        # the dense interface still reads all of W
        "neighbor_mean": (2.0 * nnz * k, 4.0 * (n * n + 2 * n * k)),
    }
    iters = {"pairwise_kl_pair": 10, "soft_ce": 200, "neighbor_mean": 10}
    rows = {}
    for name, (kern, plain) in cases.items():
        t_kern = cuda_ms(lambda: kern(a), iters[name])
        t_plain = cuda_ms(lambda: plain(a), iters[name])
        t_lib = cuda_ms(library[name], iters[name])
        flops, nbytes = work[name]
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        rows[name] = {"ms": t_kern, "plain_ms": t_plain, "library_ms": t_lib,
                      "bound_ms": bound,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes",
                      "flops": flops, "bytes": nbytes,
                      "max_abs_err": err[name]}
        print(f"  time {name:17s} kernel={t_kern:.4f} ms "
              f"plain={t_plain:.4f} ms library={t_lib:.4f} ms "
              f"bound={bound:.4f} ms ({rows[name]['bound_by']}; "
              f"{flops:.4g} flop, {nbytes:.4g} B) "
              f"share={bound / t_kern:.3%}")
    # the federation's own shape: launch-overhead territory
    af = kernel_inputs(FEDERATION, torch.float32, dev, seed=sum(FEDERATION))
    for name, (kern, plain) in cases.items():
        rows[name]["federation_ms"] = cuda_ms(lambda: kern(af), 100)
        rows[name]["federation_plain_ms"] = cuda_ms(lambda: plain(af), 100)
        print(f"  time {name:17s} at {FEDERATION}: "
              f"kernel={rows[name]['federation_ms']:.4f} ms "
              f"plain={rows[name]['federation_plain_ms']:.4f} ms")
    # what a sparse product of the same W costs (the B3 redesign's target)
    t_sparse = cuda_ms(lambda: torch.sparse.mm(w_csr, s_flat), 10)
    print(f"  time neighbor_mean as torch.sparse.mm (CSR W, {nnz} nonzeros): "
          f"{t_sparse:.4f} ms")
    rows["neighbor_mean"]["sparse_library_ms"] = t_sparse
    # the square matrix of a server round is two CHUNK_ROWS strips
    from repro_torch.kernels import ops
    t_square = cuda_ms(lambda: ops.pairwise_kl(a["logp"]), 5)
    print(f"  time pairwise_kl square N={n} (two strips) "
          f"kernel={t_square:.4f} ms, dense-work bound "
          f"{2.0 * n * n * k / PEAK_FP32_FLOPS * 1e3:.4f} ms")
    rows["pairwise_kl_pair"]["square_ms"] = t_square
    print(f"  card during timing: clocks.sm,power.draw,temperature.gpu = "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    return rows


def server_phase(dev) -> dict:
    from repro_torch.core import (candidate_mask, init_server, policy_round,
                                  select_neighbors_from_div, sqmd,
                                  upload_messengers)
    from repro_torch.core.policies import as_policy
    from repro_torch.kernels import ops, ref
    n, r, c = SERVER
    q, k = 64, 8
    rng = np.random.default_rng(0)
    repo = torch.from_numpy(
        log_softmax_np(rng.normal(size=SERVER).astype(np.float32) * 2.0))
    labels = torch.from_numpy(rng.integers(0, c, r).astype(np.int32)).to(dev)
    state = upload_messengers(init_server(n, r, c, device=dev), repo.to(dev),
                              torch.ones(n, dtype=torch.bool))
    pol = as_policy(sqmd(q=q, k=k))

    def plain_round():
        """The same round on the plain versions, on the card."""
        lp = state.repo_logp
        quality = ref.soft_ce_ref(lp, labels)
        cand = candidate_mask(quality, state.active, q)
        div = torch.cat([ref.pairwise_kl_pair_ref(lp[i:i + ops.CHUNK_ROWS],
                                                  lp)
                         for i in range(0, n, ops.CHUNK_ROWS)])
        g = select_neighbors_from_div(div, cand, k)
        return ref.neighbor_mean_ref(g.weights, torch.exp(lp)), g

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    policy_round(state, pol, labels)                     # warm-up
    plain_round()
    ops.reset_launch_counts()
    (_, targets, graph), _ = timed(lambda: policy_round(state, pol, labels))
    counts = ops.launch_counts()
    check(counts == {"pairwise_kl_pair": 2, "soft_ce": 1,
                     "neighbor_mean": 1},
          f"server round launched {counts}")
    t_kern, t_plain = [], []
    for _ in range(3):                       # in turns: kernels, plain
        t_kern.append(timed(lambda: policy_round(state, pol, labels))[1])
        (ptargets, pgraph), t = timed(plain_round)
        t_plain.append(t)
    print(f"  policy_round N={n} on the kernels: "
          f"{', '.join(f'{t:.2f}' for t in t_kern)} ms; launches {counts}")
    print(f"  policy_round N={n} on the plain versions: "
          f"{', '.join(f'{t:.2f}' for t in t_plain)} ms")

    check(bool((graph.candidates == pgraph.candidates).all()),
          "the quality pools differ")
    sim = pgraph.similarity
    nb, pnb = graph.neighbors.long(), pgraph.neighbors.long()
    same = (torch.sort(nb, 1).values == torch.sort(pnb, 1).values).all(1)
    # a differing pick must be a near-tie under the plain similarity
    ks = torch.sort(torch.gather(sim, 1, nb), 1).values
    ps = torch.sort(torch.gather(sim, 1, pnb), 1).values
    near = torch.isclose(ks, ps, rtol=1e-5, atol=0).all(1)
    n_diff = int((~same).sum())
    print(f"  neighbor sets differing from the plain round: {n_diff} rows "
          f"(all within 1e-5 relative similarity: {bool(near.all())})")
    check(bool((same | near).all()), "neighbor choice differs beyond a "
                                     "1e-5 relative near-tie")
    d = (targets - ptargets).abs()[same]
    t_err = float(d.max()) if d.numel() else 0.0
    print(f"  targets max abs err on rows with equal neighbors: {t_err:.3e}")
    check(t_err <= 1e-6, "targets disagree with the plain round")
    check(bool(torch.isfinite(targets).all()), "non-finite targets")
    return {"kernel_ms": t_kern, "plain_ms": t_plain,
            "launches": counts, "neighbor_rows_differing": n_diff,
            "targets_max_abs_err": t_err}


def federation(dev, splits, ds, init_params, draws, logits_out):
    from repro_torch.core import FederationConfig, FederationEngine, sqmd
    from repro_torch.models import hetero_mlp_zoo

    def record(engine, rnd, metrics):
        out = {}
        for coh in engine.fed.cohorts:
            xs = torch.from_numpy(np.stack(
                [splits[i].test_x for i in coh.client_ids])).to(
                    engine.fed.device)
            with torch.no_grad():
                out[coh.family_name] = coh.model(xs).float().cpu().numpy()
        logits_out.append(out)

    return FederationEngine.build(
        ds, splits, hetero_mlp_zoo(ds.feature_len, ds.n_classes), None,
        sqmd(q=16, k=8), config=FederationConfig(rounds=5, batch_size=32,
                                                 eval_every=2),
        seed=1, callbacks=[record], device=dev, init_params=init_params,
        batch_indices=lambda step, ci: draws(step, ci))


def federation_phase(dev) -> dict:
    from repro_torch.data import make_splits, sc_like
    from repro_torch.kernels import ops
    from repro_torch.models import hetero_mlp_zoo
    ds = sc_like()
    splits = make_splits(ds, seed=0)
    zoo = hetero_mlp_zoo(ds.feature_len, ds.n_classes)
    names = list(zoo)
    # numpy-made weights and batch draws, shared by the card and CPU runs
    rng = np.random.default_rng(2)
    init_params, sizes = {}, []
    for fam, cfg in zoo.items():
        ids = [i for i in range(ds.n_clients) if names[i % len(names)] == fam]
        layers = [{"w": rng.normal(size=(len(ids), a, b)).astype(np.float32)
                   / np.float32(np.sqrt(a)),
                   "b": np.zeros((len(ids), b), np.float32)}
                  for a, b in zip(cfg.dims[:-1], cfg.dims[1:])]
        init_params[fam] = {"layers": layers}
        sizes.append((len(ids), min(len(splits[i].train_y) for i in ids)))

    def draws(step, ci):
        n_c, m = sizes[ci]
        return np.random.default_rng((3, step, ci)).integers(0, m, (n_c, 32))

    card_logits, cpu_logits = [], []
    eng = federation(dev, splits, ds, init_params, draws, card_logits)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = eng.fit(splits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for rnd, acc in zip(hist.rounds, hist.mean_acc):
        print(f"  round {rnd}: mean test accuracy {acc:.4f}")
    print(f"  fit: {wall:.3f} s for 5 rounds, launches {counts}")
    check(all(v > 0 for v in counts.values()),
          f"a kernel of the main path never launched: {counts}")

    fed = eng.fed
    tensors = [fed.ref_x, fed.ref_y, fed.targets, *fed.server]
    for coh in fed.cohorts:
        tensors += [*coh.model.parameters(), coh.opt_state.step,
                    *coh.opt_state.momentum, *coh.data.values()]
    check(all(t.is_cuda for t in tensors), "a state tensor is off the card")
    print(f"  all {len(tensors)} state tensors on {fed.device}")

    cpu = federation("cpu", splits, ds, init_params, draws, cpu_logits)
    cpu_hist = cpu.fit(splits)
    worst, flips = 0.0, 0
    for gpu_ev, cpu_ev in zip(card_logits, cpu_logits):
        for fam in gpu_ev:
            g, h = gpu_ev[fam], cpu_ev[fam]
            worst = max(worst, float(np.abs(g - h).max()))
            flip = g.argmax(-1) != h.argmax(-1)
            top2 = np.sort(h, -1)[..., -2:]
            gap = (top2[..., 1] - top2[..., 0])[flip]
            check(gap.max(initial=0.0) < 2e-2,
                  "a prediction flipped away from a near-tie")
            flips += int(flip.sum())
    print(f"  card vs CPU federation: eval logits max abs diff {worst:.3e}, "
          f"{flips} near-tie prediction flips; CPU mean accuracy "
          f"{cpu_hist.mean_acc}")
    check(worst < 1e-2, "card and CPU federations drifted apart")
    check(all(np.isfinite(hist.mean_acc)) and len(hist.mean_acc) == 3,
          "bad accuracy history")
    return {"launches": counts, "fit_s": wall, "mean_acc": hist.mean_acc,
            "cpu_mean_acc": cpu_hist.mean_acc, "logit_max_abs_diff": worst}


SOURCES = {
    "pairwise_kl_pair": ("src/repro_torch/kernels/csrc/pairwise_kl.cu",
                         "src/repro/kernels/pairwise_kl.py:37"),
    "soft_ce": ("src/repro_torch/kernels/csrc/soft_ce.cu",
                "src/repro/kernels/soft_ce.py:25"),
    "neighbor_mean": ("src/repro_torch/kernels/csrc/neighbor_mean.cu",
                      "src/repro/kernels/neighbor_mean.py:25"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    print("[1] device")
    card = smi("name,power.limit")
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"capability {torch.cuda.get_device_capability(0)}")

    print("[2] build")
    t0 = time.perf_counter()
    built = build.build_all()
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {name}: {info['seconds']:.1f} s; " + " | ".join(ptxas))
    print(f"  build wall time {time.perf_counter() - t0:.1f} s "
          f"({len(built)} of {len(build.SOURCES)} sources compiled)")

    print("[3] kernels against their plain versions")
    rows = kernel_phase(dev)

    print("[4] server round at N=4096")
    server = server_phase(dev)

    print("[5] federation (main path)")
    fedres = federation_phase(dev)

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": fedres["launches"][name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name in SOURCES]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": rows, "server_round": server,
         "federation": fedres, "wall_s": time.perf_counter() - t_start},
        indent=2, default=float))
    print(f"  total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
