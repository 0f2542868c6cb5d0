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
   (37, 13, 5): the Eq. 2 split pass and 3xTF32 GEMM, Eq. 1, the Eq. 5
   gather over neighbor lists (also held against the dense Eq. 5 kernel
   on the same graph) and the dense Eq. 5 kernel; the Eq. 2 strip's error
   against fp64, beside the plain version's; then times (CUDA events,
   warm L2) of kernel, plain version and one library call as a
   yardstick, beside each kernel's bound;
4. server round: ``policy_round`` with sqmd(q=64, k=8) on a numpy-seeded
   N=4096 repository, held against the same round on the plain versions
   (neighbor sets and targets), with its launch counts;
5. federation (the main path): ``FederationEngine.fit`` on ``sc_like()``
   (32 clients, R=240, C=3), the three MLP tiers, sqmd(q=16, k=8),
   5 rounds, with launch counts read around it, every state tensor
   checked to be on the card, and the eval logits held against the same
   federation run on the CPU with the same numpy-made weights and draws;
6. the int8 kernel (dequant_kl) against its plain version on int8-encoded
   inputs: the server-round strip (2048 x 4096, R=240, C=10), the ANN
   oracle strip (64 x 131072, R=8, C=10) and the ragged (37, 13, 5); times
   of kernel, wrapper, plain version and a library product beside the
   bound;
7. a delta server round at N=4096: ``policy_round(..., uploaded=mask)``
   with 64 fresh rows, the cache held against a full rebuild, launch
   counts showing the two strips;
8. the IVF neighbor index on the card at N=10^5 and 10^6 (R=8, C=10,
   k=10, default probes, the sizes of benchmarks/ann_scale.py): build
   time, one-row upload latency, resident device bytes and top-k overlap
   against an exact oracle of chunked int8 strips (fails below 0.9); a
   real upload's forward and reverse strips through the int8 kernel
   against its plain version; at N=4096 with probe-all, every list held
   against the dense oracle's top-L computed by the plain version;
9. the IVF federation: phase 5's federation with ``delta_graph=True,
   selection="ivf", uplink="int8"``, launch counts read around it, the
   index's tensors checked to be on the card, eval logits held against
   the same run on the CPU;
10. warm fit times of both federations, in turns (phase 5's fit is the
    process's first); phases 4, 7 and 10 also run one round or fit under
    torch.profiler for the device time by kernel and the device's busy
    share;
11. a ``{"kernels": [...]}`` summary line (the int8 kernel's launches
    from phase 9, the others' from phase 5, where the dense Eq. 5 entry
    launches 0 times: both SQMD graphs carry their neighbor lists), then
    the last line ``{"ok": true, "device": {...}}``.

Every time printed names the card and its power limit. The measured
numbers also go to ``chiprun_out/chip_smoke.json``.
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

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W); the
# timed kernels run on fp32 inputs: the Eq. 2 GEMM as three TF32 tensor-
# core products (3xTF32), the others on fp32 CUDA-core FMAs
PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 tensor cores
PEAK_BYTES = 3.35e12           # HBM3

SERVER = (4096, 240, 10)
FEDERATION = (32, 240, 3)
RAGGED = (37, 13, 5)
# benchmarks/ann_scale.py:37-46: messenger dims, k, query rows, modes of
# the synthetic population, generation and oracle chunks, tie tolerance
ANN_R, ANN_C, ANN_K = 8, 10, 10
ANN_SIZES = (100_000, 1_000_000)
N_QUERY, N_PROTO, GEN_CHUNK, ORACLE_CHUNK, TIE_TOL = 64, 128, 65_536, \
    131_072, 1e-6
OVERLAP_GATE = 0.9             # the reference's gate (ann_scale.py:174)
DELTA_ROWS = 64                # fresh uploads in the delta round
CARD = "?"                     # nvidia-smi name, power limit (set in main)
# fp32 reductions in another order than the plain version's: relative to
# the magnitudes (divergences ~1-10, grades ~R log C, targets <= 1)
TOL = {"pairwise_kl_pair": (1e-4, 1e-4), "soft_ce": (1e-3, 1e-5),
       "neighbor_mean": (1e-6, 1e-5), "neighbor_gather": (1e-6, 1e-5),
       "int8_pairwise_kl_pair": (1e-4, 1e-4),
       # the split's hi + lo and row term (exp may differ in a last bit)
       "pairwise_kl_split": (1e-5, 1e-5)}
# the 3xTF32 strip's error against fp64 may be at most this multiple of
# the fp32 plain version's (cuBLAS with TF32 off)
FP64_ERR_RATIO = 2.0


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


def timed(fn):
    """(fn's result, host ms around it), the card synchronized on both
    sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_breakdown(label: str, fn) -> dict:
    """One call of ``fn`` under torch.profiler: the CUDA kernels' device
    time by name, their sum, and its share of the host wall time of the
    call (the device's busy share; the profiler's own overhead lengthens
    the wall time, so the share is a lower bound); and the host operators
    with the most self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    host_top = [{"op": e.key[:40], "ms": e.self_cpu_time_total / 1e3,
                 "count": e.count} for e in host]
    print(f"  {label}: host operators by self CPU time: "
          + "; ".join(f"{t['op']} {t['ms']:.3f} ms x{t['count']}"
                      for t in host_top))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print(f"  [{CARD}] {label}: device time not measured (the profiler "
              f"recorded no CUDA kernel)")
        return {"wall_ms": wall, "device_ms": None, "host_top": host_top}
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [{"kernel": e.key[:60], "ms": e.self_device_time_total / 1e3,
            "count": e.count} for e in kernels[:6]]
    print(f"  [{CARD}] {label} under the profiler: wall {wall:.2f} ms, "
          f"device busy {device:.3f} ms ({device / wall:.1%}); by kernel: "
          + "; ".join(f"{t['kernel']} {t['ms']:.3f} ms x{t['count']}"
                      for t in top))
    return {"wall_ms": wall, "device_ms": device,
            "busy_share": device / wall, "top": top, "host_top": host_top}


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """Max abs error, and max rel error over entries with |want| >= 1e-3
    (a divergence matrix's diagonal is ~0, where relative error says
    nothing)."""
    d = (got - want).abs()
    big = want.abs() >= 1e-3
    if not bool(big.any()):
        return float(d.max()), 0.0
    return float(d.max()), float((d[big] / want.abs()[big]).max())


def sparse_weights(n: int, k: int, rng, dev) -> tuple:
    """A graph of k neighbors per row, no self-edge, weight 1/k each: its
    dense row-stochastic W (N,N), its lists (N,K) int32 and its slot
    weights (N,K), the shapes the main path hands the Eq. 5 kernels."""
    nbrs = np.stack([rng.choice(np.delete(np.arange(n), i), size=k,
                                replace=False) for i in range(n)])
    w = np.zeros((n, n), np.float32)
    np.put_along_axis(w, nbrs, 1.0 / k, axis=1)
    return (torch.from_numpy(w).to(dev),
            torch.from_numpy(nbrs.astype(np.int32)).to(dev),
            torch.full((n, k), 1.0 / k, dtype=torch.float32, device=dev))


def kernel_inputs(shape, dtype, dev, seed):
    from repro_torch.kernels.ops import CHUNK_ROWS
    n, r, c = shape
    rng = np.random.default_rng(seed)
    logp = torch.from_numpy(
        log_softmax_np(rng.normal(size=shape) * 2.0)).to(dev)
    labels = rng.integers(0, c, r).astype(np.int32)
    if shape == RAGGED:
        labels[::4] = -1                       # padded reference rows
    w, nbrs, slot_w = sparse_weights(n, min(8, n - 1), rng, dev)
    return {
        "logp": logp.to(dtype),
        "strip": logp[:min(n, CHUNK_ROWS)].to(dtype).contiguous(),
        "labels": torch.from_numpy(labels).to(dev),
        "w": w, "nbrs": nbrs, "slot_w": slot_w,
        "probs": torch.exp(logp).to(dtype),
    }


def split_case(a) -> tuple:
    """The Eq. 2 split pass on the strip (A side) and the repository (B
    side) against its plain version: (max abs error of hi + lo and of the
    row term, whether both are within tolerance)."""
    from repro_torch.kernels import pairwise_kl as pk
    from repro_torch.kernels import ref
    atol, rtol = TOL["pairwise_kl_split"]
    err, ok = 0.0, True
    for x, a_side in ((a["strip"], True), (a["logp"], False)):
        got = pk.split(x, a_side)
        planes, rowterm = ref.pairwise_kl_split_ref(x, a_side,
                                                    got.planes.shape[2])
        ok &= bool(((got.planes.view(torch.int32) & 0x1FFF) == 0).all())
        pairs = [(got.planes.sum(0), planes.sum(0))]
        if a_side:
            pairs.append((got.rowterm, rowterm))
        for g, w in pairs:
            err = max(err, float((g - w).abs().max()))
            ok &= torch.allclose(g, w, atol=atol, rtol=rtol)
    return err, ok


def fp64_errors(a) -> tuple:
    """Max abs error against an fp64 evaluation of the same inputs, of the
    3xTF32 strip and of the fp32 plain version."""
    from repro_torch.kernels import ops, ref
    la, lb = a["strip"], a["logp"]
    r = la.shape[1]
    a64 = la.reshape(la.shape[0], -1).double()
    b64 = lb.reshape(lb.shape[0], -1).double()
    pa = a64.exp()
    truth = ((pa * a64).sum(1)[:, None] - pa @ b64.T) / r
    got = ops.pairwise_kl_pair(la, lb).double()
    plain = ref.pairwise_kl_pair_ref(la, lb).double()
    return (float((got - truth).abs().max()),
            float((plain - truth).abs().max()))


def kernel_phase(dev) -> dict:
    from repro_torch.kernels import neighbor_gather as ng
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
        "neighbor_gather": (
            lambda a: ng.neighbor_gather(a["nbrs"], a["slot_w"], a["probs"]),
            lambda a: ref.neighbor_gather_ref(a["nbrs"], a["slot_w"],
                                              a["probs"])),
        "neighbor_mean": (lambda a: nm.neighbor_mean(a["w"], a["probs"]),
                          lambda a: ref.neighbor_mean_ref(a["w"],
                                                          a["probs"])),
    }
    err = {}
    for shape in (SERVER, FEDERATION, RAGGED):
        for dtype in (torch.float32, torch.bfloat16):
            a = kernel_inputs(shape, dtype, dev, seed=sum(shape))
            dt = str(dtype)[6:]
            for name, (kern, plain) in cases.items():
                got, want = kern(a), plain(a)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == torch.float32,
                      f"{name} {shape}: shape/dtype {tuple(got.shape)} "
                      f"{got.dtype}")
                ea, er = errors(got, want)
                atol, rtol = TOL[name]
                ok = torch.allclose(got, want, atol=atol, rtol=rtol)
                print(f"  {name:17s} {str(shape):16s} {dt:9s} "
                      f"max_abs={ea:.3e} max_rel={er:.3e} atol={atol:g} "
                      f"rtol={rtol:g} {'ok' if ok else 'FAIL'}")
                check(ok, f"{name} {shape} {dtype} disagrees with its "
                          f"plain version")
                if shape == SERVER and dtype == torch.float32:
                    err[name] = ea
            es, ok = split_case(a)
            print(f"  {'pairwise_kl_split':17s} {str(shape):16s} {dt:9s} "
                  f"max_abs={es:.3e} (hi + lo, row term; TF32 planes) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"pairwise_kl_split {shape} {dtype} disagrees with "
                      f"its plain version")
            # the gather and the dense kernel on the same graph
            g = ng.neighbor_gather(a["nbrs"], a["slot_w"], a["probs"])
            d = nm.neighbor_mean(a["w"], a["probs"])
            atol, rtol = TOL["neighbor_mean"]
            ok = torch.allclose(g, d, atol=atol, rtol=rtol)
            print(f"  neighbor_gather vs the dense kernel on one graph: "
                  f"max_abs={errors(g, d)[0]:.3e} {'ok' if ok else 'FAIL'}")
            check(ok, f"neighbor_gather and neighbor_mean disagree on one "
                      f"graph at {shape} {dtype}")
            if shape == SERVER and dtype == torch.float32:
                err["pairwise_kl_split"] = es

    # times at the server-round shape, fp32 (the main path's dtype)
    a = kernel_inputs(SERVER, torch.float32, dev, seed=sum(SERVER))
    e_kern, e_plain = fp64_errors(a)
    print(f"  pairwise_kl_pair {SERVER} against fp64: 3xTF32 kernel "
          f"max_abs={e_kern:.3e}, fp32 plain version max_abs={e_plain:.3e} "
          f"(ratio {e_kern / e_plain:.3f}, limit {FP64_ERR_RATIO:g})")
    check(e_kern <= FP64_ERR_RATIO * e_plain,
          "the 3xTF32 strip is less accurate than the fp32 plain version "
          "allows")
    n, r, c = SERVER
    u, k = a["strip"].shape[0], r * c
    split_a, split_b = pk.split(a["strip"], True), pk.split(a["logp"], False)
    k_pad = split_a.planes.shape[2]
    pa = torch.exp(a["strip"].reshape(u, k))
    lb_t = a["logp"].reshape(n, k).T
    z = a["logp"]
    y_idx = a["labels"].long()[None, :, None].expand(n, -1, 1)
    s_flat = a["probs"].reshape(n, k)
    nnz = int((a["w"] != 0).sum())
    slots = a["nbrs"].numel()
    used = int(torch.unique(a["nbrs"][a["slot_w"] != 0]).numel())
    w_csr = a["w"].to_sparse_csr()
    kern_fn = {
        "pairwise_kl_split": lambda: (pk.split(a["strip"], True),
                                      pk.split(a["logp"], False)),
        "pairwise_kl_pair": lambda: pk.gemm(split_a, split_b),
    }
    plain_fn = {
        "pairwise_kl_split": lambda: (
            ref.pairwise_kl_split_ref(a["strip"], True, k_pad),
            ref.pairwise_kl_split_ref(a["logp"], False, k_pad)),
    }
    library = {
        "pairwise_kl_split": None,
        "pairwise_kl_pair": lambda: torch.matmul(pa, lb_t),
        "soft_ce": lambda: (torch.logsumexp(z, dim=-1),
                            torch.gather(z, 2, y_idx)),
        "neighbor_gather": lambda: torch.sparse.mm(w_csr, s_flat),
        "neighbor_mean": lambda: torch.matmul(a["w"], s_flat),
    }
    work = {   # (flops, bytes, peak flop/s) the function needs on these inputs
        # read l once, write the hi and lo planes and the row term
        "pairwise_kl_split": (2.0 * u * k, 4.0 * (u + n) * k
                              + 8.0 * (u + n) * k_pad + 4.0 * u,
                              PEAK_FP32_FLOPS),
        # three TF32 products keep fp32-level accuracy (3xTF32)
        "pairwise_kl_pair": (3 * 2.0 * u * n * k,
                             4.0 * (u * k + n * k + u * n), PEAK_TF32_FLOPS),
        "soft_ce": (4.0 * n * r * c, 4.0 * (n * r * c + r + n),
                    PEAK_FP32_FLOPS),
        # the rows of S some list references, the lists, T
        "neighbor_gather": (2.0 * nnz * k,
                            4.0 * used * k + 8.0 * slots + 4.0 * n * k,
                            PEAK_FP32_FLOPS),
        # W has k nonzeros per row: the product needs 2 nnz RC flops;
        # the dense interface still reads all of W
        "neighbor_mean": (2.0 * nnz * k, 4.0 * (n * n + 2 * n * k),
                          PEAK_FP32_FLOPS),
    }
    iters = {"pairwise_kl_split": 50, "pairwise_kl_pair": 10, "soft_ce": 200,
             "neighbor_gather": 100, "neighbor_mean": 10}
    rows = {}
    for name in work:
        kern = kern_fn.get(name) or (lambda: cases[name][0](a))
        plain = plain_fn.get(name) or (lambda: cases[name][1](a))
        t_kern = cuda_ms(kern, iters[name])
        t_plain = cuda_ms(plain, iters[name])
        t_lib = cuda_ms(library[name], iters[name]) if library[name] \
            else None
        flops, nbytes, peak = work[name]
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        rows[name] = {"ms": t_kern, "plain_ms": t_plain, "library_ms": t_lib,
                      "bound_ms": bound,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes",
                      "flops": flops, "bytes": nbytes, "peak_flops": peak,
                      "max_abs_err": err[name]}
        lib = f"{t_lib:.4f} ms" if t_lib is not None else "none"
        print(f"  time [{CARD}] {name:17s} kernel={t_kern:.4f} ms "
              f"plain={t_plain:.4f} ms library={lib} "
              f"bound={bound:.4f} ms ({rows[name]['bound_by']}; "
              f"{flops:.4g} flop at {peak:.3g}/s, {nbytes:.4g} B) "
              f"share={bound / t_kern:.3%}")
    # the Eq. 2 strip as the server calls it: split pass and GEMM
    t_wrap = cuda_ms(lambda: cases["pairwise_kl_pair"][0](a), 10)
    rows["pairwise_kl_pair"].update(
        {"wrapper_ms": t_wrap, "fp64_max_abs_err": e_kern,
         "plain_fp64_max_abs_err": e_plain})
    print(f"  time [{CARD}] pairwise_kl_pair {u} x {n} strip, split "
          f"included: {t_wrap:.4f} ms (GEMM alone "
          f"{rows['pairwise_kl_pair']['ms']:.4f} ms, torch.matmul cross "
          f"term {rows['pairwise_kl_pair']['library_ms']:.4f} ms)")
    # the federation's own shape: launch-overhead territory
    af = kernel_inputs(FEDERATION, torch.float32, dev, seed=sum(FEDERATION))
    for name, (kern, plain) in cases.items():
        rows[name]["federation_ms"] = cuda_ms(lambda: kern(af), 100)
        rows[name]["federation_plain_ms"] = cuda_ms(lambda: plain(af), 100)
        print(f"  time [{CARD}] {name:17s} at {FEDERATION}: "
              f"kernel={rows[name]['federation_ms']:.4f} ms "
              f"plain={rows[name]['federation_plain_ms']:.4f} ms")
    # what a sparse product of the same W costs (the dense entry's yardstick
    # on a sparse graph)
    rows["neighbor_mean"]["sparse_library_ms"] = \
        rows["neighbor_gather"]["library_ms"]
    # the square matrix of a server round: one split of each side, then
    # two CHUNK_ROWS strips over the same planes
    from repro_torch.kernels import ops
    t_square = cuda_ms(lambda: ops.pairwise_kl(a["logp"]), 5)
    print(f"  time [{CARD}] pairwise_kl square N={n} (two splits, two "
          f"strips) kernel={t_square:.4f} ms, 3xTF32 bound "
          f"{3 * 2.0 * n * n * k / PEAK_TF32_FLOPS * 1e3:.4f} ms")
    rows["pairwise_kl_pair"]["square_ms"] = t_square
    print(f"  card during timing: clocks.sm,power.draw,temperature.gpu = "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    return rows


def same_neighbors(graph, want, what: str) -> torch.Tensor:
    """(N,) rows whose neighbor set equals ``want``'s; fails unless every
    other row's picks are a near-tie under ``want``'s similarity."""
    check(bool((graph.candidates == want.candidates).all()),
          f"the quality pools differ from {what}")
    sim = want.similarity
    nb, pnb = graph.neighbors.long(), want.neighbors.long()
    same = (torch.sort(nb, 1).values == torch.sort(pnb, 1).values).all(1)
    ks = torch.sort(torch.gather(sim, 1, nb), 1).values
    ps = torch.sort(torch.gather(sim, 1, pnb), 1).values
    near = torch.isclose(ks, ps, rtol=1e-5, atol=0).all(1)
    print(f"  neighbor sets differing from {what}: {int((~same).sum())} "
          f"rows (all within 1e-5 relative similarity: "
          f"{bool(near[~same].all())})")
    check(bool((same | near).all()), "neighbor choice differs beyond a "
                                     "1e-5 relative near-tie")
    return same


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
        return ref.neighbor_gather_ref(g.neighbors, g.slot_weights,
                                       torch.exp(lp)), g

    policy_round(state, pol, labels)                     # warm-up
    plain_round()
    ops.reset_launch_counts()
    (_, targets, graph), _ = timed(lambda: policy_round(state, pol, labels))
    counts = ops.launch_counts()
    check(counts == {"pairwise_kl_split": 2, "pairwise_kl_pair": 2,
                     "soft_ce": 1, "neighbor_gather": 1, "neighbor_mean": 0,
                     "int8_pairwise_kl_pair": 0},
          f"server round launched {counts}")
    t_kern, t_plain = [], []
    for _ in range(3):                       # in turns: kernels, plain
        t_kern.append(timed(lambda: policy_round(state, pol, labels))[1])
        (ptargets, pgraph), t = timed(plain_round)
        t_plain.append(t)
    print(f"  [{CARD}] policy_round N={n} on the kernels: "
          f"{', '.join(f'{t:.2f}' for t in t_kern)} ms; launches {counts}")
    print(f"  [{CARD}] policy_round N={n} on the plain versions: "
          f"{', '.join(f'{t:.2f}' for t in t_plain)} ms")

    same = same_neighbors(graph, pgraph, "the plain round")
    n_diff = int((~same).sum())
    d = (targets - ptargets).abs()[same]
    t_err = float(d.max()) if d.numel() else 0.0
    print(f"  targets max abs err on rows with equal neighbors: {t_err:.3e}")
    check(t_err <= 1e-6, "targets disagree with the plain round")
    check(bool(torch.isfinite(targets).all()), "non-finite targets")
    trace = device_breakdown(f"policy_round N={n}",
                             lambda: policy_round(state, pol, labels))
    return {"kernel_ms": t_kern, "plain_ms": t_plain,
            "launches": counts, "neighbor_rows_differing": n_diff,
            "targets_max_abs_err": t_err, "profile": trace}


def federation(dev, splits, ds, init_params, draws, logits_out, server):
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
                                                 eval_every=2, **server),
        seed=1, callbacks=[record], device=dev, init_params=init_params,
        batch_indices=lambda step, ci: draws(step, ci))


def federation_inputs():
    """sc_like, its splits, and numpy-made weights and batch draws, shared
    by every federation run on the card and on the CPU."""
    from repro_torch.data import make_splits, sc_like
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

    return ds, splits, init_params, draws


def federation_phase(dev, server: dict, path: tuple, inputs) -> dict:
    """The 5-round sc_like federation with ``server`` (FederationConfig's
    delta/selection/codec settings) on the card, then on the CPU with the
    same weights and draws. Fails unless every kernel in ``path``
    launched during the card's fit."""
    from repro_torch.kernels import ops
    ds, splits, init_params, draws = inputs
    card_logits, cpu_logits = [], []
    eng = federation(dev, splits, ds, init_params, draws, card_logits,
                     server)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = eng.fit(splits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for rnd, acc in zip(hist.rounds, hist.mean_acc):
        print(f"  round {rnd}: mean test accuracy {acc:.4f}")
    print(f"  [{CARD}] fit: {wall:.3f} s for 5 rounds, launches {counts}")
    check(all(counts[k] > 0 for k in path),
          f"a kernel of this path never launched: {counts}")
    check(counts["neighbor_mean"] == 0,
          "the dense Eq. 5 kernel ran where the graph carries its lists")

    fed = eng.fed
    tensors = [fed.ref_x, fed.ref_y, fed.targets, *fed.server]
    for coh in fed.cohorts:
        tensors += [*coh.model.parameters(), coh.opt_state.step,
                    *coh.opt_state.momentum, *coh.data.values()]
    index = getattr(eng.policy, "_ivf", None)
    check((index is not None) == (server.get("selection") == "ivf"),
          "the IVF index is missing or unexpected")
    if index is not None:
        tensors += list(index.state_tensors().values())
        print(f"  IVF index: {index.n_centroids} centroids, probes "
              f"{index._effective_probe()}, "
              f"{int(index.active_rows().sum())} active rows")
    check(all(t.is_cuda for t in tensors), "a state tensor is off the card")
    print(f"  all {len(tensors)} state tensors on {fed.device}")

    cpu = federation("cpu", splits, ds, init_params, draws, cpu_logits,
                     server)
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
    check(cpu_hist.bytes_up == hist.bytes_up
          and cpu_hist.bytes_down == hist.bytes_down,
          "card and CPU runs metered different wire bytes")
    return {"launches": counts, "fit_s": wall, "mean_acc": hist.mean_acc,
            "cpu_mean_acc": cpu_hist.mean_acc, "logit_max_abs_diff": worst,
            "bytes_up": hist.bytes_up[-1], "bytes_down": hist.bytes_down[-1]}


def warm_fits(dev, inputs) -> dict:
    """Fit wall times of the dense and the IVF federations, both warm, in
    turns: dense, IVF, IVF, dense."""
    ds, splits, init_params, draws = inputs
    out = {"dense": [], "ivf": []}
    for kind in ("dense", "ivf", "ivf", "dense"):
        eng = federation(dev, splits, ds, init_params, draws, [],
                         IVF_SERVER if kind == "ivf" else {})
        out[kind].append(timed(lambda: eng.fit(splits))[1] / 1e3)
    print(f"  [{CARD}] warm 5-round fits: dense "
          f"{', '.join(f'{t:.3f}' for t in out['dense'])} s; IVF/int8 "
          f"{', '.join(f'{t:.3f}' for t in out['ivf'])} s")
    eng = federation(dev, splits, ds, init_params, draws, [], {})
    out["dense_profile"] = device_breakdown("warm dense 5-round fit",
                                            lambda: eng.fit(splits))
    return out


def int8_wire(shape, dev, seed):
    """(q, scale, zp) of numpy-seeded log-softmax messengers, int8-encoded
    on the card by the port's codec."""
    from repro_torch.core import wire
    rng = np.random.default_rng(seed)
    lp = torch.from_numpy(log_softmax_np(rng.normal(size=shape) * 2.0))
    p = wire.encode("int8", lp.to(dev))
    return p.arrays["q"], p.arrays["scale"], p.arrays["zp"]


def int8_case(label: str, a, b, iters: int) -> dict:
    """The int8 kernel on wire operands ``a`` (U rows) and ``b`` (M rows)
    against its plain version; with ``iters``, times of the wrapper (row
    statistics included), the kernel alone, the plain version and a
    library product (``torch.matmul`` of the pre-dequantized fp32
    operands, cross term only) beside the bound."""
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import ops, ref
    got = ops.int8_pairwise_kl_pair(*a, *b)
    want = ref.int8_pairwise_kl_pair_ref(*a, *b)
    torch.cuda.synchronize()
    (qa, sa, _), (qb, sb, _) = a, b
    u, r, c = qa.shape
    m = qb.shape[0]
    check(got.shape == (u, m) and got.dtype == torch.float32,
          f"int8 {label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    ea, er = errors(got, want)
    atol, rtol = TOL["int8_pairwise_kl_pair"]
    ok = torch.allclose(got, want, atol=atol, rtol=rtol)
    print(f"  int8_pairwise_kl_pair {label:22s} ({u} x {m}, R={r}, C={c}) "
          f"max_abs={ea:.3e} max_rel={er:.3e} atol={atol:g} rtol={rtol:g} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"int8_pairwise_kl_pair {label} disagrees with its plain "
              f"version")
    row = {"shape": [u, m, r, c], "max_abs_err": ea, "max_rel_err": er}
    if not iters:
        return row
    sa32, sb32 = sa.float(), sb.float()
    la, lb = dk.int8_row_stats(qa, sa32), dk.int8_row_stats(qb, sb32)
    k = r * c
    pa = torch.exp(qa.float().reshape(u, r, c) * sa32[..., None]
                   - la[..., None]).reshape(u, k)
    lb_t = (qb.float() * sb32[..., None] - lb[..., None]).reshape(m, k).T
    t_call = cuda_ms(lambda: ops.int8_pairwise_kl_pair(*a, *b), iters)
    t_kern = cuda_ms(lambda: dk.launch(qa, sa32, la, qb, sb32, lb), iters)
    t_plain = cuda_ms(lambda: ref.int8_pairwise_kl_pair_ref(*a, *b), iters)
    t_lib = cuda_ms(lambda: torch.matmul(pa, lb_t), iters)
    flops = 2.0 * u * m * k
    nbytes = 1.0 * (u + m) * k + 8.0 * (u + m) * r + 4.0 * u * m
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    row.update({"ms": t_call, "kernel_ms": t_kern, "plain_ms": t_plain,
                "library_ms": t_lib, "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes})
    print(f"  time [{CARD}] int8 {label:22s} wrapper={t_call:.4f} ms "
          f"kernel={t_kern:.4f} ms plain={t_plain:.4f} ms "
          f"library={t_lib:.4f} ms bound={bound:.4f} ms "
          f"({row['bound_by']}; {flops:.4g} flop, {nbytes:.4g} B) "
          f"share={bound / t_kern:.3%}")
    return row


def int8_kernel_phase(dev) -> dict:
    n, r, c = SERVER
    rows = {
        "server_strip": int8_case(
            "server-round strip", int8_wire((2048, r, c), dev, 21),
            int8_wire((n, r, c), dev, 22), iters=10),
        "oracle_strip": int8_case(
            "ANN oracle strip", int8_wire((N_QUERY, ANN_R, ANN_C), dev, 23),
            int8_wire((ORACLE_CHUNK, ANN_R, ANN_C), dev, 24), iters=20),
        "ragged": int8_case("ragged", int8_wire((19, 13, 5), dev, 25),
                            int8_wire(RAGGED, dev, 26), iters=0),
    }
    w = int8_wire(RAGGED, dev, 27)
    from repro_torch.kernels import ops, ref
    got, want = ops.int8_pairwise_kl(*w), ref.int8_pairwise_kl_ref(*w)
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
          "int8_pairwise_kl square (ragged) disagrees with its plain version")
    print(f"  int8_pairwise_kl square {RAGGED}: max_abs="
          f"{errors(got, want)[0]:.3e} ok")
    return rows


def delta_phase(dev) -> dict:
    """One delta round at the server-round size: 64 rows re-uploaded
    after a full-rebuild round; the scattered cache against a rebuild."""
    from repro_torch.core import (init_server, policy_round, sqmd,
                                  upload_messengers)
    from repro_torch.core.policies import as_policy
    from repro_torch.kernels import ops
    n, r, c = SERVER
    rng = np.random.default_rng(0)
    repo = torch.from_numpy(
        log_softmax_np(rng.normal(size=SERVER).astype(np.float32) * 2.0))
    labels = torch.from_numpy(rng.integers(0, c, r).astype(np.int32)).to(dev)
    pol = as_policy(sqmd(q=64, k=8))
    state, _, _ = policy_round(
        upload_messengers(init_server(n, r, c, device=dev), repo.to(dev),
                          torch.ones(n, dtype=torch.bool)), pol, labels)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, DELTA_ROWS, replace=False)] = True
    fresh = np.zeros(SERVER, np.float32)
    fresh[mask] = log_softmax_np(rng.normal(size=(DELTA_ROWS, r, c)) * 2.0)
    state = upload_messengers(state, torch.from_numpy(fresh).to(dev),
                              torch.from_numpy(mask))
    policy_round(state, pol, labels, uploaded=mask)      # warm-up
    ops.reset_launch_counts()
    (new, targets, graph), _ = timed(
        lambda: policy_round(state, pol, labels, uploaded=mask))
    counts = ops.launch_counts()
    check(counts == {"pairwise_kl_split": 4, "pairwise_kl_pair": 2,
                     "soft_ce": 1, "neighbor_gather": 1, "neighbor_mean": 0,
                     "int8_pairwise_kl_pair": 0},
          f"delta round launched {counts}")
    rebuilt = ops.pairwise_kl(state.repo_logp)
    err = float((new.div_cache - rebuilt).abs().max())
    print(f"  delta cache vs full rebuild: max abs err {err:.3e}; "
          f"launches {counts}")
    check(err <= 1e-5, "the delta cache disagrees with a full rebuild")
    _, full_targets, full_graph = policy_round(state, pol, labels)
    same = same_neighbors(graph, full_graph, "the full round")
    d = (targets - full_targets).abs()[same]
    t_err = float(d.max()) if d.numel() else 0.0
    check(t_err <= 1e-6, "delta and full rounds emit different targets")
    t_delta, t_full = [], []
    for _ in range(3):                        # in turns: delta, full
        t_delta.append(timed(lambda: policy_round(state, pol, labels,
                                                  uploaded=mask))[1])
        t_full.append(timed(lambda: policy_round(state, pol, labels))[1])
    print(f"  [{CARD}] policy_round N={n}, {DELTA_ROWS} fresh rows: delta "
          f"{', '.join(f'{t:.2f}' for t in t_delta)} ms; full rebuild "
          f"{', '.join(f'{t:.2f}' for t in t_full)} ms")
    trace = device_breakdown(
        f"delta policy_round N={n}",
        lambda: policy_round(state, pol, labels, uploaded=mask))
    return {"launches": counts, "cache_max_abs_err": err,
            "targets_max_abs_err": t_err, "delta_ms": t_delta,
            "full_ms": t_full, "profile": trace}


def gen_logp(rng, protos, count: int) -> np.ndarray:
    """benchmarks/ann_scale.py's clustered messengers (prototype logits
    plus per-client noise), log_softmax in numpy."""
    assign = rng.integers(0, protos.shape[0], size=count)
    logits = protos[assign] + rng.normal(scale=0.7,
                                         size=(count, ANN_R, ANN_C))
    return log_softmax_np(logits.astype(np.float32))


def oracle_topk_div(idx, queries: torch.Tensor, n: int, k: int):
    """(q, k) exact k smallest divergences per query over every active
    row (self excluded), off the index's own wire form, in chunked
    column strips through the int8 kernel."""
    best = torch.full((queries.numel(), k), float("inf"),
                      device=queries.device)
    for lo in range(0, n, ORACLE_CHUNK):
        cols = torch.arange(lo, min(lo + ORACLE_CHUNK, n),
                            device=queries.device)
        strip = idx._strip(queries, cols).masked_fill(
            cols[None, :] == queries[:, None], float("inf"))
        best = torch.sort(torch.cat([best, strip], 1), dim=1).values[:, :k]
    return best


def index_state_on_card(idx) -> None:
    check(all(t.is_cuda for t in idx.state_tensors().values()),
          "an index tensor is off the card")


def ivf_scale(dev, n: int) -> dict:
    from repro_torch.core import NeighborIndex
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    protos = rng.normal(scale=2.0, size=(N_PROTO, ANN_R, ANN_C))
    t0 = time.perf_counter()
    chunks = [gen_logp(rng, protos, min(GEN_CHUNK, n - lo))
              for lo in range(0, n, GEN_CHUNK)]
    gen_s = time.perf_counter() - t0
    idx = NeighborIndex(n, ANN_R, ANN_C, k=ANN_K, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, lp in zip(range(0, n, GEN_CHUNK), chunks):
        idx.ingest_only(np.arange(lo, lo + lp.shape[0]),
                        torch.from_numpy(lp).to(dev))
    idx.refresh()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del chunks

    queries = np.sort(rng.choice(n, size=N_QUERY, replace=False))
    idx.update(queries, torch.from_numpy(
        gen_logp(rng, protos, N_QUERY)).to(dev))
    q_t = torch.as_tensor(queries, device=dev)
    _, ndiv = idx.select(torch.ones(n, dtype=torch.bool, device=dev), ANN_K)
    oracle = oracle_topk_div(idx, q_t, n, ANN_K)
    hits = []
    for qi, row in enumerate(q_t):
        got = ndiv[row][torch.isfinite(ndiv[row])]
        kth = oracle[qi][min(ANN_K, int(torch.isfinite(oracle[qi]).sum()))
                         - 1]
        hits.append(float((got <= kth + TIE_TOL).sum()) / ANN_K)
    overlap = float(np.mean(hits))

    one = rng.integers(0, n, size=1)
    lp_one = torch.from_numpy(gen_logp(rng, protos, 1)).to(dev)
    idx.update(one, lp_one)                              # warm-up
    ops.reset_launch_counts()
    _, t_first = timed(lambda: idx.update(one, lp_one))
    per_upload = ops.launch_counts()
    upload_ms = min([t_first] + [timed(lambda: idx.update(one, lp_one))[1]
                                 for _ in range(2)])
    index_state_on_card(idx)
    row = {"n_clients": n, "ref_size": ANN_R, "n_classes": ANN_C,
           "k": ANN_K, "n_centroids": idx.n_centroids,
           "n_probe": idx._effective_probe(), "overlap": overlap,
           "resident_mb": idx.bytes_resident() / 2 ** 20,
           "dense_mb": 4.0 * n * n / 2 ** 20, "gen_s": gen_s,
           "build_s": build_s, "upload_ms": upload_ms,
           "launches_per_upload": per_upload}
    print(f"  [{CARD}] IVF N={n:,}: overlap={overlap:.4f} "
          f"resident={row['resident_mb']:.2f} MB (dense "
          f"{row['dense_mb']:.0f} MB) upload={upload_ms:.3f} ms "
          f"build={build_s:.3f} s (+{gen_s:.2f} s numpy generation) "
          f"centroids={idx.n_centroids} probes={idx._effective_probe()} "
          f"launches/upload={per_upload}")
    check(overlap >= OVERLAP_GATE,
          f"IVF overlap {overlap:.4f} at N={n} is below {OVERLAP_GATE}")
    if n == max(ANN_SIZES):
        # a real upload's strips through the int8 kernel: forward (1 x m)
        # against its candidates, reverse (m x 1) back
        one_t = torch.as_tensor(one, device=dev)
        cand, _ = idx._search(one_t)
        targets = cand[cand != one_t[0]]

        def wire_of(rows):
            s = idx._scale[rows]
            return idx._codes[rows], s, torch.zeros_like(s)
        row["m"] = int(targets.numel())
        row["upload_fwd"] = int8_case("upload forward strip", wire_of(one_t),
                                      wire_of(targets), iters=50)
        row["upload_rev"] = int8_case("upload reverse strip",
                                      wire_of(targets), wire_of(one_t),
                                      iters=50)
    return row


def ivf_probe_all(dev, n: int = SERVER[0]) -> dict:
    """Probe-all at N=4096: every list against the dense oracle's top-L,
    computed by the plain version on the card off the same wire form,
    after a bulk upload and a re-upload wave."""
    from repro_torch.core import NeighborIndex
    from repro_torch.kernels import ref
    rng = np.random.default_rng(1)
    protos = rng.normal(scale=2.0, size=(N_PROTO, ANN_R, ANN_C))
    idx = NeighborIndex(n, ANN_R, ANN_C, k=ANN_K, n_probe=10 ** 6,
                        device=dev)
    idx.update(np.arange(n), torch.from_numpy(gen_logp(rng, protos, n)))
    wave = rng.choice(n, size=DELTA_ROWS, replace=False)
    degraded = idx.update(wave, torch.from_numpy(
        gen_logp(rng, protos, DELTA_ROWS)))
    index_state_on_card(idx)
    codes, scale = idx._codes, idx._scale
    zp = torch.zeros_like(scale)
    div = ref.int8_pairwise_kl_pair_ref(codes, scale, zp, codes, scale, zp)
    div.fill_diagonal_(float("inf"))
    order = torch.sort(div, dim=1, stable=True)
    L = idx.list_len
    want_ids, want_div = order.indices[:, :L], order.values[:, :L]
    got_ids, got_div = idx._list_ids.long(), idx._list_div
    check(bool((got_ids >= 0).all()), "a probe-all list is short")
    div_err = float((got_div - want_div).abs().max())
    differ = got_ids != want_ids
    # a differing pick must be a near-tie under the oracle's divergences
    picked = torch.gather(div, 1, got_ids)
    tie_err = float((picked - want_div).abs()[differ].max()) \
        if bool(differ.any()) else 0.0
    n_rows = int(differ.any(1).sum())
    print(f"  IVF N={n} probe-all: lists vs dense oracle top-{L}: "
          f"divergence max abs err {div_err:.3e}; {n_rows} rows pick other "
          f"ids, all near-ties (max {tie_err:.3e}); {degraded} degraded "
          f"rows rebuilt by the re-upload wave")
    check(div_err <= 1e-5, "probe-all list divergences disagree with the "
                           "dense oracle")
    check(tie_err <= 1e-5, "a probe-all pick differs beyond a near-tie")
    return {"n_clients": n, "div_max_abs_err": div_err,
            "rows_with_other_ids": n_rows, "tie_max_abs_err": tie_err,
            "degraded_rebuilt": degraded}


def ivf_phase(dev) -> dict:
    out = {"probe_all": ivf_probe_all(dev)}
    for n in ANN_SIZES:
        out[str(n)] = ivf_scale(dev, n)
        torch.cuda.empty_cache()
    return out


SOURCES = {
    "pairwise_kl_split": ("src/repro_torch/kernels/csrc/pairwise_kl.cu",
                          "src/repro/kernels/pairwise_kl.py:37"),
    "pairwise_kl_pair": ("src/repro_torch/kernels/csrc/pairwise_kl.cu",
                         "src/repro/kernels/pairwise_kl.py:37"),
    "soft_ce": ("src/repro_torch/kernels/csrc/soft_ce.cu",
                "src/repro/kernels/soft_ce.py:25"),
    "neighbor_gather": ("src/repro_torch/kernels/csrc/neighbor_gather.cu",
                        "src/repro/kernels/neighbor_mean.py:25"),
    "neighbor_mean": ("src/repro_torch/kernels/csrc/neighbor_mean.cu",
                      "src/repro/kernels/neighbor_mean.py:25"),
    "int8_pairwise_kl_pair": ("src/repro_torch/kernels/csrc/dequant_kl.cu",
                              "src/repro/kernels/dequant_kl.py:39"),
}
# the kernels each federation must launch (the dense Eq. 5 entry is on
# neither: both SQMD graphs carry their neighbor lists)
DENSE_PATH = ("pairwise_kl_split", "pairwise_kl_pair", "soft_ce",
              "neighbor_gather")
IVF_PATH = ("pairwise_kl_split", "pairwise_kl_pair",
            "int8_pairwise_kl_pair", "neighbor_gather")
IVF_SERVER = dict(delta_graph=True, selection="ivf", uplink="int8")


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
    global CARD
    card = CARD = smi("name,power.limit")
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
    inputs = federation_inputs()
    fedres = federation_phase(dev, {}, DENSE_PATH, inputs)

    print("[6] int8 kernel against its plain version")
    int8_rows = int8_kernel_phase(dev)
    # the summary's ms is the kernel's own, like the bound; the wrapper's
    # time (row statistics included) stays in the JSON as "wrapper_ms"
    b4 = dict(int8_rows["server_strip"])
    b4["wrapper_ms"], b4["ms"] = b4["ms"], b4["kernel_ms"]
    rows["int8_pairwise_kl_pair"] = b4

    print(f"[7] delta server round at N={SERVER[0]}")
    delta = delta_phase(dev)

    print("[8] IVF neighbor index")
    ivf = ivf_phase(dev)

    print("[9] IVF federation (delta rounds, IVF selection, int8 uplink)")
    ivf_fed = federation_phase(dev, IVF_SERVER, IVF_PATH, inputs)

    print("[10] warm fits of both federations, in turns")
    fits = warm_fits(dev, inputs)

    # each kernel's launches come from the federation whose path it is
    # on: B1-B3 the main path's (0 for the dense Eq. 5 entry, which is on
    # no SQMD path), the int8 kernel the IVF federation's
    launches = dict(fedres["launches"])
    launches["int8_pairwise_kl_pair"] = \
        ivf_fed["launches"]["int8_pairwise_kl_pair"]
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": launches[name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name in SOURCES]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": rows, "int8_kernel": int8_rows,
         "server_round": server, "federation": fedres,
         "delta_round": delta, "ivf_index": ivf, "ivf_federation": ivf_fed,
         "warm_fits_s": fits,
         "wall_s": time.perf_counter() - t_start},
        indent=2, default=float))
    print(f"  total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
