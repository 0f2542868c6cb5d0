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
   gather over neighbor lists (also held against the dense Eq. 5 route
   on the same graph) and the dense Eq. 5 route; on a dense W (a
   complete graph, FedMD's shape) the route, its two splits (W's on B1's
   split pass, S's transposing split) and B1's GEMM in its plain-store
   mode each against its plain version, with the route's error against
   fp64 beside the plain version's; the Eq. 2 strip's error against
   fp64, beside the plain version's; then times (CUDA events, warm L2)
   of kernel, plain version and one library call as a yardstick, beside
   each kernel's bound (the dense route's: the 3xTF32 bound of W S);
4. server round: ``policy_round`` with sqmd(q=64, k=8) on a numpy-seeded
   N=4096 repository, held against the same round on the plain versions
   (neighbor sets and targets), with its launch counts;
5. federation (the main path): ``FederationEngine.fit`` on ``sc_like()``
   (32 clients, R=240, C=3), the three MLP tiers, sqmd(q=16, k=8),
   5 rounds, with launch counts read around it, every state tensor
   checked to be on the card, and the eval logits held against the same
   federation run on the CPU with the same numpy-made weights and draws;
6. the int8 kernel B4 (dequant_kl) on int8-encoded inputs, both routes:
   the entry point with the stored lse, the wide route (dequant split +
   B1's 3xTF32 GEMM) and the thin kernel, each against the plain version,
   at the server-round strip (2048 x 4096, R=240, C=10) and the ANN
   oracle strip (64 x 131072, R=8, C=10), both wide only (the thin
   kernel takes at most THIN_ROWS = 16 rows), and a ragged (13 x 37,
   R=13, C=5); the dequant split against its plain version; the wide
   route's error against fp64 beside the plain version's; the square
   matrix; a THIN_ROWS sweep (the wide route at 1-64 thin rows, the thin
   kernel at 1-16); times of entry point, routes, plain version and a
   library product beside each route's bound;
7. a delta server round at N=4096: ``policy_round(..., uploaded=mask)``
   with 64 fresh rows, the cache held against a full rebuild, launch
   counts showing the two strips;
8. the IVF neighbor index on the card at N=10^5 and 10^6 (R=8, C=10,
   k=10, default probes, the sizes of benchmarks/ann_scale.py): build
   time, one-row upload latency, resident device bytes and top-k overlap
   against an exact oracle of chunked int8 strips (fails below 0.9); a
   real upload's forward and reverse strips through B4 on the lse the
   index stores, against the plain version and timed, and one upload
   under torch.profiler (it fails if the upload computes the row
   statistics in torch); at N=4096 with probe-all, a bulk upload and a
   re-upload wave of 64 rows (both on the wide route), every list held
   against the dense oracle's top-L computed by the plain version;
9. the IVF federation: phase 5's federation with ``delta_graph=True,
   selection="ivf", uplink="int8"``, launch counts read around it (B1,
   Eq. 1, the gather and each of B4's three kernels must launch), the index's
   tensors checked to be on the card, eval logits held against the same
   run on the CPU;
10. warm fit times of both federations, in turns (phase 5's fit is the
    process's first); phases 4, 7, 10 and 11 also run one round or fit
    under torch.profiler for the device time by kernel and the device's
    busy share;
11. a FedMD server round: ``policy_round`` with fedmd() on phase 4's
    repository, held against the same round on the plain versions
    (targets within (1e-5, 1e-5)); it must launch Eq. 1 once and the
    dense Eq. 5 route once (two splits, one GEMM), nothing else;
12. phase 5's federation under each baseline, each held against its CPU
    run: fedmd() (the dense Eq. 5 route every round), ddist(k=8) on a
    numpy-made static graph passed as ``static_weights`` (the gather
    every round, no dense route) and isgd() (no server kernel, no wire
    byte);
14. the asynchronous federation (``AsyncFederationEngine.fit(until=9)``)
    on phase 5's ``sc_like`` inputs, batch 16, two local steps a wake, in
    fig. 4's regimes: facilities joining at 0/3/6 through the schedule
    shim, under sqmd(q=16, k=8) and then fedmd() (B3's dense route);
    ``StragglerLatency(0.3, 2.5)`` with ``Quorum(0.5)`` and delta rounds;
    ``BurstyArrivals()`` with every-k (k=8) on the IVF index and the int8
    uplink (one upload event a client, B4's thin kernel). Each with its
    launches, every state tensor (in-flight uploads included) on the
    card, and its History and eval logits held against its CPU run;
15. the asynchronous server at N=4096 (R=240, C=10, sqmd(q=64, k=8),
    delta rounds, dense32): a ``ServerBus`` driven through a ``Clock``
    by ``StragglerLatency(0.3, 2.5)`` with ``Quorum(0.5)`` to t=3, then
    by one burst of ``BurstyArrivals(frac=0.6, jitter=0.5)`` with every-k
    (k=64) to t=0.5 (~2443 deliveries of one row, 38 fires), with
    numpy-seeded messengers at each wake and no client training. Every
    fire is held against the same repository's round on the plain
    versions (delta cache, neighbor sets, targets), with its u, bucketed
    strip, launches and wall time; per regime the delivery times without
    their fires (median and max), one fire and one delivery that fires
    nothing under torch.profiler;
16. the mixed-architecture federation: ``sc_like()``, the registry's
    five families at their widths (``build_zoo("mlp-s,resnet,
    transformer,ssm,rglru", 64, 3)``, SGD with momentum or Adam per
    family) under the weighted assignment "mlp-s:0.3,resnet:0.3,
    transformer:0.2,ssm:0.1,rglru:0.1", sqmd(q=16, k=8), 5 rounds,
    batch 16, with numpy-made weights in the reference's layout; its
    launches (B1, B2 and the gather, nothing else), every state tensor
    on the card (each optimizer's moments and step counters too), its
    History and eval logits held against its CPU run (per family, within
    ZOO_LOGIT_RTOL of its largest logit); what that gap is made of, per
    family (the card's run repeated, the card's run from weights one fp32
    ulp off, the card's run with TF32 matmuls against the CPU); one
    forward of each fitted ResNet on the card held to FWD_RTOL of the
    same forward in fp64 (and in TF32, and on the CPU, reported); each codec
    (dense32, dense16, int8, topk) encodes the last upload's messengers
    and the targets byte for byte as the CPU does; per family a cohort
    step's and an upload's times (CUDA events back to back, and
    ``device_ms`` where the launches fit the launch queue) and one of
    each under torch.profiler; one warm fit under the profiler;
17. the paper's client models at full width: RESNET8, RESNET20 and
    RESNET50 (width 16, the 50 with bottlenecks) as a plain mapping of
    cohort builders, round-robin, on phase 16's inputs, 2 rounds (cut
    from 3 for time), held against its CPU run as phase 16 is, with the
    same logit-gap witness and per-family times;
18. train and serve: ``QueryRuntime`` on phase 14's straggler regime
    (quorum fires, delta rounds) to t=9, once under
    ``PoissonQueries(rate=0.5)`` with ``micro:8`` and once under
    ``DiurnalQueries(burst_frac=0.5)`` with ``MicroBatch(16, 0.25)``, each
    held against its CPU twin: every record's seq, client, arrival and
    serve times, snapshot version, staleness, batch size, buckets and
    queue depth equal, served logits within 1e-2 (predictions may flip
    only at near ties), B1, B2 and the gather launched on the fires; on
    the final snapshot each cohort's answers equal, bit for bit, the same
    forward on the snapshot's params at the same padded shape. Then
    ``QueryEngine.serve`` at buckets 1, 8, 32 and 128 for each MLP tier
    and for a RESNET50 cohort (width 16, full width): back-to-back ms,
    device time, kernels a call and busy share under torch.profiler; and
    each publish's copy (bytes, ms);
19. checkpoints: phase 5's federation saved after 2 rounds and restored
    into a card engine built from other weights, whose 3 more rounds
    must equal the uninterrupted card run bit for bit; phase 4's N=4096
    server state (with its targets) saved and restored onto the card
    (seconds, MB); that file without ``div_cache``, restored: B1 rebuilds
    the cache, held against the plain ``pairwise_kl`` at phase 3's
    tolerance;
20. the LM zoo's serving path (``repro_torch.launch.serve.serve``: prefill,
    then greedy decode against the cache) at batch 4, prompt 64, decode
    32, bf16 params drawn on the card from a seeded generator:
    qwen2-0.5b, gemma3-1b (also with a 600-token prompt: its 512-slot
    ring buffers wrap), mamba2-780m, stablelm-3b, musicgen-medium and
    recurrentgemma-9b at full width, deepseek-67b and internvl2-76b
    (over 80 GB) at their published widths with the depth cut to 4
    layers, the cut printed. Each serves in fp32 and in bf16 (the same
    params), each step's logits kept, no CUDA kernel of the port
    launched; the decode is held against the teacher-forced ``forward``
    in fp32 (within 1e-4 of the largest logit) and in bf16 (within a
    fixed limit per case; the control, the forward with one token
    swapped, must read above it; bf16's own drift, the bf16 forward
    against the fp32 forward, is printed); the bf16 run timed after a
    2-token warm-up: prefill s, decode ms/token back to back, one decode
    step under the profiler (device ms, kernels, busy share) beside its bytes
    bound (params + cache over 3.35 TB/s). qwen2-0.5b's fp32 twin: params
    drawn on the CPU, 8 greedy tokens on the card equal the CPU's, logits
    within 1e-4;
21. MoE and MLA serving, as phase 20 serves its cases: mixtral-8x7b
    (8 experts, top 2) cut to 4 of 32 layers and deepseek-v2-236b (MLA,
    160 routed experts, top 6, 2 shared) cut to 2 of 60, at their
    published widths, the cuts printed; the teacher-forced forward on
    the dropless MoE path (GShard drops choices at these shapes); the
    routing decisions where decode and the teacher disagree, per dtype;
    beside the all-params bound, the step's bytes bound over the experts
    it routes to (each once), the embedding's rows of its tokens, the
    rest of the params and the cache. The reduced configs' fp32 twins
    (mixtral-smoke, dsv2-smoke; params drawn on the CPU): 8 greedy
    tokens, every routing decision's experts (``torch.sort`` and
    ``argsort`` on the card against the CPU's), the logits within 1e-4,
    and the GShard forward's logits and aux loss, card against CPU; every
    dropless MoE layer forward on the card launched ``ragged_dot`` 3
    times and no other kernel of the port launched (the dropless FFN
    wrapped to count its calls, ``DroplessCalls``); the bf16 forwards at
    the published widths took ``ragged_dot``'s Hopper route and every
    fp32 twin forward its fp32 Hopper route (their counters read), the
    twins' wall time printed;
22. LM training (``repro_torch.launch.train``, ``make_train_step``): the
    ten reduced configs in fp32 (vectors nudged by numpy noise), 3 steps
    of Adam on warmup-cosine with clip 1.0 on the card and on the CPU
    from the same params and batches, without and with remat, the MoE
    configs on the GShard and dropless paths, mixtral-smoke's GShard also
    with 2 microbatches: each step's ce and gnorm, the first step's grads
    and every routing decision card against CPU, within fixed limits;
    qwen2-0.5b at full width in bf16 through ``train()`` at the reference
    CLI's batch 8 x seq 128, 30 steps at lr 1e-3, which must lower the
    ce by more than 0.3 (the reference test's criterion), with ms a step
    after 2 warm-up steps, tokens/s, peak memory, its checkpoint saved
    and restored onto the card (bits equal), and one step under the
    profiler beside its FLOP bounds (all bf16; the upcast head at the
    fp32 peak); gemma3-1b, mamba2-780m and musicgen-medium at full
    width, the other six at their published widths with the depth cut
    to fit ~40 GB at Adam's 24 B a param (one layer at least;
    internvl2-76b's and deepseek-v2-236b's one layer take SGD), the cuts
    printed, 3 bf16 steps each: loss finite, params moved, ms a step,
    peak memory; the only kernels of the port launched are the dropless
    MoE's grouped products: ``ragged_dot`` 3 a layer's forward (remat's
    recompute included) and 3 a backward, ``ragged_dot_wgrad`` 3 a
    backward; the bf16 steps took both Hopper routes, the fp32 twins
    both fp32 Hopper routes (3xTF32), and no published width the first;
23. client-axis sharding (``repro_torch.sharding``), on meshes that
    repeat the one card (the engines' ``mesh=`` seam): phase 4's
    repository through the row-strip Eq. 2 rebuild on 1, 2 and 8 shards,
    each within 1e-6 of the unsharded ``pairwise_kl``, within B1's
    tolerance of the plain version, with the same neighbors, its B1
    launches (a strip a shard) and CUDA-event ms; phase 5's federation
    and phase 14's straggler regime on 8 shards (ghost rows engaged),
    each held against its CPU twin on 8 CPU shards (launches read around
    the card's fit) and against the unsharded card run (accuracies and
    repository within 1e-6, wire bytes equal, every ghost row unchanged
    bit for bit); an 8-shard checkpoint restored unsharded and back
    (evaluation within 1e-6); ``benchmarks/shard_scale.py``'s shapes
    (one MLP cohort of N = 256, 1024, 4096 clients, ref 64, C 10, batch
    16) on 1, 2 and 8 shards: step, upload and rebuild ms; with two
    cards or more, ``FederationConfig(devices=2)`` over real cards, else
    a line saying one card was visible;
24. the static-analysis gate: ``python -m repro_torch.launch.analyze
    --json`` on the card (every rule of ``repro_torch.analysis``, the
    placement rules' probes on a mesh of the card, an empty baseline;
    any violation or error fails the phase), each rule's status printed;
    every hand kernel launched at the launch rule's odd probe shapes and
    held against its plain version (phase 3's tolerances), with each
    kernel's launches counted; and the cost model's operations and bytes
    of B1-B4's plain versions at phase 3's, 6's and 8's shapes, beside
    this run's bound of each (the grouped product's three entries at the
    launch rule's probe shapes too, 1, 7 and 160 groups, in fp32 on the
    first route, and at the Hopper routes' probe widths, K = 24 and N =
    136, in bf16 on the Hopper route and in fp32 on the fp32 one);
25. the LM dry run (``launch/dryrun.py``): qwen2-0.5b at full width on
    phase 22's step (bf16, Adam, batch 8 x seq 128) traced on a 1x1 mesh
    of fake card tensors against one real step on the card (argument
    bytes and FLOPs equal, the predicted peak within DRYRUN_PEAK_RTOL of
    ``max_memory_allocated``), then DRYRUN_ROWS on the production meshes
    (16x16, 2x16x16), one ``python -m repro_torch.launch.dryrun`` each,
    side by side, each row printed (mixtral-8x7b's prefill on both MoE
    paths; the pure data-parallel row must move collective bytes); any
    FAIL fails the phase;
26. the dropless MoE's grouped product (``kernels/ragged_dot.py``): the
    forward, the input gradient (rhs read transposed) and the weight
    gradient in bf16 and fp32 at mixtral-8x7b's and deepseek-v2-236b's
    published widths (phase 21's 256 prefill tokens, phase 22's 1024
    train tokens; uniformly routed group sizes), each against its plain
    version within the phase's tolerances, with device and back-to-back
    ms beside its bound, the plain version's ms and the library's
    (``torch._grouped_mm`` where this torch takes the dtype and strides,
    else the per-expert cuBLAS loop), and the route each took: bf16 must
    take the Hopper route, fp32 the fp32 Hopper route (3xTF32; the bound
    at a third of the TF32 peak; its splits timed alone against their
    plain versions), each timed beside the first route on the same
    inputs and held there too; the edge cases at odd shapes, fp32 and
    bf16, all on the first route (one group holding every row, empty
    groups and rows past the sum, 160 groups), with the first route's
    launches; one full-width dropless FFN's forward and backward of each
    MoE architecture under ``set_sync_debug_mode("error")``, and, not
    gated, whether a whole dropless prefill and train step are sync-free;
27. the five walkthroughs (``repro_torch.examples``), each module's
    ``run()`` on the card at the reference's published sizes, with its
    wall seconds and launches (the counts set to 0 just before it) and
    each engine fit's launches: quickstart (``pad_like``, 28 clients, 25
    rounds) and train_sqmd_federation (40 rounds of sqmd on the MLP
    tiers) from numpy-made weights and batch draws, each held to its CPU
    twin on the same ones (History bookkeeping equal, eval logits in
    phase 5's band up to the first eval that leaves it, if one does:
    that eval and the edges where the two graphs differ printed, and the
    CPU's run from weights one fp32 ulp off must leave the band too;
    where the last graphs are equal, quickstart's ``graph_stats``
    out_degree equal to the CPU's bit for bit);
    async_join (45 rounds, three engines), its times, server rounds,
    candidates, staleness rows, uploads and fires equal to its CPU
    twin's; train_and_serve (``until=24``, two admission policies), each
    policy's requests served and snapshots published equal to its CPU
    twin's; train_sqmd_federation ``--resnet`` (width 8, 40 rounds,
    checkpointed under ``build/walkthroughs``); serve_decode on gemma3-1b
    reduced and at full width (batch 4, prompt 48, decode 24). Every
    federation walkthrough must launch B1, B2 and the gather, a sqmd fit
    nothing else (B3's dense route only in async_join's fedmd fit), every
    engine's state must lie on the card, and serve_decode must launch no
    kernel of the port; a ``{"walkthroughs": ...}`` line after the total
    wall time gives each run's seconds and launches;
13. printed last: a ``{"kernels": [...]}`` summary line (B1, B2 and the
    gather's launches from phase 5, B4's three kernels' from phase 9,
    the dense Eq. 5 route's from phase 12's FedMD federation, each plus
    its launches in phases 14-19, 23 and 27; the grouped product's
    Hopper routes' kernels from phases 21 and 22, read off their
    counters; its first route is off the main path, no published width
    reaching it: its launches 0 (the run fails otherwise), marked
    ``"main_path": false``, its launches in phase 26's edges as
    ``edge_launches``; their times from phase 26: bf16 for the Hopper
    route, fp32 for the fp32 Hopper route and its splits and, on the
    same inputs (``timed_on``), for the first route), then the
    last line
    ``{"ok": true, "device": {...}}``.

Every time printed names the card and its power limit. The measured
numbers also go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --b4-against OTHER_CHECKOUT

times only B4 (the int8 Eq. 2 strip) of another checkout of this
repository and of this one, one process each, in turns (other, this,
this, other), at a real upload's strips, 16-64 oracle query rows and the
server-round strip: device and back-to-back times of the other's 64 x 64
FFMA tile alone where it has one, else of its entry point on the stored
lse (``chiprun_out/b4_against.json``; no result line).

    python3 chip_smoke.py --moe-against OTHER_CHECKOUT

times the dropless MoE path of another checkout and of this one the same
way: mixtral-8x7b and deepseek-v2-236b at phase 21's depth cuts, a
dropless forward of phase 21's prefill batch and a dropless train step
of phase 22's batch, host ms a call and one call's kernels and device
ms under the profiler, then phase 26's nine bf16 grouped products alone,
device ms each (``chiprun_out/moe_against.json``; no result line).

    python3 chip_smoke.py --fp32-memory-against OTHER_CHECKOUT

measures, with another checkout's kernels and with this one's, in turns,
the peak memory on the card of phase 22's fp32 twins of the dropless MoE
and of one fp32 dropless FFN forward and backward of each MoE
architecture at its published widths over phase 22's 8 x 128 tokens
(``chiprun_out/fp32_memory.json``; no result line).

    python3 chip_smoke.py --ragged-variants [fp32]

times the grouped product's Hopper route at phase 26's nine bf16 rows
(with ``fp32``: its fp32 Hopper route at the nine fp32 rows) beside
copies of its source built without its products, without its loads and
without its stores (and for fp32 without the weight gradient's split),
to see which part holds each row
(``chiprun_out/ragged_variants[_fp32].json``; no result line).
"""
from __future__ import annotations

import contextlib
import dataclasses
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
       # a dense W: each target sums N products, in another order
       "neighbor_mean_dense_w": (1e-5, 1e-5),
       # the plain-store GEMM against the same three products in fp32
       "neighbor_mean_gemm": (1e-6, 1e-5),
       "int8_pairwise_kl_pair": (1e-4, 1e-4),
       # the int8 dequant split's hi + lo and row term, on the stored lse
       "int8_pairwise_kl_split": (1e-5, 1e-5),
       # the split's hi + lo and row term (exp may differ in a last bit)
       "pairwise_kl_split": (1e-5, 1e-5),
       # the grouped product in fp32 at the probe shapes (K = 21; the
       # weight gradient sums up to 257 rows): sums in another order
       "ragged_dot": (1e-5, 1e-5), "ragged_dot_wgrad": (1e-5, 1e-5)}
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


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: the card is held busy
    (``torch.cuda._sleep``) while the host enqueues ``iters`` calls, so
    the events around them time the device's back-to-back work, not the
    host's launch rate, which bounds ``cuda_ms`` for calls whose kernels
    take microseconds. Fails if the host did not finish enqueueing
    before the card woke up (also when the calls' launches overflow the
    launch queue, about a thousand, and the host waits for the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # sleep ~10x the host's time for the calls (clock64 cycles, ~2 GHz):
    # the host shares its cores, and one slow enqueue must not wake the
    # card early; the sleep itself is outside the timed events
    sleep_s = max(host_s * 10, 5e-3)
    torch.cuda._sleep(int(sleep_s * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    check(enqueue_s < sleep_s * 0.5,
          "the card woke before the host had enqueued the timed calls")
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
            "busy_share": device / wall, "top": top, "host_top": host_top,
            "n_kernels": sum(e.count for e in kernels)}


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


def dense_w_case(a) -> dict:
    """The dense Eq. 5 route on a dense W (a complete graph, each row
    1/(N-1) on every other client, which TF32 does not hold exactly) and
    the server's S: the route, W's split (B1's split pass, B side), S's
    transposing split and the plain-store GEMM each against its plain
    version; the route's error against fp64 beside the fp32 plain
    version's; times of the route, the GEMM alone, the two splits, the
    plain version and ``torch.matmul`` beside the 3xTF32 bound (the
    splits' beside the bytes they must move)."""
    from repro_torch.kernels import neighbor_mean as nm
    from repro_torch.kernels import pairwise_kl as pk
    from repro_torch.kernels import ref
    probs = a["probs"]
    n, r, c = probs.shape
    k = r * c
    w = torch.full((n, n), 1.0 / (n - 1), device=probs.device)
    w.fill_diagonal_(0.0)
    got = nm.neighbor_mean(w, probs)
    want = ref.neighbor_mean_ref(w, probs)
    ea, _ = errors(got, want)
    atol, rtol = TOL["neighbor_mean_dense_w"]
    ok = torch.allclose(got, want, atol=atol, rtol=rtol)
    print(f"  neighbor_mean on a dense W {(n, r, c)}: max_abs={ea:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "neighbor_mean on a dense W disagrees with its plain version")
    sw, st = nm.split_w(w), nm.split_t(probs)
    k_pad = sw.planes.shape[2]
    w_planes, _ = ref.pairwise_kl_split_ref(w.view(n, n, 1), False, k_pad)
    s_planes = ref.neighbor_mean_split_ref(probs, k_pad)
    ok = torch.equal(sw.planes, w_planes) and torch.equal(st.planes,
                                                          s_planes)
    print(f"  neighbor_mean_split (W's split, S's transposing split) "
          f"{(n, r, c)}: planes bit-equal to the plain versions: {ok}")
    check(ok, "the dense route's splits disagree with their plain versions")
    out = torch.empty((n, k), dtype=torch.float32, device=probs.device)
    gemm = pk.gemm(sw, st, out)
    gemm_want = ref.tf32x3_ref(sw.planes, st.planes)
    eg, _ = errors(gemm, gemm_want)
    atol, rtol = TOL["neighbor_mean_gemm"]
    ok = torch.allclose(gemm, gemm_want, atol=atol, rtol=rtol)
    print(f"  pairwise_kl GEMM, plain-store mode, on those planes: "
          f"max_abs={eg:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, "the plain-store GEMM disagrees with its plain version")
    truth = w.double() @ probs.reshape(n, k).double()
    e_kern = float((got.reshape(n, k).double() - truth).abs().max())
    e_plain = float((want.reshape(n, k).double() - truth).abs().max())
    print(f"  neighbor_mean {(n, r, c)} dense W against fp64: route "
          f"max_abs={e_kern:.3e}, fp32 plain version max_abs={e_plain:.3e} "
          f"(ratio {e_kern / e_plain:.3f}, limit {FP64_ERR_RATIO:g})")
    check(e_kern <= FP64_ERR_RATIO * e_plain,
          "the dense route is less accurate than the fp32 plain version "
          "allows")
    s_flat = probs.reshape(n, k)
    t_ops = 3 * 2.0 * n * n * k / PEAK_TF32_FLOPS * 1e3
    t_bytes = 4.0 * (n * n + 2 * n * k) / PEAK_BYTES * 1e3
    split_bytes = (4.0 * n * n + probs.element_size() * n * k
                   + 8.0 * (n + k) * k_pad)
    gemm_row = {
        "ms": cuda_ms(lambda: pk.gemm(sw, st, out), 10),
        "route_ms": cuda_ms(lambda: nm.neighbor_mean(w, probs), 10),
        "plain_ms": cuda_ms(lambda: ref.neighbor_mean_ref(w, probs), 10),
        "library_ms": cuda_ms(lambda: torch.matmul(w, s_flat), 10),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "max_abs_err": ea, "gemm_max_abs_err": eg,
        "fp64_max_abs_err": e_kern, "plain_fp64_max_abs_err": e_plain}
    split_row = {
        "ms": cuda_ms(lambda: (nm.split_w(w), nm.split_t(probs)), 20),
        "plain_ms": cuda_ms(lambda: (
            ref.pairwise_kl_split_ref(w.view(n, n, 1), False, k_pad),
            ref.neighbor_mean_split_ref(probs, k_pad)), 5),
        "library_ms": None, "bound_ms": split_bytes / PEAK_BYTES * 1e3,
        "bound_by": "bytes", "bytes": split_bytes, "max_abs_err": 0.0}
    g = gemm_row
    print(f"  time [{CARD}] neighbor_mean on a dense W {(n, r, c)}: route="
          f"{g['route_ms']:.4f} ms (GEMM alone {g['ms']:.4f} ms, splits "
          f"{split_row['ms']:.4f} ms) plain={g['plain_ms']:.4f} ms "
          f"torch.matmul={g['library_ms']:.4f} ms; 3xTF32 bound "
          f"{g['bound_ms']:.4f} ms ({g['bound_by']}): share of the GEMM "
          f"{g['bound_ms'] / g['ms']:.3%}, of the route "
          f"{g['bound_ms'] / g['route_ms']:.3%}; splits' bytes bound "
          f"{split_row['bound_ms']:.4f} ms ({split_bytes:.4g} B), share "
          f"{split_row['bound_ms'] / split_row['ms']:.3%}")
    return {"gemm": gemm_row, "split": split_row}


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
    # the dense entry's row is its route on a dense W, FedMD's shape; the
    # same route on the sparse W stays beside it, with what a sparse
    # product of that W costs
    sparse = rows["neighbor_mean"]
    sparse["sparse_library_ms"] = rows["neighbor_gather"]["library_ms"]
    dense = dense_w_case(a)
    rows["neighbor_mean"] = dict(dense["gemm"], sparse_w=sparse)
    rows["neighbor_mean_split"] = dense["split"]
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


def server_repository(dev) -> tuple:
    """(state, labels): a numpy-seeded N=4096 repository, every client
    active, on the card; phase 4's and the FedMD round's."""
    from repro_torch.core import init_server, upload_messengers
    n, r, c = SERVER
    rng = np.random.default_rng(0)
    repo = torch.from_numpy(
        log_softmax_np(rng.normal(size=SERVER).astype(np.float32) * 2.0))
    labels = torch.from_numpy(rng.integers(0, c, r).astype(np.int32)).to(dev)
    state = upload_messengers(init_server(n, r, c, device=dev), repo.to(dev),
                              torch.ones(n, dtype=torch.bool))
    return state, labels


def server_phase(dev) -> dict:
    from repro_torch.core import (candidate_mask, policy_round,
                                  select_neighbors_from_div, sqmd)
    from repro_torch.core.policies import as_policy
    from repro_torch.kernels import ops, ref
    n = SERVER[0]
    q, k = 64, 8
    state, labels = server_repository(dev)
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
    check(counts == launches_of(pairwise_kl_split=2, pairwise_kl_pair=2,
                                soft_ce=1, neighbor_gather=1),
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


def launches_of(**counts) -> dict:
    """Every kernel's launch count: the given ones, 0 for the rest."""
    from repro_torch.kernels import ops
    return {name: counts.get(name, 0) for name in ops.launch_counts()}


def fedmd_round_phase(dev) -> dict:
    """``policy_round`` with fedmd() on phase 4's repository: its
    complete graph takes the dense Eq. 5 route (two splits and B1's GEMM
    in its plain-store mode) and Eq. 1, nothing else; held against the
    same round on the plain versions, timed in turns with it, and run
    once under torch.profiler."""
    from repro_torch.core import fedmd, fedmd_graph, policy_round
    from repro_torch.core.policies import as_policy
    from repro_torch.kernels import ops, ref
    n = SERVER[0]
    state, labels = server_repository(dev)
    pol = as_policy(fedmd())

    def plain_round():
        lp = state.repo_logp
        g = fedmd_graph(state.active)
        return (ref.soft_ce_ref(lp, labels),
                ref.neighbor_mean_ref(g.weights, torch.exp(lp)))

    policy_round(state, pol, labels)                     # warm-up
    plain_round()
    ops.reset_launch_counts()
    (new, targets, graph), _ = timed(lambda: policy_round(state, pol,
                                                          labels))
    counts = ops.launch_counts()
    check(counts == launches_of(soft_ce=1, neighbor_mean=1,
                                neighbor_mean_split=2),
          f"FedMD round launched {counts}")
    check(graph.slot_weights is None, "FedMD's graph carries slot weights")
    t_kern, t_plain = [], []
    for _ in range(3):                       # in turns: kernels, plain
        t_kern.append(timed(lambda: policy_round(state, pol, labels))[1])
        (pquality, ptargets), t = timed(plain_round)
        t_plain.append(t)
    print(f"  [{CARD}] FedMD policy_round N={n} on the kernels: "
          f"{', '.join(f'{t:.2f}' for t in t_kern)} ms; launches {counts}")
    print(f"  [{CARD}] FedMD policy_round N={n} on the plain versions: "
          f"{', '.join(f'{t:.2f}' for t in t_plain)} ms")
    t_err, _ = errors(targets, ptargets)
    atol, rtol = TOL["neighbor_mean_dense_w"]
    ok = torch.allclose(targets, ptargets, atol=atol, rtol=rtol)
    print(f"  targets max abs err against the plain round: {t_err:.3e} "
          f"(atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    check(ok, "FedMD targets disagree with the plain round")
    atol, rtol = TOL["soft_ce"]
    check(torch.allclose(new.quality, pquality, atol=atol, rtol=rtol),
          "FedMD grades disagree with the plain round")
    check(bool(torch.isfinite(targets).all()), "non-finite targets")
    trace = device_breakdown(f"FedMD policy_round N={n}",
                             lambda: policy_round(state, pol, labels))
    return {"kernel_ms": t_kern, "plain_ms": t_plain, "launches": counts,
            "targets_max_abs_err": t_err, "profile": trace}


def shard_mesh(dev, shards):
    """None, or a client mesh of ``shards`` entries of the one device
    ``dev`` (the engines' ``mesh=`` seam: every shard on one card)."""
    from repro_torch.sharding import ClientMesh
    if shards is None:
        return None
    d = torch.device(dev)
    if d.type == "cuda":
        d = torch.device("cuda", torch.cuda.current_device())
    return ClientMesh((d,) * shards)


def federation(dev, splits, ds, init_params, draws, logits_out, server,
               protocol=None, static_weights=None, shards=None, seam=True):
    """The 5-round sc_like federation on ``dev`` under ``protocol``
    (sqmd(q=16, k=8) by default) and ``server`` config, its client axis
    split into ``shards`` shards if given: of ``dev`` alone through the
    ``mesh=`` seam, or without it (``seam=False``) over the first
    ``shards`` cards."""
    from repro_torch.core import FederationConfig, FederationEngine, sqmd
    from repro_torch.models import hetero_mlp_zoo
    return FederationEngine.build(
        ds, splits, hetero_mlp_zoo(ds.feature_len, ds.n_classes), None,
        protocol or sqmd(q=16, k=8),
        config=FederationConfig(rounds=5, batch_size=32, eval_every=2,
                                devices=shards, **server),
        seed=1, callbacks=[logit_recorder(splits, logits_out)], device=dev,
        init_params=init_params,
        batch_indices=lambda step, ci: draws(step, ci),
        static_weights=static_weights,
        mesh=shard_mesh(dev, shards) if seam else None)


def logit_recorder(splits, logits_out):
    """An eval callback keeping every family's test logits (numpy)."""
    def record(engine, rnd, metrics):
        out = {}
        for coh in engine.fed.cohorts:
            xs = torch.from_numpy(np.stack(
                [splits[i].test_x for i in coh.client_ids])).to(
                    engine.fed.device)
            with torch.no_grad():
                logits = coh.real_forward(xs)
            check(logits.device == xs.device,
                  f"{coh.family_name}'s forward left {xs.device}")
            out[coh.family_name] = logits.float().cpu().numpy()
        logits_out.append(out)
    return record


def async_federation(dev, inputs, run: str, logits_out, protocol=None,
                     shards=None):
    """The asynchronous sc_like federation of regime ``run`` (async_run)
    on ``dev``: the three MLP tiers, batch 16, two local steps a wake,
    evals every ASYNC_EVAL_EVERY virtual seconds, under ``protocol``
    (sqmd(q=16, k=8) by default), split into ``shards`` shards if
    given."""
    from repro_torch.core import (AsyncFederationEngine, FederationConfig,
                                  sqmd)
    from repro_torch.models import hetero_mlp_zoo
    ds, splits, init_params, draws = inputs
    arrivals, trigger, server = async_run(run, ds.n_clients)
    return AsyncFederationEngine.build(
        ds, splits, hetero_mlp_zoo(ds.feature_len, ds.n_classes), None,
        protocol or sqmd(q=16, k=8), arrivals=arrivals, trigger=trigger,
        config=FederationConfig(batch_size=16, local_steps=2,
                                eval_every=ASYNC_EVAL_EVERY, devices=shards,
                                **server),
        seed=1, callbacks=[logit_recorder(splits, logits_out)], device=dev,
        init_params=init_params,
        batch_indices=lambda step, ci: draws(step, ci, 16),
        mesh=shard_mesh(dev, shards))


def numpy_seams(ds, splits, zoo) -> tuple:
    """Numpy-made stacked weights (the reference's layout) for clients
    round-robin over ``zoo``'s MLP tiers, and the batch draws
    ``draws(step, cohort, batch=32)``: shared by a run on the card and
    its CPU twin, whose torch generators draw differently."""
    names = list(zoo)
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

    def draws(step, ci, batch=32):
        n_c, m = sizes[ci]
        return np.random.default_rng((3, step, ci)).integers(0, m,
                                                             (n_c, batch))

    return init_params, draws


def federation_inputs():
    """sc_like, its splits, and numpy-made weights and batch draws, shared
    by every federation run on the card and on the CPU."""
    from repro_torch.data import make_splits, sc_like
    from repro_torch.models import hetero_mlp_zoo
    ds = sc_like()
    splits = make_splits(ds, seed=0)
    init_params, draws = numpy_seams(
        ds, splits, hetero_mlp_zoo(ds.feature_len, ds.n_classes))
    return ds, splits, init_params, draws


def federation_phase(dev, server: dict, path: tuple, inputs,
                     protocol=None, static_weights=None,
                     exact=None, run=None, required=None, shards=None,
                     engines=None) -> dict:
    """The 5-round sc_like federation under ``protocol`` (sqmd(q=16, k=8)
    by default) with ``server`` (FederationConfig's delta/selection/codec
    settings) on the card, then on the CPU with the same weights and
    draws; with ``run`` (a regime of ``async_run``) the asynchronous
    federation of that regime up to ASYNC_UNTIL instead. Fails unless
    every kernel in ``required`` (default: all of ``path``) launched
    during the card's fit, every kernel off ``path`` launched 0 times,
    and each kernel in ``exact`` launched exactly that many times; and
    unless both runs keep the same History bookkeeping (times, server
    rounds, staleness, wire bytes) and eval logits within 1e-2. With
    ``shards`` both runs split their client axis into that many shards of
    their device; ``engines`` (a list) receives the card's engine."""
    from repro_torch.kernels import ops
    ds, splits, init_params, draws = inputs

    def build(d, logits_out):
        if run is None:
            return federation(d, splits, ds, init_params, draws, logits_out,
                              server, protocol, static_weights, shards)
        return async_federation(d, inputs, run, logits_out, protocol,
                                shards)

    def fit(eng):
        if run is None:
            return eng.fit(splits)
        return eng.fit(splits, until=ASYNC_UNTIL)

    what = "5 rounds" if run is None else f"t <= {ASYNC_UNTIL} ({run})"
    card_logits, cpu_logits = [], []
    eng = build(dev, card_logits)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = fit(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for rnd, t, acc in zip(hist.rounds, hist.times, hist.mean_acc):
        print(f"  round {rnd} (t={t:g}): mean test accuracy {acc:.4f}")
    print(f"  [{CARD}] fit: {wall:.3f} s for {what}, server rounds "
          f"{hist.server_rounds[-1]}, launches {counts}")
    check(all(counts[k] > 0 for k in (required or path)),
          f"a kernel of this path never launched: {counts}")
    check(all(v == 0 for k, v in counts.items() if k not in path),
          f"a kernel off this path launched: {counts}")
    check(all(counts[k] == v for k, v in (exact or {}).items()),
          f"launches other than {exact}: {counts}")

    fed = eng.fed
    tensors = engine_state_tensors(eng)
    if static_weights is not None:
        tensors += [fed.static_weights, eng.policy.neighbors,
                    eng.policy.slot_weights]
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

    cpu = build("cpu", cpu_logits)
    cpu_hist = fit(cpu)
    check(len(card_logits) == len(cpu_logits) == len(hist.rounds),
          "the card and CPU runs evaluated at different points")
    worst = hold_logits(card_logits, cpu_logits, cpu_hist)
    n_evals = 3 if run is None else len(np.arange(0.0, ASYNC_UNTIL + 1e-9,
                                                  ASYNC_EVAL_EVERY))
    check(all(np.isfinite(hist.mean_acc)) and len(hist.mean_acc) == n_evals,
          "bad accuracy history")
    for key in ("rounds", "times", "server_rounds", "staleness", "bytes_up",
                "bytes_down"):
        check(getattr(cpu_hist, key) == getattr(hist, key),
              f"card and CPU runs kept different History.{key}")
    if engines is not None:
        engines.append(eng)
    return {"launches": counts, "fit_s": wall, "mean_acc": hist.mean_acc,
            "cpu_mean_acc": cpu_hist.mean_acc, "logit_max_abs_diff": worst,
            "times": hist.times, "server_rounds": hist.server_rounds,
            "bytes_up": hist.bytes_up[-1], "bytes_down": hist.bytes_down[-1]}


def logit_scales(logits) -> dict:
    """Per family, the largest eval-logit magnitude of a run."""
    return {fam: max(float(np.abs(ev[fam]).max()) for ev in logits)
            for fam in logits[0]}


def family_gaps(a_logits, b_logits) -> dict:
    """Per family, the largest difference between two runs' eval logits."""
    out = {}
    for a, b in zip(a_logits, b_logits):
        for fam in a:
            out[fam] = max(out.get(fam, 0.0),
                           float(np.abs(a[fam] - b[fam]).max()))
    return out


def hold_logits(card_logits, cpu_logits, cpu_hist, tol: float = 1e-2,
                rtol: float = 0.0) -> float:
    """Hold the card's eval logits (per eval, per family) against the
    CPU run's: within ``tol`` plus ``rtol`` of the family's largest CPU
    logit magnitude, and a prediction may flip only where the CPU's top
    two logits are within twice that. Returns the worst difference."""
    scale = logit_scales(cpu_logits)
    limit = {fam: tol + rtol * v for fam, v in scale.items()}
    worst, flips = 0.0, 0
    for gpu_ev, cpu_ev in zip(card_logits, cpu_logits):
        check(set(gpu_ev) == set(cpu_ev), "the runs evaluated other cohorts")
        for fam in gpu_ev:
            g, h = gpu_ev[fam], cpu_ev[fam]
            worst = max(worst, float(np.abs(g - h).max()))
            flip = g.argmax(-1) != h.argmax(-1)
            top2 = np.sort(h, -1)[..., -2:]
            gap = (top2[..., 1] - top2[..., 0])[flip]
            check(gap.max(initial=0.0) < 2 * limit[fam],
                  "a prediction flipped away from a near-tie")
            flips += int(flip.sum())
    gaps = family_gaps(card_logits, cpu_logits)
    print(f"  card vs CPU federation: eval logits max abs diff {worst:.3e}, "
          f"{flips} near-tie prediction flips; CPU mean accuracy "
          f"{cpu_hist.mean_acc}")
    if rtol:
        print("  per family, gap / limit: " + ", ".join(
            f"{fam} {gaps[fam]:.3e} / {limit[fam]:.3e}" for fam in gaps))
    check(all(gaps[fam] < limit[fam] for fam in gaps),
          "card and CPU federations drifted apart")
    return worst


@contextlib.contextmanager
def tf32_matmuls():
    """fp32 matmuls in TF32 inside, as a caller may turn them on."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def static_graph(n: int, k: int) -> np.ndarray:
    """A numpy-made D-Dist graph: k distinct other clients a row, weight
    1/k each, (n, n) fp32."""
    rng = np.random.default_rng(4)
    w = np.zeros((n, n), np.float32)
    for i in range(n):
        w[i, rng.choice(np.delete(np.arange(n), i), size=k,
                        replace=False)] = 1.0 / k
    return w


def baseline_phase(dev, inputs) -> dict:
    """Phase 5's federation under each baseline: FedMD's complete graph
    takes the dense Eq. 5 route every round, D-Dist's static graph (made
    with numpy, passed through ``static_weights``) the gather, I-SGD no
    server kernel and no wire byte."""
    from repro_torch.core import ddist, fedmd, isgd
    ds = inputs[0]
    rounds = 5
    out = {}
    for name, protocol, static, path, exact in (
            ("fedmd", fedmd(), None, FEDMD_PATH,
             {"neighbor_mean": rounds, "neighbor_mean_split": 2 * rounds}),
            ("ddist", ddist(k=8), static_graph(ds.n_clients, 8),
             DDIST_PATH, {"neighbor_gather": rounds}),
            ("isgd", isgd(), None, (), {})):
        print(f"  -- {name}")
        out[name] = federation_phase(dev, {}, path, inputs, protocol,
                                     static, exact)
    check(out["isgd"]["bytes_up"] == out["isgd"]["bytes_down"] == 0.0,
          "I-SGD charged wire bytes")
    return out


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


def async_federation_phase(dev, inputs) -> dict:
    """The asynchronous sc_like federation in fig. 4's regimes, each held
    against its CPU run: (a) facilities joining at 0/3/6 through the
    schedule shim, under sqmd(q=16, k=8), then fedmd() (B3's dense
    route); (b) stragglers landing 2.5 late on a quorum, delta rounds;
    (c) bursty single-row uploads fired every 8 rows on the IVF index and
    the int8 uplink (B4's thin kernel)."""
    from repro_torch.core import fedmd
    out = {}
    for label, run, protocol, path, required in (
            ("staged-sqmd", "staged", None, DENSE_PATH, None),
            ("staged-fedmd", "staged", fedmd(), FEDMD_PATH, None),
            ("straggler-quorum-delta", "straggler", None, DENSE_PATH, None),
            ("bursty-every-k-ivf-int8", "bursty", None, IVF_PATH,
             ("soft_ce", "neighbor_gather", "int8_pairwise_kl_thin"))):
        print(f"  -- {label}")
        out[label] = federation_phase(
            dev, async_run(run, inputs[0].n_clients)[2], path, inputs,
            protocol, run=run, required=required)
    return out


def async_server_phase(dev) -> dict:
    """A ServerBus at the server-round size driven through a Clock by an
    arrival process, numpy-seeded messengers at each wake, no client
    training: (a) StragglerLatency(0.3, 2.5) with Quorum(0.5) to t=3;
    (b) one burst of BurstyArrivals(frac=0.6, jitter=0.5), one delivery
    a client, fired every 64 rows, to t=0.5. Every fire is held against
    the same repository's round on the plain versions (the delta cache
    against the plain divergence matrix, neighbor sets, targets), with
    its u, bucketed strip, launches and wall time; each regime's
    delivery times and one fire under torch.profiler."""
    from repro_torch.core import (BurstyArrivals, Clock, EveryKUploads,
                                  Federation, Quorum, ServerBus,
                                  StragglerLatency, candidate_mask,
                                  init_server, select_neighbors_from_div,
                                  sqmd, wire)
    from repro_torch.core.policies import as_policy
    from repro_torch.core.similarity import _bucket_rows
    from repro_torch.kernels import ops, ref
    n, r, c = SERVER
    q, k = 64, 8
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, c, r).astype(np.int32)).to(dev)

    def plain_round(state):
        lp = state.repo_logp
        quality = ref.soft_ce_ref(lp, labels)
        cand = candidate_mask(quality, state.active, q)
        div = torch.cat([ref.pairwise_kl_pair_ref(lp[i:i + ops.CHUNK_ROWS],
                                                  lp)
                         for i in range(0, n, ops.CHUNK_ROWS)])
        g = select_neighbors_from_div(div, cand, k)
        return quality, div, g, ref.neighbor_gather_ref(
            g.neighbors, g.slot_weights, torch.exp(lp))

    out = {}
    # profile_at: the fire run under the profiler; quiet: a delivery that
    # fires nothing (the t=2.5 stragglers' 1229 rows against a quorum of
    # 2048; the burst's second row against k=64), also profiled
    for name, arrivals, trigger, until, profile_at, quiet in (
            ("straggler-quorum", StragglerLatency(0.3, 2.5), Quorum(frac=0.5),
             3.0, 1, 3),
            ("bursty-every-k", BurstyArrivals(frac=0.6, jitter=0.5),
             EveryKUploads(k=64), 0.5, 5, 1)):
        fed = Federation(cohorts=[], server=init_server(n, r, c, device=dev),
                         ref_x=torch.zeros((r, 1), device=dev), ref_y=labels,
                         n_clients=n,
                         generator=torch.Generator(device=dev))
        bus = ServerBus(fed, as_policy(sqmd(q=q, k=k)), trigger=trigger,
                        delta=True)
        fires, deliveries, fire_ms = [], [], [0.0]
        fire = bus.fire

        def checked_fire(t):
            entered = time.perf_counter()
            rows = np.nonzero(bus.fresh_since_fire)[0]
            full = rows.size >= n          # u = N rebuilds the matrix
            strip = n if full else len(_bucket_rows(rows))
            before = ops.launch_counts()
            if len(fires) == profile_at:
                prof = device_breakdown(f"{name}: fire {len(fires)} at "
                                        f"t={t:g}, u={rows.size}",
                                        lambda: fire(t))
                ms = prof["wall_ms"]
            else:
                prof = None
                _, ms = timed(lambda: fire(t))
            after = ops.launch_counts()
            launches = {kk: after[kk] - before[kk] for kk in after
                        if after[kk] != before[kk]}
            # a delta round: two strips, each splitting both sides; a
            # rebuild: one split a side, a GEMM a CHUNK_ROWS strip
            check(launches == {"pairwise_kl_split": 2 if full else 4,
                               "pairwise_kl_pair": -(-n // ops.CHUNK_ROWS)
                               if full else 2,
                               "soft_ce": 1, "neighbor_gather": 1},
                  f"{name}: fire {len(fires)} launched {launches}")
            state = fed.server
            quality, div, g, ptargets = plain_round(state)
            atol, rtol = TOL["soft_ce"]
            check(torch.allclose(state.quality, quality, atol=atol,
                                 rtol=rtol),
                  f"{name}: fire {len(fires)}'s grades disagree with the "
                  f"plain round")
            cache_err, _ = errors(state.div_cache, div)
            atol, rtol = TOL["pairwise_kl_pair"]
            check(torch.allclose(state.div_cache, div, atol=atol, rtol=rtol),
                  f"{name}: fire {len(fires)}'s delta cache disagrees with "
                  f"the plain divergence matrix")
            same = same_neighbors(bus.last_graph, g, "the plain round")
            # nothing is sent to a row outside the policy's receivers
            recv = bus.policy.receivers(state, bus.last_graph)
            ptargets = torch.where(recv[:, None, None], ptargets,
                                   torch.zeros_like(ptargets))
            d = (fed.targets - ptargets).abs()[same]
            t_err = float(d.max()) if d.numel() else 0.0
            check(t_err <= 1e-6, f"{name}: fire {len(fires)}'s targets "
                                 f"disagree with the plain round")
            fires.append({"t": t, "u": int(rows.size),
                          "strip": [strip, n], "full_rebuild": full,
                          "launches": launches, "ms": ms,
                          "cache_max_abs_err": cache_err,
                          "targets_max_abs_err": t_err,
                          "neighbor_rows_differing": int((~same).sum()),
                          "profile": prof})
            # the fire and its checks leave the delivery's own time
            fire_ms[0] = (time.perf_counter() - entered) * 1e3

        bus.fire = checked_fire
        clock = Clock()
        for t, mask in arrivals.wakes(n, until):
            clock.schedule(t, "wake", mask)
        n_wakes, delivery_prof = 0, None
        while (ev := clock.pop_due(until)) is not None:
            if ev.kind == "wake":
                msg = log_softmax_np(np.random.default_rng((1, n_wakes))
                                     .normal(size=SERVER)
                                     .astype(np.float32) * 2.0)
                n_wakes += 1
                payload = wire.encode("dense32",
                                      torch.from_numpy(msg).to(dev))
                mask = ev.payload
                lat = arrivals.latency(ev.time, mask, n)
                for dly in np.unique(lat[mask]):
                    clock.schedule(ev.time + float(dly), "upload",
                                   (mask & (lat == dly), payload, ev.time))
                continue
            sub, payload, produced = ev.payload
            fire_ms[0] = 0.0
            n_fires = len(fires)

            def deliver():
                return bus.deliver(ev.time, payload, sub,
                                   produced_at=produced)
            if len(deliveries) == quiet:
                fired, delivery_prof = False, device_breakdown(
                    f"{name}: delivery {quiet} at t={ev.time:g}, "
                    f"{int(sub.sum())} rows", deliver)
                check(len(fires) == n_fires, f"{name}: the profiled "
                                             f"delivery fired")
                ms = None
            else:
                fired, ms = timed(deliver)
                ms -= fire_ms[0]
            check(fired == (len(fires) == n_fires + 1),
                  f"{name}: a fire went unrecorded")
            deliveries.append({"t": ev.time, "rows": int(sub.sum()),
                               "ms": ms, "fired": fired})
        # the profiled delivery's wall carries the profiler's overhead
        dms = np.array([dd["ms"] for dd in deliveries
                        if dd["ms"] is not None])
        us = [f["u"] for f in fires]
        buckets = sorted({f["strip"][0] for f in fires})
        print(f"  [{CARD}] {name}: {n_wakes} wakes, {len(deliveries)} "
              f"deliveries ({bus.n_uploads} rows merged, median "
              f"{np.median(dms):.3f} ms, max {dms.max():.3f} ms a delivery "
              f"without its fire), {len(fires)} fires: u "
              f"{min(us)}-{max(us)}, strips of {buckets} rows, fire ms "
              f"median {np.median([f['ms'] for f in fires]):.2f} max "
              f"{max(f['ms'] for f in fires):.2f}")
        for f in fires[:6]:
            print(f"    fire t={f['t']:.6g} u={f['u']} strip {f['strip']} "
                  f"{f['ms']:.2f} ms, launches {f['launches']}, cache err "
                  f"{f['cache_max_abs_err']:.2e}, targets err "
                  f"{f['targets_max_abs_err']:.2e}")
        check(len(fires) >= 3 and fires[profile_at]["profile"] is not None
              and delivery_prof is not None,
              f"{name}: too few fires or deliveries")
        out[name] = {"n_wakes": n_wakes, "fires": fires,
                     "deliveries": len(deliveries),
                     "delivery_profile": delivery_prof,
                     "delivery_ms_median": float(np.median(dms)),
                     "delivery_ms_max": float(dms.max()),
                     "rows_merged": bus.n_uploads,
                     "launches": {kk: sum(f["launches"].get(kk, 0)
                                          for f in fires)
                                  for kk in ops.launch_counts()}}
        torch.cuda.empty_cache()
    return out


# phase 16's zoo: the registry's five families at their widths, under
# the weighted assignment; phase 17's: the paper's own client models
ZOO_NAMES = "mlp-s,resnet,transformer,ssm,rglru"
ZOO_SPEC = "mlp-s:0.3,resnet:0.3,transformer:0.2,ssm:0.1,rglru:0.1"
# phase 17 runs 2 rounds, cut from 3: at 3 its CPU twin (RESNET50 on the
# host of an H100 80GB HBM3 at 700 W) took 38.8 s of a 144 s script; 2
# is the fewest rounds that distill
ZOO_ROUNDS, RESNET_ROUNDS, ZOO_BATCH = 5, 2, 16
# the zoo federations' eval logits, card against CPU, may differ by this
# share of each family's largest CPU logit magnitude. Training carries
# fp32 rounding far: on an H100 80GB HBM3 at 700 W the drift witness read
# RESNET50's card-vs-CPU gap at 9.6e-5 of its 146.5 and its gap from
# weights one fp32 ulp off at 6.9e-5, both over the 6.8e-5 a 1e-2
# absolute limit allows there; TF32 matmuls moved the families by 5.1e-5
# (transformer) to 8.3e-3 (mlp-s), RESNET50 by 9.0e-4
ZOO_LOGIT_RTOL = 3e-4
# one forward of a fitted ResNet on the card: within this share of its
# largest logit of the same forward in fp64 (fp32 read 2.5e-7 to 6.7e-7
# there, TF32 7.7e-5 to 1.5e-4)
FWD_RTOL = 1e-5
CODECS = ("dense32", "dense16", "int8", "topk")


def zoo_inputs(families, spec) -> tuple:
    """sc_like, its splits, ``families`` (a Zoo or a plain mapping of
    cohort builders), the assignment, numpy-made weights and batch
    draws, shared by the card's and the CPU's run."""
    from repro_torch.convert import numpy_cohort_inputs
    from repro_torch.data import make_splits, sc_like
    from repro_torch.models import parse_assignment
    ds = sc_like()
    splits = make_splits(ds, seed=0)
    fams = families(ds)
    assignment = parse_assignment(spec, list(fams), ds.n_clients)
    init, draws = numpy_cohort_inputs(fams, assignment, splits, ZOO_BATCH,
                                      seed=5)
    return ds, splits, fams, assignment, init, draws


def zoo_federation(dev, inputs, rounds: int, logits_out):
    from repro_torch.core import FederationConfig, FederationEngine, sqmd
    ds, splits, fams, assignment, init, draws = inputs
    return FederationEngine.build(
        ds, splits, fams, assignment, sqmd(q=16, k=8),
        config=FederationConfig(rounds=rounds, batch_size=ZOO_BATCH,
                                eval_every=2),
        seed=1, callbacks=[logit_recorder(splits, logits_out)], device=dev,
        init_params=init, batch_indices=draws)


def family_times(label: str, eng, iters: int) -> dict:
    """Per cohort of a fitted engine: one cohort step (a fixed batch, all
    clients on, distilling) and one messenger upload on the uplink codec,
    timed back to back by CUDA events and, where the calls' launches fit
    the launch queue, by ``device_ms``; one step under torch.profiler."""
    from repro_torch.core.client import cohort_messenger_upload, cohort_step
    from repro_torch.data.pipeline import cohort_batch
    fed = eng.fed
    out = {}
    for ci, coh in enumerate(fed.cohorts):
        n_c, m = coh.data["y"].shape
        idx = torch.from_numpy(np.random.default_rng(ci).integers(
            0, m, (n_c, ZOO_BATCH)))
        batch = cohort_batch(coh.data, idx)
        rows = torch.as_tensor(coh.client_ids, device=fed.device)
        targets, on = fed.targets[rows], torch.ones(
            n_c, dtype=torch.bool, device=fed.device)

        def step():
            cohort_step(coh.model, coh.optimizer, coh.opt_state, batch["x"],
                        batch["y"], fed.ref_x, targets, on,
                        eng.policy.rho, True)

        def upload():
            cohort_messenger_upload(coh.model, fed.ref_x,
                                    codec=eng.clients.uplink)

        row = {"clients": n_c,
               "params_per_client": sum(p[0].numel()
                                        for p in coh.model.parameters()),
               "step_ms": cuda_ms(step, iters),
               "upload_ms": cuda_ms(upload, iters)}
        for name, fn in (("step", step), ("upload", upload)):
            prof = device_breakdown(f"{label} {coh.family_name} {name}", fn)
            row[f"{name}_profile"] = prof
            n_k = prof.get("n_kernels") or 0
            # device_ms needs the calls' launches inside the launch queue
            reps = min(10, 800 // max(n_k, 1))
            row[f"{name}_device_ms"] = device_ms(fn, reps) if reps else None
        print(f"  [{CARD}] {label} {coh.family_name} ({n_c} clients, "
              f"{row['params_per_client']} params a client): step "
              f"{row['step_ms']:.3f} ms back to back, "
              f"{device_text(row, 'step')}; upload {row['upload_ms']:.3f} "
              f"ms, {device_text(row, 'upload')}")
        out[coh.family_name] = row
    return out


def device_text(row: dict, name: str) -> str:
    prof = row[f"{name}_profile"]
    if row[f"{name}_device_ms"] is not None:
        return (f"device {row[f'{name}_device_ms']:.3f} ms "
                f"({prof.get('n_kernels')} kernels)")
    return (f"device_ms not measured ({prof.get('n_kernels')} launches "
            f"overflow the launch queue), kernel time under the profiler "
            f"{prof.get('device_ms') or 0:.3f} ms")


def hold_codecs(dev, msg: torch.Tensor, targets: torch.Tensor) -> dict:
    """Every codec encodes the card's messengers (log) and targets (prob)
    byte for byte as the CPU encodes the same values."""
    from repro_torch.core import wire
    out = {}
    for spec in CODECS:
        for domain, x in (("log", msg), ("prob", targets)):
            got = wire.encode(spec, x, domain=domain)
            want = wire.encode(spec, x.cpu(), domain=domain)
            for name, a in got.arrays.items():
                check(a.device == x.device, f"{spec} encoded off the card")
                g, w = a.cpu(), want.arrays[name]
                if g.dtype == torch.bfloat16:
                    g, w = g.view(torch.int16), w.view(torch.int16)
                check(g.dtype == w.dtype and torch.equal(g, w),
                      f"{spec} ({domain}) field {name}: the card's encode "
                      f"differs from the CPU's")
            out[f"{spec}/{domain}"] = wire.payload_bytes(got)
    print(f"  codecs byte-identical on the card and the CPU "
          f"(messengers and targets): {out}")
    return out


def one_ulp_off(init: dict, seed: int) -> dict:
    """Every leaf of ``init`` moved to a neighbouring fp32 value, up or
    down as a seeded coin says."""
    rng = np.random.default_rng(seed)
    inf = np.float32(np.inf)

    def go(tree):
        if isinstance(tree, dict):
            return {k: go(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [go(v) for v in tree]
        return np.nextafter(tree, np.where(rng.random(tree.shape) < 0.5,
                                           inf, -inf))

    return {fam: go(tree) for fam, tree in init.items()}


def drift_witness(dev, label: str, inputs, rounds: int, eng, card_logits,
                  cpu_logits) -> dict:
    """What the card-against-CPU gap of a federation's eval logits is made
    of, on the same inputs, per family and relative to the family's
    largest CPU logit magnitude: the card's run again (run to run); the
    card's run from weights one fp32 ulp off (how far the training
    carries a last-bit difference); the card's run with TF32 matmuls (an
    arithmetic the checks must catch). And one forward of each fitted
    ResNet on the card in fp32 (held to FWD_RTOL) and in TF32, and on the
    CPU in fp32, against the same forward in fp64."""
    import copy
    splits = inputs[1]
    scale = logit_scales(cpu_logits)

    def refit(init=None):
        logits = []
        zoo_federation(dev, inputs if init is None else
                       (*inputs[:4], init, inputs[5]), rounds,
                       logits).fit(splits)
        return logits

    rerun = refit()
    off = refit(one_ulp_off(inputs[4], 9))
    with tf32_matmuls():
        tf32 = refit()
    runs = {"card_vs_cpu": family_gaps(card_logits, cpu_logits),
            "card_rerun": family_gaps(rerun, card_logits),
            "card_one_ulp_off": family_gaps(off, card_logits),
            "card_tf32_vs_cpu": family_gaps(tf32, cpu_logits)}
    out = {"logit_scale": scale}
    for name, gaps in runs.items():
        rel = {fam: gaps[fam] / scale[fam] for fam in gaps}
        out[name] = {"max_abs": gaps, "relative": rel,
                     "max_relative": max(rel.values())}
        print(f"  [{CARD}] {label} witness {name}: largest relative gap "
              f"{max(rel.values()):.2e} (" + ", ".join(
                  f"{fam} {gaps[fam]:.2e}/{scale[fam]:.1f}" for fam in gaps)
              + ")")
    forward = {}
    for coh in eng.fed.cohorts:
        if getattr(coh.model, "family", None) != "resnet":
            continue                   # the others cast inside to fp32
        xs = torch.from_numpy(np.stack([splits[i].test_x
                                        for i in coh.client_ids]))
        with torch.no_grad():
            card = coh.model(xs.to(dev)).cpu().double()
            with tf32_matmuls():
                card_tf32 = coh.model(xs.to(dev)).cpu().double()
            model = copy.deepcopy(coh.model).cpu()
            cpu = model(xs).double()
            exact = model.double()(xs.double())
        big = float(exact.abs().max())
        row = {"logit_scale": big, **{
            k: float((v - exact).abs().max()) / big for k, v in
            (("card", card), ("card_tf32", card_tf32), ("cpu", cpu))}}
        forward[coh.family_name] = row
        print(f"  {label} {coh.family_name}: one forward of the fitted model "
              f"against fp64, relative to its largest logit {big:.3f}: card "
              f"{row['card']:.2e}, card in TF32 {row['card_tf32']:.2e}, CPU "
              f"{row['cpu']:.2e}")
        check(row["card"] < FWD_RTOL,
              f"{coh.family_name}'s forward on the card is not fp32")
    out["fp64_forward"] = forward
    return out


def zoo_phase(dev, label: str, inputs, rounds: int, iters: int,
              warm_profile: bool) -> dict:
    """A mixed-architecture federation on the card, held against its CPU
    run (History bookkeeping equal, eval logits within ZOO_LOGIT_RTOL of
    their largest magnitude); fails
    unless B1, B2 and the gather launched during the card's fit and
    nothing else did, and unless every state tensor (each optimizer's
    moments and per-client steps included) is on the card. Then the
    codecs on the last upload's messengers, the per-family step and
    upload times, and optionally one warm fit under torch.profiler."""
    from repro_torch.kernels import ops
    from repro_torch.optim import state_tensors
    ds, splits = inputs[0], inputs[1]
    card_logits, cpu_logits, uploads = [], [], []
    eng = zoo_federation(dev, inputs, rounds, card_logits)
    collect = eng.clients.collect_messengers

    def keep(mask):
        msg = collect(mask)
        uploads.append(msg)
        return msg

    eng.clients.collect_messengers = keep
    ops.reset_launch_counts()
    hist, wall = timed(lambda: eng.fit(splits))
    counts = ops.launch_counts()
    for rnd, acc in zip(hist.rounds, hist.mean_acc):
        print(f"  round {rnd}: mean test accuracy {acc:.4f}")
    sizes = {c.family_name: len(c.client_ids) for c in eng.fed.cohorts}
    opts = {c.family_name: type(c.opt_state).__name__
            for c in eng.fed.cohorts}
    print(f"  [{CARD}] {label} fit: {wall / 1e3:.3f} s for {rounds} rounds "
          f"({sizes}, {opts}), server rounds {hist.server_rounds[-1]}, "
          f"launches {counts}")
    check(all(counts[k] > 0 for k in DENSE_PATH),
          f"a kernel of this path never launched: {counts}")
    check(all(v == 0 for k, v in counts.items() if k not in DENSE_PATH),
          f"a kernel off this path launched: {counts}")
    fed = eng.fed
    tensors = [fed.ref_x, fed.ref_y, fed.targets, *fed.server]
    for coh in fed.cohorts:
        tensors += [*coh.model.parameters(), *state_tensors(coh.opt_state),
                    *coh.data.values()]
    check(all(t.is_cuda for t in tensors), "a state tensor is off the card")
    print(f"  all {len(tensors)} state tensors on {fed.device}")

    cpu = zoo_federation("cpu", inputs, rounds, cpu_logits)
    t0 = time.perf_counter()
    cpu_hist = cpu.fit(splits)
    cpu_s = time.perf_counter() - t0
    print(f"  the same federation on the CPU: {cpu_s:.1f} s")
    check(len(card_logits) == len(cpu_logits) == len(hist.rounds),
          "the card and CPU runs evaluated at different points")
    witness = drift_witness(dev, label, inputs, rounds, eng, card_logits,
                            cpu_logits)
    worst = hold_logits(card_logits, cpu_logits, cpu_hist, tol=0.0,
                        rtol=ZOO_LOGIT_RTOL)
    for key in ("rounds", "times", "server_rounds", "staleness", "bytes_up",
                "bytes_down"):
        check(getattr(cpu_hist, key) == getattr(hist, key),
              f"card and CPU runs kept different History.{key}")
    check(all(np.isfinite(hist.mean_acc)), "bad accuracy history")
    from repro_torch.core import wire
    codecs = hold_codecs(dev, wire.decode(uploads[-1]), fed.targets)
    times = family_times(label, eng, iters)
    out = {"launches": counts, "fit_s": wall / 1e3, "cpu_fit_s": cpu_s,
           "mean_acc": hist.mean_acc, "cpu_mean_acc": cpu_hist.mean_acc,
           "logit_max_abs_diff": worst, "cohorts": sizes,
           "optimizers": opts, "drift_witness": witness,
           "codec_bytes": codecs, "families": times}
    if warm_profile:
        warm = zoo_federation(dev, inputs, rounds, [])
        out["warm_profile"] = device_breakdown(
            f"warm {label} {rounds}-round fit", lambda: warm.fit(splits))
    return out


def zoo_families(ds):
    from repro_torch.models import build_zoo
    return build_zoo(ZOO_NAMES, ds.feature_len, ds.n_classes)


def resnet_families(ds):
    """RESNET8/20/50 (width 16, the 50 with bottlenecks) as a plain
    mapping of cohort builders."""
    from repro_torch.models import (RESNET8, RESNET20, RESNET50,
                                    resnet1d_family)
    return {cfg.name: resnet1d_family(cfg)
            for cfg in (RESNET8, RESNET20, RESNET50)}


# phase 18: each query workload (label, workload, batch policy) runs on
# phase 14's straggler regime (quorum fires, delta rounds) to
# ASYNC_UNTIL; then QueryEngine.serve is timed at these buckets
SERVE_REGIME = "straggler"
SERVE_BUCKETS = (1, 8, 32, 128)
RECORD_KEYS = ("seq", "client_id", "t_arrival", "t_served", "version",
               "staleness", "batch_size", "buckets", "depth_at_admission")


def serve_runs():
    from repro_torch.serve import DiurnalQueries, MicroBatch, PoissonQueries
    return (("poisson-micro8", PoissonQueries(rate=0.5), "micro:8"),
            ("diurnal-burst-micro16", DiurnalQueries(burst_frac=0.5),
             MicroBatch(max_batch=16, max_wait=0.25)))


def serve_run(dev, inputs, workload, policy, logits_out):
    """Phase 14's asynchronous federation of SERVE_REGIME on ``dev`` with
    a QueryRuntime on its clock, run to ASYNC_UNTIL; every served batch's
    logits go to ``logits_out``."""
    from repro_torch.serve import QueryRuntime, split_query_stream
    eng = async_federation(dev, inputs, SERVE_REGIME, [])
    qr = QueryRuntime(eng, workload=workload, policy=policy,
                      features=split_query_stream(inputs[1]))
    serve = qr.qengine.serve

    def keeping(*args, **kw):
        res = serve(*args, **kw)
        logits_out.append(res.logits)
        return res

    qr.qengine.serve = keeping
    qr.run(inputs[1], until=ASYNC_UNTIL)
    return qr


def hold_records(card, cpu, card_logits, cpu_logits) -> dict:
    """The card's serving records against the CPU run's: every field of
    RECORD_KEYS equal, served logits within phase 14's 1e-2, and a
    prediction differing only where the CPU's top two logits are within
    twice that."""
    check(len(card.records) == len(cpu.records) > 0,
          f"{len(card.records)} records on the card, {len(cpu.records)} on "
          f"the CPU")
    for a, b in zip(card.records, cpu.records):
        for key in RECORD_KEYS:
            check(a[key] == b[key], f"record {a['seq']}: {key} {a[key]} on "
                                    f"the card, {b[key]} on the CPU")
    check(len(card_logits) == len(cpu_logits), "other batches served")
    g, h = np.concatenate(card_logits), np.concatenate(cpu_logits)
    worst = float(np.abs(g - h).max())
    check(worst < 1e-2, f"served logits differ by {worst:.3e}")
    preds = np.array([[a["pred"], b["pred"]]
                      for a, b in zip(card.records, cpu.records)])
    flip = preds[:, 0] != preds[:, 1]
    top2 = np.sort(h, -1)[:, -2:]
    check(float((top2[:, 1] - top2[:, 0])[flip].max(initial=0.0)) < 2e-2,
          "a served prediction flipped away from a near-tie")
    return {"served_logit_max_abs_diff": worst,
            "near_tie_pred_flips": int(flip.sum())}


def hold_snapshot_forward(qr, splits, dev) -> None:
    """On the final snapshot, each cohort answers a batch of its clients
    with the bits of the same forward on the snapshot's params at the
    same padded shape."""
    from repro_torch.serve import bucket_size, serve_step
    snap = qr.store.current()
    for view in snap.views:
        check(all(p.is_cuda for p in view.params.values()),
              f"{view.family_name}'s snapshot is off the card")
        ids = [int(c) for c in view.client_ids[:5]]
        xs = np.stack([splits[c].test_x[0] for c in ids])
        res = qr.qengine.serve(ids, xs, ASYNC_UNTIL, snapshot=snap)
        pad = bucket_size(len(ids)) - len(ids)
        rows = np.concatenate([snap.row_of[ids], np.zeros(pad, np.int64)])
        xp = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:], xs.dtype)])
        want = serve_step(view.module, view.params,
                          torch.as_tensor(rows, device=dev),
                          torch.as_tensor(xp, dtype=torch.float32,
                                          device=dev))[:len(ids)]
        check(np.array_equal(res.logits, want.cpu().numpy()),
              f"{view.family_name}: served logits differ from the same "
              f"forward on the snapshot's params")


def serve_times(label: str, store, view_index: int, splits,
                iters: int) -> dict:
    """QueryEngine.serve of one cohort's clients at each SERVE_BUCKETS
    batch: back-to-back ms (each call ends in the logits' copy to the
    host), and one call under torch.profiler (device time, kernels a
    call, busy share)."""
    from repro_torch.serve import QueryEngine
    qe = QueryEngine(store)
    view = store.current().views[view_index]
    ids = [int(c) for c in view.client_ids]
    out = {}
    for b in SERVE_BUCKETS:
        cids = [ids[i % len(ids)] for i in range(b)]
        xs = np.stack([splits[c].test_x[i % len(splits[c].test_x)]
                       for i, c in enumerate(cids)])
        res = qe.serve(cids, xs, 0.0)
        check(res.buckets == (b,) and np.isfinite(res.logits).all(),
              f"{label}: bucket {res.buckets} or non-finite logits")
        ms = cuda_ms(lambda: qe.serve(cids, xs, 0.0), iters)
        prof = device_breakdown(f"{label} serve b={b}",
                                lambda: qe.serve(cids, xs, 0.0))
        out[b] = {"ms": ms, "device_ms": prof.get("device_ms"),
                  "kernels": prof.get("n_kernels"),
                  "busy_share": prof.get("busy_share"),
                  "compute_s": res.compute_s}
        print(f"  [{CARD}] {label} serve b={b}: {ms:.3f} ms back to back, "
              f"device {prof.get('device_ms') or 0:.4f} ms in "
              f"{prof.get('n_kernels')} kernels, busy "
              f"{prof.get('busy_share') or 0:.1%}")
    return out


def publish_times(label: str, fed, iters: int) -> dict:
    """One publish (the copy of every cohort's stacked params): its bytes,
    CUDA-event ms back to back and host ms."""
    from repro_torch.serve import SnapshotStore
    store = SnapshotStore()
    ms = cuda_ms(lambda: store.publish(fed, 0.0), iters)
    row = {"bytes": store.publish_bytes, "ms": ms,
           "host_ms": store.publish_s / store.n_published * 1e3}
    print(f"  [{CARD}] {label} publish: {row['bytes'] / 1e6:.2f} MB in "
          f"{ms:.4f} ms back to back (host {row['host_ms']:.4f} ms)")
    return row


def serve_phase(dev, inputs) -> dict:
    """Train and serve: each query workload through QueryRuntime on phase
    14's asynchronous federation, held against its CPU twin (records
    field for field, served logits, the bits of the snapshot's forward),
    with its B1/B2/B3 launches; then QueryEngine.serve and publish times
    for the MLP tiers and for a RESNET50 cohort at full width."""
    from repro_torch.kernels import ops
    from repro_torch.serve import SnapshotStore
    out = {"launches": launches_of()}
    for label, workload, policy in serve_runs():
        print(f"  -- {label}")
        card_logits, cpu_logits = [], []
        ops.reset_launch_counts()
        qr, wall = timed(lambda: serve_run(dev, inputs, workload, policy,
                                           card_logits))
        counts = ops.launch_counts()
        check(all(counts[k] > 0 for k in DENSE_PATH),
              f"a kernel of this path never launched: {counts}")
        check(all(v == 0 for k, v in counts.items() if k not in DENSE_PATH),
              f"a kernel off this path launched: {counts}")
        cpu = serve_run("cpu", inputs, workload, policy, cpu_logits)
        held = hold_records(qr, cpu, card_logits, cpu_logits)
        hold_snapshot_forward(qr, inputs[1], dev)
        s = qr.summary(ASYNC_UNTIL)
        store = qr.store
        row = {"launches": counts, "run_s": wall / 1e3, **held,
               "n_served": s["n_served"], "mean_batch": s["mean_batch"],
               "versions_served": s["versions_served"],
               "staleness_mean": s["staleness_mean"],
               "compute_wall_s": s["compute_wall_s"],
               "snapshots_published": store.n_published,
               "publish_bytes": store.publish_bytes,
               "publish_host_s": store.publish_s,
               "server_rounds": qr.engine.bus.n_triggers}
        print(f"  [{CARD}] {label}: {s['n_served']} queries in "
              f"{qr.engine.bus.n_triggers} server fires, mean batch "
              f"{s['mean_batch']:.2f}, {s['versions_served']} versions "
              f"served, {store.n_published} publishes of "
              f"{store.publish_bytes / 1e3:.1f} kB ({store.publish_s * 1e3:.2f} "
              f"ms host in all); run {wall / 1e3:.3f} s; serve compute "
              f"{s['compute_wall_s'] * 1e3:.2f} ms in all; launches {counts}; "
              f"records equal the CPU's, served logits within "
              f"{held['served_logit_max_abs_diff']:.2e}, "
              f"{held['near_tie_pred_flips']} near-tie flips")
        out[label] = row
        for k in out["launches"]:
            out["launches"][k] += counts[k]
    store = SnapshotStore()
    qr.engine.attach_snapshots(store)
    out["mlp"] = {v.family_name: serve_times(v.family_name, store, i,
                                             inputs[1], iters=20)
                  for i, v in enumerate(store.current().views)}
    out["mlp_publish"] = publish_times("MLP tiers (32 clients)",
                                       qr.engine.fed, iters=20)
    res_inputs = zoo_inputs(resnet_families, None)
    eng = zoo_federation(dev, res_inputs, 1, [])
    store = eng.attach_snapshots(SnapshotStore())
    vi = [v.family_name for v in store.current().views].index("resnet50-1d")
    view = store.current().views[vi]
    per_client = sum(p[0].numel() for p in view.params.values())
    print(f"  RESNET50 cohort: {view.n_real} clients, {per_client} params "
          f"a client")
    out["resnet50"] = {"clients": view.n_real,
                       "params_per_client": per_client,
                       "buckets": serve_times("RESNET50", store, vi,
                                              res_inputs[1], iters=5)}
    out["resnet_publish"] = publish_times("RESNET8/20/50 (32 clients)",
                                          eng.fed, iters=10)
    return out


def checkpoint_phase(dev, inputs) -> dict:
    """Checkpoints on the card: phase 5's federation saved after 2 rounds
    and restored into a card engine built from other weights, whose 3
    more rounds must equal the uninterrupted card run bit for bit; the
    N=4096 server state of phase 4 saved and restored (seconds, MB); a
    file without ``div_cache`` at N=4096, rebuilt on B1 and held against
    the plain ``pairwise_kl``."""
    import tempfile
    from repro_torch.checkpoint import (restore_federation, restore_pytree,
                                        save_federation, save_pytree)
    from repro_torch.core import Federation, init_server, policy_round, sqmd
    from repro_torch.core.policies import as_policy
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import state_tensors
    ds, splits, init_params, draws = inputs
    out = {}
    ops.reset_launch_counts()
    oracle = federation(dev, splits, ds, init_params, draws, [], {})
    first = federation(dev, splits, ds, init_params, draws, [], {})
    for rnd in range(5):
        oracle.run_round(rnd)
    for rnd in range(2):
        first.run_round(rnd)
    other = {fam: {"layers": [{k: v * np.float32(0.5) + np.float32(0.1)
                               for k, v in layer.items()}
                              for layer in tree["layers"]]}
             for fam, tree in init_params.items()}
    resumed = federation(dev, splits, ds, other, draws, [], {})
    with tempfile.TemporaryDirectory() as tmp:
        _, save_ms = timed(lambda: save_federation(
            tmp, first.fed, step=2, bus=first.bus, clients=first.clients))
        _, restore_ms = timed(lambda: restore_federation(
            tmp, resumed.fed, bus=resumed.bus, clients=resumed.clients))
    for rnd in range(2, 5):
        resumed.run_round(rnd)
    counts = ops.launch_counts()
    check(all(counts[k] > 0 for k in DENSE_PATH),
          f"a kernel of this path never launched: {counts}")
    mine = [*resumed.server, resumed.fed.targets]
    want = [*oracle.server, oracle.fed.targets]
    for a, b in zip(oracle.fed.cohorts, resumed.fed.cohorts):
        want += [*a.model.parameters(), *state_tensors(a.opt_state)]
        mine += [*b.model.parameters(), *state_tensors(b.opt_state)]
    check(all(t.is_cuda for t in mine), "a restored tensor is off the card")
    check(all(torch.equal(a, b) for a, b in zip(want, mine)),
          "the resumed card run differs from the uninterrupted one")
    check(resumed.bus.n_triggers == oracle.bus.n_triggers and np.array_equal(
        resumed.bus.bytes_up, oracle.bus.bytes_up), "bus counters differ")
    print(f"  [{CARD}] phase 5's federation saved after 2 rounds "
          f"({save_ms:.1f} ms) and restored into an engine of other weights "
          f"({restore_ms:.1f} ms): its 3 more rounds equal the "
          f"uninterrupted card run bit for bit ({len(mine)} tensors)")
    out["resume"] = {"save_ms": save_ms, "restore_ms": restore_ms,
                     "tensors_equal": len(mine), "launches": counts}

    n, r, c = SERVER
    state, labels = server_repository(dev)
    new, targets, _ = policy_round(state, as_policy(sqmd(q=64, k=8)), labels)

    def server_fed(server, tgt=None):
        return Federation(cohorts=[], server=server, ref_x=labels,
                          ref_y=labels, n_clients=n,
                          generator=torch.Generator(device=dev),
                          targets=tgt)

    big = server_fed(new, targets)
    with tempfile.TemporaryDirectory() as tmp:
        _, save_ms = timed(lambda: save_federation(tmp, big, step=1))
        path = Path(tmp) / "step_1.msgpack"
        mb = path.stat().st_size / 1e6
        fresh = server_fed(init_server(n, r, c, device=dev))
        _, restore_ms = timed(lambda: restore_federation(tmp, fresh,
                                                         step=1))
        check(all(torch.equal(a, b) for a, b in zip(big.server,
                                                    fresh.server))
              and torch.equal(big.targets, fresh.targets),
              f"the N={n} server state did not come back as saved")
        check(all(t.is_cuda for t in fresh.server),
              "a restored server tensor is off the card")
        print(f"  [{CARD}] N={n} server state and targets: {mb:.1f} MB, "
              f"save {save_ms / 1e3:.3f} s, restore onto the card "
              f"{restore_ms / 1e3:.3f} s")
        tree = restore_pytree(str(path))
        del tree["server"]["div_cache"]
        save_pytree(str(Path(tmp) / "legacy" / "step_1.msgpack"), tree)
        del tree
        legacy = server_fed(init_server(n, r, c, device=dev))
        ops.reset_launch_counts()
        _, legacy_ms = timed(lambda: restore_federation(
            str(Path(tmp) / "legacy"), legacy))
        rebuild = ops.launch_counts()
    check(rebuild["pairwise_kl_pair"] > 0 and all(
        v == 0 for k, v in rebuild.items()
        if k not in ("pairwise_kl_split", "pairwise_kl_pair")),
        f"the div_cache rebuild launched {rebuild}")
    lp = legacy.server.repo_logp
    plain = torch.cat([ref.pairwise_kl_pair_ref(lp[i:i + ops.CHUNK_ROWS], lp)
                       for i in range(0, n, ops.CHUNK_ROWS)])
    err, rel = errors(legacy.server.div_cache, plain)
    atol, rtol = TOL["pairwise_kl_pair"]
    check(torch.allclose(legacy.server.div_cache, plain, atol=atol,
                         rtol=rtol), "the rebuilt div_cache disagrees with "
                                     "the plain version")
    same = bool(torch.equal(legacy.server.div_cache, new.div_cache))
    print(f"  [{CARD}] legacy file (no div_cache) at N={n}: restored in "
          f"{legacy_ms / 1e3:.3f} s, B1 rebuilt the cache ({rebuild}); max "
          f"abs err against the plain pairwise_kl {err:.3e} (atol {atol:g}, "
          f"rtol {rtol:g}), bit-equal to the round's cache: {same}")
    launches = {k: counts[k] + rebuild[k] for k in counts}
    out["server_state"] = {"mb": mb, "save_s": save_ms / 1e3,
                           "restore_s": restore_ms / 1e3}
    out["legacy"] = {"restore_s": legacy_ms / 1e3, "launches": rebuild,
                     "max_abs_err": err, "max_rel_err": rel,
                     "equals_round_cache": same}
    out["launches"] = launches
    return out


# phase 20: the LM zoo's serving path at the reference serve CLI's
# defaults (launch/serve.py: batch 4, prompt 64, decode 32): the six
# architectures that fit one card in bf16 at full width; deepseek-67b
# (134.9 GB) and internvl2-76b (141.1 GB) at their published widths with
# only the depth cut to LM_DEPTH_CUT layers (~11 GB each); gemma3-1b also
# with a 600-token prompt, so its 512-slot ring buffers wrap while the
# prefill is packed and again while decoding
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 64, 32
LM_DEPTH_CUT = {"deepseek-67b": 4, "internvl2-76b": 4,
                # phase 21: 93.4 and 478.7 GB of bf16 params at full
                # depth; the phase holds bf16 and an fp32 copy (3x)
                "mixtral-8x7b": 4, "deepseek-v2-236b": 2}
LM_CASES = (("qwen2-0.5b", LM_PROMPT), ("gemma3-1b", LM_PROMPT),
            ("gemma3-1b", 600), ("mamba2-780m", LM_PROMPT),
            ("stablelm-3b", LM_PROMPT), ("musicgen-medium", LM_PROMPT),
            ("recurrentgemma-9b", LM_PROMPT), ("deepseek-67b", LM_PROMPT),
            ("internvl2-76b", LM_PROMPT))
# decode against the teacher-forced forward, as a share of the largest
# forward logit. fp32 within the CPU tests' 1e-4. bf16 within a fixed
# limit per case, about twice its sound reading on the H100 (decode and
# forward each round on their own; mamba2-780m's 48 SSD layers read 0.13,
# as the reference's own bf16 decode drifts: tests/test_torch_lm_bf16.py)
# and far under the control: the forward of the same tokens with the
# first decoded one swapped (0.62-1.28), which must read above the limit
LM_FP32_RTOL = 1e-4
LM_BF16_RTOL = {("qwen2-0.5b", LM_PROMPT): 2e-2,
                ("gemma3-1b", LM_PROMPT): 2e-2, ("gemma3-1b", 600): 3e-2,
                ("mamba2-780m", LM_PROMPT): 0.25,
                ("stablelm-3b", LM_PROMPT): 3.5e-2,
                ("musicgen-medium", LM_PROMPT): 6e-2,
                ("recurrentgemma-9b", LM_PROMPT): 2e-2,
                ("deepseek-67b", LM_PROMPT): 1.5e-2,
                ("internvl2-76b", LM_PROMPT): 1.5e-2,
                # phase 21: bf16 rounding flips experts at near ties (4 of
                # 496 and 6 of 248 decode decisions on the H100), each
                # moving its row's later logits by an expert's share: the
                # whole gap reads 0.442 and 0.259 against controls of 1.22
                # and 1.33 ...
                ("mixtral-8x7b", LM_PROMPT): 0.9,
                ("deepseek-v2-236b", LM_PROMPT): 0.5}
# ... so the steps before a row's first flip are also held on their own,
# to about twice their reading (1.35e-2 and 1.12e-2; controls 1.18, 1.26)
LM_BF16_CLEAN_RTOL = {"mixtral-8x7b": 3e-2, "deepseek-v2-236b": 2.5e-2}
# qwen2-0.5b's fp32 twin: the card's greedy decode against the CPU's
LM_TWIN_STEPS, LM_TWIN_RTOL = 8, 1e-4
# phase 21: the two MoE architectures, at their widths with the depth cut
MOE_CASES = ("mixtral-8x7b", "deepseek-v2-236b")


def lm_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest gap of ``got`` from ``want``, as a share of the largest
    ``want``."""
    return float((got - want).abs().max() / want.abs().max())


@contextlib.contextmanager
def recorded_routes():
    """The expert indices of every MoE routing decision made inside the
    block, in call order: ``repro_torch.models.ffn.route`` wrapped (the
    MoE paths look it up at each call), no sync added."""
    from repro_torch.models import ffn
    seen, plain = [], ffn.route

    def route(p, cfg, x):
        out = plain(p, cfg, x)
        seen.append(out[1])
        return out

    ffn.route = route
    try:
        yield seen
    finally:
        ffn.route = plain


def routing_disagreements(served, taught, n_layers: int, length: int):
    """Where a ``serve`` run's experts differ from the teacher-forced
    forward's at the same position: ``served`` the run's routes (the
    prefill's layers, then each decode step's), ``taught`` the forward's,
    one per layer. Returns the decode decisions that differ, the decode
    decisions compared, the prefill's (row, position) pairs that differ
    at some layer, and each row's first position that differs at some
    layer (the sequence's length where none does): a flipped expert
    moves that row's later logits by a whole expert's share."""
    steps = len(served) // n_layers - 1
    rows = served[0].shape[0]
    differs = torch.zeros((rows, length + steps), dtype=torch.bool,
                          device=served[0].device)

    def other(a, b):
        return (a.sort(-1).values != b.sort(-1).values).any(-1)

    decode = 0
    for layer in range(n_layers):
        differs[:, :length] |= other(served[layer],
                                     taught[layer][:, :length])
        for j in range(steps):
            d = other(served[(j + 1) * n_layers + layer][:, 0],
                      taught[layer][:, length + j])
            differs[:, length + j] |= d
            decode += int(d.sum())
    at = torch.arange(length + steps, device=differs.device)
    first = torch.where(differs, at, length + steps).amin(dim=1)
    return {"differ": decode, "decisions": steps * n_layers * rows,
            "prefill_differ": int(differs[:, :length].sum()),
            "first": first}


def routed_bytes(params, cfg, step_routes, cache_bytes: int) -> tuple:
    """The bytes one decode step must move when it reads only the experts
    it routes to (each once, however many rows chose it), the embedding's
    rows of the step's tokens and everything else once, plus the cache;
    and the routed experts per layer."""
    from repro_torch.models.common import tree_leaves
    total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    ffns = ([params["groups"][k]["ffn"] for k in params["groups"]]
            + [p["ffn"] for p in params["rem"]])
    experts = [f[w] for f in ffns for w in ("w_gate", "w_up", "w_down")]
    total -= sum(t.numel() * t.element_size() for t in experts)
    embed = params["embed"]
    if not cfg.tie_embeddings:
        total -= (embed.shape[0] - LM_BATCH) * embed.shape[1] \
            * embed.element_size()
    per_expert = 3 * cfg.d_model * cfg.d_ff * embed.element_size()
    routed = [int(torch.unique(idx).numel()) for idx in step_routes]
    return total + sum(routed) * per_expert + cache_bytes, routed


def lm_case(dev, arch: str, prompt_len: int) -> dict:
    """``serve`` on one case in bf16 and in fp32 (the same params, cast):
    each run's decode held against its own teacher-forced ``forward``
    (the MoE FFN on the dropless path: GShard drops choices at these
    shapes); the bf16 run timed (after a 2-token warm-up at its shapes),
    one of its decode steps under the profiler. With experts, also the
    routing decisions where decode and the teacher disagree, and the
    step's bytes bound over the experts it routes to."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.frontends import frontend_dim
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_params)
    cfg = get_config(arch)
    if arch in LM_DEPTH_CUT:
        cfg = dataclasses.replace(cfg, n_layers=LM_DEPTH_CUT[arch])
    gen = torch.Generator(device=dev).manual_seed(20)
    params = init_params(cfg, dev, gen)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, prompt_len),
                            generator=gen, dtype=torch.int32, device=dev)
    embeds = None
    if cfg.frontend is not None:
        embeds = torch.randn((LM_BATCH, 8, frontend_dim(cfg.frontend)),
                             generator=gen, device=dev).to(cfg.param_dtype)
    cut = f" ({cfg.n_layers} layers)" if arch in LM_DEPTH_CUT else ""
    label = f"{arch}{cut}, prompt {prompt_len}"
    length = prompt_len + (0 if embeds is None else embeds.shape[1])
    # serve's cache holds prompt + decode positions; a frontend's frames
    # come first, so its last steps overwrite the last slot (as the
    # reference's do): decode is held where the cache holds every position
    held = min(LM_DECODE, prompt_len + LM_DECODE - length + 1)

    def run(p, decode_len=LM_DECODE):
        return serve(arch, batch=LM_BATCH, prompt_len=prompt_len,
                     decode_len=decode_len, device=dev, params=p,
                     prompts=prompts, embeds=embeds, cfg=cfg, verbose=False,
                     keep_logits=True)

    def teacher(p, c, toks):
        full, _ = forward(p, c, tokens=torch.cat([prompts, toks[:, :-1]],
                                                 dim=1), embeds=embeds,
                          moe_path="dropless")
        return full[:, length - 1:length - 1 + held]

    def served_and_taught(p, c):
        """A serve run, its teacher-forced logits, and (with experts)
        their routing disagreements."""
        with recorded_routes() as served:
            r = run(p)
        with recorded_routes() as taught:
            want = teacher(p, c, r["tokens"])
        if not c.is_moe:
            return r, want, None
        return r, want, routing_disagreements(served, taught, c.n_layers,
                                              length)

    ops.reset_launch_counts()
    DROPLESS.reset()
    p32 = tree_map(lambda t: t.float(), params)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
    r32, want, routes32 = served_and_taught(p32, cfg32)
    fp32 = lm_gap(r32["logits"][:, :held], want)
    del r32
    run(params, decode_len=2)
    r16, want, routes16 = served_and_taught(params, cfg)
    routes = {"fp32": routes32, "bf16": routes16} if cfg.is_moe else {}
    got = r16["logits"][:, :held]
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
    bf16 = lm_gap(got, want)
    if cfg.is_moe:
        # the bf16 steps before a row's first flipped expert (at any
        # layer, prefill included): there bf16 rounding alone separates
        # decode from the teacher, so they are held to a dense case's
        # limit, beside the whole gap's
        clean = (torch.arange(held, device=dev) + length - 1)[None, :] \
            < routes16["first"][:, None]
        check(bool(clean.any()), f"{label}: every bf16 step follows a "
                                 f"flipped expert")
        gap = (got - want).abs().amax(dim=-1)
        clean_bf16 = float(gap[clean].max() / want.abs().max())
    # bf16's own drift: the bf16 forward against the fp32 forward of the
    # same params and tokens (a reading, not a limit)
    drift = lm_gap(want, teacher(p32, cfg32, r16["tokens"]))
    del p32
    swapped = r16["tokens"].clone()
    swapped[:, 0] = (swapped[:, 0] + 1) % cfg.vocab_size
    control_logits = teacher(params, cfg, swapped)
    control = lm_gap(got, control_logits)
    counts = ops.launch_counts()
    kernel_routes = ops.route_counts()
    moe_launches = DROPLESS.hold(label, counts)
    check(DROPLESS.calls > 0 or not cfg.is_moe,
          f"{label}: no dropless MoE forward ran on the card")
    check(kernel_routes["ragged_dot.tma"] > 0 or not cfg.is_moe,
          f"{label}: the bf16 dropless forward at the published widths "
          f"did not take ragged_dot's Hopper route ({kernel_routes})")
    limit = LM_BF16_RTOL[(arch, prompt_len)]
    check(fp32 <= LM_FP32_RTOL,
          f"{label}: fp32 decode is {fp32:.3e} off its forward")
    check(bf16 <= limit, f"{label}: bf16 decode is {bf16:.3e} off its "
                         f"forward (limit {limit:g})")
    check(control > limit, f"{label}: the control (one token swapped) "
                           f"reads {control:.3e}, within the limit {limit:g}")
    if cfg.is_moe:
        clean_limit = LM_BF16_CLEAN_RTOL[arch]
        gap = (got - control_logits).abs().amax(dim=-1)
        clean_control = float(gap[clean].max() / want.abs().max())
        check(clean_bf16 <= clean_limit,
              f"{label}: bf16 decode before a flipped expert is "
              f"{clean_bf16:.3e} off its forward (limit {clean_limit:g})")
        check(clean_control > clean_limit,
              f"{label}: the control before a flipped expert reads "
              f"{clean_control:.3e}, within the limit {clean_limit:g}")
    del control_logits
    cache = r16["cache"]
    with recorded_routes() as step_routes:
        prof = device_breakdown(f"{label}: one decode step",
                                lambda: decode_step(params, cfg,
                                                    r16["tokens"][:, -1:],
                                                    cache))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(cache))
    bound_ms = (param_bytes + cache_bytes) / PEAK_BYTES * 1e3
    ms_tok = r16["decode_s"] / (LM_DECODE - 1) * 1e3
    moe_text = ""
    out = {}
    if cfg.is_moe:
        step_bytes, routed = routed_bytes(params, cfg, step_routes,
                                          cache_bytes)
        disagree = {k: {"differ": r["differ"], "decisions": r["decisions"],
                        "prefill_differ": r["prefill_differ"]}
                    for k, r in routes.items()}
        out.update(routed_bound_ms=step_bytes / PEAK_BYTES * 1e3,
                   routed_experts=routed, routing_disagreements=disagree,
                   bf16_clean_steps=int(clean.sum()),
                   bf16_clean_err=clean_bf16,
                   bf16_clean_limit=clean_limit,
                   bf16_clean_control=clean_control)
        moe_text = (f"; routed bytes bound {out['routed_bound_ms']:.4f} ms "
                    f"({step_bytes / 1e9:.3f} GB: {routed} of "
                    f"{cfg.n_experts} experts routed a layer, the "
                    f"embedding's {LM_BATCH} rows); decode's routing "
                    f"decisions that differ from the teacher's: "
                    + ", ".join(f"{k} {r['differ']} of {r['decisions']} "
                                f"(prefill positions {r['prefill_differ']})"
                                for k, r in disagree.items())
                    + f"; bf16 over the {int(clean.sum())} (row, step) "
                    f"pairs before a row's first flip: {clean_bf16:.3e} "
                    f"(limit {clean_limit:g}; control {clean_control:.3e})"
                    f"; {moe_launches}")
    print(f"  [{CARD}] {label}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{param_bytes / 1e9:.3f} GB of bf16 params; prefill "
          f"{r16['prefill_s']:.4f} s; decode {ms_tok:.3f} ms/token back "
          f"to back; one step: "
          f"device {prof['device_ms']} ms, {prof.get('n_kernels')} kernels, "
          f"busy {prof.get('busy_share')}; bytes bound {bound_ms:.4f} ms "
          f"(params + cache {cache_bytes / 1e6:.2f} MB over 3.35 TB/s)"
          f"{moe_text}; "
          f"decode vs forward over {held} steps: bf16 {bf16:.3e} (limit "
          f"{limit:g}; control {control:.3e}; bf16 forward vs fp32 "
          f"{drift:.3e}), fp32 {fp32:.3e} (limit {LM_FP32_RTOL:g})")
    out.update({"label": label, "n_layers": cfg.n_layers,
                "d_model": cfg.d_model,
                "vocab": cfg.vocab_size, "param_gb": param_bytes / 1e9,
                "cache_mb": cache_bytes / 1e6, "prefill_s": r16["prefill_s"],
                "decode_ms_per_token": ms_tok,
                "step_device_ms": prof["device_ms"],
                "step_kernels": prof.get("n_kernels"),
                "step_busy_share": prof.get("busy_share"),
                "step_wall_ms": prof["wall_ms"], "bound_ms": bound_ms,
                "held_steps": held, "bf16_err": bf16, "bf16_limit": limit,
                "bf16_control": control, "bf16_forward_drift": drift,
                "fp32_err": fp32, "launches": counts,
                "routes": kernel_routes})
    del params, r16, cache, got, want
    torch.cuda.empty_cache()
    return out


def lm_twin(dev) -> dict:
    """qwen2-0.5b at full width in fp32, params drawn on the CPU and
    moved to the card: LM_TWIN_STEPS greedy tokens through ``serve`` on
    both devices."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(21)
    params = init_params(cfg, "cpu", gen)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, dtype=torch.int32)

    def run(p, device):
        return serve("qwen2-0.5b", reduced=False, batch=LM_BATCH,
                     prompt_len=LM_PROMPT, decode_len=LM_TWIN_STEPS,
                     device=device, params=p, prompts=prompts,
                     verbose=False, keep_logits=True)

    t0 = time.perf_counter()
    cpu = run(params, "cpu")
    cpu_s = time.perf_counter() - t0
    card = run(tree_map(lambda t: t.to(dev), params), dev)
    err = lm_gap(card["logits"].cpu(), cpu["logits"])
    same = bool(torch.equal(card["tokens"].cpu(), cpu["tokens"]))
    check(same, "qwen2-0.5b fp32: the card's greedy tokens differ from the "
                "CPU's")
    check(err <= LM_TWIN_RTOL, f"qwen2-0.5b fp32: card logits {err:.3e} "
                               f"off the CPU's")
    print(f"  [{CARD}] qwen2-0.5b fp32 twin ({LM_TWIN_STEPS} tokens, CPU "
          f"run {cpu_s:.1f} s): tokens equal the CPU's; logits within "
          f"{err:.3e} of the largest (limit {LM_TWIN_RTOL:g})")
    return {"tokens_equal": same, "max_rel_err": err, "cpu_s": cpu_s}


def moe_twin(dev, arch: str) -> dict:
    """``arch``'s reduced config in fp32, params drawn on the CPU and
    moved to the card: LM_TWIN_STEPS greedy tokens through ``serve`` on
    both devices (the prefill dropless), then ``forward`` on the GShard
    path; tokens, every routing decision's experts, logits and the aux
    loss held card against CPU."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import serve
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import forward, init_params
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(22)
    params = init_params(cfg, "cpu", gen)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, dtype=torch.int32)
    runs = {}
    for where, p in (("cpu", params),
                     ("card", tree_map(lambda t: t.to(dev), params))):
        device = "cpu" if where == "cpu" else dev
        with recorded_routes() as routes:
            out = serve(arch, batch=LM_BATCH, prompt_len=LM_PROMPT,
                        decode_len=LM_TWIN_STEPS, device=device, params=p,
                        prompts=prompts, cfg=cfg, verbose=False,
                        keep_logits=True)
            logits, aux = forward(p, cfg, tokens=prompts.to(device),
                                  moe_path="gshard")
        runs[where] = {"tokens": out["tokens"].cpu(),
                       "logits": out["logits"].cpu(),
                       "routes": [r.cpu() for r in routes],
                       "gshard": logits.cpu(), "aux": float(aux)}
    cpu, card = runs["cpu"], runs["card"]
    same_tokens = bool(torch.equal(card["tokens"], cpu["tokens"]))
    same_routes = (len(card["routes"]) == len(cpu["routes"]) and all(
        torch.equal(a, b) for a, b in zip(card["routes"], cpu["routes"])))
    err = lm_gap(card["logits"], cpu["logits"])
    gshard = lm_gap(card["gshard"], cpu["gshard"])
    aux = abs(card["aux"] - cpu["aux"]) / abs(cpu["aux"])
    label = f"{cfg.name} fp32 twin"
    check(same_tokens, f"{label}: the card's greedy tokens differ from the "
                       f"CPU's")
    check(same_routes, f"{label}: the card routes tokens to other experts "
                       f"than the CPU")
    check(err <= LM_TWIN_RTOL and gshard <= LM_TWIN_RTOL,
          f"{label}: card logits {err:.3e} (serve), {gshard:.3e} (GShard "
          f"forward) off the CPU's")
    check(aux <= 1e-5, f"{label}: the aux loss is {aux:.3e} off the CPU's")
    n = sum(r.numel() // r.shape[-1] for r in cpu["routes"])
    print(f"  [{CARD}] {label} ({LM_TWIN_STEPS} tokens): tokens and all "
          f"{n} routing decisions equal the CPU's; logits within {err:.3e} "
          f"of the largest, the GShard forward within {gshard:.3e} (limit "
          f"{LM_TWIN_RTOL:g}), its aux loss {aux:.3e} off")
    return {"tokens_equal": same_tokens, "routes_equal": same_routes,
            "decisions": n, "max_rel_err": err, "gshard_rel_err": gshard,
            "aux_rel_err": aux}


def print_depth_cut(arch: str) -> None:
    """Print why ``arch`` runs with its depth cut, and its widths."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    full = get_config(arch)
    n = full.param_count(init_params(full, device="meta"))
    experts = (f", {full.n_experts} experts of d_ff {full.d_ff}, top "
               f"{full.moe_top_k}, {full.n_shared_experts} shared"
               if full.is_moe else f", d_ff {full.d_ff}")
    print(f"  {arch}: {n * 2 / 1e9:.1f} GB of bf16 params at "
          f"{full.n_layers} layers do not fit one 80 GB card: its published "
          f"widths (d_model {full.d_model}, {full.n_heads} heads, "
          f"{full.n_kv_heads} kv{experts}, vocab {full.vocab_size}) run "
          f"with the depth cut to {LM_DEPTH_CUT[arch]} layers; a step's "
          f"share outside the layers (embedding, head, the host's per-step "
          f"work) is larger than at full depth")


def moe_serving_phase(dev) -> dict:
    """MoE and MLA serving: mixtral-8x7b and deepseek-v2-236b at their
    published widths, the depth cut, through phase 20's case runner; the
    reduced configs' fp32 twins against the CPU. Every dropless MoE layer
    forward on the card launches ragged_dot 3 times, and nothing else of
    the port launches (``DroplessCalls.hold``)."""
    from repro_torch.kernels import ops
    check(torch.get_float32_matmul_precision() == "highest",
          "fp32 matmuls may run in TF32: MoE routing needs IEEE fp32")
    out = {"cases": []}
    for arch in MOE_CASES:
        print_depth_cut(arch)
        out["cases"].append(lm_case(dev, arch, LM_PROMPT))
    ops.reset_launch_counts()
    DROPLESS.reset()
    t0 = time.perf_counter()
    out["twins"] = {arch: moe_twin(dev, arch) for arch in MOE_CASES}
    out["twins_s"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"  the MoE twins: {DROPLESS.hold('the MoE twins', counts)}; "
          f"{out['twins_s']:.1f} s")
    check(DROPLESS.calls > 0, "the MoE twins ran no dropless forward")
    check(ops.route_counts()["ragged_dot.tf32"] == counts["ragged_dot"],
          f"the MoE twins' fp32 dropless forwards did not all take the fp32 "
          f"Hopper route ({ops.route_counts()}, {counts})")
    out["launches"] = {name: n + sum(c["launches"][name]
                                     for c in out["cases"])
                       for name, n in counts.items()}
    out["routes"] = {name: n + sum(c["routes"][name] for c in out["cases"])
                     for name, n in ops.route_counts().items()}
    return out


def lm_serving_phase(dev) -> dict:
    """The LM zoo's serving path: each case through ``serve`` in bf16 and
    fp32, held against its forward, timed, one step under the profiler;
    the depth cuts printed; qwen2-0.5b's fp32 twin against the CPU."""
    from repro_torch.launch.steps import greedy_sample
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the fp32 holds need IEEE fp32 products")
    # greedy ties go to the first maximum, as jnp.argmax's
    ties = torch.zeros((LM_BATCH, 1, 151936), device=dev)
    ties[:, :, [7, 4000, 151935]] = 1.0
    check(bool((greedy_sample(ties) == 7).all()),
          "greedy_sample on the card breaks a tie past the first maximum")
    out = {"cases": []}
    for arch, prompt_len in LM_CASES:
        if arch in LM_DEPTH_CUT:
            print_depth_cut(arch)
        out["cases"].append(lm_case(dev, arch, prompt_len))
    out["qwen2_fp32_twin"] = lm_twin(dev)
    return out


# phase 22: LM training on the card. The twins: every architecture's
# reduced config in fp32 takes TRAIN_TWIN_STEPS ``make_train_step`` steps
# on the card and on the CPU from the same params and batches (Adam,
# warmup-cosine, clip 1.0): the MoE architectures on both paths, every
# case without and with remat, mixtral-smoke's GShard also with 2
# microbatches
TRAIN_TWIN_STEPS, TRAIN_TWIN_BATCH, TRAIN_TWIN_SEQ = 3, 4, 32
TRAIN_TWIN_LR = 1e-3
TRAIN_TWIN_MICROBATCHES = ("mixtral-8x7b", "gshard")
# card against CPU, fixed before the first run: each step's ce and gnorm
# within these shares of the CPU's, the first step's grads per leaf
# within this share of the leaf's largest CPU grad (fp32 sums in other
# orders; the CPU tests hold the port's grads to the reference's at 1e-4)
TRAIN_TWIN_CE_RTOL, TRAIN_TWIN_GNORM_RTOL = 1e-4, 1e-3
TRAIN_TWIN_GRAD_RTOL = 1e-4
# the twins' norm scales, biases and recurrence vectors are moved off
# their init by N(0, 0.1), as the CPU tests move the reference's
NUDGED = {"scale", "bq", "bk", "bv", "conv_b", "b_a", "b_i", "dt_bias",
          "a_log", "d_skip", "norm_scale"}
# qwen2-0.5b at full width through train(), bf16: the reference train
# CLI's batch and sequence, 30 steps at lr 1e-3, held to the reference
# test's criterion (tests/test_models.py: final ce < initial ce - 0.3)
TRAIN_FULL_ARCH, TRAIN_FULL_STEPS, TRAIN_FULL_LR = "qwen2-0.5b", 30, 1e-3
TRAIN_FULL_DROP = 0.3
TRAIN_BATCH, TRAIN_SEQ = 8, 128
# the other architectures in bf16, TRAIN_OTHER_STEPS steps each: three at
# full width, six at their published widths with the depth cut to the
# most layers whose params take at most TRAIN_MEM_BUDGET at Adam's
# ADAM_BYTES a param (bf16 params and grads, old and new fp32 moments,
# fp32 updates), one layer at least; where one layer's Adam step would
# pass TRAIN_ADAM_LIMIT (internvl2-76b's 71 GB, deepseek-v2-236b's 120 GB)
# the case takes SGD steps, ~10 B a param
TRAIN_OTHER_FULL = ("gemma3-1b", "mamba2-780m", "musicgen-medium")
TRAIN_OTHER_CUT = ("stablelm-3b", "recurrentgemma-9b", "deepseek-67b",
                   "internvl2-76b", "mixtral-8x7b", "deepseek-v2-236b")
TRAIN_OTHER_STEPS, TRAIN_OTHER_LR = 3, 3e-4
TRAIN_MEM_BUDGET, TRAIN_ADAM_LIMIT, ADAM_BYTES = 40e9, 60e9, 24
# Adam's first step moves an element with a nonzero grad by about lr
# (TRAIN_OTHER_LR), over two bf16 spacings wherever |p| <= 2^-6
ADAM_MOVABLE = 2.0 ** -6
PEAK_BF16_FLOPS = 989e12       # bf16 tensor cores, dense


def nudged_params(cfg, seed: int):
    """``cfg``'s params drawn on the CPU from ``seed``, the vectors in
    NUDGED moved by numpy N(0, 0.1)."""
    from repro_torch.models.transformer import init_params
    rng = np.random.default_rng(seed)

    def nudge(node, key=None):
        if isinstance(node, dict):
            return {k: nudge(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [nudge(v) for v in node]
        if key in NUDGED:
            noise = torch.from_numpy(0.1 * rng.normal(size=tuple(node.shape)))
            return (node.double() + noise).to(node.dtype)
        return node

    return nudge(init_params(cfg, "cpu", torch.Generator().manual_seed(seed)))


def train_twin(dev, arch: str, moe_path: str, remat: bool,
               microbatches: int) -> dict:
    """``arch``'s reduced config in fp32: the first step's grads and
    TRAIN_TWIN_STEPS train steps on the card and on the CPU, from the
    same params and batches; the routing decisions too (with experts)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import lm_token_stream
    from repro_torch.launch.steps import lm_value_and_grad, make_train_step
    from repro_torch.launch.train import train_batches
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adam, single_model, warmup_cosine
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=torch.float32)
    params = nudged_params(cfg, 24)
    gen = torch.Generator().manual_seed(25)
    stream = lm_token_stream(cfg.vocab_size, 4096, gen, "cpu")
    it = train_batches(cfg, stream, TRAIN_TWIN_BATCH, TRAIN_TWIN_SEQ, 26, gen)
    batches = [next(it) for _ in range(TRAIN_TWIN_STEPS)]
    runs = {}
    for where, device in (("cpu", torch.device("cpu")), ("card", dev)):
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        p = tree_map(lambda t: t.to(device), params)
        bs = [{n: v.to(device) for n, v in b.items()} for b in batches]
        opt = single_model(adam(warmup_cosine(TRAIN_TWIN_LR, 0,
                                              TRAIN_TWIN_STEPS)))
        state = opt.init(p)
        step = make_train_step(cfg, opt, moe_path=moe_path, remat=remat,
                               microbatches=microbatches)
        with recorded_routes() as routes:
            _, _, _, grads = lm_value_and_grad(p, cfg, bs[0], moe_path,
                                               remat)
            metrics = []
            for b in bs:
                p, state, m = step(p, state, b)
                metrics.append({n: float(v) for n, v in m.items()})
        on = all(t.device.type == device.type for t in
                 tree_leaves(p) + tree_leaves(list(state)))
        runs[where] = {"grads": [g.cpu() for g in grads],
                       "metrics": metrics, "on_device": on,
                       "routes": [r.cpu() for r in routes]}
    peak = torch.cuda.max_memory_allocated() / 1e9
    cpu, card = runs["cpu"], runs["card"]
    label = (f"{cfg.name} fp32 twin ({moe_path if cfg.is_moe else 'dense'}"
             f", remat={remat}, microbatches={microbatches})")
    check(card["on_device"] and cpu["on_device"],
          f"{label}: a param or optimizer tensor left its device")
    ce = max(abs(a["ce"] - b["ce"]) / abs(b["ce"])
             for a, b in zip(card["metrics"], cpu["metrics"]))
    gnorm = max(abs(a["gnorm"] - b["gnorm"]) / abs(b["gnorm"])
                for a, b in zip(card["metrics"], cpu["metrics"]))
    grad = max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
               for a, b in zip(card["grads"], cpu["grads"]))
    same_routes = (len(card["routes"]) == len(cpu["routes"]) and all(
        torch.equal(a, b) for a, b in zip(card["routes"], cpu["routes"])))
    check(ce <= TRAIN_TWIN_CE_RTOL and gnorm <= TRAIN_TWIN_GNORM_RTOL,
          f"{label}: per-step ce {ce:.3e}, gnorm {gnorm:.3e} off the CPU's "
          f"(limits {TRAIN_TWIN_CE_RTOL:g}, {TRAIN_TWIN_GNORM_RTOL:g})")
    check(grad <= TRAIN_TWIN_GRAD_RTOL,
          f"{label}: first-step grads {grad:.3e} off the CPU's (limit "
          f"{TRAIN_TWIN_GRAD_RTOL:g})")
    check(same_routes, f"{label}: the card routes tokens to other experts "
                       f"than the CPU")
    decisions = sum(r.numel() // r.shape[-1] for r in cpu["routes"])
    print(f"  {label}: ce {[round(m['ce'], 4) for m in card['metrics']]}, "
          f"within {ce:.2e} of the CPU's per step, gnorm {gnorm:.2e}, "
          f"first-step grads {grad:.2e}"
          + (f", all {decisions} routing decisions equal" if decisions
             else "") + f"; peak on the card {peak:.4f} GB")
    return {"label": label, "ce_rel": ce, "gnorm_rel": gnorm,
            "grad_rel": grad, "routing_decisions": decisions,
            "ce": [m["ce"] for m in card["metrics"]], "peak_gb": peak}


def train_bounds(params, tied: bool, tokens: int) -> dict:
    """A train step's least time on the card, two readings: every FLOP
    at the bf16 tensor-core peak; and the head's at the fp32 peak, as
    ``lm_logits`` upcasts both operands. 6 FLOPs a param a token
    (forward 2, backward 4), attention's score products left out; the
    embedding's lookup none, a tied embedding's as the head."""
    from repro_torch.models.common import tree_leaves
    total = sum(t.numel() for t in tree_leaves(params))
    head = params["embed" if tied else "lm_head"].numel()
    body = total - params["embed"].numel() - (0 if tied else head)
    flops_body, flops_head = 6 * body * tokens, 6 * head * tokens
    return {"params": total, "body_params": body, "head_params": head,
            "flops": flops_body + flops_head,
            "bound_bf16_ms": (flops_body + flops_head) / PEAK_BF16_FLOPS * 1e3,
            "bound_fp32_head_ms": (flops_body / PEAK_BF16_FLOPS
                                   + flops_head / PEAK_FP32_FLOPS) * 1e3,
            "adam_bytes_ms": ADAM_BYTES * total / PEAK_BYTES * 1e3}


def train_full(dev) -> dict:
    """qwen2-0.5b at full width through ``train()`` (bf16): the
    criterion, ms a step after 2 warm-up steps, peak memory, the
    checkpoint's save and a restore onto the card (bits equal), then one
    step of a fresh Adam on the trained params under the profiler,
    beside the step's bounds."""
    import os
    import tempfile
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_tree_from_numpy
    from repro_torch.data import lm_token_stream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train, train_batches
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adam, single_model, warmup_cosine
    cfg = get_config(TRAIN_FULL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = train(TRAIN_FULL_ARCH, reduced=False, steps=TRAIN_FULL_STEPS,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_FULL_LR,
                    device=dev, verbose=False, ckpt=tmp)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        params, losses = out["params"], out["losses"]
        label = (f"{TRAIN_FULL_ARCH} bf16 ({cfg.n_layers} layers, d_model "
                 f"{cfg.d_model}, vocab {cfg.vocab_size}), batch "
                 f"{TRAIN_BATCH} x seq {TRAIN_SEQ}")
        check(all(np.isfinite(losses)), f"{label}: a non-finite loss")
        check(out["final_ce"] < out["initial_ce"] - TRAIN_FULL_DROP,
              f"{label}: ce {out['initial_ce']:.4f} -> {out['final_ce']:.4f}"
              f" in {TRAIN_FULL_STEPS} steps, not below initial - "
              f"{TRAIN_FULL_DROP}")
        path = os.path.join(tmp, "again.msgpack")
        _, save_ms = timed(lambda: save_pytree(path, {"params": params,
                                                      "losses": losses}))
        mb = os.path.getsize(path) / 1e6
        restored, restore_ms = timed(lambda: lm_tree_from_numpy(
            restore_pytree(path)["params"], dev))
        own = lm_tree_from_numpy(restore_pytree(os.path.join(
            tmp, f"step_{TRAIN_FULL_STEPS}.msgpack"))["params"], dev)
        for tree in (restored, own):
            check(all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(tree), tree_leaves(params))),
                  f"{label}: a restored checkpoint differs from the params")
        del restored, own
    step_ms = float(np.mean(out["step_s"][2:])) * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    gen = torch.Generator(device=dev).manual_seed(28)
    opt = single_model(adam(warmup_cosine(TRAIN_FULL_LR, 3, 30)))
    state = opt.init(params)
    step = make_train_step(cfg, opt, moe_path="dropless", remat=False)
    it = train_batches(cfg, lm_token_stream(cfg.vocab_size, 200_000, gen,
                                            dev), TRAIN_BATCH, TRAIN_SEQ, 0,
                       gen)
    step(params, state, next(it))              # warm-up
    b = next(it)
    prof = device_breakdown(f"{TRAIN_FULL_ARCH} one train step",
                            lambda: step(params, state, b))
    bounds = train_bounds(params, cfg.tie_embeddings, TRAIN_BATCH * TRAIN_SEQ)
    print(f"  [{CARD}] {label}: ce {out['initial_ce']:.4f} -> "
          f"{out['final_ce']:.4f} in {TRAIN_FULL_STEPS} steps (lr "
          f"{TRAIN_FULL_LR:g}); {step_ms:.2f} ms a step back to back after "
          f"2 warm-up steps (train(), one host sync a step), {tok_s:.0f} "
          f"tokens/s; train() {wall:.2f} s; peak memory "
          f"{peak / 1e9:.2f} GB; one step under the profiler: device "
          f"{prof['device_ms']} ms, {prof.get('n_kernels')} kernels, busy "
          f"{prof.get('busy_share')}; bound {bounds['bound_bf16_ms']:.3f} ms "
          f"(6 x {bounds['body_params'] / 1e6:.1f} M + 6 x "
          f"{bounds['head_params'] / 1e6:.1f} M head params x "
          f"{TRAIN_BATCH * TRAIN_SEQ} tokens = {bounds['flops']:.3e} FLOPs "
          f"at 989 TFLOP/s bf16), {bounds['bound_fp32_head_ms']:.3f} ms "
          f"with the upcast head's FLOPs at 67 TFLOP/s fp32; Adam's "
          f"{ADAM_BYTES} B a param over 3.35 TB/s "
          f"{bounds['adam_bytes_ms']:.3f} ms; checkpoint {mb:.1f} MB saved "
          f"in {save_ms / 1e3:.3f} s, restored onto the card in "
          f"{restore_ms / 1e3:.3f} s, bits equal")
    del params, state, out
    torch.cuda.empty_cache()
    return {"label": label, "losses": losses, "step_ms": step_ms,
            "tokens_per_s": tok_s, "train_s": wall, "peak_gb": peak / 1e9,
            "step_device_ms": prof["device_ms"],
            "step_kernels": prof.get("n_kernels"),
            "step_busy_share": prof.get("busy_share"),
            "step_wall_ms": prof["wall_ms"], "ckpt_mb": mb,
            "save_s": save_ms / 1e3, "restore_s": restore_ms / 1e3,
            **bounds}


def train_depth(cfg) -> tuple:
    """The most layers (one at least) whose params take at most
    TRAIN_MEM_BUDGET at ADAM_BYTES a param, and the params of that cut
    and of the full depth."""
    from repro_torch.models.transformer import init_params

    def count(n):
        c = dataclasses.replace(cfg, n_layers=n)
        return c.param_count(init_params(c, device="meta"))

    n = 1
    while n < cfg.n_layers and ADAM_BYTES * count(n + 1) <= TRAIN_MEM_BUDGET:
        n += 1
    return n, count(n), count(cfg.n_layers)


def train_other(dev, arch: str) -> dict:
    """``arch`` in bf16 at its published widths (the depth cut where it
    does not fit): TRAIN_OTHER_STEPS train steps on the card, the MoE
    FFN dropless; the loss finite, the params moved, ms a step (the last
    two), peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_token_stream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_batches
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adam, sgd, single_model, warmup_cosine
    cfg = get_config(arch)
    if arch in TRAIN_OTHER_CUT:
        n, n_params, full = train_depth(cfg)
        cfg = dataclasses.replace(cfg, n_layers=n)
        cut = (f" cut to {n} of {get_config(arch).n_layers} layers "
               f"({full * ADAM_BYTES / 1e9:.1f} GB at {ADAM_BYTES} B a param "
               f"at full depth, {n_params * ADAM_BYTES / 1e9:.1f} GB cut)")
    else:
        n_params = cfg.param_count(init_params(cfg, device="meta"))
        cut = " at full depth"
    use_adam = ADAM_BYTES * n_params <= TRAIN_ADAM_LIMIT
    opt = single_model(adam(warmup_cosine(TRAIN_OTHER_LR, 0,
                                          TRAIN_OTHER_STEPS))
                       if use_adam else sgd(TRAIN_OTHER_LR))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(27)
    params = init_params(cfg, dev, gen)
    strides = [max(1, t.numel() // 4096) for t in tree_leaves(params)]
    before = [t.reshape(-1)[::s].clone()
              for t, s in zip(tree_leaves(params), strides)]
    state = opt.init(params)
    step = make_train_step(cfg, opt, moe_path="dropless", remat=False)
    it = train_batches(cfg, lm_token_stream(cfg.vocab_size, 200_000, gen,
                                            dev), TRAIN_BATCH, TRAIN_SEQ, 0,
                       gen)
    losses, secs = [], []
    for _ in range(TRAIN_OTHER_STEPS):
        b = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["ce"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    changed = [t.reshape(-1)[::s] != b0 for t, s, b0 in
               zip(tree_leaves(params), strides, before)]
    moved = sum(int(c.sum()) for c in changed) / sum(
        b0.numel() for b0 in before)
    label = f"{arch} bf16{cut}"
    check(all(np.isfinite(losses)), f"{label}: a non-finite loss {losses}")
    check(moved > 0, f"{label}: no param moved")
    held = ""
    if use_adam:
        # every leaf whose sampled elements had a grad (mu != 0) and lie
        # where one Adam step passes a bf16 spacing moved some of them
        stuck, n_held = [], 0
        for i, (c, s, b0, mu) in enumerate(zip(changed, strides, before,
                                               tree_leaves(state.mu))):
            due = (mu.reshape(-1)[::s] != 0) & (b0.abs() <= ADAM_MOVABLE)
            if bool(due.any()):
                n_held += 1
                if not bool(c[due].any()):
                    stuck.append(i)
        check(not stuck, f"{label}: Adam moved no element of leaves {stuck}")
        held = (f", each of the {n_held} of {len(changed)} leaves with "
                f"movable sampled elements moved")
    step_ms = float(np.mean(secs[1:])) * 1e3
    print(f"  [{CARD}] {label}: {n_params / 1e9:.3f} B params, "
          f"{'Adam' if use_adam else 'SGD'}, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}: ce {[round(x, 4) for x in losses]}, "
          f"{moved:.1%} of sampled param elements moved{held}; "
          f"{step_ms:.1f} ms a "
          f"step (the last {TRAIN_OTHER_STEPS - 1}); peak memory "
          f"{peak / 1e9:.2f} GB")
    del params, state
    torch.cuda.empty_cache()
    return {"label": label, "n_layers": cfg.n_layers, "params": n_params,
            "optimizer": "adam" if use_adam else "sgd", "losses": losses,
            "moved_share": moved, "step_ms": step_ms, "peak_gb": peak / 1e9}


def lm_training_phase(dev) -> dict:
    """LM training on the card: the ten reduced configs' fp32 twins,
    qwen2-0.5b at full width through ``train()``, the other
    architectures' bf16 steps; the only kernels of the port launched are
    the dropless MoE's grouped products, 3 + 3 + 3 a layer's forward and
    backward (``DroplessCalls.hold``)."""
    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.kernels import ops
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the twins and MoE routing need IEEE fp32")
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    DROPLESS.reset()
    out = {"twins": []}
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        paths = ("gshard", "dropless") if get_reduced(arch).is_moe \
            else ("gshard",)
        for path in paths:
            for remat in (False, True):
                out["twins"].append(train_twin(dev, arch, path, remat, 1))
    out["twins"].append(train_twin(dev, *TRAIN_TWIN_MICROBATCHES, False, 2))
    out["twins_s"] = time.perf_counter() - t0
    print(f"  the {len(out['twins'])} fp32 twins took {out['twins_s']:.1f} s")
    out["full"] = train_full(dev)
    out["others"] = [train_other(dev, arch) for arch in
                     TRAIN_OTHER_FULL + TRAIN_OTHER_CUT]
    counts = ops.launch_counts()
    out["moe"] = DROPLESS.hold("LM training", counts)
    check(DROPLESS.backward > 0, "LM training ran no dropless backward")
    out["routes"] = ops.route_counts()
    check(all(out["routes"].values()),
          f"LM training: the bf16 dropless steps at the published widths "
          f"and the fp32 twins did not take both Hopper routes of both "
          f"grouped products ({out['routes']})")
    print(f"  LM training on the card: {out['moe']}")
    out["launches"] = counts
    return out


def int8_wire(shape, dev, seed):
    """(q, scale, zp) of numpy-seeded log-softmax messengers, int8-encoded
    on the card by the port's codec."""
    from repro_torch.core import wire
    rng = np.random.default_rng(seed)
    lp = torch.from_numpy(log_softmax_np(rng.normal(size=shape) * 2.0))
    p = wire.encode("int8", lp.to(dev))
    return p.arrays["q"], p.arrays["scale"], p.arrays["zp"]


def int8_operands(shape, dev, seed):
    """(q, fp32 scale, zp, lse): ``int8_wire`` with the row statistics the
    IVF index stores beside the codes (torch.logsumexp of q·scale)."""
    from repro_torch.kernels import dequant_kl as dk
    q, s, z = int8_wire(shape, dev, seed)
    s = s.float()
    return q, s, z, dk.int8_row_stats(q, s)


def int8_bytes(u: int, m: int, r: int, c: int) -> float:
    """Bytes a B4 strip must move: each code once, scale and lse once,
    the (U, M) fp32 result once."""
    return 1.0 * (u + m) * r * c + 8.0 * (u + m) * r + 4.0 * u * m


def int8_case(label: str, a, b, iters: int, routes=()) -> dict:
    """B4 on operands ``a`` (U rows) and ``b`` (M rows) from
    ``int8_operands``: the entry point with the stored lse (as the IVF
    index calls it) and each route in ``routes`` on its own ("thin",
    "wide"), against the plain version. With ``iters``, times of the
    entry point, of each route, of the wide route's splits and GEMM
    alone, of the plain version and of a library product
    (``torch.matmul`` of the decoded fp32 operands, cross term only),
    beside each route's bound: bytes or fp32 FFMA for the thin kernel,
    3xTF32 for the wide route."""
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import ops, ref
    (qa, sa, za, la), (qb, sb, zb, lb) = a, b
    u, r, c = qa.shape
    m = qb.shape[0]
    k = r * c
    calls = {
        "entry": lambda: ops.int8_pairwise_kl_pair(qa, sa, za, qb, sb, zb,
                                                   lse_a=la, lse_b=lb),
        "thin": lambda: dk.thin(qa, sa, qb, sb, la, lb),
        "wide": lambda: dk.wide(qa, sa, qb, sb, la, lb)}
    want = ref.int8_pairwise_kl_pair_ref(qa, sa, za, qb, sb, zb)
    atol, rtol = TOL["int8_pairwise_kl_pair"]
    row = {"shape": [u, m, r, c],
           "entry_route": "thin" if dk.thin_fits(min(u, m), r, c)
           else "wide"}
    for name in ("entry", *routes):
        got = calls[name]()
        torch.cuda.synchronize()
        check(got.shape == (u, m) and got.dtype == torch.float32,
              f"int8 {label} {name}: shape/dtype {tuple(got.shape)} "
              f"{got.dtype}")
        ea, er = errors(got, want)
        ok = torch.allclose(got, want, atol=atol, rtol=rtol)
        what = f"{name} ({row['entry_route']})" if name == "entry" else name
        print(f"  int8_pairwise_kl {label:22s} {what:12s} ({u} x {m}, R={r}, "
              f"C={c}) max_abs={ea:.3e} max_rel={er:.3e} atol={atol:g} "
              f"rtol={rtol:g} {'ok' if ok else 'FAIL'}")
        check(ok, f"int8 {label} {name} disagrees with its plain version")
        row[f"{name}_max_abs_err"] = ea
    if not iters:
        return row
    nbytes = int8_bytes(u, m, r, c)
    flops = 2.0 * u * m * k
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bounds = {"thin": (max(flops / PEAK_FP32_FLOPS * 1e3, t_bytes),
                       "operations" if flops / PEAK_FP32_FLOPS * 1e3
                       >= t_bytes else "bytes"),
              "wide": (max(3 * flops / PEAK_TF32_FLOPS * 1e3, t_bytes),
                       "operations" if 3 * flops / PEAK_TF32_FLOPS * 1e3
                       >= t_bytes else "bytes")}
    row["entry_ms"] = cuda_ms(calls["entry"], iters)
    for name in routes:
        row[f"{name}_ms"] = cuda_ms(calls[name], iters)
        row[f"{name}_device_ms"] = device_ms(calls[name], iters)
        row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bounds[name]
    pa = torch.exp(ref.int8_decode_ref(qa, sa, la)).reshape(u, k)
    lb_t = ref.int8_decode_ref(qb, sb, lb).reshape(m, k).T
    row["plain_ms"] = cuda_ms(
        lambda: ref.int8_pairwise_kl_pair_ref(qa, sa, za, qb, sb, zb), iters)
    row["library_ms"] = cuda_ms(lambda: torch.matmul(pa, lb_t), iters)
    # timed as the kernels are: a back-to-back loop of microsecond calls
    # measures the host's launch rate
    row["library_device_ms"] = device_ms(lambda: torch.matmul(pa, lb_t),
                                         iters)
    row.update({"flops": flops, "bytes": nbytes})
    times = " ".join(f"{n}={row[f'{n}_ms']:.4f} ms (device "
                     f"{row[f'{n}_device_ms']:.4f} ms; bound "
                     f"{row[f'{n}_bound_ms']:.4f}, {row[f'{n}_bound_by']}, "
                     f"share of device "
                     f"{row[f'{n}_bound_ms'] / row[f'{n}_device_ms']:.1%})"
                     for n in routes)
    print(f"  time [{CARD}] int8 {label:22s} entry={row['entry_ms']:.4f} ms "
          f"{times} plain={row['plain_ms']:.4f} ms "
          f"library={row['library_ms']:.4f} ms (device "
          f"{row['library_device_ms']:.4f} ms)")
    if "wide" in routes:
        split_a = dk.split(qa, sa, True, la)[0]
        split_b = dk.split(qb, sb, False, lb)[0]
        row["split_ms"] = cuda_ms(lambda: (dk.split(qa, sa, True, la),
                                           dk.split(qb, sb, False, lb)),
                                  iters)
        row["gemm_ms"] = cuda_ms(lambda: dk.gemm(split_a, split_b), iters)
        # the GEMM alone: 3xTF32 operations against the planes read once
        k_pad = split_a.planes.shape[2]
        g_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        g_bytes = (8.0 * (u + m) * k_pad + 4.0 * u + 4.0 * u * m) \
            / PEAK_BYTES * 1e3
        row["gemm_bound_ms"] = max(g_ops, g_bytes)
        row["gemm_bound_by"] = "operations" if g_ops >= g_bytes else "bytes"
        print(f"  time [{CARD}] int8 {label:22s} wide route: two splits "
              f"{row['split_ms']:.4f} ms + GEMM {row['gemm_ms']:.4f} ms "
              f"(GEMM bound {row['gemm_bound_ms']:.4f} ms, "
              f"{row['gemm_bound_by']})")
    return row


def int8_split_case(a, b, iters: int) -> dict:
    """The dequant split of both operands of a strip against its plain
    version (hi + lo, the row term, TF32 bits), then its time beside its
    bytes bound (codes, scale and lse in; planes and row term out)."""
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import ref
    atol, rtol = TOL["int8_pairwise_kl_split"]
    err, ok = 0.0, True
    for (q, s, _, lse), a_side in ((a, True), (b, False)):
        got, _ = dk.split(q, s, a_side, lse)
        planes, rowterm = ref.int8_pairwise_kl_split_ref(
            q, s, lse, a_side, got.planes.shape[2])
        ok &= bool(((got.planes.view(torch.int32) & 0x1FFF) == 0).all())
        pairs = [(got.planes.sum(0), planes.sum(0))]
        if a_side:
            pairs.append((got.rowterm, rowterm))
        for g, w in pairs:
            err = max(err, float((g - w).abs().max()))
            ok &= torch.allclose(g, w, atol=atol, rtol=rtol)
    (qa, sa, _, la), (qb, sb, _, lb) = a, b
    u, r, c = qa.shape
    m = qb.shape[0]
    k_pad = got.planes.shape[2]
    print(f"  int8_pairwise_kl_split ({u} + {m} rows, R={r}, C={c}) "
          f"max_abs={err:.3e} (hi + lo, row term; TF32 planes) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "int8_pairwise_kl_split disagrees with its plain version")
    t_kern = cuda_ms(lambda: (dk.split(qa, sa, True, la),
                              dk.split(qb, sb, False, lb)), iters)
    t_plain = cuda_ms(lambda: (
        ref.int8_pairwise_kl_split_ref(qa, sa, la, True, k_pad),
        ref.int8_pairwise_kl_split_ref(qb, sb, lb, False, k_pad)), iters)
    nbytes = (1.0 * (u + m) * r * c + 8.0 * (u + m) * r
              + 8.0 * (u + m) * k_pad + 4.0 * u)
    flops = 2.0 * u * r * c             # exp and the row term, A side
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS) * 1e3
    by = "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_FP32_FLOPS \
        else "operations"
    print(f"  time [{CARD}] int8_pairwise_kl_split kernel={t_kern:.4f} ms "
          f"plain={t_plain:.4f} ms bound={bound:.4f} ms ({by}; "
          f"{nbytes:.4g} B) share={bound / t_kern:.1%}")
    return {"ms": t_kern, "plain_ms": t_plain, "library_ms": None,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "max_abs_err": err}


def int8_fp64_errors(a, b) -> tuple:
    """Max abs error against fp64 of the decoded operands, of the wide
    route and of the fp32 plain version on the same lse."""
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import ref
    (qa, sa, _, la), (qb, sb, _, lb) = a, b
    r = qa.shape[1]
    da = ref.int8_decode_ref(qa, sa, la).reshape(qa.shape[0], -1).double()
    db = ref.int8_decode_ref(qb, sb, lb).reshape(qb.shape[0], -1).double()
    pa = da.exp()
    truth = ((pa * da).sum(1)[:, None] - pa @ db.T) / r
    got = dk.wide(qa, sa, qb, sb, la, lb).double()
    plain = dk.plain(qa, sa, qb, sb, la, lb).double()
    return (float((got - truth).abs().max()),
            float((plain - truth).abs().max()))


def thin_sweep(dev) -> list:
    """The wide route at 1, 8, 16, 32 and 64 thin rows, and the thin
    kernel up to its THIN_ROWS, against an ANN oracle chunk (131072 rows,
    R=8, C=10), forward (thin x many) and reverse (many x thin), and at
    the server's K (R=240, C=10) against 4096 rows; each route held
    against the plain version, then its device and back-to-back times."""
    from repro_torch.kernels import dequant_kl as dk
    out = []
    for (r, c), many_rows, sizes in (
            ((ANN_R, ANN_C), ORACLE_CHUNK, (1, 8, 16, 32, 64)),
            ((SERVER[1], SERVER[2]), SERVER[0], (1, 8, 16))):
        many = int8_operands((many_rows, r, c), dev, 28)
        for t in sizes:
            few = int8_operands((t, r, c), dev, 29)
            routes = ("thin", "wide") if t <= dk.THIN_ROWS else ("wide",)
            for orient in ("forward", "reverse"):
                a, b = (few, many) if orient == "forward" else (many, few)
                row = int8_case(f"sweep {orient} t={t}", a, b, 0, routes)
                (qa, sa, _, la), (qb, sb, _, lb) = a, b
                fns = {"thin": lambda: dk.thin(qa, sa, qb, sb, la, lb),
                       "wide": lambda: dk.wide(qa, sa, qb, sb, la, lb)}
                row.update({"orient": orient, "thin_rows": t,
                            "many_rows": many_rows, "r": r, "c": c})
                for name in routes:
                    row[f"{name}_ms"] = cuda_ms(fns[name], 20)
                    row[f"{name}_device_ms"] = device_ms(fns[name], 20)
                print(f"  [{CARD}] THIN_ROWS sweep R={r} C={c} {orient:7s} "
                      f"{t:2d} x {many_rows}: " + ", ".join(
                          f"{n} device {row[f'{n}_device_ms']:.4f} ms "
                          f"(back-to-back {row[f'{n}_ms']:.4f})"
                          for n in routes))
                out.append(row)
        del many
    return out


def int8_kernel_phase(dev) -> dict:
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import ops, ref
    n, r, c = SERVER
    sa_, sb_ = (int8_operands((ops.CHUNK_ROWS, r, c), dev, 21),
                int8_operands((n, r, c), dev, 22))
    rows = {"server_strip": int8_case("server-round strip", sa_, sb_, 10,
                                      routes=("wide",))}
    rows["split"] = int8_split_case(sa_, sb_, 20)
    e_kern, e_plain = int8_fp64_errors(sa_, sb_)
    print(f"  int8 server-round strip against fp64 of the decoded operands: "
          f"wide route max_abs={e_kern:.3e}, fp32 plain version "
          f"max_abs={e_plain:.3e} (ratio {e_kern / e_plain:.3f}, limit "
          f"{FP64_ERR_RATIO:g})")
    check(e_kern <= FP64_ERR_RATIO * e_plain,
          "the int8 wide route is less accurate than the fp32 plain version "
          "allows")
    rows["server_strip"].update({"fp64_max_abs_err": e_kern,
                                 "plain_fp64_max_abs_err": e_plain})
    oa = int8_operands((N_QUERY, ANN_R, ANN_C), dev, 23)
    ob = int8_operands((ORACLE_CHUNK, ANN_R, ANN_C), dev, 24)
    rows["oracle_strip"] = int8_case("ANN oracle strip", oa, ob, 20,
                                     routes=("wide",))
    rows["ragged"] = int8_case("ragged", int8_operands((13, 13, 5), dev, 25),
                               int8_operands(RAGGED, dev, 26), 0,
                               routes=("thin", "wide"))
    rows["thin_sweep"] = thin_sweep(dev)
    # the square matrix: one split of each side, one GEMM a CHUNK_ROWS strip
    for shape, seed in ((RAGGED, 27), (SERVER, 22)):
        w = int8_wire(shape, dev, seed)
        got, want = ops.int8_pairwise_kl(*w), ref.int8_pairwise_kl_ref(*w)
        ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
        print(f"  int8_pairwise_kl square {shape}: max_abs="
              f"{errors(got, want)[0]:.3e} {'ok' if ok else 'FAIL'}")
        check(ok, f"int8_pairwise_kl square {shape} disagrees with its plain "
                  f"version")
    t_square = cuda_ms(lambda: ops.int8_pairwise_kl(*w), 5)
    print(f"  time [{CARD}] int8_pairwise_kl square N={n} (two splits, two "
          f"GEMMs) {t_square:.4f} ms, 3xTF32 bound "
          f"{3 * 2.0 * n * n * r * c / PEAK_TF32_FLOPS * 1e3:.4f} ms")
    rows["square_ms"] = t_square
    print(f"  THIN_ROWS = {dk.THIN_ROWS}")
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
    check(counts == launches_of(pairwise_kl_split=4, pairwise_kl_pair=2,
                                soft_ce=1, neighbor_gather=1),
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
    from repro_torch.kernels import dequant_kl as dk
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
        # a real upload's strips through B4, on the lse the index stores:
        # forward (1 x m) against its candidates, reverse (m x 1) back
        one_t = torch.as_tensor(one, device=dev)
        cand, _ = idx._search(one_t)
        targets = cand[cand != one_t[0]]

        def wire_of(rows):
            s = idx._scale[rows]
            return idx._codes[rows], s, torch.zeros_like(s), idx._lse[rows]
        row["m"] = int(targets.numel())
        for name, (ra, rb) in (("upload_fwd", (one_t, targets)),
                               ("upload_rev", (targets, one_t))):
            case = int8_case(f"upload {name[7:]} strip", wire_of(ra),
                             wire_of(rb), 50, routes=("thin",))
            # the index's own call (row gathers included), and the entry
            # point asked to compute the lse itself (in the kernel)
            case["index_strip_ms"] = cuda_ms(lambda: idx._strip(ra, rb), 50)
            (qa, sa, za, _), (qb, sb, zb, _) = wire_of(ra), wire_of(rb)
            case["entry_computed_lse_ms"] = cuda_ms(
                lambda: ops.int8_pairwise_kl_pair(qa, sa, za, qb, sb, zb), 50)
            print(f"  time [{CARD}] {name}: the index's strip call "
                  f"{case['index_strip_ms']:.4f} ms; the entry point with "
                  f"the stored lse {case['entry_ms']:.4f} ms, computing it "
                  f"{case['entry_computed_lse_ms']:.4f} ms")
            row[name] = case
        # one upload under the profiler; the plain version's row
        # statistics must not run on this path
        calls = []
        real = dk.int8_row_stats
        dk.int8_row_stats = lambda *a: calls.append(a) or real(*a)
        try:
            ops.reset_launch_counts()
            row["upload_profile"] = device_breakdown(
                f"idx.update, one row, N={n:,}",
                lambda: idx.update(one, lp_one))
            row["upload_profile"]["launches"] = ops.launch_counts()
        finally:
            dk.int8_row_stats = real
        print(f"  upload launches {row['upload_profile']['launches']}; "
              f"torch int8_row_stats calls: {len(calls)}")
        check(not calls, "an upload recomputed the row statistics in torch")
    return row


def ivf_probe_all(dev, n: int = SERVER[0]) -> dict:
    """Probe-all at N=4096: every list against the dense oracle's top-L,
    computed by the plain version on the card off the same wire form,
    after a bulk upload and a re-upload wave."""
    from repro_torch.core import NeighborIndex
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(1)
    protos = rng.normal(scale=2.0, size=(N_PROTO, ANN_R, ANN_C))
    idx = NeighborIndex(n, ANN_R, ANN_C, k=ANN_K, n_probe=10 ** 6,
                        device=dev)
    bulk = torch.from_numpy(gen_logp(rng, protos, n))
    wave = rng.choice(n, size=DELTA_ROWS, replace=False)
    fresh = torch.from_numpy(gen_logp(rng, protos, DELTA_ROWS))
    # the launches of both uploads (4096 and 64 rows: the wide route),
    # printed and kept apart from the federation's in the summary line
    ops.reset_launch_counts()
    idx.update(np.arange(n), bulk)
    degraded = idx.update(wave, fresh)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"  IVF N={n} probe-all bulk upload and re-upload wave: launches "
          f"{launches}")
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
            "degraded_rebuilt": degraded, "launches": launches}


def ivf_phase(dev) -> dict:
    out = {"probe_all": ivf_probe_all(dev)}
    for n in ANN_SIZES:
        out[str(n)] = ivf_scale(dev, n)
        torch.cuda.empty_cache()
    return out


# B4's strips timed against another checkout (--b4-against), (U, M, R,
# C): a real upload's two strips at N=10^6 (m = 38411, the candidates of
# phase 8's upload), 16, 32 and 64 query rows against an ANN oracle chunk
# (64 is the oracle strip), and the server-round strip
B4_SHAPES = {"upload_fwd": (1, 38411, ANN_R, ANN_C),
             "upload_rev": (38411, 1, ANN_R, ANN_C),
             "oracle_16": (16, ORACLE_CHUNK, ANN_R, ANN_C),
             "oracle_32": (32, ORACLE_CHUNK, ANN_R, ANN_C),
             "oracle_64": (N_QUERY, ORACLE_CHUNK, ANN_R, ANN_C),
             "server_strip": (2048, SERVER[0], SERVER[1], SERVER[2])}


def b4_times(src: str) -> dict:
    """B4's device and back-to-back times at B4_SHAPES, with the
    ``repro_torch`` of ``src``, on operands that carry their lse: the
    64 x 64 FFMA tile alone (``dequant_kl.launch``) where that checkout
    has it, else the entry point handed the lse (thin or wide route)."""
    sys.path.insert(0, src)
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    tile = hasattr(dk, "launch")
    out = {"src": src, "card": smi("name,power.limit"),
           "what": "FFMA tile" if tile else "entry point, stored lse"}
    for name, (u, m, r, c) in B4_SHAPES.items():
        (qa, sa, za, la), (qb, sb, zb, lb) = (
            int8_operands((u, r, c), dev, 41), int8_operands((m, r, c), dev,
                                                             42))
        fn = (lambda: dk.launch(qa, sa, la, qb, sb, lb)) if tile else (
            lambda: ops.int8_pairwise_kl_pair(qa, sa, za, qb, sb, zb,
                                              lse_a=la, lse_b=lb))
        out[name] = {"device_ms": device_ms(fn, 20),
                     "back_to_back_ms": cuda_ms(fn, 20)}
    return out


def b4_against(other: Path) -> int:
    """B4 of another checkout (e.g. the parent commit, unpacked with git
    archive) and of this one, one process each, in turns: other, this,
    this, other. Prints the times; they also go to
    ``chiprun_out/b4_against.json``."""
    runs = []
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        res = subprocess.run([sys.executable, __file__, "--b4-times",
                              str(tree / "src")], capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["label"] = label
        runs.append(row)
        for name in B4_SHAPES:
            print(f"  [{row['card']}] {label:5s} {row['what']:23s} "
                  f"{name:12s} device {row[name]['device_ms']:.4f} ms, "
                  f"back-to-back {row[name]['back_to_back_ms']:.4f} ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b4_against.json").write_text(json.dumps(runs, indent=2))
    return 0

# phase 23: client-axis sharding. A mesh of k entries of the one card
# (the engines' mesh= seam) runs every shard on it; with two cards or
# more, FederationConfig(devices=2) also runs over make_client_mesh's
# real cards
SHARD_MESHES = (1, 2, 8)
SHARD_TOL = 1e-6       # the reference's bound for a sharded run
# benchmarks/shard_scale.py:54-80's shapes: one MLP cohort (24 features,
# one hidden layer of 64, 32 samples a client, 10 classes), a reference
# set of 64, batch 16, at N clients
SHARD_BENCH_N = (256, 1024, 4096)
SHARD_FEAT, SHARD_HIDDEN, SHARD_SAMPLES = 24, 64, 32
SHARD_REF, SHARD_CLASSES, SHARD_BATCH = 64, 10, 16


def sharded_rebuild(dev) -> dict:
    """Phase 4's repository (N=4096, R=240, C=10) through meshes of 1, 2
    and 8 entries of the card: each within SHARD_TOL of the unsharded
    ``pairwise_kl``, within B1's tolerance of the plain version, with the
    unsharded rebuild's neighbors; its B1 launches and CUDA-event ms."""
    from repro_torch.core import candidate_mask, select_neighbors_from_div
    from repro_torch.core.similarity import divergence_matrix
    from repro_torch.kernels import ops, ref
    state, labels = server_repository(dev)
    lp = state.repo_logp
    n = lp.shape[0]
    whole = ops.pairwise_kl(lp)
    plain = torch.cat([ref.pairwise_kl_pair_ref(lp[i:i + ops.CHUNK_ROWS], lp)
                       for i in range(0, n, ops.CHUNK_ROWS)])
    cand = candidate_mask(ops.soft_ce(lp, labels), state.active, 64)
    want = select_neighbors_from_div(whole, cand, 8)
    atol, rtol = TOL["pairwise_kl_pair"]
    out = {}
    for k in SHARD_MESHES:
        mesh = shard_mesh(dev, k)
        ops.reset_launch_counts()
        div = divergence_matrix(lp, mesh=mesh)
        counts = ops.launch_counts()
        # a strip a shard (each side split, one GEMM); one entry is the
        # unsharded rebuild (two splits, a GEMM a CHUNK_ROWS chunk)
        gemms = k if k > 1 else -(-n // ops.CHUNK_ROWS)
        check(counts == launches_of(pairwise_kl_split=2 * k,
                                    pairwise_kl_pair=gemms),
              f"the {k}-shard rebuild launched {counts}")
        err = float((div - whole).abs().max())
        check(err <= SHARD_TOL, f"the {k}-shard rebuild is {err:.3e} from "
                                f"the unsharded one")
        perr, _ = errors(div, plain)
        check(torch.allclose(div, plain, atol=atol, rtol=rtol),
              f"the {k}-shard rebuild disagrees with the plain version")
        graph = select_neighbors_from_div(div, cand, 8)
        check(torch.equal(graph.neighbors, want.neighbors),
              f"the {k}-shard rebuild selects other neighbors")
        ms = cuda_ms(lambda: divergence_matrix(lp, mesh=mesh), iters=10)
        equal = bool(torch.equal(div, whole))
        print(f"  [{CARD}] Eq. 2 rebuild N={n} on {k} shard(s): {ms:.4f} "
              f"ms, launches {counts}; max abs err against unsharded "
              f"{err:.3e} (bit-equal {equal}), against the plain version "
              f"{perr:.3e}; same neighbors")
        out[str(k)] = {"ms": ms, "launches": counts,
                       "max_abs_err_unsharded": err, "bit_equal": equal,
                       "max_abs_err_plain": perr}
    return out


def ghost_rows_unchanged(eng, init_params) -> int:
    """Fail unless every ghost row of every shard still holds its last
    real client's initial params and a zero optimizer state (ghosts are
    never trainable); returns the ghost rows checked."""
    from repro_torch.convert import tensors_to_numpy
    from repro_torch.optim import state_tensors
    count = 0
    for coh in eng.fed.cohorts:
        layers = init_params[coh.family_name]["layers"]
        for sh in coh.shards:
            real = coh.real_rows(sh)
            if real == sh.n_rows:
                continue
            ghost = tensors_to_numpy(
                coh.module, [p[real:] for p in sh.model.parameters()])
            for got, init in zip(ghost["layers"], layers):
                for key in ("w", "b"):
                    check(np.array_equal(got[key], np.broadcast_to(
                        init[key][-1], got[key].shape)),
                        f"a ghost row of {coh.family_name} moved")
            check(all(bool((t[real:] == 0).all())
                      for t in state_tensors(sh.opt_state)),
                  f"a ghost row's optimizer state of {coh.family_name} "
                  f"moved")
            count += sh.n_rows - real
    return count


def hold_sharded(eng, base, init_params, what: str) -> dict:
    """A sharded card run against the unsharded card run of the same
    federation: accuracies within SHARD_TOL, each repository log-prob
    within SHARD_TOL of its magnitude (at least 1), wire bytes and fires
    equal, ghost rows unchanged.

    The repository is held relative to its magnitude because cuBLAS
    picks its batched-GEMM kernel by the batch count (``gemm_witness``:
    11 stacked clients and the same rows in blocks of 2 differ in the
    last bits), training carries that to the messengers, and log-probs
    reach |x| > 8, where one fp32 ulp is already ~1e-6."""
    h, b = eng.history, base.history
    acc_err = max(abs(x - y) for x, y in zip(h.mean_acc + h.val_acc,
                                             b.mean_acc + b.val_acc))
    got, want = eng.server.repo_logp, base.server.repo_logp
    diff = (got - want).abs()
    repo_abs = float(diff.max())
    repo_err = float((diff / want.abs().clamp(min=1.0)).max())
    at = float(want.flatten()[diff.argmax()])
    check(len(h.mean_acc) == len(b.mean_acc) and acc_err <= SHARD_TOL,
          f"{what}: accuracies {acc_err:.3e} from the unsharded run")
    check(repo_err <= SHARD_TOL,
          f"{what}: repository {repo_err:.3e} of its magnitude from the "
          f"unsharded run")
    check(h.bytes_up == b.bytes_up and h.server_rounds == b.server_rounds,
          f"{what}: wire bytes or fires differ from the unsharded run")
    ghosts = ghost_rows_unchanged(eng, init_params)
    pads = {c.family_name: c.n_pad for c in eng.fed.cohorts}
    print(f"  [{CARD}] {what}: accuracies within {acc_err:.3e}, "
          f"repository within {repo_abs:.3e} (at a log-prob of {at:.3f}; "
          f"{repo_err:.3e} of its magnitude) of the unsharded card run, "
          f"bytes up {h.bytes_up[-1]:.0f} equal; ghost rows {pads}, all "
          f"{ghosts} unchanged bit for bit")
    return {"acc_max_abs_diff": acc_err, "repo_max_abs_diff": repo_abs,
            "repo_max_rel_diff": repo_err, "repo_diff_at": at,
            "ghost_rows": ghosts, "n_pad": pads}


def gemm_witness(dev) -> dict:
    """Whether the card's batched GEMM gives a row the same bits at
    another batch count: the mlp tiers' first layer on the reference set
    (240 x 64 by 64 x 32) and its weight grad (64 x 256 by 256 x 32), 10,
    11 and 16 stacked clients against the same rows in blocks of 2 (an
    8-shard split's). Measured, not held."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    for label, a_shape, b_shape in (("forward", (240, 64), (64, 32)),
                                    ("weight grad", (64, 256), (256, 32))):
        for n in (10, 11, 16):
            a = torch.randn((n,) + a_shape, generator=gen, device=dev)
            b = torch.randn((n,) + b_shape, generator=gen, device=dev)
            parts = torch.cat([torch.bmm(a[i:i + 2], b[i:i + 2])
                               for i in range(0, n, 2)])
            out[f"{label}/{n}"] = float((torch.bmm(a, b) - parts)
                                        .abs().max())
    print(f"  [{CARD}] batched GEMM, n stacked rows against blocks of 2 "
          f"(max abs diff): {out}")
    return out


def sharded_federations(dev, inputs) -> dict:
    """Phase 5's federation and phase 14's straggler regime on an
    8-entry mesh of the card, each held against its CPU twin on an
    8-entry CPU mesh (``federation_phase``, launches read around the
    card's fit) and against the unsharded card run."""
    ds, splits, init_params, draws = inputs
    out = {}
    for label, run in (("sync", None), ("straggler-quorum-delta",
                                        "straggler")):
        print(f"  -- {label} on 8 shards")
        server = {} if run is None else async_run(run, ds.n_clients)[2]
        engines = []
        res = federation_phase(dev, server, DENSE_PATH, inputs, run=run,
                               shards=8, engines=engines)
        if run is None:
            base = federation(dev, splits, ds, init_params, draws, [],
                              server)
            base.fit(splits)
        else:
            base = async_federation(dev, inputs, run, [])
            base.fit(splits, until=ASYNC_UNTIL)
        res.update(hold_sharded(engines[0], base, init_params,
                                f"{label}, 8 shards"))
        out[label] = res
    return out


def sharded_checkpoints(dev, inputs) -> dict:
    """Phase 5's federation on 8 shards, saved after 2 rounds, restored
    into an unsharded card engine of other weights, whose save restores
    into another 8-shard engine: evaluations within SHARD_TOL, real rows
    bit for bit, one more round on both sharded engines alike."""
    import tempfile
    from repro_torch.checkpoint import restore_federation, save_federation
    ds, splits, init_params, draws = inputs
    other = {fam: {"layers": [{k: v * np.float32(0.5) + np.float32(0.1)
                               for k, v in layer.items()}
                              for layer in tree["layers"]]}
             for fam, tree in init_params.items()}
    sharded = federation(dev, splits, ds, init_params, draws, [], {},
                         shards=8)
    whole = federation(dev, splits, ds, other, draws, [], {})
    again = federation(dev, splits, ds, other, draws, [], {}, shards=8)
    for rnd in range(2):
        sharded.run_round(rnd)
    acc = sharded.evaluate(splits)
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src, dst, label in ((sharded, whole, "sharded -> unsharded"),
                                (whole, again, "unsharded -> sharded")):
            path = f"{tmp}/{label[0]}"
            save_federation(path, src.fed, step=2, bus=src.bus,
                            clients=src.clients)
            restore_federation(path, dst.fed, bus=dst.bus,
                               clients=dst.clients)
            for a, b in zip(sharded.fed.cohorts, dst.fed.cohorts):
                check(all(torch.equal(x, y) for x, y in zip(
                    a.real_params.values(), b.real_params.values())),
                    f"{label}: the real rows did not come back as saved")
            errs[label] = float(np.abs(dst.evaluate(splits) - acc).max())
            check(errs[label] <= SHARD_TOL, f"{label}: evaluation "
                                            f"{errs[label]:.3e} apart")
    sharded.run_round(2)
    again.run_round(2)
    errs["one more round"] = float(np.abs(
        again.evaluate(splits) - sharded.evaluate(splits)).max())
    check(errs["one more round"] <= SHARD_TOL,
          "the restored 8-shard engine's next round differs")
    print(f"  [{CARD}] 8-shard checkpoint after 2 rounds, restored "
          f"unsharded and back: evaluation max abs diff {errs}")
    return errs


def shard_bench(dev) -> dict:
    """benchmarks/shard_scale.py's shapes on the card: one MLP cohort of
    N clients on 1, 2 and 8 shards of the card: a cohort step, an upload
    and the Eq. 2 rebuild, CUDA-event ms over back-to-back calls."""
    from repro_torch.core.client import (Cohort, sharded_cohort_step,
                                         sharded_messenger_upload)
    from repro_torch.core.similarity import divergence_matrix
    from repro_torch.models.mlp import MLPConfig, mlp_family
    from repro_torch.optim import sgd
    from repro_torch.sharding import place_cohort_stacks
    build = mlp_family(MLPConfig("bench", SHARD_FEAT, (SHARD_HIDDEN,),
                                 SHARD_CLASSES))
    opt = sgd(0.05, momentum=0.9)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    for n in SHARD_BENCH_N:
        data = {"x": torch.randn((n, SHARD_SAMPLES, SHARD_FEAT),
                                 generator=gen, device=dev),
                "y": torch.randint(0, SHARD_CLASSES, (n, SHARD_SAMPLES),
                                   generator=gen, device=dev)}
        ref_x = torch.randn((SHARD_REF, SHARD_FEAT), generator=gen,
                            device=dev)
        logp = torch.log_softmax(torch.randn(
            (n, SHARD_REF, SHARD_CLASSES), generator=gen, device=dev) * 2,
            -1)
        idx = torch.randint(0, SHARD_SAMPLES, (n, SHARD_BATCH),
                            generator=gen, device=dev)
        for k in SHARD_MESHES:
            model = build(n, device=dev, generator=gen)
            coh = Cohort.whole("bench", model,
                               opt.init(list(model.parameters())),
                               np.arange(n), data, opt)
            mesh = shard_mesh(dev, k)
            place_cohort_stacks(coh, mesh)
            targets = torch.full((coh.n_rows, SHARD_REF, SHARD_CLASSES),
                                 1.0 / SHARD_CLASSES, device=dev)
            on = torch.arange(coh.n_rows, device=dev) < n
            row = {
                "step_ms": cuda_ms(lambda: sharded_cohort_step(
                    coh, idx, ref_x, targets, on, 0.8, True), iters=5),
                "upload_ms": cuda_ms(lambda: sharded_messenger_upload(
                    coh, ref_x, "dense32", dev), iters=5),
                "graph_ms": cuda_ms(lambda: divergence_matrix(
                    logp, mesh=mesh), iters=5)}
            print(f"  [{CARD}] shard_scale N={n} on {k} shard(s): step "
                  f"{row['step_ms']:.3f} ms, upload {row['upload_ms']:.3f} "
                  f"ms, graph {row['graph_ms']:.3f} ms")
            out[f"{n}/{k}"] = row
    return out


def sharding_phase(dev, inputs) -> dict:
    """Client-axis sharding on the card (phase 23)."""
    t0 = time.perf_counter()
    out = {"rebuild": sharded_rebuild(dev),
           "gemm_witness": gemm_witness(dev),
           "federations": sharded_federations(dev, inputs),
           "checkpoints": sharded_checkpoints(dev, inputs),
           "shard_scale": shard_bench(dev)}
    if torch.cuda.device_count() >= 2:
        ds, splits, init_params, draws = inputs
        two = federation(dev, splits, ds, init_params, draws, [], {},
                         shards=2, seam=False)
        check([d.index for d in two.mesh.devices] == [0, 1],
              "devices=2 did not take the first two cards")
        two.fit(splits)
        base = federation(dev, splits, ds, init_params, draws, [], {})
        base.fit(splits)
        out["two_cards"] = hold_sharded(two, base, init_params,
                                        "devices=2 over two cards")
    else:
        print(f"  one card visible (torch.cuda.device_count() = "
              f"{torch.cuda.device_count()}): FederationConfig(devices=2) "
              f"over real cards not run")
    out["launches"] = {
        name: sum(r["launches"][name]
                  for r in out["federations"].values())
        for name in out["federations"]["sync"]["launches"]}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 23 wall time {out['wall_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 24: the static-analysis gate on the card
# --------------------------------------------------------------------------

def analyze_gate() -> dict:
    """``python -m repro_torch.launch.analyze --json`` on the card, in its
    own process: each rule's status; fails on any violation or error."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.analyze",
                           "--json"], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.stdout.strip().startswith("{"),
          f"analyze printed no report (exit {proc.returncode}):\n"
          f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    for r in report["rules"]:
        print(f"  {r['family']:9s} {r['rule']:28s} {r['status']}"
              + (f" ({r['n_findings']} findings)" if r["n_findings"] else ""))
        for v in r["violations"]:
            print(f"    {v['where']}: {v['message'][:200]}")
        if r["status"] == "error":
            print("    " + r["detail"].strip().splitlines()[-1][:300])
    statuses = {r["rule"]: r["status"] for r in report["rules"]}
    print(f"  [{CARD}] gate: {len(statuses)} rules, --device "
          f"{report['device']}, {wall:.1f} s, exit {proc.returncode}")
    check(proc.returncode == 0 and not report["failed"]
          and len(statuses) == 15
          and all(st == "ok" for st in statuses.values()),
          f"the analysis gate failed: {statuses}")
    return {"wall_s": wall, "statuses": statuses,
            "device": report["device"]}


def probe_launches(dev) -> list:
    """Every hand kernel at the launch rule's odd probe shapes (no extent
    a multiple of any tile, the thin kernel at every instance on both
    sides and past the resident-grid cap), each held against its plain
    version with phase 3's tolerances; the launches counted."""
    from repro_torch.analysis import launch_rules as lr
    from repro_torch.kernels import dequant_kl as dk
    from repro_torch.kernels import ops, ref
    u, m, r, c = lr.PROBE_U, lr.PROBE_M, lr.PROBE_R, lr.PROBE_C
    rng = np.random.default_rng(24)

    def logp(n):
        return torch.from_numpy(log_softmax_np(
            rng.normal(size=(n, r, c)) * 2.0)).to(dev)

    a, b = logp(u), logp(m)
    labels = torch.from_numpy(rng.integers(-1, c, r).astype(np.int32)) \
        .to(dev)
    w = torch.from_numpy(rng.random((u, u)).astype(np.float32)).to(dev)
    w /= w.sum(1, keepdim=True)
    probs = torch.exp(a)
    cases = [("pairwise_kl_pair", ops.pairwise_kl_pair(a, b),
              ref.pairwise_kl_pair_ref(a, b)),
             ("pairwise_kl_pair", ops.pairwise_kl(a), ref.pairwise_kl_ref(a)),
             ("soft_ce", ops.soft_ce(a, labels), ref.soft_ce_ref(a, labels)),
             ("neighbor_mean_dense_w", ops.neighbor_mean(w, probs),
              ref.neighbor_mean_ref(w, probs))]
    for slots in lr.PROBE_SLOTS:
        nbrs = torch.from_numpy(rng.integers(0, u, (u, slots))
                                .astype(np.int32)).to(dev)
        sw = torch.full((u, slots), 1.0 / slots, device=dev)
        cases.append(("neighbor_gather", ops.neighbor_gather(nbrs, sw, probs),
                      ref.neighbor_gather_ref(nbrs, sw, probs)))
    qa, sa, za, la = int8_operands((u, r, c), dev, 25)
    qb, sb, zb, lb = int8_operands((m, r, c), dev, 26)
    cases.append(("int8_pairwise_kl_pair",
                  ops.int8_pairwise_kl_pair(qa, sa, za, qb, sb, zb),
                  dk.plain(qa, sa, qb, sb)))
    cases.append(("int8_pairwise_kl_pair", ops.int8_pairwise_kl(qa, sa, za),
                  dk.plain(qa, sa, qa, sa)))
    # the grouped product: M = PROBE_M rows by K = R*C into N = PROBE_U
    # columns, group sizes summing to 10 rows short of M (empty groups
    # among 160), its input gradient back and its weight gradient, fp32
    k = r * c
    for g in lr.PROBE_GROUPS:
        sizes = torch.from_numpy(rng.multinomial(m - 10, np.ones(g) / g)
                                 .astype(np.int32)).to(dev)
        lhs, rhs, dout = ragged_operands(m, k, u, g, torch.float32, dev, g)
        cases += [("ragged_dot", ops.ragged_dot(lhs, rhs, sizes),
                   ref.ragged_dot_ref(lhs, rhs, sizes)),
                  ("ragged_dot", ops.ragged_dot(dout, rhs, sizes,
                                                transpose_rhs=True),
                   ref.ragged_dot_ref(dout, rhs, sizes, True)),
                  ("ragged_dot_wgrad", ops.ragged_dot_wgrad(lhs, dout, sizes),
                   ref.ragged_dot_wgrad_ref(lhs, dout, sizes))]
    for many in lr.PROBE_MANY:
        qm, sm, zm, lm = int8_operands((many, r, c), dev, 27)
        for t in lr.PROBE_THIN:
            qt, st, zt, lt = qa[:t], sa[:t], za[:t], la[:t]
            cases.append(("int8_pairwise_kl_pair",
                          ops.int8_pairwise_kl_pair(qt, st, zt, qm, sm, zm),
                          dk.plain(qt, st, qm, sm)))
            cases.append(("int8_pairwise_kl_pair",
                          ops.int8_pairwise_kl_pair(qm, sm, zm, qt, st, zt,
                                                    lse_a=lm, lse_b=lt),
                          dk.plain(qm, sm, qt, st, lm, lt)))
    return cases


def probe_phase(dev) -> dict:
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    cases = probe_launches(dev)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    worst = {}
    for name, got, want in cases:
        atol, rtol = TOL[name]
        ea, _ = errors(got.float(), want.float())
        check(torch.allclose(got, want, atol=atol, rtol=rtol),
              f"{name} at a probe shape {tuple(got.shape)}: max_abs={ea:.3e}"
              f" beyond atol={atol:g} rtol={rtol:g}")
        worst[name] = max(worst.get(name, 0.0), ea)
    print(f"  [{CARD}] {len(cases)} probe launches held to their plain "
          f"versions; max abs error by tolerance: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    print("  launches at the probe shapes: " + json.dumps(launches))
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched at the probe shapes: {launches}")
    tma = tma_probes(dev)
    return {"cases": len(cases), "max_abs_err": worst,
            "launches": launches, "hopper_route": tma}


def tma_probes(dev) -> dict:
    """The grouped product's Hopper routes at the launch rule's probe
    shapes (M = PROBE_M rows, K = PROBE_TMA_K and N = PROBE_TMA_N,
    multiples of 8 but of no tile; 1, 7 and 160 groups summing to 10 rows
    short of M), bf16 on the Hopper route and fp32 on the fp32 one: the
    forward, the input gradient and the weight gradient, each on its
    route (the counters read) and held to its plain version with phase
    26's rule for its dtype."""
    from repro_torch.analysis import launch_rules as lr
    from repro_torch.kernels import ops
    m, k, n = lr.PROBE_M, lr.PROBE_TMA_K, lr.PROBE_TMA_N
    rng = np.random.default_rng(24)
    ops.reset_launch_counts()
    worst = {}
    for g in lr.PROBE_GROUPS:
        sizes = torch.from_numpy(rng.multinomial(m - 10, np.ones(g) / g)
                                 .astype(np.int32)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            lhs, rhs, dout = ragged_operands(m, k, n, g, dtype, dev, g)
            f32 = [t.float() for t in (lhs, rhs, dout)]
            key = str(dtype).split(".")[-1]
            for entry, (kernel, plain) in ragged_calls(lhs, rhs, dout,
                                                       sizes).items():
                worst[key] = max(worst.get(key, 0.0), hold_ragged(
                    f"{key} {entry} at a probe shape (G={g})", kernel(),
                    plain(*f32), dtype))
    torch.cuda.synchronize()
    routes, counts = ops.route_counts(), ops.launch_counts()
    groups = len(lr.PROBE_GROUPS)
    want = {"ragged_dot.tma": 2 * groups, "ragged_dot_wgrad.tma": groups,
            "ragged_dot.tf32": 2 * groups, "ragged_dot.tf32_split": 2 * groups,
            "ragged_dot_wgrad.tf32": groups,
            "ragged_dot_wgrad.tf32_split": groups}
    n_probes = 6 * groups
    check(routes == want
          and counts["ragged_dot"] + counts["ragged_dot_wgrad"] == n_probes,
          f"the Hopper routes' probes took another route: {routes}, "
          f"{counts}")
    print(f"  [{CARD}] the grouped product's Hopper routes at (M, K, N) = "
          f"({m}, {k}, {n}), G in {lr.PROBE_GROUPS}, bf16 and fp32: "
          f"{n_probes} calls ({routes}) held to their plain versions, max "
          f"|error| " + ", ".join(f"{name} {err:.3e}"
                                   for name, err in worst.items()))
    return {"launches": routes, "max_abs_err": worst}


def cost_beside_bounds(rows: dict) -> dict:
    """The cost model's count (repro_torch.analysis.cost) of B1-B4's plain
    versions at the shapes phase 3, 6 and 8 time them at, beside the
    bound this run computed for each: model FLOPs, its memory traffic and
    its argument + result bytes, and the larger of those bytes over
    PEAK_BYTES and the FLOPs over the fp32 peak."""
    from repro_torch.analysis.cost import interp
    from repro_torch.kernels import ref

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    n, r, c = SERVER
    strip = min(n, 2048)
    k = 8
    shapes = {
        "pairwise_kl_pair": (ref.pairwise_kl_pair_ref,
                             (t(strip, r, c), t(n, r, c))),
        "soft_ce": (ref.soft_ce_ref, (t(n, r, c), t(r, dtype=torch.int32))),
        "neighbor_gather": (ref.neighbor_gather_ref,
                            (t(n, k, dtype=torch.int32), t(n, k),
                             t(n, r, c))),
        "neighbor_mean": (ref.neighbor_mean_ref, (t(n, n), t(n, r, c))),
        "int8_pairwise_kl_pair": (ref.int8_pairwise_kl_pair_ref,
                                  (t(strip, r, c, dtype=torch.uint8),
                                   t(strip, r), t(strip, r),
                                   t(n, r, c, dtype=torch.uint8), t(n, r),
                                   t(n, r)))}
    out = {}
    for name, (fn, args) in shapes.items():
        s = interp.summary_of(fn, *args)
        io = s.arg_bytes + s.out_bytes
        model_ms = max(io / PEAK_BYTES, s.flops / PEAK_FP32_FLOPS) * 1e3
        row = rows.get(name, {})
        out[name] = {"flops": s.flops, "matmul_flops": s.matmul_flops,
                     "bytes": s.bytes, "io_bytes": io,
                     "model_bound_ms_fp32": model_ms,
                     "run_bound_ms": row.get("bound_ms"),
                     "run_bound_by": row.get("bound_by")}
        print(f"  {name}: model {s.flops:.4e} FLOPs ({s.matmul_flops:.4e} "
              f"matmul), {s.bytes:.4e} B traffic, {io:.4e} B args+result; "
              f"fp32 bound {model_ms:.4f} ms beside this run's bound "
              f"{row.get('bound_ms')} ms ({row.get('bound_by')}) [{CARD}]")
    return out


def analysis_phase(dev, rows: dict) -> dict:
    t0 = time.perf_counter()
    gate = analyze_gate()
    probes = probe_phase(dev)
    cost = cost_beside_bounds(rows)
    wall = time.perf_counter() - t0
    print(f"  phase 24 wall time {wall:.1f} s")
    return {"gate": gate, "probes": probes, "cost": cost, "wall_s": wall}


# --------------------------------------------------------------------------
# phase 25: the LM dry run (launch/dryrun.py) on the card's machine
# --------------------------------------------------------------------------
# the predicted peak (argument + output - alias + temp bytes of the 1x1
# trace) within this share of the real step's peak allocation, fixed
# before the first run (phase 22's step read 13.05 GB)
DRYRUN_PEAK_RTOL = 0.15
# the production-mesh rows phase 25 traces: (arch, shape, flags), each a
# ``python -m repro_torch.launch.dryrun`` of its own, all started together
# (the pure data-parallel row on 16x16: train_4k's 256 rows divide its
# 256 ranks, where on 2x16x16's 512 the batch stays replicated)
DRYRUN_ROWS = (
    ("qwen2-0.5b", "train_4k", ()),
    ("qwen2-0.5b", "train_4k", ("--dp-over-model",)),
    ("mixtral-8x7b", "prefill_32k", ()),
    ("mixtral-8x7b", "prefill_32k", ("--moe-path", "dropless")),
    ("deepseek-v2-236b", "train_4k", ("--multi-pod", "--fsdp")),
    ("gemma3-1b", "long_500k", ()),
)


def dryrun_host_check(dev) -> dict:
    """qwen2-0.5b at full width on phase 22's step (bf16, Adam, batch
    TRAIN_BATCH x seq TRAIN_SEQ, no remat), traced on a 1x1 mesh of fake
    card tensors, against one real step on the card: argument bytes and
    FLOPs equal, the predicted peak within DRYRUN_PEAK_RTOL of the real
    step's peak allocation."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import InputShape, concrete_inputs, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_process_group, make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adam, single_model
    cfg = get_config(TRAIN_FULL_ARCH)
    shape = InputShape("phase22", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    with fake_process_group(1):
        row = dryrun.trace_step(cfg, shape, make_host_mesh(device=dev),
                                remat=False, donate=False, device=dev)
    trace_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(25)
    params = init_params(cfg, device=dev, generator=gen)
    opt = single_model(adam(1e-4))
    state = opt.init(params)
    batch = concrete_inputs(gen, cfg, shape, device=dev)
    args = tree_leaves(params) + tree_leaves(state) + tree_leaves(batch)
    arg_bytes = sum(t.numel() * t.element_size() for t in args)
    step = make_train_step(cfg, opt, remat=False)
    step(params, state, batch)     # cuBLAS's workspace, allocated once
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - arg_bytes   # earlier phases'
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = step(params, state, batch)
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated() - other
    del out
    mem = row["memory"]
    predicted = row["bytes_per_device"]
    rel = abs(predicted - real_peak) / real_peak
    label = (f"{TRAIN_FULL_ARCH} bf16, batch {TRAIN_BATCH} x seq "
             f"{TRAIN_SEQ}, Adam, 1x1 mesh")
    check(mem["argument_bytes"] == arg_bytes,
          f"{label}: traced argument bytes {mem['argument_bytes']} != the "
          f"real params + optimizer state + batch {arg_bytes}")
    check(row["hlo_flops_per_dev"] == fc.get_total_flops(),
          f"{label}: traced FLOPs {row['hlo_flops_per_dev']:.6e} != "
          f"FlopCounterMode of the real step {fc.get_total_flops():.6e}")
    check(rel <= DRYRUN_PEAK_RTOL,
          f"{label}: predicted peak {predicted / 1e9:.3f} GB off the real "
          f"step's {real_peak / 1e9:.3f} GB by {rel:.1%} (limit "
          f"{DRYRUN_PEAK_RTOL:.0%})")
    print(f"  [{CARD}] {label}: traced in {trace_s:.1f} s; argument bytes "
          f"{arg_bytes} equal; FLOPs {fc.get_total_flops():.6e} equal; "
          f"predicted peak {predicted / 1e9:.3f} GB (args "
          f"{mem['argument_bytes'] / 1e9:.3f} + temp "
          f"{mem['temp_bytes'] / 1e9:.3f} + out - alias "
          f"{(mem['output_bytes'] - mem['alias_bytes']) / 1e9:.3f}) "
          f"against max_memory_allocated {real_peak / 1e9:.3f} GB "
          f"({rel:.2%})")
    del params, state, batch, args
    torch.cuda.empty_cache()
    return {"trace_s": trace_s, "argument_bytes": arg_bytes,
            "flops": fc.get_total_flops(), "predicted_peak": predicted,
            "real_peak": real_peak, "peak_rel": rel, "memory": mem}


def dryrun_rows() -> list:
    """DRYRUN_ROWS, one dry-run process each (fake card tensors), all
    started together; each row's JSON and its printed summary."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out_dir = ROOT / "chiprun_out" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for i, (arch, shape, flags) in enumerate(DRYRUN_ROWS):
        # a directory a row: two rows may share an (arch, shape, mesh) name
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, *flags, "--out",
               str(out_dir / f"row{i}")]
        procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    rows = []
    for i, ((arch, shape, flags), proc) in enumerate(zip(DRYRUN_ROWS, procs)):
        text, _ = proc.communicate()
        mesh = "multi" if "--multi-pod" in flags else "single"
        tag = f"{arch}__{shape}__{mesh}"
        path = out_dir / f"row{i}" / f"{tag}.json"
        row = json.loads(path.read_text()) if path.exists() else {
            "status": "FAIL", "error": text[-2000:]}
        summary = [ln for ln in text.splitlines()
                   if ln.startswith("DRY-RUN SUMMARY")]
        check(proc.returncode == 0 and row["status"] == "OK",
              f"dry run {tag} {' '.join(flags)}: {row.get('status')} "
              f"{row.get('error', '')}")
        if "--dp-over-model" in flags:
            check(row["coll_bytes_per_dev"] > 0,
                  f"dry run {tag} {' '.join(flags)}: no collective bytes: "
                  f"the batch is not sharded")
        mem = row["memory"]
        print(f"  {tag} {' '.join(flags)}: {row['mesh']}, traced in "
              f"{row['trace_s']} s; per device {row['hlo_flops_per_dev']:.3e} "
              f"FLOPs, {row['hlo_bytes_per_dev']:.3e} B, collectives "
              f"{row['coll_bytes_per_dev']:.3e} B {row['coll_counts']}; "
              f"memory args {mem['argument_bytes'] / 1e9:.2f} GB temp "
              f"{mem['temp_bytes'] / 1e9:.2f} GB; roofline compute "
              f"{row['compute_s'] * 1e3:.2f} ms, memory "
              f"{row['memory_s'] * 1e3:.2f} ms, collective "
              f"{row['collective_s'] * 1e3:.2f} ms -> {row['dominant']}; "
              f"useful {row['useful_flops_frac']:.3f} | {summary[-1]}")
        rows.append(dict(row, flags=list(flags)))
    print(f"  the {len(rows)} rows in {time.perf_counter() - t0:.1f} s "
          f"(processes side by side)")
    return rows


def dryrun_phase(dev) -> dict:
    t0 = time.perf_counter()
    host = dryrun_host_check(dev)
    rows = dryrun_rows()
    wall = time.perf_counter() - t0
    print(f"  phase 25 wall time {wall:.1f} s")
    return {"host_mesh": host, "rows": rows, "wall_s": wall}



# --------------------------------------------------------------------------
# phase 26: the dropless MoE's grouped product (kernels/ragged_dot.py)
# --------------------------------------------------------------------------
# (label, tokens, top k, D, F, experts): the two MoE architectures'
# published widths at phase 21's prefill (batch 4 x prompt 64) and phase
# 22's train batch (8 x seq 128); the product's rows are tokens x top k
RAGGED_CASES = (("mixtral-8x7b prefill", LM_BATCH * LM_PROMPT, 2, 4096,
                 14336, 8),
                ("deepseek-v2-236b prefill", LM_BATCH * LM_PROMPT, 6, 5120,
                 1536, 160),
                ("mixtral-8x7b train", 8 * 128, 2, 4096, 14336, 8))
# the edge cases at odd shapes (no extent a tile's multiple): (M, K, N)
# and the group sizes' pattern
RAGGED_EDGE = (257, 21, 131)
# fp32 (IEEE FFMA against cuBLAS without TF32): sums in another order,
# held to this share of the largest |output|; bf16: one rounding of an
# fp32 sum, held against the plain version on the same values in fp32 to
# half a bf16 spacing (2^-8 of the value) plus this share of the largest
# |output| for the fp32 sums' order near zero
RAGGED_FP32_RTOL = 1e-5
RAGGED_BF16_FLOOR = 1e-2 * 2.0 ** -8
RAGGED_ENTRIES = ("forward", "input_grad", "wgrad")


class DroplessCalls:
    """The dropless MoE FFN's calls and the grouped-product launches each
    made: ``repro_torch.models.ffn.moe_dropless_forward`` wrapped once
    (``moe_forward`` looks it up at each call), each call's ``ragged_dot``
    launches read around it, and a hook on its output counting the calls
    whose backward ran (a remat recompute's output never sees one); calls
    on the card only, no sync added. ``reset`` beside
    ``ops.reset_launch_counts``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls, self.backward, self.per_call = 0, 0, set()

    def install(self) -> None:
        from repro_torch.kernels import ops
        from repro_torch.models import ffn
        plain = ffn.moe_dropless_forward

        def counted(p, cfg, x):
            if not x.is_cuda:              # a CPU twin launches nothing
                return plain(p, cfg, x)
            before = ops.launch_counts()["ragged_dot"]
            try:
                y, aux = plain(p, cfg, x)
            finally:
                # a remat recompute stops early (an exception) once it
                # has rebuilt what the backward saved, past the products
                self.per_call.add(ops.launch_counts()["ragged_dot"] - before)
                self.calls += 1
            if y.requires_grad:
                y.register_hook(self._backward)
            return y, aux

        ffn.moe_dropless_forward = counted

    def _backward(self, grad) -> None:
        self.backward += 1

    def hold(self, label: str, counts: dict) -> str:
        """Fails unless ``counts`` (read since the last reset) are the
        grouped products of the dropless calls since then: ``ragged_dot``
        3 a layer's forward (each call exactly 3) plus 3 a backward,
        ``ragged_dot_wgrad`` 3 a backward, no other kernel of the port."""
        others = {n: c for n, c in counts.items()
                  if n not in ("ragged_dot", "ragged_dot_wgrad")}
        check(not any(others.values()),
              f"{label}: a kernel off the dropless MoE path launched "
              f"{others}")
        check(self.per_call <= {3},
              f"{label}: a dropless MoE layer's forward launched ragged_dot "
              f"{sorted(self.per_call)} times (3 expected)")
        want = (3 * (self.calls + self.backward), 3 * self.backward)
        got = (counts["ragged_dot"], counts["ragged_dot_wgrad"])
        check(got == want,
              f"{label}: ragged_dot / ragged_dot_wgrad launched {got}, not "
              f"{want}: 3 each of {self.calls} dropless layer forwards, "
              f"3 + 3 each of {self.backward} backwards")
        from repro_torch.kernels import ops
        routes = ops.route_counts()
        return (f"{self.calls} dropless MoE layer forwards, {self.backward} "
                f"backwards: ragged_dot {got[0]} (Hopper route "
                f"{routes['ragged_dot.tma']}, fp32 Hopper route "
                f"{routes['ragged_dot.tf32']}), ragged_dot_wgrad {got[1]} "
                f"(Hopper route {routes['ragged_dot_wgrad.tma']}, fp32 "
                f"Hopper route {routes['ragged_dot_wgrad.tf32']}) launches")


DROPLESS = DroplessCalls()


def routed_sizes(tokens: int, k: int, g: int, rng) -> np.ndarray:
    """Group sizes of ``tokens`` tokens each routed to k distinct experts
    of g drawn uniformly (the sorted choices' experts)."""
    choice = np.argsort(rng.random((tokens, g)), axis=1)[:, :k]
    return np.bincount(choice.reshape(-1), minlength=g).astype(np.int32)


def edge_sizes(kind: str, m: int, rng) -> np.ndarray:
    if kind == "one group holds every row":
        return np.array([0, m, 0], np.int32)
    if kind == "empty groups, 40 rows past the sum":
        return np.array([0, 50, 0, 0, m - 90, 0, 0], np.int32)
    cuts = np.sort(rng.integers(0, m + 1, 159))          # 160 groups
    return np.diff(np.concatenate([[0], cuts, [m]])).astype(np.int32)


def ragged_operands(m: int, k: int, n: int, g: int, dtype, dev, seed: int):
    """lhs (M,K), rhs (G,K,N) scaled by 1/sqrt(K) as ``dense_init`` draws,
    and an output gradient (M,N), drawn on the card in fp32 and cast."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    return draw(m, k), draw(g, k, n, scale=k ** -0.5), draw(m, n)


def ragged_calls(lhs, rhs, dout, sizes) -> dict:
    """Each entry's kernel call and plain call on the same operands: the
    forward, the input gradient (rhs read transposed) and the weight
    gradient; and the plain call on fp32 copies (the held value)."""
    from repro_torch.kernels import ragged_dot as rd
    from repro_torch.kernels.ref import ragged_dot_ref, ragged_dot_wgrad_ref
    return {
        "forward": (lambda: rd.ragged_dot(lhs, rhs, sizes, False),
                    lambda a, b, c: ragged_dot_ref(a, b, sizes)),
        "input_grad": (lambda: rd.ragged_dot(dout, rhs, sizes, True),
                       lambda a, b, c: ragged_dot_ref(c, b, sizes, True)),
        "wgrad": (lambda: rd.ragged_dot_wgrad(lhs, dout, sizes),
                  lambda a, b, c: ragged_dot_wgrad_ref(a, c, sizes))}


def hold_ragged(label: str, got, want32, dtype) -> float:
    """``got`` against the plain version's fp32 value of the same inputs,
    within the phase's tolerance for ``dtype``; returns max |error|."""
    err = (got.float() - want32).abs()
    top = float(want32.abs().max())
    if dtype == torch.float32:
        ok = float(err.max()) <= RAGGED_FP32_RTOL * top
        limit = f"{RAGGED_FP32_RTOL:g} x max |out| {top:.3e}"
    else:
        ok = bool((err <= 2.0 ** -8 * want32.abs()
                   + RAGGED_BF16_FLOOR * top).all())
        limit = f"2^-8 |want| + {RAGGED_BF16_FLOOR:.2e} x max |out| {top:.3e}"
    check(ok, f"{label}: max |error| {float(err.max()):.3e} beyond {limit}")
    return float(err.max())


def grouped_mm_call(entry: str, lhs, rhs, dout, sizes, want32):
    """The library yardstick: one ``torch._grouped_mm`` call computing
    ``entry`` (offsets the groups' cumulative sizes), or None with the
    reason where this torch refuses the dtype or strides, or its result
    is not ``want32`` (to 1 % of the largest value: the same function)."""
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    calls = {"forward": lambda: torch._grouped_mm(lhs, rhs, offs=offs),
             "input_grad": lambda: torch._grouped_mm(
                 dout, rhs.transpose(-2, -1), offs=offs),
             "wgrad": lambda: torch._grouped_mm(lhs.t(), dout, offs=offs)}
    fn = calls[entry]
    try:
        got = fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    gap = float((got.float() - want32).abs().max())
    if got.shape != want32.shape or gap > 1e-2 * float(want32.abs().max()):
        return None, f"its result is off the plain version's by {gap:.3e}"
    return fn, "torch._grouped_mm"


def routed(kernel):
    """(kernel's result, the route its grouped product took: "hopper"
    (bf16), "tf32" (fp32's Hopper route) or "first"), read off the routes'
    counters around the call."""
    from repro_torch.kernels import ops
    before = ops.route_counts()
    got = kernel()
    moved = {name.split(".")[1] for name, n in ops.route_counts().items()
             if n != before[name]}
    if "tma" in moved:
        return got, "hopper"
    return got, "tf32" if moved else "first"


@contextlib.contextmanager
def first_route():
    """Inside the block every grouped product takes the first route, to
    time it beside the Hopper routes on the same inputs."""
    from repro_torch.kernels import ragged_dot as rd
    keep = rd.takes_tma, rd.takes_tf32
    rd.takes_tma = rd.takes_tf32 = lambda *args: False
    try:
        yield
    finally:
        rd.takes_tma, rd.takes_tf32 = keep


def tf32_split_row(entry: str, lhs, dout, sizes, iters: int) -> dict:
    """The fp32 Hopper route's split before ``entry``'s product, alone:
    the forward's split of lhs (or of the output gradient, the input
    gradient's lhs) and the weight gradient's transposing split of lhs
    and grad, against their plain versions (equal bit for bit: the same
    roundings), device ms beside the bytes bound (each input read once,
    the planes written once) and the plain version's ms."""
    from repro_torch.kernels import ragged_dot as rd
    from repro_torch.kernels import ref
    m = lhs.shape[0]
    if entry == "wgrad":
        mp = rd.tf32_m_pad(m, sizes.shape[0])
        _, tile = rd.tf32_wgrad_tables(sizes.tolist(), m)
        used = rd.TF32_TN * tile[-2]            # the groups' columns
        kernel = lambda: rd.tf32_wgrad_split(lhs, dout, sizes)
        plain = lambda: (ref.ragged_dot_wgrad_tf32_split_ref(lhs, sizes, mp),
                         ref.ragged_dot_wgrad_tf32_split_ref(dout, sizes, mp))
        got, want = kernel(), plain()
        err = max(float((a[..., :used] - b[..., :used]).abs().max())
                  for a, b in zip(got, want))
        nbytes = 4.0 * (lhs.numel() + dout.numel()) + 4.0 * 2 * used * (
            lhs.shape[1] + dout.shape[1])
    else:
        x = dout if entry == "input_grad" else lhs
        kp = rd.tf32_k_pad(x.shape[1])
        kernel = lambda: rd.tf32_split(x)
        plain = lambda: ref.pairwise_kl_split_ref(x.unsqueeze(-1), False,
                                                  kp)[0]
        err = float((kernel() - plain()).abs().max())
        nbytes = 4.0 * x.numel() + 4.0 * 2 * m * kp
    check(err == 0.0, f"the fp32 route's {entry} split is {err:.3e} off its "
                      f"plain version")
    torch.cuda.synchronize()
    bound_ms = nbytes / PEAK_BYTES * 1e3
    dms = device_ms(kernel, iters)
    return {"max_abs_err": err, "ms": dms,
            "plain_ms": cuda_ms(plain, 3, warmup=1), "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None, "bytes": nbytes}


def ragged_case(dev, label: str, tokens: int, top_k: int, d: int, f: int,
                g: int, dtype) -> dict:
    """The three entries at one case's shapes in one dtype: each against
    its plain version, timed (device and back-to-back ms), beside its
    bound, the plain version's time and the library yardstick's. At these
    published widths bf16 must take the Hopper route and fp32 the fp32
    Hopper route (3xTF32; its splits also timed alone), or the phase
    fails; each is timed beside the first route on the same inputs."""
    rng = np.random.default_rng(26)
    m = tokens * top_k
    sizes_np = routed_sizes(tokens, top_k, g, rng)
    sizes = torch.from_numpy(sizes_np).to(dev)
    lhs, rhs, dout = ragged_operands(m, d, f, g, dtype, dev, 26)
    calls = ragged_calls(lhs, rhs, dout, sizes)
    f32 = [t.float() for t in (lhs, rhs, dout)]
    # fp32 runs as three TF32 products (B1's row, phase 3)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
        else PEAK_TF32_FLOPS / 3
    size = lhs.element_size()
    iters = 10 if dtype == torch.bfloat16 else 5
    out = {"rows": m, "groups": g, "group_sizes": sizes_np.tolist(),
           "dtype": str(dtype).split(".")[-1]}
    for entry, (kernel, plain) in calls.items():
        name = f"{label} {out['dtype']} {entry}"
        got, route = routed(kernel)
        want = "hopper" if dtype == torch.bfloat16 else "tf32"
        check(route == want, f"{name}: took the {route} route, not the "
                             f"{want}")
        want32 = plain(*f32)
        err = hold_ragged(name, got, want32, dtype)
        plain_out = plain(lhs, rhs, dout)
        plain_err = float((plain_out.float() - want32).abs().max())
        del got, plain_out
        lib, lib_what = grouped_mm_call(entry, lhs, rhs, dout, sizes, want32)
        del want32
        ms = cuda_ms(kernel, iters)
        dms = device_ms(kernel, iters)
        with first_route():
            first_err = hold_ragged(f"{name} (first route)", kernel(),
                                    plain(*f32), dtype)
            first_ms = device_ms(kernel, 10 if dtype == torch.bfloat16
                                 else 3)
        plain_ms = cuda_ms(lambda: plain(lhs, rhs, dout), 3, warmup=1)
        if lib is None:                  # the per-expert loop it replaces
            lib_ms = plain_ms
            lib_what = f"per-expert cuBLAS loop (torch._grouped_mm: " \
                       f"{lib_what})"
        else:                  # back to back: the call reads on the host
            lib_ms = cuda_ms(lib, iters)
        # each operand read once, the output written once
        out_elems = (g * d * f) if entry == "wgrad" else \
            m * (d if entry == "input_grad" else f)
        in_elems = m * d + m * f if entry == "wgrad" else \
            (m * (f if entry == "input_grad" else d) + g * d * f)
        nbytes = (in_elems + out_elems) * size + 4 * g
        flops = 2.0 * m * d * f
        bound_ms = max(nbytes / PEAK_BYTES, flops / peak) * 1e3
        bound_by = "bytes" if nbytes / PEAK_BYTES >= flops / peak \
            else "operations"
        # the first route's: fp32 on IEEE FFMA, bf16 on the tensor cores
        first_peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
            else PEAK_FP32_FLOPS
        first_bound = max(nbytes / PEAK_BYTES, flops / first_peak) * 1e3
        first_by = "bytes" if nbytes / PEAK_BYTES >= flops / first_peak \
            else "operations"
        print(f"  [{CARD}] {name} (M={m}, K={d if entry != 'input_grad' else f}"
              f", N={f if entry != 'input_grad' else d}, G={g}), {route} "
              f"route: max |error| "
              f"{err:.3e} (plain version on these values {plain_err:.3e}); "
              f"device {dms:.4f} ms, back to back {ms:.4f} ms"
              f" (the first route on these inputs: device "
              f"{first_ms:.4f} ms); bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB, "
              f"{flops / 1e9:.1f} GFLOP; {bound_ms / dms:.1%}); plain "
              f"{plain_ms:.4f} ms; library {lib_ms:.4f} ms back to back "
              f"[{lib_what}]")
        out[entry] = {"max_abs_err": err, "plain_max_abs_err": plain_err,
                      "route": route, "first_route_ms": first_ms,
                      "first_route_max_abs_err": first_err,
                      "first_route_bound_ms": first_bound,
                      "first_route_bound_by": first_by,
                      "ms": dms, "back_to_back_ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library": lib_what, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        if route == "tf32":
            split = out[entry]["split"] = tf32_split_row(entry, lhs, dout,
                                                         sizes, iters)
            print(f"  [{CARD}] {name}: its split alone device "
                  f"{split['ms']:.4f} ms, bound {split['bound_ms']:.4f} ms "
                  f"(bytes: {split['bytes'] / 1e9:.3f} GB; "
                  f"{split['bound_ms'] / split['ms']:.1%}), plain "
                  f"{split['plain_ms']:.4f} ms, equal to the plain version "
                  f"bit for bit")
    del lhs, rhs, dout, f32, calls
    torch.cuda.empty_cache()
    return out


def ragged_edges(dev) -> dict:
    """The three entries at RAGGED_EDGE's odd shapes, fp32 and bf16, with
    one group holding every row, empty groups and rows past the sum, and
    160 groups: each against its plain version; the rows past the sum and
    the empty groups' weight gradients 0. All take the first route; its
    launches here (the counts set to 0 just before) are the summary
    line's ``edge_launches``, not main-path launches: no published width
    reaches the first route."""
    from repro_torch.kernels import ops
    m, k, n = RAGGED_EDGE
    rng = np.random.default_rng(27)
    worst = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for kind in ("one group holds every row",
                 "empty groups, 40 rows past the sum", "160 groups"):
        sizes_np = edge_sizes(kind, m, rng)
        sizes = torch.from_numpy(sizes_np).to(dev)
        used = int(min(sizes_np.sum(), m))
        for dtype in (torch.float32, torch.bfloat16):
            lhs, rhs, dout = ragged_operands(m, k, n, len(sizes_np), dtype,
                                             dev, 28)
            f32 = [t.float() for t in (lhs, rhs, dout)]
            for entry, (kernel, plain) in ragged_calls(lhs, rhs, dout,
                                                       sizes).items():
                got, route = routed(kernel)
                name = f"edge {kind} {str(dtype).split('.')[-1]} {entry}"
                check(route == "first", f"{name}: took the {route} route at "
                                        f"widths not multiples of 8")
                err = hold_ragged(name, got, plain(*f32), dtype)
                if entry == "wgrad":
                    check(not got[torch.from_numpy(sizes_np == 0)
                                  .to(dev)].any(),
                          f"{name}: an empty group's gradient is not 0")
                else:
                    check(not got[used:].any(),
                          f"{name}: a row past the groups is not 0")
                key = str(dtype).split(".")[-1]
                worst[key] = max(worst.get(key, 0.0), err)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(not any(ops.route_counts().values()),
          f"the edges took a Hopper route: {ops.route_counts()}")
    print(f"  [{CARD}] edge cases at (M, K, N) = {RAGGED_EDGE}, all on the "
          f"first route: one group "
          f"holding every row, empty groups and 40 rows past the sum, 160 "
          f"groups; forward, input gradient and weight gradient held to "
          f"their plain versions, rows past the sum and empty groups' "
          f"gradients 0; max |error| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; launches ragged_dot {launches['ragged_dot']}, "
            f"ragged_dot_wgrad {launches['ragged_dot_wgrad']}")
    return {"max_abs_err": worst,
            "launches": {name: launches[name]
                         for name in ("ragged_dot", "ragged_dot_wgrad")}}


def sync_frame(err: BaseException) -> str:
    """The innermost frame of the port in ``err``'s traceback."""
    import traceback
    frames = [fr for fr in traceback.extract_tb(err.__traceback__)
              if "repro_torch" in fr.filename]
    if not frames:
        return f"{type(err).__name__}: {err}"
    fr = frames[-1]
    return (f"{Path(fr.filename).name}:{fr.lineno} ({fr.name}: "
            f"{fr.line})")


def dropless_sync(dev) -> dict:
    """The dropless FFN's forward and backward at each MoE architecture's
    published widths (one layer's params, phase 21's 256 prefill tokens)
    under ``torch.cuda.set_sync_debug_mode("error")``: any host sync fails
    the phase. Then, not gated, whether a whole dropless prefill step and
    a whole train step (depth cut, SGD; the loss not read on the host)
    are sync-free, with the first sync's frame if not."""
    from repro_torch.configs import InputShape, concrete_inputs, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models.common import Init
    from repro_torch.models.ffn import init_moe, moe_dropless_forward
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import sgd, single_model
    out = {}
    for arch in MOE_CASES:
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(29)
        p = init_moe(Init(None, dev, gen), cfg)
        for v in p.values():
            if isinstance(v, torch.Tensor):
                v.requires_grad_()
        x = (torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), generator=gen,
                         device=dev) * 0.5).to(cfg.param_dtype)
        x.requires_grad_()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_dropless_forward(p, cfg, x)
            (y.float().square().mean() + aux).backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts["ragged_dot"] == 6 and counts["ragged_dot_wgrad"] == 3,
              f"{arch}: the FFN's forward and backward launched {counts}")
        check(bool(torch.isfinite(x.grad).all()),
              f"{arch}: non-finite input gradient")
        del p, x, y, aux
        torch.cuda.empty_cache()
        # whole steps, one layer (phase 22's deepseek-v2-236b cut)
        steps = {}
        cut = dataclasses.replace(cfg, n_layers=1)
        params = init_params(cut, dev, gen)
        for kind in ("prefill", "train"):
            shape = InputShape(kind, LM_PROMPT if kind == "prefill"
                               else TRAIN_SEQ, LM_BATCH if kind == "prefill"
                               else TRAIN_BATCH, kind)
            batch = concrete_inputs(gen, cut, shape, device=dev)
            if kind == "prefill":
                step = make_prefill_step(cut, moe_path="dropless",
                                         cache_seq=LM_PROMPT)
                args = (params, batch)
            else:
                opt = single_model(sgd(1e-4))
                step = make_train_step(cut, opt, moe_path="dropless")
                args = (params, opt.init(params), batch)
            with torch.no_grad() if kind == "prefill" else \
                    contextlib.nullcontext():
                step(*args)                      # warm: cuBLAS handles
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    step(*args)
                    steps[kind] = "sync-free"
                except RuntimeError as e:
                    steps[kind] = f"syncs at {sync_frame(e)}"
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            del batch, args, step
        del params
        torch.cuda.empty_cache()
        print(f"  [{CARD}] {arch} at its published widths (d_model "
              f"{cfg.d_model}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, "
              f"top {cfg.moe_top_k}): one dropless FFN's forward and "
              f"backward over {LM_BATCH} x {LM_PROMPT} tokens ran under "
              f"set_sync_debug_mode('error') with no host sync (ragged_dot "
              f"{counts['ragged_dot']}, ragged_dot_wgrad "
              f"{counts['ragged_dot_wgrad']} launches); not gated: a whole "
              f"dropless prefill step ({cut.n_layers} layers) "
              f"{steps['prefill']}; a whole train step (SGD, the loss not "
              f"read) {steps['train']}")
        out[arch] = {"ffn_sync_free": True, "steps": steps,
                     "launches": counts}
    return out


def ragged_phase(dev) -> dict:
    t0 = time.perf_counter()
    out = {"cases": {}}
    for label, tokens, k, d, f, g in RAGGED_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            out["cases"][f"{label} {str(dtype).split('.')[-1]}"] = \
                ragged_case(dev, label, tokens, k, d, f, g, dtype)
    out["edges"] = ragged_edges(dev)
    out["sync"] = dropless_sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 26 wall time {out['wall_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 27: the five walkthroughs (repro_torch.examples) on the card
# --------------------------------------------------------------------------
# the twins' eval logits are held in phase 5's band (hold_logits: within
# 1e-2, a prediction flipped only at a near tie) up to the first eval that
# leaves it, if one does; then the CPU run from weights one fp32 ulp off
# must leave it too (the CPU alone drifts as far)
WALK_TOL = 1e-2
WALK_DIR = ROOT / "build" / "walkthroughs"


@contextlib.contextmanager
def fit_launches(fits: list):
    """Inside, every ``fit`` of either engine appends (engine, the
    kernels launched during that fit) to ``fits``."""
    from repro_torch.core import AsyncFederationEngine, FederationEngine
    from repro_torch.kernels import ops
    originals = {cls: cls.fit for cls in (FederationEngine,
                                          AsyncFederationEngine)}

    def counted(fit):
        def run(self, *args, **kwargs):
            before = ops.launch_counts()
            try:
                return fit(self, *args, **kwargs)
            finally:
                after = ops.launch_counts()
                fits.append((self, {k: after[k] - before[k] for k in after}))
        return run

    for cls, fit in originals.items():
        cls.fit = counted(fit)
    try:
        yield fits
    finally:
        for cls, fit in originals.items():
            cls.fit = fit


def engine_state_tensors(eng) -> list:
    """Every tensor an engine holds (phase 5's check), the payloads of an
    asynchronous engine's uploads still in flight past its horizon
    included."""
    from repro_torch.optim import state_tensors
    fed = eng.fed
    tensors = [fed.ref_x, fed.ref_y, fed.targets, *fed.server]
    for sh in (sh for coh in fed.cohorts for sh in coh.shards):
        tensors += [*sh.model.parameters(), *state_tensors(sh.opt_state),
                    *sh.data.values()]
    for *_, ev in getattr(eng.clock, "_heap", ()):
        if ev.kind == "upload":
            tensors += list(ev.payload[1].arrays.values())
    return tensors


def walk(label: str, fn) -> tuple:
    """``fn()``, a walkthrough's run on the card, with its wall seconds
    and launches (the counts set to 0 just before, read just after) and
    each engine fit's launches."""
    from repro_torch.kernels import ops
    fits = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fit_launches(fits):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"  [{CARD}] {label}: {wall:.2f} s on the card, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return out, {"wall_s": wall, "launches": counts}, fits


def hold_fits(label: str, fits: list, engines: list) -> dict:
    """Fail unless the walkthrough's fits launched B1, B2 and the gather,
    each sqmd fit nothing off DENSE_PATH (B3's dense route never), each
    fedmd fit nothing off FEDMD_PATH, and every engine's state tensors
    lie on the card. Returns the dense route's GEMM and split launches
    (fedmd fits)."""
    check({id(e) for e in engines} == {id(e) for e, _ in fits},
          f"{label}: the engines returned are not the engines fitted")
    total = {k: sum(c[k] for _, c in fits) for k in fits[0][1]}
    check(all(total[k] > 0 for k in DENSE_PATH),
          f"{label}: B1, B2 or the gather never launched: {total}")
    dense = splits = 0
    for eng, counts in fits:
        name = eng.policy.name
        check(name in ("sqmd", "fedmd"), f"{label}: policy {name}")
        path = FEDMD_PATH if name == "fedmd" else DENSE_PATH
        check(all(v == 0 for k, v in counts.items() if k not in path),
              f"{label}: a {name} fit launched off its path: {counts}")
        if name == "fedmd":
            check(counts["neighbor_mean"] > 0,
                  f"{label}: the fedmd fit never took the dense route")
            dense += counts["neighbor_mean"]
            splits += counts["neighbor_mean_split"]
    n = 0
    for eng in engines:
        tensors = engine_state_tensors(eng)
        check(all(t.is_cuda for t in tensors),
              f"{label}: a state tensor is off the card")
        n += len(tensors)
    print(f"  {label}: {len(fits)} fits, all {n} state tensors on the card; "
          f"B3's dense route (fedmd fits only): {dense} GEMMs, {splits} "
          f"splits")
    return {"dense_route_launches": dense, "dense_split_launches": splits}


def eval_in_band(card_ev: dict, cpu_ev: dict, tol: float) -> bool:
    """hold_logits' test of one eval, without failing."""
    for fam in card_ev:
        g, h = card_ev[fam], cpu_ev[fam]
        flip = g.argmax(-1) != h.argmax(-1)
        top2 = np.sort(h, -1)[..., -2:]
        if (np.abs(g - h).max() >= tol
                or (top2[..., 1] - top2[..., 0])[flip].max(initial=0.0)
                >= 2 * tol):
            return False
    return True


def first_out_of_band(a_logits, b_logits, tol: float):
    """The first eval whose logits leave the band, or None."""
    return next((i for i, (a, b) in enumerate(zip(a_logits, b_logits))
                 if not eval_in_band(a, b, tol)), None)


def eval_gaps(a_logits, b_logits) -> list:
    """Per eval, the largest logit difference over the families."""
    return [max(float(np.abs(a[f] - b[f]).max()) for f in a)
            for a, b in zip(a_logits, b_logits)]


def edges_apart(a: np.ndarray, b: np.ndarray) -> tuple:
    """(edges only in a, edges only in b) of two (N, N) edge masks."""
    return ([tuple(map(int, e)) for e in np.argwhere(a & ~b)],
            [tuple(map(int, e)) for e in np.argwhere(b & ~a)])


def held_twins(dev, label: str, module, dataset, **kw) -> dict:
    """Walkthrough ``module`` on the card and on the CPU from the same
    numpy-made weights and batch draws (``dataset(60, 120)`` is its data),
    then on the CPU from those weights one fp32 ulp off. Fails unless the
    card's fits pass ``hold_fits``, the History bookkeeping is the CPU's,
    and the eval logits stay in WALK_TOL's band up to the first eval that
    leaves it, at round 0 at least; where the card leaves the band, the
    CPU's ulp-off run must leave it too. Prints that eval and the edges
    in which the two runs' collaboration graphs differ there."""
    from repro_torch.data import make_splits
    from repro_torch.models import hetero_mlp_zoo
    ds = dataset(samples_per_client=60, ref_size=120)
    splits = make_splits(ds, seed=0, label_noise=0.3)
    init, draws = numpy_seams(ds, splits,
                              hetero_mlp_zoo(ds.feature_len, ds.n_classes))

    def run(d, init_params):
        logits, edges = [], []

        def record_edges(engine, rnd, metrics):
            edges.append((engine.server.weights > 0).cpu().numpy())

        out = module.run(device=d, init_params=init_params,
                         batch_indices=lambda step, ci: draws(step, ci, 16),
                         callbacks=[logit_recorder(splits, logits),
                                    record_edges], **kw)
        return out, logits, edges

    (card, card_logits, card_edges), res, fits = walk(
        label, lambda: run(dev, init))
    res.update(hold_fits(label, fits, [card["engine"]]))
    t0 = time.perf_counter()
    cpu, cpu_logits, cpu_edges = run("cpu", init)
    res["cpu_twin_s"] = time.perf_counter() - t0
    _, ulp_logits, _ = run("cpu", one_ulp_off(init, 9))
    hist, cpu_hist = card["history"], cpu["history"]
    for key in ("rounds", "times", "server_rounds", "staleness", "bytes_up",
                "bytes_down"):
        check(getattr(cpu_hist, key) == getattr(hist, key),
              f"{label}: card and CPU runs kept different History.{key}")
    check(len(card_logits) == len(cpu_logits) == len(hist.rounds),
          f"{label}: the card and CPU runs evaluated at different points")
    check(all(np.isfinite(hist.mean_acc)), f"{label}: bad accuracy history")
    out_at = first_out_of_band(card_logits, cpu_logits, WALK_TOL)
    ulp_at = first_out_of_band(ulp_logits, cpu_logits, WALK_TOL)
    held = len(cpu_logits) if out_at is None else out_at
    check(held >= 1, f"{label}: the card left the band at round 0")
    worst = hold_logits(card_logits[:held], cpu_logits[:held], cpu_hist,
                        tol=WALK_TOL)
    graphs_at = next((i for i, (a, b) in enumerate(zip(card_edges,
                                                       cpu_edges))
                      if not np.array_equal(a, b)), None)
    gaps = eval_gaps(card_logits, cpu_logits)
    ulp_gaps = eval_gaps(ulp_logits, cpu_logits)
    rounds = hist.rounds
    print(f"  {label}: eval logits card vs CPU per eval (rounds {rounds}): "
          + ", ".join(f"{g:.2e}" for g in gaps))
    print(f"  {label}: CPU from weights one ulp off vs CPU per eval: "
          + ", ".join(f"{g:.2e}" for g in ulp_gaps))
    print(f"  {label}: graphs first differ at "
          + ("no eval" if graphs_at is None else f"round {rounds[graphs_at]}")
          + f"; mean accuracy card {hist.mean_acc[-1]:.4f}, CPU "
          f"{cpu_hist.mean_acc[-1]:.4f}")
    if "graph_stats" in card and np.array_equal(card_edges[-1],
                                                cpu_edges[-1]):
        # the same last graph: the same degrees, to the bit
        got, want = (r["graph_stats"]["out_degree"] for r in (card, cpu))
        check(got == want, f"{label}: graph_stats' out_degree {got!r} on "
                           f"the card, {want!r} on the CPU")
        print(f"  {label}: graph_stats' out_degree {got!r}, the CPU's "
              f"{want!r}")
    res.update({"evals": len(rounds), "held_evals": held,
                "cut_at_round": None if out_at is None else rounds[out_at],
                "ulp_off_leaves_at_round":
                    None if ulp_at is None else rounds[ulp_at],
                "graphs_differ_from_round":
                    None if graphs_at is None else rounds[graphs_at],
                "logit_gaps": gaps, "ulp_off_logit_gaps": ulp_gaps,
                "held_max_abs_diff": worst, "mean_acc": hist.mean_acc,
                "cpu_mean_acc": cpu_hist.mean_acc})
    if out_at is None:
        print(f"  {label}: held over all {held} evals")
        return res
    card_only, cpu_only = edges_apart(card_edges[out_at], cpu_edges[out_at])
    print(f"  {label}: held over {held} of {len(rounds)} evals; round "
          f"{rounds[out_at]} leaves the band (gap {gaps[out_at]:.3e}); "
          f"edges there on the card only {card_only}, on the CPU only "
          f"{cpu_only}")
    print(f"  {label}: the CPU run from weights one ulp off leaves the band "
          + ("at no eval" if ulp_at is None else f"at round {rounds[ulp_at]}"))
    check(ulp_at is not None,
          f"{label}: the card leaves the band at round {rounds[out_at]}, "
          f"the CPU from weights one ulp off never does")
    res.update({"cut_edges_card_only": card_only,
                "cut_edges_cpu_only": cpu_only})
    return res


def async_join_twin(dev) -> dict:
    """async_join on the card and on the CPU: every engine's
    bookkeeping (times, server rounds, candidates; staleness rows;
    uploads and fires) equal, their arrivals and triggers drawn by
    numpy."""
    from repro_torch.examples import async_join
    card, res, fits = walk("async_join", lambda: async_join.run(device=dev))
    res.update(hold_fits("async_join", fits,
                         [r["engine"] for r in card.values()]))
    t0 = time.perf_counter()
    cpu = async_join.run(device="cpu")
    res["cpu_twin_s"] = time.perf_counter() - t0
    for key, mine in card.items():
        theirs = cpu[key]
        if key.startswith("staged"):
            cols = [[(r[0], r[3], r[4]) for r in x["rows"]]
                    for x in (mine, theirs)]
        else:
            cols = [[(r[0], *r[2:]) for r in x["rows"]]
                    for x in (mine, theirs)]
        check(cols[0] == cols[1],
              f"async_join {key}: bookkeeping apart from the CPU's")
        check((mine["n_uploads"], mine["n_triggers"])
              == (theirs["n_uploads"], theirs["n_triggers"]),
              f"async_join {key}: uploads or fires apart from the CPU's")
        print(f"  async_join {key}: {len(cols[0])} rows, uploads "
              f"{mine['n_uploads']}, fires {mine['n_triggers']}, equal to "
              f"the CPU's; final accuracy card {mine['rows'][-1][1]:.4f}, "
              f"CPU {theirs['rows'][-1][1]:.4f}")
        res[key] = {"n_uploads": mine["n_uploads"],
                    "n_triggers": mine["n_triggers"],
                    "acc": mine["rows"][-1][1],
                    "cpu_acc": theirs["rows"][-1][1]}
    return res


def train_and_serve_twin(dev) -> dict:
    """train_and_serve on the card and on the CPU: per policy the
    requests served and snapshots published equal; the latencies, timed
    on the host, are printed, not compared."""
    from repro_torch.examples import train_and_serve
    card, res, fits = walk("train_and_serve",
                           lambda: train_and_serve.run(device=dev))
    res.update(hold_fits("train_and_serve", fits,
                         [r["engine"] for r in card.values()]))
    t0 = time.perf_counter()
    cpu = train_and_serve.run(device="cpu")
    res["cpu_twin_s"] = time.perf_counter() - t0
    for policy, mine in card.items():
        s, c = mine["summary"], cpu[policy]["summary"]
        for key in ("n_served", "snapshots_published"):
            check(s[key] == c[key],
                  f"train_and_serve {policy}: {key} {s[key]} on the card, "
                  f"{c[key]} on the CPU")
        print(f"  [{CARD}] train_and_serve {policy}: served {s['n_served']}, "
              f"snapshots {s['snapshots_published']} (the CPU's); latency "
              f"p50 {s['latency_p50_s'] * 1e3:.2f} ms, p99 "
              f"{s['latency_p99_s'] * 1e3:.2f} ms (CPU twin "
              f"{c['latency_p50_s'] * 1e3:.2f}, "
              f"{c['latency_p99_s'] * 1e3:.2f})")
        res[policy] = {k: s[k] for k in (
            "n_served", "snapshots_published", "latency_p50_s",
            "latency_p99_s", "queue_depth_max", "staleness_mean")}
    return res


def walkthrough_phase(dev) -> dict:
    """Phase 27: the five walkthroughs' ``run()`` on the card at the
    reference's published sizes, each timed with its launches; quickstart
    and the MLP train_sqmd_federation held to CPU twins (``held_twins``),
    async_join's and train_and_serve's bookkeeping equal to the CPU's,
    the ResNet federation's fits checked as the others', and serve_decode
    on gemma3-1b reduced and at full width launching no kernel of the
    port."""
    from repro_torch.data import pad_like, sc_like
    from repro_torch.examples import (quickstart, serve_decode,
                                      train_sqmd_federation)
    t_phase = time.perf_counter()
    out = {"quickstart": held_twins(dev, "quickstart", quickstart,
                                    pad_like)}
    out["async_join"] = async_join_twin(dev)
    out["train_and_serve"] = train_and_serve_twin(dev)
    out["train_sqmd_federation"] = held_twins(
        dev, "train_sqmd_federation", train_sqmd_federation, sc_like,
        ckpt=str(WALK_DIR / "mlp"))
    label = "train_sqmd_federation --resnet"
    ckpt = WALK_DIR / "resnet"
    res_out, res, fits = walk(label, lambda: train_sqmd_federation.run(
        device=dev, resnet=True, ckpt=str(ckpt)))
    res.update(hold_fits(label, fits, [res_out["engine"]]))
    check(np.all(np.isfinite(res_out["history"].mean_acc))
          and Path(res_out["checkpoint"]).stat().st_size > 0,
          f"{label}: bad accuracy history or no checkpoint")
    res["acc"] = res_out["acc"]
    out[label] = res
    for reduced in (True, False):
        label = f"serve_decode gemma3-1b {'reduced' if reduced else 'full'}"
        dec, res, fits = walk(label, lambda: serve_decode.run(
            device=dev, reduced=reduced))
        check(not fits and not any(res["launches"].values()),
              f"{label}: a kernel of the port launched: {res['launches']}")
        check(dec["tokens"].is_cuda and dec["generated"] == (4, 24),
              f"{label}: token grid {dec['generated']} off the card or "
              f"of another shape")
        res.update(prefill_s=dec["prefill_s"], decode_s=dec["decode_s"])
        out[label] = res
    launches = {k: sum(r["launches"][k] for r in out.values())
                for k in out["quickstart"]["launches"]}
    wall = time.perf_counter() - t_phase
    print(f"  phase 27 wall time {wall:.1f} s")
    return {"walkthroughs": out, "launches": launches, "wall_s": wall}


# the dropless MoE path timed against another checkout (--moe-against):
# phase 21's cuts (mixtral-8x7b 4 layers, deepseek-v2-236b 2) at the
# published widths, bf16
MOE_AGAINST_ITERS = 5


def moe_times(src: str) -> dict:
    """With the ``repro_torch`` of ``src``: each MoE architecture at its
    published widths in bf16 through a dropless forward of phase 21's
    batch 4 x prompt 64 at phase 21's depth cut (the prefill's work) and
    a dropless train step at one layer (SGD, ~10 B a param; phase 22's
    batch 8 x seq 128, the loss not read): host ms a call (median of
    MOE_AGAINST_ITERS after two warm-ups) and one call's kernels and
    device ms under the profiler; then the grouped product alone, phase
    26's nine bf16 rows on phase 26's inputs, device ms each with the
    kernels ``src`` picks."""
    sys.path.insert(0, src)
    from repro_torch.configs import InputShape, concrete_inputs, get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.optim import sgd, single_model
    global CARD
    CARD = smi("name,power.limit")
    dev = torch.device("cuda")
    out = {"src": src, "card": CARD}
    for arch in MOE_CASES:
        row = {}
        for kind, n_layers in (("prefill", LM_DEPTH_CUT[arch]),
                               ("train", 1)):
            cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
            gen = torch.Generator(device=dev).manual_seed(30)
            params = init_params(cfg, dev, gen)
            if kind == "prefill":
                prompts = torch.randint(0, cfg.vocab_size,
                                        (LM_BATCH, LM_PROMPT), generator=gen,
                                        dtype=torch.int32, device=dev)

                def fn():
                    with torch.no_grad():
                        return forward(params, cfg, tokens=prompts,
                                       moe_path="dropless")
            else:
                batch = concrete_inputs(gen, cfg, InputShape(
                    "train", TRAIN_SEQ, TRAIN_BATCH, "train"), device=dev)
                opt = single_model(sgd(1e-4))
                state = opt.init(params)
                step = make_train_step(cfg, opt, moe_path="dropless")

                def fn():
                    return step(params, state, batch)
            for _ in range(2):
                fn()
            ms = sorted(timed(fn)[1] for _ in range(MOE_AGAINST_ITERS))
            prof = device_breakdown(f"{arch} ({n_layers} layers) dropless "
                                    f"{kind}", fn)
            row[kind] = {"n_layers": n_layers, "ms": ms[len(ms) // 2],
                         "ms_all": ms, "device_ms": prof["device_ms"],
                         "kernels": prof.get("n_kernels"),
                         "busy_share": prof.get("busy_share")}
            del params, fn
            torch.cuda.empty_cache()
        out[arch] = row
    kernels = {}
    for label, tokens, top_k, d, f, g in RAGGED_CASES:
        rng = np.random.default_rng(26)
        sizes = torch.from_numpy(routed_sizes(tokens, top_k, g, rng)).to(dev)
        lhs, rhs, dout = ragged_operands(tokens * top_k, d, f, g,
                                         torch.bfloat16, dev, 26)
        for entry, (kernel, _) in ragged_calls(lhs, rhs, dout,
                                               sizes).items():
            kernels[f"{label} {entry}"] = device_ms(kernel, 10)
        del lhs, rhs, dout
        torch.cuda.empty_cache()
    out["ragged_device_ms"] = kernels
    return out


def moe_against(other: Path) -> int:
    """The dropless MoE path of another checkout (e.g. the parent commit,
    unpacked with git archive) and of this one, one process each, in
    turns: other, this, this, other. Prints the times; they also go to
    ``chiprun_out/moe_against.json``."""
    runs = []
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        res = subprocess.run([sys.executable, __file__, "--moe-times",
                              str(tree / "src")], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-5000:], file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["label"] = label
        runs.append(row)
        for arch in MOE_CASES:
            for kind in ("prefill", "train"):
                r = row[arch][kind]
                print(f"  [{row['card']}] {label:5s} {arch} "
                      f"({r['n_layers']} layers) dropless {kind}: "
                      f"{r['ms']:.2f} ms a call (median; all "
                      f"{[round(x, 2) for x in r['ms_all']]}), one call "
                      f"under the profiler {r['device_ms']} device ms in "
                      f"{r['kernels']} kernels, busy {r['busy_share']}")
        print(f"  [{row['card']}] {label:5s} grouped product, device ms: "
              + "; ".join(f"{k} {v:.4f}"
                          for k, v in row["ragged_device_ms"].items()))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "moe_against.json").write_text(json.dumps(runs, indent=2))
    return 0


def fp32_memory(src: str) -> dict:
    """With the ``repro_torch`` of ``src``: peak allocated GB on the card
    of phase 22's fp32 twins of the dropless MoE (``train_twin``, held to
    the CPU as there) and of one fp32 dropless FFN's forward and backward
    of each MoE architecture at its published widths over phase 22's
    batch (8 x 128 tokens), with the allocation before it and the
    grouped product's Hopper-route launches."""
    sys.path.insert(0, src)
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models.common import Init
    from repro_torch.models.ffn import init_moe, moe_dropless_forward
    global CARD
    CARD = smi("name,power.limit")
    dev = torch.device("cuda")
    out = {"src": src, "card": CARD, "twins": {}, "ffn": {}}
    for arch in ARCH_IDS:
        if get_reduced(arch).is_moe:
            for remat in (False, True):
                row = train_twin(dev, arch, "dropless", remat, 1)
                out["twins"][row["label"]] = row["peak_gb"]
    for arch in MOE_CASES:
        cfg = dataclasses.replace(get_config(arch),
                                  param_dtype=torch.float32)
        gen = torch.Generator(device=dev).manual_seed(29)
        p = init_moe(Init(None, dev, gen), cfg)
        for v in p.values():
            if isinstance(v, torch.Tensor):
                v.requires_grad_()
        x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                        device=dev) * 0.5
        x.requires_grad_()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, aux = moe_dropless_forward(p, cfg, x)
        (y.square().mean() + aux).backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out["ffn"][arch] = {
            "before_gb": base / 1e9, "peak_gb": peak / 1e9,
            "above_gb": (peak - base) / 1e9,
            "routes": {k: v for k, v in ops.route_counts().items() if v}}
        del p, x, y, aux
        torch.cuda.empty_cache()
    return out


def fp32_memory_against(other: Path) -> int:
    """``fp32_memory`` of another checkout (e.g. the parent commit,
    unpacked with git archive) and of this one, one process each, in
    turns: other, this, this, other. Prints the peaks; they also go to
    ``chiprun_out/fp32_memory.json``."""
    runs = []
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        res = subprocess.run([sys.executable, __file__, "--fp32-memory",
                              str(tree / "src")], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-5000:], file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["label"] = label
        runs.append(row)
        for name, gb in row["twins"].items():
            print(f"  [{row['card']}] {label:5s} {name}: peak {gb:.4f} GB")
        for arch, r in row["ffn"].items():
            print(f"  [{row['card']}] {label:5s} {arch} fp32 dropless FFN "
                  f"forward and backward over {TRAIN_BATCH} x {TRAIN_SEQ} "
                  f"tokens: peak {r['peak_gb']:.4f} GB, "
                  f"{r['above_gb']:.4f} above the {r['before_gb']:.4f} "
                  f"allocated before; Hopper-route launches {r['routes']}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fp32_memory.json").write_text(json.dumps(runs, indent=2))
    return 0


# the Hopper route of the grouped product with one part taken out, to see
# which part holds it (--ragged-variants): (name, (the text of
# csrc/ragged_dot.cu replaced, its replacement), ...)
RAGGED_VARIANTS = (
    ("no products",
     (("    wgmma_m64n256k16<TA, TB>(acc, da, db, (first && kk == 0) ? 0 : "
       "1);\n", ""),)),
    ("no loads", (("bar_expect(&full[slot], bytes);",
                   "bar_expect(&full[slot], 0);"),)),
    ("no stores", (("      if (row < rend && col < cols)\n",
                    "      if (row < 0)\n"),)))
# the same for the fp32 Hopper route (--ragged-variants fp32): each copy
# is csrc/ragged_dot_tf32.cu built with one of its diagnostic macros
# defined; "no split" is the weight gradient on whatever the planes hold
TF32_VARIANTS = (("no products", "RAGGED_TF32_NO_PRODUCTS"),
                 ("no loads", "RAGGED_TF32_NO_LOADS"),
                 ("no stores", "RAGGED_TF32_NO_STORES"),
                 ("no split", "RAGGED_TF32_NO_SPLIT"))


def ragged_variants(dtype=torch.bfloat16) -> int:
    """A Hopper route at phase 26's nine rows, device ms, beside copies of
    its source built without its products (loads and ring only), without
    its loads (products on whatever the ring holds) and without its
    stores (for fp32 also without the weight gradient's split), in turns
    (the tree's, each copy, the tree's): bf16's (csrc/ragged_dot.cu) or
    fp32's (csrc/ragged_dot_tf32.cu); a dense cuBLAS product of mixtral's
    whole train batch for scale. Prints the times; they also go to
    ``chiprun_out/ragged_variants[_fp32].json`` (no result line)."""
    import ctypes
    import re
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    global CARD
    CARD = smi("name,power.limit")
    build.build_all()
    fp32 = dtype == torch.float32
    source = "ragged_dot_tf32" if fp32 else "ragged_dot"
    src = (build.CSRC / f"{source}.cu").read_text()
    out_dir = build.BUILD_DIR / f"variants_{source}"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in (TF32_VARIANTS if fp32 else RAGGED_VARIANTS):
        so = out_dir / f"{name.replace(' ', '_')}.so"
        if fp32:
            cmd = [f"-D{edits}", "-o", str(so),
                   str(build.CSRC / f"{source}.cu")]
        else:
            text = src
            for old, new in edits:
                check(old in text, f"{name}: csrc/{source}.cu has no {old!r}")
                text = text.replace(old, new)
            if name == "no loads":       # and no TMA issued
                text = re.sub(r"(?m)^(\s+)tma_load\(", r"\1if (0) tma_load(",
                              text)
            cu = so.with_suffix(".cu")
            cu.write_text(text)
            cmd = ["-o", str(so), str(cu)]
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.FLAGS, *cmd], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    libs = {"tree": build.load(source)}
    for name, proc in procs.items():
        _, err = proc.communicate()
        check(proc.returncode == 0, f"{name}: nvcc failed: {err[-2000:]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name.replace(' ', '_')}.so"))

    def use(name):
        build._libs[source] = libs[name]
        build._entries.clear()

    dev = torch.device("cuda")
    rows = {}
    for label, tokens, top_k, d, f, g in RAGGED_CASES:
        rng = np.random.default_rng(26)
        m = tokens * top_k
        sizes = torch.from_numpy(routed_sizes(tokens, top_k, g, rng)).to(dev)
        lhs, rhs, dout = ragged_operands(m, d, f, g, dtype, dev, 26)
        for entry, (kernel, _) in ragged_calls(lhs, rhs, dout,
                                               sizes).items():
            row = {}
            for name in ("tree", *procs, "tree"):
                use(name)
                row.setdefault(name, []).append(
                    device_ms(kernel, 5 if fp32 else 10))
            rows[f"{label} {entry}"] = row
            print(f"  [{CARD}] {label} {entry} (M={m}) device ms: "
                  + "; ".join(f"{k} " + ", ".join(f"{x:.4f}" for x in v)
                              for k, v in row.items()), flush=True)
        if m == max(t * k for _, t, k, *_ in RAGGED_CASES):
            dense = device_ms(lambda: lhs @ rhs[0], 10)
            rows["dense cuBLAS"] = {"ms": dense, "shape": [m, d, f]}
            print(f"  [{CARD}] dense cuBLAS ({m}, {d}) @ ({d}, {f}) "
                  f"{str(dtype).split('.')[-1]}: {dense:.4f} ms, "
                  f"{2 * m * d * f / dense / 1e9:.0f} TFLOP/s")
        del lhs, rhs, dout
        torch.cuda.empty_cache()
    use("tree")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"ragged_variants{'_fp32' if fp32 else ''}.json").write_text(
        json.dumps({"card": CARD, "rows": rows}, indent=2))
    return 0


SOURCES = {
    "pairwise_kl_split": ("src/repro_torch/kernels/csrc/pairwise_kl.cu",
                          "src/repro/kernels/pairwise_kl.py:37"),
    "pairwise_kl_pair": ("src/repro_torch/kernels/csrc/pairwise_kl.cu",
                         "src/repro/kernels/pairwise_kl.py:37"),
    "soft_ce": ("src/repro_torch/kernels/csrc/soft_ce.cu",
                "src/repro/kernels/soft_ce.py:25"),
    "neighbor_gather": ("src/repro_torch/kernels/csrc/neighbor_gather.cu",
                        "src/repro/kernels/neighbor_mean.py:25"),
    # the dense Eq. 5 route: its two splits (W's on B1's split kernel,
    # S's transposing split of neighbor_mean.cu), then B1's GEMM in its
    # plain-store mode
    "neighbor_mean_split": ("src/repro_torch/kernels/csrc/neighbor_mean.cu",
                            "src/repro/kernels/neighbor_mean.py:25"),
    "neighbor_mean": ("src/repro_torch/kernels/csrc/pairwise_kl.cu",
                      "src/repro/kernels/neighbor_mean.py:25"),
    "int8_pairwise_kl_split": ("src/repro_torch/kernels/csrc/dequant_kl.cu",
                               "src/repro/kernels/dequant_kl.py:39"),
    "int8_pairwise_kl_thin": ("src/repro_torch/kernels/csrc/dequant_kl.cu",
                              "src/repro/kernels/dequant_kl.py:39"),
    # B4's wide route runs B1's 3xTF32 GEMM on the int8 splits
    "int8_pairwise_kl_pair": ("src/repro_torch/kernels/csrc/pairwise_kl.cu",
                              "src/repro/kernels/dequant_kl.py:39"),
    # no Pallas kernel: jax.lax.ragged_dot, one XLA op of the reference's
    # dropless MoE FFN (forward; the input gradient is the same kernel on
    # rhs read transposed), and its weight gradient: the first route
    # (fp32, odd widths) and the Hopper route (bf16 at K, N multiples of
    # 8: TMA, wgmma, persistent blocks)
    "ragged_dot": ("src/repro_torch/kernels/csrc/ragged_dot.cu",
                   "src/repro/models/ffn.py:151"),
    "ragged_dot_wgrad": ("src/repro_torch/kernels/csrc/ragged_dot.cu",
                         "src/repro/models/ffn.py:151"),
    "ragged_dot_tma": ("src/repro_torch/kernels/csrc/ragged_dot.cu",
                       "src/repro/models/ffn.py:151"),
    "ragged_dot_wgrad_tma": ("src/repro_torch/kernels/csrc/ragged_dot.cu",
                             "src/repro/models/ffn.py:151"),
    # and the fp32 Hopper route (fp32 at K, N multiples of 4: 3xTF32 on
    # wgmma): the forward's split of lhs (B1's split pass, counted on
    # this route) and its product, the weight gradient's transposing split
    # and its product
    "ragged_dot_tf32_split": ("src/repro_torch/kernels/csrc/pairwise_kl.cu",
                              "src/repro/models/ffn.py:151"),
    "ragged_dot_tf32": ("src/repro_torch/kernels/csrc/ragged_dot_tf32.cu",
                        "src/repro/models/ffn.py:151"),
    "ragged_dot_wgrad_tf32_split": (
        "src/repro_torch/kernels/csrc/ragged_dot_tf32.cu",
        "src/repro/models/ffn.py:151"),
    "ragged_dot_wgrad_tf32": ("src/repro_torch/kernels/csrc/ragged_dot_tf32.cu",
                              "src/repro/models/ffn.py:151"),
}
# the kernels each federation must launch (the dense Eq. 5 entry is on
# neither: both SQMD graphs carry their neighbor lists)
DENSE_PATH = ("pairwise_kl_split", "pairwise_kl_pair", "soft_ce",
              "neighbor_gather")
# B4's three kernels are on the IVF federation's path: its index's
# uploads take the thin kernel, its rebuilds and selects the wide route
# (the dequant split and the GEMM on int8 splits)
B4 = ("int8_pairwise_kl_split", "int8_pairwise_kl_thin",
      "int8_pairwise_kl_pair")
IVF_PATH = ("pairwise_kl_split", "pairwise_kl_pair", "soft_ce",
            "neighbor_gather", *B4)
# the baselines' paths: FedMD's complete graph takes the dense Eq. 5
# route, D-Dist's static lists the gather; neither runs Eq. 2, and I-SGD
# launches nothing
FEDMD_PATH = ("soft_ce", "neighbor_mean", "neighbor_mean_split")
DDIST_PATH = ("soft_ce", "neighbor_gather")
IVF_SERVER = dict(delta_graph=True, selection="ivf", uplink="int8")
# phase 14's horizon and eval period (virtual seconds)
ASYNC_UNTIL, ASYNC_EVAL_EVERY = 9.0, 3


def async_run(name: str, n: int) -> tuple:
    """(arrivals, trigger, FederationConfig settings) of the regime
    ``name`` ("staged", "straggler" or "bursty") for n clients."""
    from repro_torch.core import (BurstyArrivals, EveryKUploads, Quorum,
                                  ScheduleArrivals, StagedJoin,
                                  StragglerLatency)
    if name == "staged":
        # facility = family (clients round-robin over the three tiers),
        # joining at 0, 3 and 6
        return (ScheduleArrivals(StagedJoin([3 * (i % 3)
                                             for i in range(n)])), None, {})
    if name == "straggler":
        return (StragglerLatency(fraction=0.3, delay=2.5, seed=1),
                Quorum(frac=0.5), dict(delta_graph=True))
    if name == "bursty":
        return BurstyArrivals(), EveryKUploads(k=8), IVF_SERVER
    raise KeyError(name)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--b4-times":
        print(json.dumps(b4_times(sys.argv[2])))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--b4-against":
        return b4_against(Path(sys.argv[2]).resolve())
    if len(sys.argv) == 3 and sys.argv[1] == "--moe-times":
        print(json.dumps(moe_times(sys.argv[2])))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--moe-against":
        return moe_against(Path(sys.argv[2]).resolve())
    if len(sys.argv) == 3 and sys.argv[1] == "--fp32-memory":
        print(json.dumps(fp32_memory(sys.argv[2])))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--fp32-memory-against":
        return fp32_memory_against(Path(sys.argv[2]).resolve())
    if len(sys.argv) == 2 and sys.argv[1] == "--ragged-variants":
        return ragged_variants()
    if sys.argv[1:] == ["--ragged-variants", "fp32"]:
        return ragged_variants(torch.float32)
    if len(sys.argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

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
    DROPLESS.install()

    print("[3] kernels against their plain versions")
    rows = kernel_phase(dev)

    print("[4] server round at N=4096")
    server = server_phase(dev)

    print("[5] federation (main path)")
    inputs = federation_inputs()
    fedres = federation_phase(dev, {}, DENSE_PATH, inputs)

    print("[6] the int8 kernel's two routes against their plain version")
    int8_rows = int8_kernel_phase(dev)

    print(f"[7] delta server round at N={SERVER[0]}")
    delta = delta_phase(dev)

    print("[8] IVF neighbor index")
    ivf = ivf_phase(dev)

    print("[9] IVF federation (delta rounds, IVF selection, int8 uplink)")
    ivf_fed = federation_phase(dev, IVF_SERVER, IVF_PATH, inputs)

    print("[10] warm fits of both federations, in turns")
    fits = warm_fits(dev, inputs)

    print(f"[11] FedMD server round at N={SERVER[0]}")
    fedmd_round = fedmd_round_phase(dev)

    print("[12] baseline federations: FedMD, D-Dist, I-SGD")
    baselines = baseline_phase(dev, inputs)

    print("[14] asynchronous federations (fig. 4's regimes)")
    async_fed = async_federation_phase(dev, inputs)

    print(f"[15] asynchronous server at N={SERVER[0]}")
    async_server = async_server_phase(dev)

    print("[16] mixed zoo federation (mlp-s, resnet, transformer, ssm, "
          "rglru)")
    zoo_fed = zoo_phase(dev, "zoo", zoo_inputs(zoo_families, ZOO_SPEC),
                        ZOO_ROUNDS, iters=10, warm_profile=True)

    print("[17] the paper's client models: RESNET8/20/50")
    resnet_fed = zoo_phase(dev, "resnet8/20/50",
                           zoo_inputs(resnet_families, None),
                           RESNET_ROUNDS, iters=3, warm_profile=False)

    print("[18] train and serve: QueryRuntime on the asynchronous "
          "federation")
    serving = serve_phase(dev, inputs)

    print("[19] checkpoints")
    checkpoints = checkpoint_phase(dev, inputs)

    print("[20] the LM zoo's serving path: prefill and greedy decode")
    t0 = time.perf_counter()
    lm_serving = lm_serving_phase(dev)
    lm_serving["wall_s"] = time.perf_counter() - t0
    print(f"  phase 20 wall time {lm_serving['wall_s']:.1f} s")

    print("[21] MoE and MLA serving: mixtral-8x7b and deepseek-v2-236b")
    t0 = time.perf_counter()
    moe_serving = moe_serving_phase(dev)
    moe_serving["wall_s"] = time.perf_counter() - t0
    print(f"  phase 21 wall time {moe_serving['wall_s']:.1f} s")

    print("[22] LM training: fp32 twins, qwen2-0.5b at full width, the "
          "other architectures in bf16")
    t0 = time.perf_counter()
    lm_training = lm_training_phase(dev)
    lm_training["wall_s"] = time.perf_counter() - t0
    print(f"  phase 22 wall time {lm_training['wall_s']:.1f} s")

    print("[23] client-axis sharding: the row-strip Eq. 2 rebuild, ghost-"
          "padded federations, checkpoints across layouts")
    sharding = sharding_phase(dev, inputs)

    # B4's rows: the wide route's GEMM and splits at the server-round
    # strip, the thin kernel at a real upload's forward strip (N=10^6),
    # whose ms is its device time (device_ms): a back-to-back loop of
    # those calls measures the host's launch rate, not the kernel
    srv = int8_rows["server_strip"]
    rows["int8_pairwise_kl_pair"] = {
        "ms": srv["gemm_ms"], "plain_ms": srv["plain_ms"],
        "library_ms": srv["library_ms"], "bound_ms": srv["gemm_bound_ms"],
        "bound_by": srv["gemm_bound_by"],
        "max_abs_err": srv["wide_max_abs_err"],
        "wide_ms": srv["wide_ms"], "entry_ms": srv["entry_ms"]}
    rows["int8_pairwise_kl_split"] = int8_rows["split"]
    up = ivf[str(max(ANN_SIZES))]["upload_fwd"]
    rows["int8_pairwise_kl_thin"] = {
        "ms": up["thin_device_ms"], "plain_ms": up["plain_ms"],
        "back_to_back_ms": up["thin_ms"],
        "library_ms": up["library_device_ms"],
        "library_back_to_back_ms": up["library_ms"],
        "bound_ms": up["thin_bound_ms"],
        "bound_by": up["thin_bound_by"], "max_abs_err": up["thin_max_abs_err"],
        "entry_ms": up["entry_ms"]}
    # each kernel's launches come from the federation whose path it is
    # on, read around that federation's fit alone: B1, B2 and the gather
    # the main path's, B4's the IVF federation's (phase 9 fails unless
    # each launched there), the dense Eq. 5 route's the FedMD
    # federation's (phase 12 fails unless it launched every round)
    launches = dict(fedres["launches"])
    for name in B4:
        launches[name] = ivf_fed["launches"][name]
    for name in ("neighbor_mean", "neighbor_mean_split"):
        launches[name] = baselines["fedmd"]["launches"][name]
    # and the asynchronous path's, read around each run of phases 14-15,
    # the zoo federations' of phases 16-17, the serving runs' of phase 18
    # and the checkpoint phase's rounds and div_cache rebuild
    # and the sharded federations' of phase 23 (one B1 strip a shard)
    for res in [*async_fed.values(), *async_server.values(), zoo_fed,
                resnet_fed, serving, checkpoints, sharding]:
        for name in launches:
            launches[name] += res["launches"][name]

    print("[24] the static-analysis gate, the kernels at the launch rule's "
          "probe shapes, the cost model beside the bounds")
    analysis = analysis_phase(dev, rows)

    print("[25] the LM dry run: the 1x1 trace against a real step, then "
          "production-mesh rows")
    lm_dryrun = dryrun_phase(dev)

    print("[26] the dropless MoE's grouped product: the kernels against "
          "their plain versions at the MoE widths, the edges, sync-free")
    ragged = ragged_phase(dev)
    # the grouped product's rows: mixtral-8x7b's prefill forward and its
    # train batch's weight gradient, bf16 on the Hopper route, fp32 on
    # the fp32 Hopper route (its splits timed alone), the first route on
    # the fp32 inputs; their launches from the MoE paths' runs, phases 21
    # (serving: forwards) and 22 (training), each Hopper route's read off
    # its counters (bf16 at the published widths, the fp32 twins). No
    # published width reaches the first route: its main-path launches
    # are 0 (checked), it is off the main path, and its launches in
    # phase 26's edges at odd widths are a field of their own
    cases = ragged["cases"]
    prefill = cases["mixtral-8x7b prefill float32"]["forward"]
    train = cases["mixtral-8x7b train float32"]["wgrad"]
    for name, row in (
            ("ragged_dot_tma",
             cases["mixtral-8x7b prefill bfloat16"]["forward"]),
            ("ragged_dot_wgrad_tma",
             cases["mixtral-8x7b train bfloat16"]["wgrad"]),
            ("ragged_dot_tf32", prefill), ("ragged_dot_wgrad_tf32", train),
            ("ragged_dot_tf32_split", prefill["split"]),
            ("ragged_dot_wgrad_tf32_split", train["split"])):
        rows[name] = row
    for name, row, inputs in (
            ("ragged_dot", prefill, "mixtral-8x7b prefill float32 forward"),
            ("ragged_dot_wgrad", train,
             "mixtral-8x7b train float32 wgrad")):
        rows[name] = {"ms": row["first_route_ms"],
                      "max_abs_err": row["first_route_max_abs_err"],
                      "plain_ms": row["plain_ms"],
                      "library_ms": row["library_ms"],
                      "bound_ms": row["first_route_bound_ms"],
                      "bound_by": row["first_route_bound_by"],
                      "main_path": False, "timed_on": inputs,
                      "edge_launches": ragged["edges"]["launches"][name]}
    for name in ("ragged_dot", "ragged_dot_wgrad"):
        total = (moe_serving["launches"][name]
                 + lm_training["launches"][name])
        route = {r: (moe_serving["routes"][f"{name}.{r}"]
                     + lm_training["routes"][f"{name}.{r}"])
                 for r in ("tma", "tf32", "tf32_split")}
        launches[f"{name}_tma"] = route["tma"]
        launches[f"{name}_tf32"] = route["tf32"]
        launches[f"{name}_tf32_split"] = route["tf32_split"]
        launches[name] += total - route["tma"] - route["tf32"]
        check(launches[name] == 0,
              f"{name}: the main path launched the first route "
              f"{launches[name]} times at published widths")

    print("[27] the five walkthroughs (repro_torch.examples) on the card")
    walkthroughs = walkthrough_phase(dev)
    # and the walkthroughs' (none of the grouped product's: checked)
    for name, n in walkthroughs["launches"].items():
        launches[name] += n
    main_path = [name for name in SOURCES
                 if rows[name].get("main_path", True)]
    check(all(launches[name] > 0 for name in main_path),
          f"a kernel of the main path was launched no time: "
          f"{ {name: launches[name] for name in main_path} }")
    check(not any(launches[name] for name in SOURCES
                  if name not in main_path),
          f"the first route ran on the main path: "
          f"{ {name: launches[name] for name in SOURCES} }")
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": launches[name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"],
         **{key: rows[name][key] for key in ("main_path", "timed_on",
                                             "edge_launches")
            if key in rows[name]}}
        for name in SOURCES]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": rows, "int8_kernel": int8_rows,
         "server_round": server, "federation": fedres,
         "delta_round": delta, "ivf_index": ivf, "ivf_federation": ivf_fed,
         "warm_fits_s": fits, "fedmd_round": fedmd_round,
         "baseline_federations": baselines,
         "async_federations": async_fed, "async_server": async_server,
         "zoo_federation": zoo_fed, "resnet_federation": resnet_fed,
         "serving": serving, "checkpoints": checkpoints,
         "lm_serving": lm_serving, "moe_serving": moe_serving,
         "lm_training": lm_training, "sharding": sharding,
         "analysis": analysis, "lm_dryrun": lm_dryrun,
         "ragged_dot": ragged, "walkthroughs": walkthroughs,
         "wall_s": time.perf_counter() - t_start},
        indent=2, default=float))
    print(f"  total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"walkthroughs": {
        "card": card, "wall_s": walkthroughs["wall_s"], "runs": {
            label: {"wall_s": r["wall_s"], "cpu_twin_s": r.get("cpu_twin_s"),
                    "launches": {k: v for k, v in r["launches"].items()
                                 if v}}
            for label, r in walkthroughs["walkthroughs"].items()}}}))
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
