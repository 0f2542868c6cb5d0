"""The output check: the plain reference replays the first rounds from
the benchmark's inputs and judges what the port's same rounds produced.

The rounds judged are the first ``CHECK_ROUNDS`` that set-up drives
through ``run_round`` on the engine the window then times. Numbers
compared (each a relative gap, the worst over leaves or rounds):

* ``grad1_norm`` / ``grad1_max``: the first gradient as the optimizer
  got it (the momentum after round 0), per leaf: the gap between the
  port's and the reference's norms over max(the reference's norm of the
  leaf, the median leaf's); and the largest elementwise gap over the
  reference's largest entry of the leaf;
* ``change_norm`` / ``change_max``: the same for each leaf's change over
  the rounds;
* ``repo_max``: the repository rows merged (the uploads);
* ``grades_max``: Eq. 1's grades;
* ``div_max``: Eq. 2's divergence matrix;
* ``select_regret``: how far the port's pool and neighbours fall short
  of the best under the reference's grades and divergence (0 where the
  two agree or a near-tie decided; 1 where the choice breaks a rule:
  a pool of the wrong size or with inactive rows, a self-edge, a
  duplicate, a wrong count or weight);
* ``targets_max``: Eq. 5's targets after the downlink.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the elementwise and change numbers (they move by
round-off alone). The reference follows the port's own pool and
neighbours once ``select_regret`` has judged them, so a rounding near-tie
does not carry into the later rounds; where they break a rule it takes
its own. ``replay(judge=None)`` is the reference alone: its
observations can stand in for the port's (the control, and the faults
planted in it).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench import spec
from portbench.families.common import host
from portbench.inputs import Inputs
from portbench.reference import federation as ref
from portbench.reference.precision import dtype, flags

CHECK_ROUNDS = 3
NOUGHT = 1e-3          # a leaf's gradient under this x the median's
FAULTS = ("frozen", "half_batch", "answer")
NUMBERS = ("grad1_norm", "grad1_max", "change_norm", "change_max",
           "repo_max", "grades_max", "div_max", "select_regret",
           "targets_max")


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got = got.to(want.device, want.dtype)
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    return gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)


def selection_regret(got: dict, g: torch.Tensor, div: torch.Tensor,
                     active: torch.Tensor, q: int, k: int
                     ) -> Tuple[float, bool]:
    """(regret, whether the choice keeps every rule)."""
    dev = g.device
    cand = got["cand"].to(dev)
    nbrs = got["nbrs"].to(dev).long()
    slot = got["slot"].to(dev, div.dtype)
    n = g.shape[0]
    want = min(q, int(active.sum()))
    if bool((cand & ~active).any()) or int(cand.sum()) != want:
        return 1.0, False
    kk = ref.n_neighbours(n, k)
    if tuple(nbrs.shape) != (n, kk):
        return 1.0, False
    regret = 0.0
    if want:
        gs = torch.where(active, g, torch.full_like(g, math.inf))
        tau = float(torch.kthvalue(gs, want).values)
        worst = float(g[cand].max())
        regret = max(0.0, worst - tau) / max(abs(tau), 1e-30)
    rows = torch.arange(n, device=dev)
    valid = slot > 0
    cnt = valid.sum(dim=1)
    pool_n = int(cand.sum())
    expected = torch.clamp(pool_n - cand.long(), max=kk)
    legal = (nbrs >= 0) & (nbrs < n)
    safe = torch.where(legal, nbrs, torch.zeros_like(nbrs))
    ok_slot = ~valid | (legal & cand[safe] & (safe != rows[:, None]))
    ok_w = ~valid | torch.isclose(
        slot, 1.0 / torch.clamp(cnt, min=1).to(slot.dtype)[:, None], rtol=1e-6,
        atol=0)
    marked = torch.where(valid, safe, -1 - torch.arange(kk, device=dev))
    srt = torch.sort(marked, dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(dim=1)
    if not bool(((cnt == expected) & ok_slot.all(1) & ok_w.all(1)
                 & distinct).all()):
        return 1.0, False
    pool = torch.nonzero(cand).flatten()
    if pool.numel() == 0:
        return regret, True
    for i in range(0, n, ref.BLOCK):
        r = rows[i:i + ref.BLOCK]
        sub = ref.similarity_rows(div, r)[:, pool]
        sub = torch.where(pool[None, :] == r[:, None],
                          torch.full_like(sub, -math.inf), sub)
        take = int(min(kk, pool.numel()))
        kappa = torch.topk(sub, take, dim=1).values[:, -1]
        chosen = torch.gather(ref.similarity_rows(div, r), 1, safe[i:i + ref.BLOCK])
        chosen = torch.where(valid[i:i + ref.BLOCK], chosen,
                             torch.full_like(chosen, math.inf)).min(dim=1)
        has = expected[i:i + ref.BLOCK] > 0
        gap = torch.clamp(kappa - chosen.values, min=0) / kappa
        if bool(has.any()):
            regret = max(regret, float(gap[has].max()))
    return regret, True


def _leaf_numbers(got: Dict[str, Dict[str, torch.Tensor]],
                  want: Dict[str, Dict[str, torch.Tensor]],
                  counted: Dict[Tuple[str, str], bool]
                  ) -> Tuple[float, float]:
    """(norm gap, elementwise gap), each of the worst leaf."""
    norms = {(f, k): float(v.norm()) for f, leaves in want.items()
             for k, v in leaves.items()}
    med = float(np.median(list(norms.values())))
    gaps, max_gap = [], 0.0
    for (f, k), wn in norms.items():
        gv = got[f][k].to(want[f][k].device, want[f][k].dtype)
        gn = float(gv.norm())
        denom = max(wn, med)
        if denom > 0:
            gaps.append(abs(gn - wn) / denom)
        if counted[(f, k)]:
            max_gap = max(max_gap, rel_max(gv, want[f][k]))
    return max(gaps, default=0.0), max_gap


def replay(inputs: Inputs, device, *, rounds: int = CHECK_ROUNDS,
           precision: str = "fp32", judge: Optional[dict] = None,
           fault: Optional[str] = None, root=spec.ROOT,
           trail: Optional[list] = None
           ) -> Tuple[dict, Dict[str, float]]:
    """Run the plain reference for ``rounds`` rounds. Returns its
    observations (host tensors, laid out as the port's are read) and,
    with ``judge`` (such observations of another run of the same
    inputs), the numbers that judge them. ``fault`` plants one of
    ``FAULTS`` in the reference; ``trail`` (a list) gets each round's
    numbers."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    cfg = inputs.config
    pro, opt = cfg["protocol"], cfg["optimizer"]
    if pro["interval"] != 1:
        raise ValueError("the check replays a server round every round "
                         "(protocol interval 1)")
    n, c = inputs.n_clients, inputs.n_classes
    r = len(inputs.ref_y)
    kinds = {f["name"]: spec.reference_kind(f["kind"], root)
             for f in cfg["families"]}
    fwd = {f["name"]: functools.partial(kinds[f["name"]].forward, f)
           for f in cfg["families"]}
    dt = dtype(precision)
    params = {f["name"]: {k: v.to(device, dt, copy=True)
                          for k, v in inputs.weights[f["name"]].items()}
              for f, _ in inputs.cohorts}
    mom = {f: {k: torch.zeros_like(v) for k, v in p.items()}
           for f, p in params.items()}
    xs = [torch.as_tensor(inputs.x[ids], device=device).to(dt)
          for _, ids in inputs.cohorts]
    ys = [torch.as_tensor(inputs.y[ids], device=device)
          for _, ids in inputs.cohorts]
    ids_t = [torch.as_tensor(ids, device=device) for _, ids in inputs.cohorts]
    ref_x = torch.as_tensor(inputs.ref_x, device=device).to(dt)
    ref_y = torch.as_tensor(inputs.ref_y, device=device)
    repo = torch.full((n, r, c), float(np.float32(-math.log(c))),
                      dtype=dt, device=device)
    active = torch.zeros(n, dtype=torch.bool, device=device)
    targets = torch.full((n, r, c), 1.0 / c, dtype=dt, device=device)
    obs: dict = {"rounds": []}
    nums: Dict[str, float] = {}
    steps = int(cfg["local_steps"])

    def worst(name: str, value: float) -> None:
        nums[name] = max(nums.get(name, 0.0), value)
        if trail is not None:       # each round's numbers, for a look
            trail[-1][name] = value

    with flags(precision):
        for rnd in range(rounds):
            if trail is not None:
                trail.append({"round": rnd})
            avail = torch.as_tensor(inputs.available(rnd), device=device)
            for s in range(steps):
                for ci, (fam, _) in enumerate(inputs.cohorts):
                    if fault == "frozen":
                        continue
                    name = fam["name"]
                    idx = torch.as_tensor(inputs.draws(rnd * steps + s, ci),
                                          device=device)
                    rows = torch.arange(idx.shape[0], device=device)[:, None]
                    leaves = {k: v.detach().requires_grad_(True)
                              for k, v in params[name].items()}
                    with torch.enable_grad():
                        loss = ref.client_losses(
                            fwd[name], leaves, xs[ci][rows, idx],
                            ys[ci][rows, idx], ref_x, targets[ids_t[ci]],
                            pro["rho"], rnd > 0, precision,
                            half_batch=fault == "half_batch")
                        grads = torch.autograd.grad(loss.sum(),
                                                    list(leaves.values()))
                    with torch.no_grad():
                        ref.sgd_step(params[name], mom[name],
                                     dict(zip(leaves, grads)),
                                     avail[ids_t[ci]], opt["lr"],
                                     opt["momentum"])
            if rnd == 0:
                grad1 = {f: {k: v.clone() for k, v in m.items()}
                         for f, m in mom.items()}
            altered = fault != "answer"
            for ci, (fam, _) in enumerate(inputs.cohorts):
                on = avail[ids_t[ci]]
                if not bool(on.any()):
                    continue
                logp = ref.messengers(fwd[fam["name"]], params[fam["name"]],
                                      ref_x, precision)
                if not altered:     # one awake client's answer, rolled
                    first = int(torch.nonzero(on)[0])
                    logp[first] = torch.roll(logp[first], 1, dims=-1)
                    altered = True
                repo[ids_t[ci][on]] = logp[on]
            active |= avail
            g = ref.grades(repo, ref_y)
            div = ref.divergence(repo, precision)
            follow = False
            if judge is not None:
                got = judge["rounds"][rnd]
                worst("repo_max", rel_max(got["repo"], repo))
                worst("grades_max", rel_max(got["grades"], g))
                worst("div_max", rel_max(got["div"], div))
                regret, follow = selection_regret(got, g, div, active,
                                                  pro["q"], pro["k"])
                worst("select_regret", regret)
            if follow:
                cand = got["cand"].to(device)
                nbrs = got["nbrs"].to(device).long()
                slot = got["slot"].to(device, dt)
            else:
                cand = ref.candidates(g, active, pro["q"])
                nbrs, slot = ref.select(div, cand, pro["k"])
            targets = ref.targets(repo, nbrs, slot, active)
            if judge is not None:
                worst("targets_max", rel_max(got["targets"], targets))
            else:
                obs["rounds"].append({k: host(v) for k, v in (
                    ("repo", repo), ("grades", g), ("div", div),
                    ("active", active), ("cand", cand), ("nbrs", nbrs),
                    ("slot", slot), ("targets", targets))})
            del div
    final = {f: {k: v.detach() for k, v in p.items()}
             for f, p in params.items()}
    if judge is None:
        obs["grad1"] = {f: {k: host(v) for k, v in m.items()}
                        for f, m in grad1.items()}
        obs["final"] = {f: {k: host(v) for k, v in p.items()}
                        for f, p in final.items()}
        return obs, nums
    norms = {(f, k): float(v.norm()) for f, m in grad1.items()
             for k, v in m.items()}
    med = float(np.median(list(norms.values())))
    counted = {fk: v >= NOUGHT * med for fk, v in norms.items()}
    nums["grad1_norm"], nums["grad1_max"] = _leaf_numbers(
        judge["grad1"], grad1, counted)
    theta0 = {f: {k: v.to(device, dt) for k, v in inputs.weights[f].items()}
              for f in final}
    change_ref = {f: {k: final[f][k] - theta0[f][k] for k in final[f]}
                  for f in final}
    change_got = {f: {k: judge["final"][f][k].to(device, dt) - theta0[f][k]
                      for k in final[f]} for f in final}
    kept_ref = {f: {k: v for k, v in m.items() if counted[(f, k)]}
                for f, m in change_ref.items()}
    nums["change_norm"], nums["change_max"] = _leaf_numbers(
        change_got, kept_ref, {fk: True for fk, ok in counted.items() if ok})
    nums["leaves_left_out"] = float(sum(not ok for ok in counted.values()))
    return obs, nums


def verdict(nums: Dict[str, float], limits: dict) -> Tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}). A number whose limit is
    null is shown and not compared (its configuration's limits file says
    why)."""
    shown = {}
    ok = True
    for name in NUMBERS:
        lim = limits["numbers"][name]["limit"]
        value = nums.get(name, math.nan)
        if lim is not None:
            ok = ok and math.isfinite(value) and value <= lim
        shown[name] = {"value": value, "limit": lim}
    return ok, shown
