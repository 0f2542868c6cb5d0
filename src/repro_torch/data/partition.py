"""Client-shard utilities: train/val/test splits, sparsity simulation, and
cohort packing (stacking same-architecture clients into one batch axis).
A numpy-only copy of the reference's, so splits match bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import FederatedDataset


@dataclasses.dataclass
class ClientSplit:
    train_x: np.ndarray
    train_y: np.ndarray
    val_x: np.ndarray
    val_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray


def split_client(x: np.ndarray, y: np.ndarray, seed: int,
                 ratio=(8, 1, 1)) -> ClientSplit:
    """The paper's 8:1:1 random split per client.

    Tiny shards: the floor arithmetic zeroes out whole splits
    (``m * 1 // 10 == 0`` for m < 10 empties val; m <= 2 can empty train),
    and 0-row shards then poison evaluate/pad paths downstream. Whenever
    ``m`` allows, every split is guaranteed >= 1 sample by stealing from
    the largest split (train first as donor), prioritizing
    train > test > val as recipients; splits large enough for the pure
    ratio are bit-identical to the historical behaviour."""
    rng = np.random.default_rng(seed)
    m = len(y)
    perm = rng.permutation(m)
    total = sum(ratio)
    counts = [m * ratio[0] // total, m * ratio[1] // total]
    counts.append(m - counts[0] - counts[1])        # remainder -> test
    prio = (0, 2, 1)                                # train, test, val
    for i in prio:
        if counts[i]:
            continue
        donor = int(np.argmax(counts))
        if counts[donor] > 1:
            counts[donor] -= 1
            counts[i] += 1
        else:
            # fewer samples than splits: a lower-priority split gives up
            # its only sample (m=1 must yield a trainable client, not a
            # test-only one)
            for j in reversed(prio):
                if counts[j] and prio.index(j) > prio.index(i):
                    counts[j] -= 1
                    counts[i] += 1
                    break
    n_tr, n_va = counts[0], counts[1]
    idx_tr = perm[:n_tr]
    idx_va = perm[n_tr:n_tr + n_va]
    idx_te = perm[n_tr + n_va:]
    return ClientSplit(x[idx_tr], y[idx_tr], x[idx_va], y[idx_va],
                       x[idx_te], y[idx_te])


def apply_sparsity(split: ClientSplit, r_percent: float,
                   seed: int) -> ClientSplit:
    """Keep r% of the TRAINING samples (paper §IV-D sparsity simulation).
    Val/test untouched. Always keeps >= 2 samples."""
    rng = np.random.default_rng(seed)
    m = len(split.train_y)
    keep = max(2, int(round(m * r_percent / 100.0)))
    idx = rng.choice(m, keep, replace=False)
    return dataclasses.replace(split, train_x=split.train_x[idx],
                               train_y=split.train_y[idx])


def sliding_window_augment(x: np.ndarray, y: np.ndarray, window: int,
                           stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """The paper's sliding-window augmentation over each recording slice."""
    if x.shape[1] <= window:
        return x, y
    outs, labs = [], []
    for s in range(0, x.shape[1] - window + 1, stride):
        outs.append(x[:, s:s + window])
        labs.append(y)
    return np.concatenate(outs), np.concatenate(labs)


def pack_cohort(splits: Sequence[ClientSplit],
                pad_to: int = 0) -> Dict[str, np.ndarray]:
    """Stack same-architecture clients' train shards into (n_c, M, L) arrays
    (truncate/cycle-pad to a common M so vmap applies)."""
    m = pad_to or min(len(s.train_y) for s in splits)
    xs, ys = [], []
    for s in splits:
        x, y = s.train_x, s.train_y
        if len(y) < m:  # cycle-pad small shards
            reps = -(-m // len(y))
            x = np.tile(x, (reps, 1))[:m]
            y = np.tile(y, reps)[:m]
        xs.append(x[:m])
        ys.append(y[:m])
    return {"x": np.stack(xs), "y": np.stack(ys)}


def apply_label_noise(split: ClientSplit, noise: float, n_classes: int,
                      seed: int) -> ClientSplit:
    """Flip ``noise`` fraction of TRAINING labels uniformly (sensor/annotation
    noise — §I of the paper: 'a fully isolated model is prone to unreliable
    signals and noises if deployed on IoT sensors'). Val/test stay clean."""
    rng = np.random.default_rng(seed)
    y = split.train_y.copy()
    flip = rng.random(len(y)) < noise
    y[flip] = rng.integers(0, n_classes, flip.sum())
    return dataclasses.replace(split, train_y=y)


def make_splits(ds: FederatedDataset, seed: int = 0,
                sparsity_r: float = 100.0,
                label_noise: float = 0.0) -> List[ClientSplit]:
    splits = [split_client(ds.client_x[n], ds.client_y[n], seed + n)
              for n in range(ds.n_clients)]
    if sparsity_r < 100.0:
        splits = [apply_sparsity(s, sparsity_r, seed + 1000 + i)
                  for i, s in enumerate(splits)]
    if label_noise > 0.0:
        splits = [apply_label_noise(s, label_noise, ds.n_classes,
                                    seed + 2000 + i)
                  for i, s in enumerate(splits)]
    return splits
