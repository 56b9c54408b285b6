"""Length bucketing — static-shape batching for variable-length corpora.

A numpy-only copy of the JAX package's ``data/bucketing.py`` (the port
cannot import it: any module of that package pulls in jax). Under torch a
new batch length costs no compile, but the ladder keeps the batches the
JAX package forms, so both packages train on the same rows.

The reference pads every batch to its longest sequence at collate time
(``collate_fn_padd``, reference/ASV_dl_func.py:1220-1227), which under XLA
would compile one program per distinct batch length. Bucketing quantizes
lengths to a small fixed ladder instead: each sequence goes to the smallest
bucket that fits, batches form within a bucket, and the compiler sees only
``len(buckets)`` shapes (BASELINE config #4's "length-bucketed batches").

Padding semantics match the scorer's mask contract: padded frames are zero,
recovered downstream by ``score.padding_mask`` / masked losses.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterator

import numpy as np


def make_bucket_ladder(lengths: np.ndarray, n_buckets: int = 4) -> list[int]:
    """Quantile-based bucket boundaries covering all observed lengths."""
    qs = np.quantile(np.asarray(lengths), np.linspace(0, 1, n_buckets + 1)[1:])
    ladder = sorted(set(int(np.ceil(q)) for q in qs))
    if ladder[-1] < max(lengths):
        ladder[-1] = int(max(lengths))
    return ladder


def bucket_for(length: int, ladder: list[int]) -> int:
    """Smallest bucket length that fits; the top bucket catches the rest."""
    for b in ladder:
        if length <= b:
            return b
    return ladder[-1]


def bucketed_batches(
    sequences: list[np.ndarray],
    labels: np.ndarray,
    batch_size: int,
    *,
    ladder: list[int] | None = None,
    n_buckets: int = 4,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = False,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Yield (x (B, T_bucket, F), lengths (B,), y (B,), n_true) with zero
    padding. Batches are ALWAYS exactly ``batch_size`` rows: a short tail
    (or a bucket smaller than the batch) fills cyclically with repeats, so
    each jit sees at most ``len(ladder)`` input shapes. ``n_true`` is the
    number of non-repeat rows — exact metrics weight by it and mask the
    repeated tail rows out (``fit_bucketed`` does).

    Sequences are (T_i, F) arrays; batches never mix buckets. With
    ``shuffle`` the BATCH ORDER is also permuted across buckets — without
    that, every epoch would run short batches first (a length curriculum
    the reference's fully-shuffled collate does not have).
    """
    lengths = np.asarray([len(s) for s in sequences])
    if ladder is None:
        ladder = make_bucket_ladder(lengths, n_buckets)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(sequences)) if shuffle else np.arange(len(sequences))

    groups: dict[int, list[int]] = defaultdict(list)
    for i in order:
        groups[bucket_for(lengths[i], ladder)].append(i)

    batches: list[tuple[int, list[int], int]] = []
    for bucket_len in sorted(groups):
        idx = groups[bucket_len]
        for lo in range(0, len(idx), batch_size):
            sel = idx[lo : lo + batch_size]
            n_true = len(sel)
            if n_true < batch_size:
                if drop_last:
                    continue
                # cyclic tiling keeps the batch at exactly batch_size even
                # when the whole bucket is smaller than one batch
                sel = sel + [
                    idx[k % len(idx)] for k in range(batch_size - n_true)
                ]
            batches.append((bucket_len, sel, n_true))
    if shuffle:
        rng.shuffle(batches)

    feat_dim = sequences[0].shape[-1]
    for bucket_len, sel, n_true in batches:
        x = np.zeros((len(sel), bucket_len, feat_dim), dtype=np.float32)
        ls = np.empty(len(sel), dtype=np.int32)
        for j, i in enumerate(sel):
            seq = sequences[i][:bucket_len]
            x[j, : len(seq)] = seq
            ls[j] = len(seq)
        yield x, ls, labels[list(sel)], n_true
