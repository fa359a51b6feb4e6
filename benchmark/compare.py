"""The comparison that decides `correct`: the answers and the profile of
a run against the plain reference, as numbers held to the cell's
limits (limits/<cell>.json)."""

from __future__ import annotations

import numpy as np
import torch

from . import reference

# the numbers, in the order they are printed
NAMES = ("answers_missing", "hits_wrong", "score_err", "unique_wrong",
         "profile_err")


def compare(answers: list, expected: dict, n_expected: int,
            counts_all: np.ndarray, counts_unique: np.ndarray,
            ref_all: np.ndarray, ref_unique: np.ndarray) -> dict:
    """answers: (ring, row, hit taxa, hit scores) of every compared read
    as produced; expected: (ring, row) -> (taxa ascending, float64
    scores) of the reference; n_expected: answers the run owes.
    -> answers_missing (owed, not produced), hits_wrong (answers whose
    hit count or taxa differ), score_err (the largest relative gap of a
    hit's score), unique_wrong (counts_unique cells that differ),
    profile_err (the largest gap of a counts_all cell over max(ref, 1))."""
    hits_wrong, score_err = 0, 0.0
    for b, r, ht, hk in answers:
        taxa, sc = expected[(b, r)]
        order = np.argsort(ht, kind="stable")
        if len(ht) != len(taxa) or np.any(ht[order] != taxa):
            hits_wrong += 1
            continue
        if len(taxa):
            gap = np.abs(hk[order].astype(np.float64) - sc) / sc
            score_err = max(score_err, float(gap.max()))
    ca = np.asarray(counts_all, np.float64)
    profile_err = float(np.max(np.abs(ca - ref_all)
                               / np.maximum(np.abs(ref_all), 1.0)))
    unique_wrong = int(np.count_nonzero(
        np.asarray(counts_unique, np.int64) != ref_unique))
    return dict(answers_missing=max(0, n_expected - len(answers)),
                hits_wrong=hits_wrong, score_err=score_err,
                unique_wrong=unique_wrong, profile_err=profile_err)


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NAMES)


def lines(numbers: dict, limits: dict) -> list:
    """One 'name number (limit L)' line a number."""
    return [f"check {k} {numbers[k]!r} (limit {limits[k]!r})" for k in NAMES]


class Reference:
    """The reference's view of a ring: per batch what it matches, its
    sampled reads' answers, and the profile of any sequence of passes."""

    def __init__(self, index_path: str, cfg: dict, traffic: dict, batches,
                 device):
        self.index = reference.Index(index_path, cfg["k_low"],
                                     cfg["k_high"], device)
        self.six, self.unique = traffic["six"], traffic["unique"]
        self.batches = batches

    def hits(self, bt):
        return reference.BatchHits(self.index, bt.mates, self.six,
                                   self.unique)

    def expected(self, bt, bh, dtype=torch.float64) -> dict:
        sc = reference.read_scores(self.index, bh, bt.sample, dtype)
        return {(bt.idx, int(r)): a for r, a in
                zip(bt.sample, reference.answers_of(sc))}


def check_window(ref: Reference, win, want_sectors: bool = False):
    """-> (numbers, key and taxa sectors per ring batch or None): the run's
    answers and profile against the reference, each ring batch counted
    as often as it was dispatched."""
    passes = np.bincount([rec.ring for rec in win.records],
                         minlength=len(ref.batches))
    expected, sectors, total = {}, {}, None
    n_expected = 0
    for bt in ref.batches:
        if passes[bt.idx] == 0:
            continue
        bh = ref.hits(bt)
        gh = bh.group_hits(ref.index)
        total = [g * int(passes[bt.idx]) for g in gh] if total is None \
            else [t + g * int(passes[bt.idx]) for t, g in zip(total, gh)]
        expected.update(ref.expected(bt, bh))
        n_expected += int(passes[bt.idx]) * len(bt.sample)
        sectors[bt.idx] = bh.key_sectors + bh.taxa_sectors
        del bh
    ca, cu = reference.profile_of(ref.index, total)
    numbers = compare(win.answers, expected, n_expected, win.counts_all,
                      win.counts_unique, ca.cpu().numpy(), cu.cpu().numpy())
    return numbers, (sectors if want_sectors else None)


def control(ref: Reference, order: list, dtype=torch.bfloat16) -> dict:
    """The control: the reference in `dtype` put in the program's place,
    over the ring batches in `order` (its scores and each batch's
    profile summed in `dtype`), held to the reference in float64."""
    idx = ref.index
    passes = np.bincount(order, minlength=len(ref.batches))
    contrib, answers, expected, total = {}, [], {}, None
    for bt in ref.batches:
        if passes[bt.idx] == 0:
            continue
        bh = ref.hits(bt)
        gh = bh.group_hits(idx)
        total = [g * int(passes[bt.idx]) for g in gh] if total is None \
            else [t + g * int(passes[bt.idx]) for t, g in zip(total, gh)]
        contrib[bt.idx] = reference.profile_of(idx, gh, dtype)
        expected.update(ref.expected(bt, bh))
        low = ref.expected(bt, bh, dtype)
        for _ in range(int(passes[bt.idx])):
            answers += [(b, r, t, s.astype(np.float32))
                        for (b, r), (t, s) in low.items()]
        del bh
    ca = torch.zeros_like(contrib[order[0]][0])
    cu = torch.zeros_like(contrib[order[0]][1])
    for b in order:
        ca += contrib[b][0]
        cu += contrib[b][1]
    ref_ca, ref_cu = reference.profile_of(idx, total)
    return compare(answers, expected, len(answers),
                   ca.to(torch.float64).cpu().numpy(), cu.cpu().numpy(),
                   ref_ca.cpu().numpy(), ref_cu.cpu().numpy())
