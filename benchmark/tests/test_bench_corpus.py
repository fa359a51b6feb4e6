"""The benchmark's generator: deterministic for a seed, and the index
family of synth.py's genomes byte for byte on a tiny corpus."""

import os

import numpy as np
import pytest
import torch

from benchmark import corpus
from benchmark.tests import tiny


def _synth_family(cfg, directory):
    from kasa_tpu_torch import synth
    gen = synth._gen_genomes(np.random.default_rng(cfg["corpus_seed"]),
                             cfg["num_species"], cfg["genome_len"],
                             cfg["core_genes"], cfg["core_per_genome"])
    limbs, taxids = synth._index_from_genomes(gen, cfg["highest_k"])
    os.makedirs(directory)
    index = os.path.join(directory, "benchIndex")
    synth._write_artifacts(index, limbs, taxids, cfg["num_species"],
                           cfg["highest_k"])
    return index, gen


@pytest.mark.parametrize("name", ["dense2k", "wide2k"])
def test_index_family_matches_synth(name, tmp_path, monkeypatch):
    cfg = tiny.config(name)
    from kasa_tpu_torch import synth
    monkeypatch.setattr(synth, "ULTRA_GENOMES", cfg["ultra_genomes"])
    ref, gen = _synth_family(cfg, str(tmp_path / "synth"))
    assert np.array_equal(corpus.genomes(cfg),
                          np.stack([np.asarray(g) for g in gen]))
    mine = corpus.ensure_index(cfg, str(tmp_path / "mine"), "cpu",
                               log=lambda m: None)
    for suffix in ("", "_info.txt", "_content.txt", "_f.txt"):
        with open(ref + suffix, "rb") as a, open(mine + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    with open(os.path.join(str(tmp_path / "mine"), "DONE")) as fh:
        n = int(fh.read())
    assert n == corpus.records_to_words(
        np.fromfile(mine, corpus.REC_64 if cfg["highest_k"] == 12
                    else corpus.REC_128, count=n),
        cfg["highest_k"])[0].shape[0]


@pytest.mark.parametrize("traffic", ["long_e", "pe150_six"])
def test_reads_deterministic_for_a_seed(traffic):
    tr = tiny.traffic(traffic)
    cfg = tiny.config("dense2k")
    gen_t = torch.from_numpy(corpus.genomes(cfg))
    a = corpus.draw_ring(tr, gen_t, 2**31 + 12345)
    b = corpus.draw_ring(tr, gen_t, 2**31 + 12345)
    c = corpus.draw_ring(tr, gen_t, 7)
    assert len(a) == tr["ring_batches"]
    for x, y in zip(a, b):
        for (bx, ox), (by, oy) in zip(x, y):
            assert np.array_equal(bx, by) and np.array_equal(ox, oy)
    assert any(not np.array_equal(x[0][0], z[0][0]) for x, z in zip(a, c))
    # every seed draws the same set of sizes, in another order
    if not tr["paired"]:
        la = np.sort(np.concatenate([np.diff(m[0][1]) for m in a]))
        lc = np.sort(np.concatenate([np.diff(m[0][1]) for m in c]))
        assert np.array_equal(la, lc)
        assert la.min() >= tr["read_len_min"]
        assert la.max() <= tr["read_len_max"]
        assert not np.array_equal(np.diff(a[0][0][1]), np.diff(c[0][0][1]))
    for mates in a:
        for blob, offs in mates:
            assert set(np.unique(blob)) <= set(b"ACGT")
            assert offs[-1] == len(blob)
            assert len(offs) == tr["reads_per_batch"] + 1


def test_pairs_are_fr_mates_of_one_fragment():
    tr = tiny.traffic("pe150_six")
    tr["error_rate"] = 0.0
    cfg = tiny.config("dense2k")
    gen = corpus.genomes(cfg)
    ring = corpus.draw_ring(tr, torch.from_numpy(gen), 5)
    comp = np.zeros(256, np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    text = [g.tobytes() for g in gen]
    (b1, o1), (b2, o2) = ring[0]
    for r in range(5):
        m1 = b1[o1[r]:o1[r + 1]].tobytes()
        m2 = comp[b2[o2[r]:o2[r + 1]][::-1]].tobytes()
        hits = [g for g, t in enumerate(text) if m1 in t and m2 in t]
        assert hits
        t = text[hits[0]]
        ins = t.find(m2) + len(m2) - t.find(m1)
        assert tr["insert_min"] <= ins <= tr["insert_max"]


def _rc(seq: bytes) -> bytes:
    return seq.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def test_long_read_lengths_follow_the_lognormal():
    tr = dict(tiny.traffic("long_e"), read_len_mean=3000, read_len_sd=2300,
              read_len_min=100, read_len_max=8000)
    n = 1 << 16
    gen = torch.Generator().manual_seed(3)
    sizes = corpus._lognormal_sizes(tr, n, gen, "cpu").numpy()
    # PBSIM's defaults: the log-normal's mean, and 3.73 % cut to 8 kbp
    assert abs(np.mean(np.minimum(sizes, 8000)) - 2893) < 5
    assert abs(np.mean(sizes == 8000) - 0.0373) < 0.001
    assert abs(np.median(sizes) - 2381) < 3


@pytest.mark.parametrize("accuracy", [1.0, 0.8])
def test_long_reads_copy_both_strands_with_the_stated_errors(accuracy):
    tr = dict(tiny.traffic("long_e"), accuracy_mean=accuracy,
              accuracy_sd=0.0, accuracy_min=accuracy, accuracy_max=accuracy,
              reverse_share=0.5)
    cfg = tiny.config("dense2k")
    gen = corpus.genomes(cfg)
    text = [g.tobytes() for g in gen]
    ring = corpus.draw_ring(tr, torch.from_numpy(gen), 2**33 + 1)
    blob, offs = ring[0][0]
    fwd = rev = 0
    kept = []
    for r in range(len(offs) - 1):
        read = blob[offs[r]:offs[r + 1]].tobytes()
        if accuracy == 1.0:
            f = any(read in t for t in text)
            b = any(_rc(read) in t for t in text)
            assert f or b
            fwd, rev = fwd + f, rev + b
        else:
            # the share of 12-base words found unchanged in a genome on
            # either strand is about accuracy ** 12 (0.069 at 0.8)
            for s in (read, _rc(read)):
                words = [s[i:i + 12] for i in range(0, len(s) - 12, 12)]
                kept.append(np.mean([any(w in t for t in text)
                                     for w in words]))
    if accuracy == 1.0:
        assert fwd and rev
    else:
        share = np.mean(kept) * 2      # one strand of the two holds it
        assert 0.02 < share < 0.2, share
