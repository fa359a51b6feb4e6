"""kasa_tpu_torch.synth reproduces bench_corpus.py's generator: at a
tiny size (same seed, same code path) both write byte-identical index
families and read files, and the port identifies the corpus."""

import filecmp

import numpy as np
import torch

torch.set_num_threads(2)

TINY = dict(num_species=40, genome_len=2_000, core_genes=8, reads=300,
            small_reads=60, warm_reads=50)


def test_synth_matches_bench_corpus(tmp_path, monkeypatch):
    import bench_corpus as bc
    from kasa_tpu_torch import synth
    ref = tmp_path / "ref"
    ref.mkdir()
    for name, val in (("NUM_SPECIES", TINY["num_species"]),
                      ("GENOME_LEN", TINY["genome_len"]),
                      ("CORE_GENES", TINY["core_genes"]),
                      ("READS", TINY["reads"]),
                      ("SMALL_READS", TINY["small_reads"]),
                      ("WARM_READS", TINY["warm_reads"]),
                      ("DIR", str(ref)),
                      ("INDEX", str(ref / "benchIndex")),
                      ("READS_FQ", str(ref / "reads.fastq")),
                      ("READS_SMALL_FQ", str(ref / "reads_small.fastq")),
                      ("WARM_FQ", str(ref / "warm.fastq"))):
        monkeypatch.setattr(bc, name, val)
    bc.ensure_corpus(log=lambda *a: None)
    got = synth.generate(str(tmp_path / "port"), smoke_reads=100,
                         log=lambda *a: None, **TINY)
    assert got["n_entries"] > 10_000
    for suffix in ("", "_info.txt", "_trie", "_trie.txt", "_f.txt",
                   "_content.txt"):
        assert filecmp.cmp(str(ref / "benchIndex") + suffix,
                           got["index"] + suffix, shallow=False), suffix
    for name in ("reads.fastq", "reads_small.fastq", "warm.fastq"):
        assert filecmp.cmp(ref / name, tmp_path / "port" / name,
                           shallow=False), name
    head = open(got["smoke"], "rb").read().splitlines()
    assert len(head) == 400
    assert head == open(got["reads"], "rb").read().splitlines()[:400]


def test_synth_corpus_identifies(tmp_path):
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify
    p = synth.generate(str(tmp_path), smoke_reads=100, log=lambda *a: None,
                       **TINY)
    cfg = Config()
    ca, cu, nreads, nk = identify(cfg, index_path=p["index"],
                                  input_path=p["smoke"],
                                  out_file=str(tmp_path / "o.json"),
                                  profile_file=str(tmp_path / "p.csv"),
                                  device="cpu")
    assert nreads == 100
    # reads are sampled from the genomes: nearly every read hits
    assert cu.sum() > 0 and np.isfinite(ca).all()
    assert fast.LAST_FALLBACK[1] == 100


def test_synth_pairs_come_from_one_fragment(tmp_path):
    """Both mates of a pair lie on one fragment of their source genome:
    mate 1 at its start, mate 2 reverse-complemented at its end, the
    insert within INSERT_MIN..INSERT_MAX."""
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.core.alphabet import build_revcomp_lut
    p = synth.generate(str(tmp_path), smoke_reads=100, log=lambda *a: None,
                       **TINY)
    genomes = synth._gen_genomes(np.random.default_rng(synth.SEED),
                                 TINY["num_species"], TINY["genome_len"],
                                 TINY["core_genes"])
    mates = [open(f, "rb").read().splitlines() for f in p["pairs"]]
    assert len(mates[0]) == len(mates[1]) == 4 * 50
    revcomp = build_revcomp_lut()
    L = synth.READ_LEN

    def best_offset(genome, read):
        win = np.lib.stride_tricks.sliding_window_view(genome, L)
        dist = (win != read).sum(axis=1)
        return int(dist.argmin()), int(dist.min())

    for i in range(0, 200, 40):
        assert mates[0][i] == mates[1][i]
        g = genomes[int(mates[0][i].split(b"src")[1]) - 1]
        m1 = np.frombuffer(mates[0][i + 1], np.uint8)
        m2 = revcomp[np.frombuffer(mates[1][i + 1], np.uint8)][::-1]
        (o1, d1), (o2, d2) = best_offset(g, m1), best_offset(g, m2)
        assert d1 <= 6 and d2 <= 6
        assert synth.INSERT_MIN <= o2 + L - o1 <= synth.INSERT_MAX


def _agree_with_jax(tmp_path, index, reads, kr):
    """identify on `index` at k range kr, the port on the CPU against
    kasa_tpu's turbo run, under the contract.  Every hit of a read is
    written (-b large): the synthetic genomes share genes, so many reads
    tie at the third-best score, where the two packages' float sums may
    order the tied taxa differently."""
    import json
    from kasa_tpu.config import Config as JConfig
    from kasa_tpu.match.pipeline import identify as jidentify
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    from test_torch_identify import assert_identify_agrees
    res = None
    for who, cfg in (("j", JConfig()), ("t", Config())):
        cfg.lower_k, cfg.higher_k = kr
        cfg.num_of_beasts = 100_000
        kw = dict(index_path=index, input_path=reads,
                  out_file=str(tmp_path / f"{who}.json"),
                  profile_file=str(tmp_path / f"{who}.csv"))
        if who == "j":
            cfg.engine = "tpu"
            jidentify(cfg, **kw)
        else:
            res = identify(cfg, device="cpu", **kw)
    assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                           json.load(open(tmp_path / "t.json")),
                           (tmp_path / "j.csv").read_text(),
                           (tmp_path / "t.csv").read_text(),
                           kr[1] - kr[0] + 1)
    return res


def test_big_s_corpus_takes_the_sparse_fold(tmp_path, monkeypatch):
    """A small corpus of the large-species generator (4,100 species, more
    than SPARSE_FOLD_S, at a short genome length): the tables carry no
    hot tier, and identify takes the sparse fold in both packages at
    their default threshold and agrees."""
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.turbo import SPARSE_FOLD_S
    monkeypatch.setenv("KASA_MESH_DP", "1")
    p = synth.generate_big_s(str(tmp_path / "bigS"), num_species=4_100,
                             genome_len=400, core_genes=256,
                             smoke_reads=200, warm_reads=10,
                             log=lambda *a: None)
    assert p["num_species"] + 1 > SPARSE_FOLD_S
    assert not (tmp_path / "bigS" / "pairs_1.fastq").exists()
    ca, cu, nreads, _ = _agree_with_jax(tmp_path, p["index"], p["smoke"],
                                        (7, 12))
    assert nreads == 200 and cu.sum() > 0 and np.isfinite(ca).all()
    assert fast.LAST_DISPATCH.tt.hotmask.shape[0] == 1


def test_wide_corpus_is_the_default_genomes_at_k25(tmp_path, monkeypatch):
    """generate_wide writes the default corpus's genomes as a 128-bit
    index that kasa_tpu reads as the port does (sorted, distinct (k-mer,
    taxid) records); the default corpus's reads identify on it at k
    20..25 as in kasa_tpu's turbo run."""
    from kasa_tpu.index import artifacts as JA
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.index import artifacts as PA
    monkeypatch.setenv("KASA_MESH_DP", "1")
    small = {k: TINY[k] for k in ("num_species", "genome_len",
                                  "core_genes")}
    d = synth.generate(str(tmp_path / "d"), smoke_reads=100,
                       log=lambda *a: None, **TINY)
    w = synth.generate_wide(str(tmp_path / "w"), log=lambda *a: None,
                            **small)
    limbs, taxids, hk, itype = PA.read_index(w["index"])
    jl, jt, jhk, jtype = JA.read_index(w["index"])
    assert (hk, itype) == (jhk, jtype) == (25, PA.INDEX_TYPE_128)
    np.testing.assert_array_equal(limbs, jl)
    np.testing.assert_array_equal(taxids, jt)
    assert len(taxids) == w["n_entries"] > 10_000 and limbs.shape[1] == 5
    key = [tuple(r) + (t,) for r, t in zip(limbs[:2000].tolist(),
                                           taxids[:2000].tolist())]
    assert key == sorted(set(key))
    _, cu, nreads, _ = _agree_with_jax(tmp_path, w["index"], d["smoke"],
                                       (20, 25))
    assert nreads == 100 and cu.sum() > 0
