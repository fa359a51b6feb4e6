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
