"""K12's read-id arm and K5's arms, on the CPU.

K12 (csrc/query_sort.cu) sorts the join path's windows by their limbs
alone (rid_bits = 0) and counts on the read ids the path hands it to
ascend already: a stable sort then keeps the (limbs, read id) order that
sort_queries_plain gives.  These tests run the join engine on the golden
fixtures over every input route (single-end, paired-end, --six, reads
above MAXLEN_CAP through the chunked reader with reads split across
batches, an identify_multiple folder), capture each batch that reaches
match/join.py sort_queries, and check that the path asks for the
ascending arm, that the batch's read ids ascend, and that a stable sort
by the limbs alone equals sort_queries_plain.

match_and_score works out that order from the read ids it is given, so
a batch whose ids do not ascend takes the read-id arm.

K5 (csrc/dedup.cu): the arm kernels.dedup_arm picks at each edge for
L = 2..5."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
CONTENT = GOLDEN / "exampleIndex_content.txt"

ROUTES = ("single", "paired", "six", "giant_split", "multiple")


def _giant_reads(directory):
    """fixtures/example.fasta's genomes joined into reads above
    MAXLEN_CAP, in 70-character lines, plus one short read."""
    from kasa_tpu_torch.host.fastx import iter_records
    from kasa_tpu_torch.match.fast import MAXLEN_CAP
    seqs = [r.seq for r in iter_records(str(FIXTURES / "example.fasta"))]
    reads = ["".join(seqs[:4]), "".join(seqs[4:]), seqs[0][:150]]
    assert len(reads[0]) > MAXLEN_CAP and len(reads[1]) > MAXLEN_CAP
    p = directory / "giant.fasta"
    p.write_text("".join(
        f">g{i}\n" + "".join(s[j:j + 70] + "\n" for j in range(0, len(s), 70))
        for i, s in enumerate(reads)))
    return str(p)


def _run_route(route, out, mp):
    """The join engine (--engine join) over one input route, on the CPU."""
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import chunking
    from kasa_tpu_torch.match.pipeline import identify, identify_multiple
    cfg = Config()
    cfg.engine = "join"
    cfg.content_file = str(CONTENT)
    index = str(GOLDEN / "exampleIndex")
    inp = str(FIXTURES / "reads.fastq")
    if route == "paired":
        cfg.paired_end_1 = str(FIXTURES / "reads_1.fastq")
        cfg.paired_end_2 = str(FIXTURES / "reads_2.fastq")
        inp = ""
    elif route == "six":
        cfg.six_frames = True
    elif route == "giant_split":
        # a soft budget small enough that the giant reads are split
        # across batches (tests/test_torch_classic_identify.py)
        mp.setattr(chunking, "_HUNDRED_MB", 24 * 2000)
        mp.setattr(chunking, "identify_soft_budget",
                   lambda *a, **k: 24 * 2000 + 24 * 6000)
        inp = _giant_reads(out)
    if route == "multiple":
        cfg.index_file = index
        cfg.input = str(FIXTURES / "multi")
        cfg.read_to_taxa_file = str(out / "q_")
        cfg.table_file = str(out / "p_")
        identify_multiple(cfg, device="cpu")
        return
    identify(cfg, index_path=index, input_path=inp,
             out_file=str(out / "o.json"), profile_file=str(out / "p.csv"),
             device="cpu")


@pytest.fixture(scope="module", params=ROUTES)
def join_batches(request, tmp_path_factory):
    """[(q (M, L) int32, read ids (M,) int32, ids_ascending)] of every
    batch the join engine's run over the route hands to sort_queries."""
    from kasa_tpu_torch.match import join as J
    seen = []
    orig = J.sort_queries

    def capture(q, read_ids, num_reads, ids_ascending=False):
        seen.append((q.clone(), read_ids.clone(), ids_ascending))
        return orig(q, read_ids, num_reads, ids_ascending=ids_ascending)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "sort_queries", capture)
        _run_route(request.param, tmp_path_factory.mktemp(request.param),
                   mp)
    assert seen, f"{request.param}: the join engine sorted no batch"
    return seen


def test_join_read_ids_ascend(join_batches):
    """The join path asks for K12's ascending arm, and each batch's read
    ids do ascend (one id per line, lines in order: ingest.py and
    chunking.py, then pipeline.encode_batch)."""
    for q, r, ascending in join_batches:
        assert ascending
        assert len(r) == len(q) > 0
        assert bool((r[1:] >= r[:-1]).all())


def test_limb_sort_equals_plain_on_join_batches(join_batches):
    """On those batches a stable sort by the limbs alone (what K12 does at
    rid_bits = 0) equals sort_queries_plain's (limbs, read id) order."""
    from kasa_tpu_torch.match.join import sort_queries_plain
    for q, r, _ in join_batches:
        order = torch.arange(len(r))
        for i in range(q.shape[1] - 1, -1, -1):
            order = order[torch.argsort(q[order, i], stable=True)]
        pq, pr = sort_queries_plain(q, r)
        assert torch.equal(q[order], pq) and torch.equal(r[order], pr)


@pytest.mark.parametrize("order", ["ascending", "permuted"])
def test_match_and_score_derives_id_order(order):
    """match_and_score asks K12 for its limbs-only arm exactly when the
    batch's read ids ascend: the first batch of fixtures/reads.fastq as
    encode_batch lays it out, and the same (window, read id) rows in a
    random order, whose counts must not change."""
    from kasa_tpu_torch.core.encode import Encoder
    from kasa_tpu_torch.index import artifacts
    from kasa_tpu_torch.match import ingest
    from kasa_tpu_torch.match import join as J
    from kasa_tpu_torch.match.device import StackedTables
    from kasa_tpu_torch.match.pipeline import (encode_batch,
                                               load_content_for_identify)
    limbs, taxids, hk, _ = artifacts.read_index(str(GOLDEN / "exampleIndex"))
    content = load_content_for_identify(str(CONTENT))
    batch = next(ingest.read_file_batches(
        str(FIXTURES / "reads.fastq"), ingest.BatchBuilder(hk, 7)))
    q, r = encode_batch(batch, Encoder(), hk, False, False)
    ji = J.JoinIndex(StackedTables.build(J.DeviceIndex(
        limbs, taxids, content.tax_to_idx, hk, 7, 12, content.num_species,
        "cpu")))
    want = J.match_and_score(ji, q, r, batch.num_reads, unique=True)
    if order == "permuted":
        perm = np.random.default_rng(9).permutation(len(r))
        q, r = q[perm], r[perm]
    asked = []
    orig = J.sort_queries

    def capture(q, read_ids, num_reads, ids_ascending=False):
        asked.append(ids_ascending)
        return orig(q, read_ids, num_reads, ids_ascending=ids_ascending)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "sort_queries", capture)
        got = J.match_and_score(ji, q, r, batch.num_reads, unique=True)
    assert asked == [order == "ascending"]
    assert got.counts_unique.sum() > 0
    np.testing.assert_array_equal(got.counts_all, want.counts_all)
    np.testing.assert_array_equal(got.counts_unique, want.counts_unique)
    np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("L", [2, 3, 4, 5])
def test_dedup_arm_edges(L):
    """K5's arm by shape: short up to DEDUP_CAP windows (the bitonic sort
    pads to a power of two), the shared-memory arm from DEDUP_CAP + 1 to
    the last kpr whose rows and indices fit one block (on the H100,
    232,448 bytes of which the kernel keeps 8,256 for itself), global
    above."""
    from kasa_tpu_torch.kernels import dedup_arm
    from kasa_tpu_torch.match.turbo import DEDUP_CAP
    last = (232_448 - 8_256) // (4 * L + 4)
    for kpr, arm in ((1, "short"), (DEDUP_CAP, "short"),
                     (DEDUP_CAP + 1, "long"), (last, "long"),
                     (last + 1, "global"), (65_536, "global")):
        assert dedup_arm(kpr, last) == arm, (kpr, L)
