"""K9's and K8's arms, on the CPU.

K9 (csrc/classic_classify.cu) has two arms, picked by
kernels.classic_arm from S, the layout and the card's shared-memory
budget: "local" (one block per read, its score row in shared memory)
takes a batch whose read's windows form one run, i.e. the uniform layout
or a scatter layout whose read ids ascend, and "global" every other.
The wrapper checks the ids itself (kernels.ids_ascend), so no caller
passes a flag.  These tests run the classic per-batch engine
(match/engine.py TpuEngine and match/oocore.py's chunks) on the golden
fixtures over every input route (single-end, paired-end, --six, reads
above MAXLEN_CAP split across batches, an identify_multiple folder,
oocore chunks, and -e, whose dedup hands the windows in key order) in
the scatter layout, capture each batch that reaches classify_batch, and
check that its read ids ascend, so that the wrapper picks the local arm;
and that the routed classic mesh's blocks, padded by route_queries as
kasa_tpu pads them, reach K9 with ids that ascend.

K8 (csrc/tiered_pass.cu) searches a chunk from its prefix table, which
gives the fixed bisect's pos where kasa_tpu's step count covers the
chunk; K7 keeps window order inside a chunk, so the read of a routed
window does not decrease along a chunk."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
CONTENT = GOLDEN / "exampleIndex_content.txt"

ROUTES = ("single", "paired", "six", "giant_split", "multiple", "oocore",
          "unique")
BUDGET = 232_448 - 64     # an H100's opt-in shared memory less K9's part


def _run_route(route, out, mp):
    """The classic per-batch engine over one input route, on the CPU, in
    the scatter layout (DENSE_MAX_S = 0)."""
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import chunking, engine, fast
    from kasa_tpu_torch.match.pipeline import identify, identify_multiple
    from test_torch_sort_arms import _giant_reads

    def unavailable(*a, **k):
        raise fast.FastPathUnavailable("the per-batch engine under test")
    mp.setattr(fast, "fast_identify", unavailable)
    mp.setattr(fast, "fast_identify_multi", unavailable)
    mp.setattr(engine, "DENSE_MAX_S", 0)
    cfg = Config()
    cfg.content_file = str(CONTENT)
    cfg.temp_path = str(out)
    index = str(GOLDEN / "exampleIndex")
    inp = str(FIXTURES / "reads.fastq")
    if route == "paired":
        cfg.paired_end_1 = str(FIXTURES / "reads_1.fastq")
        cfg.paired_end_2 = str(FIXTURES / "reads_2.fastq")
        inp = ""
    elif route == "six":
        cfg.six_frames = True
    elif route == "oocore":
        cfg.memory_avail = 1 << 20
    elif route == "unique":
        cfg.unique = True
    elif route == "giant_split":
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
def classic_batches(request, tmp_path_factory):
    """(route, [(read ids (M,) int32 or None, kmers_per_read)]) of every
    batch the route hands to classify_batch."""
    from kasa_tpu_torch.match import device as D
    seen = []
    orig = D.classify_batch

    def capture(t, q, read_ids, q_valid, num_reads, cap=16,
                kmers_per_read=0):
        seen.append((None if read_ids is None else read_ids.clone(),
                     kmers_per_read))
        return orig(t, q, read_ids, q_valid, num_reads, cap, kmers_per_read)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(D, "classify_batch", capture)
        _run_route(request.param, tmp_path_factory.mktemp(request.param),
                   mp)
    assert seen, f"{request.param}: the classic engine classified no batch"
    return request.param, seen


def test_classic_read_ids_ascend(classic_batches):
    """Every route but -e hands K9 read ids that ascend (one id per line,
    lines in order: ingest.py and chunking.py, then
    pipeline.encode_batch); -e's dedup sorts the windows by key, and its
    ids do not ascend."""
    from kasa_tpu_torch.kernels import ids_ascend
    route, batches = classic_batches
    for r, kpr in batches:
        assert kpr == 0 and r is not None and len(r) > 0
        assert ids_ascend(r) == (route != "unique")


def test_classic_arm_of_routes(classic_batches):
    """The arm the wrapper picks for those ids at the golden index's
    species count: local for every route but -e."""
    from kasa_tpu_torch.kernels import classic_arm, ids_ascend
    from kasa_tpu_torch.match.pipeline import load_content_for_identify
    S = load_content_for_identify(str(CONTENT)).num_species
    route, batches = classic_batches
    want = "global" if route == "unique" else "local"
    assert {classic_arm(S, ids_ascend(r), BUDGET)
            for r, _ in batches} == {want}


@pytest.mark.parametrize("S,ascending,want", [
    (1, True, "local"), (BUDGET // 8, True, "local"),
    (BUDGET // 8 + 1, True, "global"), (2047, False, "global"),
    (1, False, "global"), (10_001, True, "local")],
    ids=["one", "at_capacity", "above_capacity", "unsorted",
         "unsorted_one", "bigS"])
def test_classic_arm_edges(S, ascending, want):
    """K9's arm at the shared-row capacity (8 * S bytes of the budget),
    one species above it, and for ids that do not ascend."""
    from kasa_tpu_torch.kernels import classic_arm
    assert classic_arm(S, ascending, BUDGET) == want


@pytest.mark.parametrize("ids,want", [
    ([], True), ([3], True), ([0, 0, 1, 5, 5], True), ([0, 1, 0], False),
    ([2, 1], False)])
def test_ids_ascend(ids, want):
    from kasa_tpu_torch.kernels import ids_ascend
    assert ids_ascend(torch.tensor(ids, dtype=torch.int32)) is want


@pytest.mark.parametrize("ip", [2, 4])
def test_routed_blocks_ascend(ip, monkeypatch):
    """route_queries pads each (dp, ip) block with read id 0, as
    kasa_tpu's does; the routed classifier hands K9 the block with its
    pad cells on the last window's read id, so the ids ascend (the local
    arm) and every window keeps its own id."""
    from types import SimpleNamespace
    from kasa_tpu_torch.kernels import ids_ascend
    from kasa_tpu_torch.parallel import mesh as PM
    rng = np.random.default_rng(ip)
    m, R = 3000, 40
    q = rng.integers(0, 1 << 30, size=(m, 2)).astype(np.int32)
    rid = np.sort(rng.integers(1, R, size=m)).astype(np.int32)
    valid = rng.random(m) < 0.9
    lo = np.r_[np.iinfo(np.int32).min,
               np.arange(1, ip) * ((1 << 30) // ip)].astype(np.int32)
    si = SimpleNamespace(shard_lo=lo, num_shards=ip,
                         tables=SimpleNamespace(device=torch.device("cpu")))
    qb, rb, vb, dropped = PM.route_queries(si, q, rid, valid, 1, m)
    assert dropped == 0 and not ids_ascend(torch.from_numpy(rb[0, 0]))
    seen = []
    monkeypatch.setattr(PM, "_classify_over_ip",
                        lambda si, mesh, q, r, v, *a: seen.append((r, v)))
    for i in range(ip):
        run, _ = PM.make_routed_classifier(
            si, SimpleNamespace(ip=ip, dp_index=0, ip_index=i), R, m)
        run(qb, rb, vb)
    assert len(seen) == ip
    for i, (r, v) in enumerate(seen):
        assert ids_ascend(r)
        assert torch.equal(v, torch.from_numpy(vb[0, i]))
        assert torch.equal(r[v], torch.from_numpy(rb[0, i][vb[0, i]]))


@pytest.mark.parametrize("n", [1, 2, 7_000, 65_535, 65_536, 8_388_607,
                               8_388_608])
def test_tiered_steps_cover_chunk(n):
    """The fixed bisect's step count for a padded chunk of n rows
    (tiered._steps, kasa_tpu's) is n's bit length, the steps in which it
    converges on every path, so K8's search from its prefix table gives
    the same pos (kernels.tiered_pass refuses fewer)."""
    from kasa_tpu_torch.match.tiered import _steps
    assert _steps(n) == n.bit_length()


@pytest.mark.parametrize("C", [1, 4, 37])
def test_tiered_route_keeps_read_order(C):
    """tiered_route_plain's routed windows: inside each chunk's cut (and
    below the first chunk) the read posr // kpr never decreases."""
    from kasa_tpu_torch.match.tiered import tiered_route_plain
    rng = np.random.default_rng(C)
    R, kpr = 300, 41
    q = rng.integers(0, 1 << 30, size=(R * kpr, 2), dtype=np.int64)
    q = torch.from_numpy(q.astype(np.int32))
    l0 = torch.from_numpy(np.unique(rng.integers(0, 1 << 30, size=C))
                          .astype(np.int32))
    _, _, posr, cuts = tiered_route_plain(q, l0, 7, 12)
    bounds = [0] + cuts.tolist() + [R * kpr]
    rows = posr.long() // kpr
    for a, b in zip(bounds[:-1], bounds[1:]):
        assert bool((rows[a + 1:b] >= rows[a:b - 1]).all())


@pytest.mark.parametrize("seed,pad", [(1, 0), (2, 500), (3, 1)])
def test_tiered_prefix_brackets_lower_bound(seed, pad):
    """K8's prefix table (tiered_prefix_plain, which the kernel's table
    equals on the card): for every window, the bucket the kernel reads
    ((limb 0 - base) >> shift, clamped to the last bucket) starts at or
    before the window's lower bound in the padded rows and ends at or
    after it, also for windows above every real row and below the
    first."""
    from kasa_tpu_torch.match.tiered import PREFIX_BITS, tiered_prefix_plain
    rng = np.random.default_rng(seed)
    n = 20_000
    lo0 = int(rng.integers(0, 1 << 29))
    x = np.sort(rng.integers(lo0, lo0 + int(rng.integers(1 << 10, 1 << 29)),
                             size=n))
    rows = np.zeros((n + pad, 4), np.int64)
    rows[:n, 0], rows[:n, 1] = x, rng.integers(0, 1 << 30, size=n)
    rows[n:, :2] = np.iinfo(np.int32).max
    order = np.lexsort((rows[:, 1], rows[:, 0]))
    rows = torch.from_numpy(rows[order].astype(np.int32))
    pfx = tiered_prefix_plain(rows)
    base, shift = int(pfx[-2]), int(pfx[-1])
    q = rows[rng.integers(0, n, size=3000), :2].long()
    q[:1000, 1] ^= 7
    q[1000:1100] = torch.tensor([(1 << 30) - 1, (1 << 30) - 1])
    q[1100:1200, 0] = int(x[0]) - 1
    keys = (rows[:, 0].long() << 31) | rows[:, 1].long()
    lb = torch.searchsorted(keys, (q[:, 0] << 31) | q[:, 1])
    b = ((q[:, 0] - base).clamp(min=0) >> shift).clamp(
        max=(1 << PREFIX_BITS) - 1)
    assert bool((pfx[b].long() <= lb).all())
    assert bool((lb <= pfx[b + 1].long()).all())
