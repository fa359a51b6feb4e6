"""The port's turbo mesh (kasa_tpu_torch/parallel/turbo_mesh.py) against
kasa_tpu's (kasa_tpu/parallel/turbo_mesh.py) on the CPU.

The port's mesh spans the ranks of a process group: the tests spawn CPU
gloo ranks (parallel/launch.py, start method spawn, one thread each)
that meet through a file:// rendezvous in tmp_path.  kasa_tpu's mesh
runs on the 8 virtual CPU devices of tests/conftest.py.  Both are held
to the contract of ROADMAP.md: integers identical, floats within rtol
2e-5 / atol 1e-4.  The step test runs both meshes with kasa_tpu's static
caps (the port's budgets at one BUDGET_SLOTS of slots a read are
kasa_tpu's), so the flags agree bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from test_turbo_mesh import NUM_READS, run_identify, synth_corpus
from test_torch_tables import drop_sidecars  # noqa: F401

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-4
RANK_TIMEOUT = 300       # seconds before hung ranks are killed
WORLD = 4
MESH_SHAPES = [(2, 2), (1, 4), (4, 1)]


def _port_single(idx, fq, out, prof):
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    cfg = Config()
    cfg.content_file = idx + "_content.txt"
    cfg.num_of_beasts = 100
    identify(cfg, index_path=idx, input_path=fq, out_file=out,
             profile_file=prof, device="cpu")


def _port_mesh(tmp_path, idx, fq, tag, env, profile=True):
    from kasa_tpu_torch.parallel.launch import run_cli
    out = str(tmp_path / f"{tag}.json")
    prof = str(tmp_path / f"{tag}.csv")
    args = ["identify", "-d", idx, "-c", idx + "_content.txt", "-i", fq,
            "-q", out, "-b", "100", "--device", "cpu"]
    if profile:
        args += ["-p", prof]
    recs = run_cli(WORLD, args, env=env, out_dir=str(tmp_path / tag),
                   threads=1, timeout=RANK_TIMEOUT)
    assert [r["result"] for r in recs] == [0] * WORLD, \
        open(recs[0]["log"]).read()
    return out, prof, open(recs[0]["log"]).read()


@pytest.fixture(scope="module")
def mesh_corpus(tmp_path_factory):
    """The mini bench corpus of tests/test_turbo_mesh.py, kasa_tpu's
    resident run and the port's single-device run."""
    d = tmp_path_factory.mktemp("torch_turbo_mesh")
    idx, fq = synth_corpus(d)
    with pytest.MonkeyPatch.context() as mp:
        run_identify(idx, fq, str(d / "jax1.json"), str(d / "jax1.csv"), mp,
                     dp=1, ip=1)
    _port_single(idx, fq, str(d / "port1.json"), str(d / "port1.csv"))
    return d, idx, fq


def _hits(path):
    return [{h["tax ID"]: float(h["k-mer Score"])
             for h in r["Top hits"] + r["Further hits"]}
            for r in json.load(open(path))]


def _agree(ref, got):
    a, b = _hits(ref), _hits(got)
    assert len(a) == len(b) == NUM_READS
    multi = 0
    for i, (ha, hb) in enumerate(zip(a, b)):
        assert set(ha) == set(hb), f"read {i}"
        multi += len(ha) > 1
        for t in ha:
            np.testing.assert_allclose(hb[t], ha[t], rtol=RTOL, atol=ATOL)
    return multi


def _profiles_agree(ref, got, num_k=6):
    el, tl = open(ref).read().splitlines(), open(got).read().splitlines()
    assert len(el) == len(tl) and el[0] == tl[0]
    for e, t in zip(el[1:], tl[1:]):
        ec, tc = e.split(","), t.split(",")
        assert ec[:2 + num_k] == tc[:2 + num_k]     # taxon + unique counts
        np.testing.assert_allclose(np.array(tc[2 + num_k:], float),
                                   np.array(ec[2 + num_k:], float),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dp,ip", MESH_SHAPES)
def test_cli_turbo_mesh_agrees_with_jax_mesh(tmp_path, monkeypatch,
                                             mesh_corpus, dp, ip):
    """The CLI at world 4 on (dp, ip) against kasa_tpu forced to the same
    shape, and against the port's own single-device run."""
    d, idx, fq = mesh_corpus
    jo, jp = str(tmp_path / "jax.json"), str(tmp_path / "jax.csv")
    run_identify(idx, fq, jo, jp, monkeypatch, dp=dp, ip=ip)
    po, pp, log = _port_mesh(tmp_path, idx, fq, "port",
                             {"KASA_MESH_DP": str(dp),
                              "KASA_MESH_IP": str(ip)})
    assert f"turbo mesh active: dp={dp} x ip={ip}" in log, log
    assert _agree(jo, po) > 10, "the corpus should exercise the merge"
    _profiles_agree(jp, pp)
    _agree(str(d / "port1.json"), po)
    _profiles_agree(str(d / "port1.csv"), pp)


def test_over_budget_index_shards_over_ip(tmp_path, mesh_corpus):
    """Tables over the device budget whose quarter fits: the port at
    world 4 shards them over ip = 4 (kasa_tpu's test_turbo_mesh.py
    test_over_budget_index_shards_over_ip) instead of streaming tiered
    chunks, and agrees with the resident runs."""
    from kasa_tpu_torch.index import artifacts
    from kasa_tpu_torch.match.fast import bytes_per_entry_resident
    d, idx, fq = mesh_corpus
    n, _ = artifacts.read_info(idx)
    budget = int(bytes_per_entry_resident(6) * n / 3)
    po, _, log = _port_mesh(tmp_path, idx, fq, "shard",
                            {"KASA_DEVICE_BUDGET": str(budget)},
                            profile=False)
    assert "turbo mesh active" in log and "ip=4" in log, log
    _agree(str(d / "port1.json"), po)
    _agree(str(d / "jax1.json"), po)


def test_identify_multiple_on_the_mesh(tmp_path, mesh_corpus):
    """A folder of two files with per-file profiles at (dp, ip) = (2, 2):
    each rank counts its block's reads into their files' slabs (a batch
    spans the file boundary); every output equals the port's
    single-device run of the folder under the contract."""
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify_multiple
    from kasa_tpu_torch.parallel.launch import run_cli
    d, idx, fq = mesh_corpus
    folder = tmp_path / "reads"
    folder.mkdir()
    lines = open(fq).read().splitlines(keepends=True)
    cut = 4 * 333
    (folder / "a.fastq").write_text("".join(lines[:cut]))
    (folder / "b.fastq").write_text("".join(lines[cut:]))
    cfg = Config()
    cfg.index_file, cfg.input = idx, str(folder)
    cfg.content_file = idx + "_content.txt"
    cfg.read_to_taxa_file = str(tmp_path / "one_")
    cfg.table_file = str(tmp_path / "one_")
    cfg.num_of_beasts = 100
    identify_multiple(cfg, device="cpu")
    recs = run_cli(WORLD, ["identify_multiple", "-d", idx, "-c",
                           idx + "_content.txt", "-i", str(folder), "-q",
                           str(tmp_path / "mesh_"), "-p",
                           str(tmp_path / "mesh_"), "-b", "100",
                           "--device", "cpu"],
                   env={"KASA_MESH_DP": "2", "KASA_MESH_IP": "2"},
                   out_dir=str(tmp_path / "ranks"), threads=1,
                   timeout=RANK_TIMEOUT)
    assert [r["result"] for r in recs] == [0] * WORLD
    assert "turbo mesh active" in open(recs[0]["log"]).read()
    for name, n in (("a", 333), ("b", NUM_READS - 333)):
        a, b = _hits(tmp_path / f"one_{name}.json"), \
            _hits(tmp_path / f"mesh_{name}.json")
        assert len(a) == len(b) == n
        for ha, hb in zip(a, b):
            assert set(ha) == set(hb)
            for t in ha:
                np.testing.assert_allclose(hb[t], ha[t], rtol=RTOL,
                                           atol=ATOL)
        _profiles_agree(str(tmp_path / f"one_{name}.csv"),
                        str(tmp_path / f"mesh_{name}.csv"))


# ---------------------------------------------------------------------------
# the pieces: shards, boundaries, K4's split, the step, K14's plain version

def _index(idx):
    from kasa_tpu_torch.index import artifacts
    from kasa_tpu_torch.match.join import map_tax_rows
    from kasa_tpu_torch.match.pipeline import load_content_for_identify
    limbs, taxids, _, _ = artifacts.read_index(idx)
    content = load_content_for_identify(idx + "_content.txt")
    return limbs, map_tax_rows(taxids, content.tax_to_idx), \
        content.num_species


def test_shards_match_jax_stacked_tables(mesh_corpus):
    """Shard s's fields equal kasa_tpu's stacked arrays at [s, :n_s]
    (grp2 un-strided from kasa_tpu's common stride); the whole index's
    host tables built without a sidecar equal kasa_tpu's host tables."""
    from kasa_tpu.parallel.turbo_mesh import ShardedTurboTables as JST
    from kasa_tpu_torch.parallel.turbo_mesh import (ShardedTurboTables,
                                                    whole_host_tables)
    _, idx, _ = mesh_corpus
    limbs, tax_rows, S = _index(idx)
    ip = 4
    jst = JST.build(limbs, tax_rows, 12, 7, 12, S, ip)
    host = whole_host_tables(None, limbs, tax_rows, 12, 7, 12, S)
    np.testing.assert_array_equal(host.host_masks,
                                  np.asarray(jst.host.host_masks))
    for f in ("host_grp_start", "host_d_tax", "host_grp_id"):
        for a, b in zip(getattr(host, f), getattr(jst.host, f)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    nmax = jst.keys2.shape[1]
    for s in range(ip):
        st = ShardedTurboTables.build(limbs, tax_rows, 12, 7, 12, S, ip, s,
                                      "cpu")
        np.testing.assert_array_equal(st.bounds, jst.bounds)
        p = st.shard
        ns = p.n
        np.testing.assert_array_equal(np.asarray(jst.keys2[s, :ns]),
                                      p.keys2.numpy())
        np.testing.assert_array_equal(np.asarray(jst.rowdat[s, :ns]),
                                      p.rowdat.numpy())
        g = np.asarray(jst.grp2[s]).reshape(6, nmax)[:, :ns].reshape(-1)
        np.testing.assert_array_equal(g, p.grp2.numpy())
        for f, jf in (("router", jst.router), ("sub2", jst.sub2),
                      ("d_tax4", jst.d_tax4), ("hotmask", jst.hotmask_s),
                      ("t_hot", jst.t_hot_s)):
            a = getattr(p, f).numpy()
            np.testing.assert_array_equal(np.asarray(jf[s, :a.shape[0]]),
                                          a, err_msg=f)
        assert p.num_steps <= jst.num_steps


@pytest.mark.parametrize("shards", [2, 3, 7, 64])
def test_prefix_aligned_boundaries_match_jax(shards):
    """Skewed limb-0 runs: a few runs hold most entries."""
    from kasa_tpu.parallel.mesh import prefix_aligned_boundaries as jpab
    from kasa_tpu_torch.parallel.mesh import prefix_aligned_boundaries
    rng = np.random.default_rng(shards)
    sizes = np.concatenate([rng.integers(1, 4, 200),
                            rng.integers(500, 3000, 5)])
    rng.shuffle(sizes)
    limb0 = np.repeat(np.arange(len(sizes), dtype=np.int32) * 7, sizes)
    np.testing.assert_array_equal(prefix_aligned_boundaries(limb0, shards),
                                  jpab(limb0, shards))


def _batch(idx, fq, R, six=False):
    """A padded read matrix of the corpus's first R reads (the drive
    loop's assembly)."""
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match.fast import BatchAssembler, _len_bucket
    from kasa_tpu_torch.native import load_fastx, sanitize_inplace
    seq, off, _, _, _ = load_fastx(fq, True)
    sanitize_inplace(seq, False)
    asm = BatchAssembler(12, 7, six=six)
    lens = np.diff(off[:R + 1])
    maxlen = _len_bucket(int(lens.max()) + asm.marker_len, asm.min_line)
    mat = asm.assemble(seq[:off[R]], off[:R + 1].astype(np.int64), maxlen,
                       R)
    return mat, asm.window_target(maxlen), \
        np.asarray(build_codon_code_lut(), np.int32)


def _k4_inputs(idx, fq, R):
    from kasa_tpu_torch.core.encode import encode_windows
    from kasa_tpu_torch.match.turbo import (build_tables_np,
                                            tables_from_numpy,
                                            turbo_match, turbo_reads_pre)
    limbs, tax_rows, S = _index(idx)
    tt = tables_from_numpy(*build_tables_np(limbs, tax_rows, 12, 7, 12, S),
                           "cpu")
    mat, w, lut = _batch(idx, fq, R)
    q = encode_windows(torch.from_numpy(mat), torch.from_numpy(lut), w,
                       False, False, 12)
    skey, mpay = turbo_match(q, tt, R, w)
    ck, cc, runs, mcnt, cp = turbo_reads_pre(skey, mpay)
    return tt, cp, mcnt, runs


def test_k4_split_leaves_single_device_bit_identical(mesh_corpus):
    """turbo_multi_plain with flag_reduce=None, and split with an
    identity reduce, give the same bits; a reduce that ORs in other
    reads' flags zeroes exactly those reads' contributions and leaves
    every other read's score row bit for bit."""
    from kasa_tpu_torch.match.turbo import turbo_multi_plain
    _, idx, fq = mesh_corpus
    R = 512
    tt, cp, mcnt, runs = _k4_inputs(idx, fq, R)
    S = tt.num_species

    def run(reduce, budget=1 << 19, m=None):
        acc = torch.zeros((6, S), dtype=torch.float32)
        out = turbo_multi_plain(cp, mcnt if m is None else m, runs, tt, acc,
                                budget, 1 << 19, flag_reduce=reduce)
        return (acc,) + tuple(out)
    base = run(None)
    for a, b in zip(base, run(lambda f: f)):
        assert torch.equal(a, b)
    extra = torch.zeros(R, dtype=torch.bool)
    extra[::5] = True
    acc, ofc, dm, a3w, a3c, diag = run(lambda f: f | extra)
    assert torch.equal(ofc, base[1] | extra)
    assert bool((dm[ofc] == 0).all()) and bool((a3w[ofc] == 0).all())
    keep = ~ofc
    assert torch.equal(dm[keep], base[2][keep])
    assert torch.equal(a3w[keep], base[3][keep])
    # the counts equal a run in which the extra reads have no multi slots
    acc2, *_ = run(None, m=torch.where(extra, 0, mcnt))
    np.testing.assert_allclose(acc.numpy(), acc2.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert int(diag[1]) <= int(base[5][1])


def _rank_step(idx, fq, R, dp, ip, mb):
    """One rank of the step test: this rank's dp block through the
    port's mesh step at multi-slot budget `mb`; returns (dp-gathered
    packed rows, ht_m, hk_m, the world-summed counts, this shard's K4
    cut flags before the OR over ip)."""
    from kasa_tpu_torch.parallel import turbo_mesh as TM
    from kasa_tpu_torch.parallel.dist import (gather_over,
                                              make_identify_mesh, or_over,
                                              sum_over)
    from kasa_tpu_torch.parallel.turbo_mesh import (ShardedTurboTables,
                                                    turbo_mesh_step)
    from kasa_tpu_torch.match.turbo import CSR_CAP_FACTOR, EXP_BUDGET, WOUT
    seen = []

    def recording_or(group, flags):
        seen.append(flags.clone())
        return or_over(group, flags)
    # the step's first OR over ip is K4's cut (flag_reduce)
    TM.or_over = recording_or
    mesh = make_identify_mesh(ip=ip, dp=dp)
    limbs, tax_rows, S = _index(idx)
    st = ShardedTurboTables.build(limbs, tax_rows, 12, 7, 12, S, ip,
                                  mesh.ip_index, "cpu")
    mat, w, lut = _batch(idx, fq, R)
    Rl = R // dp
    d = mesh.dp_index
    acc_ca = torch.zeros((6, S), dtype=torch.float32)
    acc_cu = torch.zeros((6, S), dtype=torch.int32)
    packed, ht, hk = turbo_mesh_step(
        st, mesh, torch.from_numpy(mat[d * Rl:(d + 1) * Rl].copy()),
        torch.from_numpy(lut), acc_ca, acc_cu, Rl, w, CSR_CAP_FACTOR * Rl,
        mb, EXP_BUDGET, WOUT)
    sum_over(None, acc_ca)
    sum_over(None, acc_cu)
    return tuple(gather_over(mesh.dp_group, t).numpy()
                 for t in (packed, ht, hk)) + (acc_ca.numpy(),
                                               acc_cu.numpy(),
                                               seen[0].numpy())


# the multi-slot budget of the flagged case: the first dp block's
# shards hold 2,770 and 2,955 multi slots (its second block's 4,212 and
# 4,167), so there shard 1 alone overflows and flags its reads; the
# corpus's multi slots are all hot-set, so the expansion budget flags
# nothing at any size
FLAG_MB = 2900


@pytest.mark.parametrize("mb", [None, FLAG_MB],
                         ids=["default-budget", "flagged-on-one-shard"])
def test_mesh_step_matches_jax_step(tmp_path, mesh_corpus, monkeypatch,
                                    request, mb):
    """The port's step at (dp, ip) = (2, 2) against kasa_tpu's
    make_turbo_mesh_step on the same batch: packed rows (hc, flags, CSR
    taxa, tail) identical, ksums within the contract; merged lists;
    counts.  At FLAG_MB both sides run the same low multi-slot budget
    (kasa_tpu's MULTI_BUDGET patched), reads are flagged, some on one
    shard only: the OR over ip before any count is masked is what keeps
    the summed counts equal (kasa_tpu turbo_mesh.py:209-214)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import kasa_tpu.match.turbo as JT
    from kasa_tpu.parallel.turbo_mesh import (ShardedTurboTables as JST,
                                              make_turbo_mesh_step)
    from kasa_tpu_torch.match.turbo import MULTI_BUDGET
    from kasa_tpu_torch.parallel.launch import run_ranks
    _, idx, fq = mesh_corpus
    dp, ip, R = 2, 2, 512
    mb = mb or MULTI_BUDGET
    recs = run_ranks(dp * ip, "test_torch_turbo_mesh:_rank_step",
                     (idx, fq, R, dp, ip, mb),
                     out_dir=str(tmp_path / "ranks"), device="cpu",
                     threads=1, timeout=RANK_TIMEOUT)
    packed, ht, hk, ca, cu, _ = recs[0]["result"]
    # rank = dp_index * ip + ip_index: each dp block's shards' cut flags
    cuts = np.stack([[recs[d * ip + s]["result"][5] for s in range(ip)]
                     for d in range(dp)])
    one_shard = cuts.sum(axis=1) == 1

    # kasa_tpu reads MULTI_BUDGET when it traces; drop every cached
    # trace on both sides of the patch
    jax.clear_caches()
    request.addfinalizer(jax.clear_caches)
    monkeypatch.setattr(JT, "MULTI_BUDGET", mb)

    from kasa_tpu.core.encode import build_codon_code_lut
    limbs, tax_rows, S = _index(idx)
    mat, w, _ = _batch(idx, fq, R)
    lut = np.asarray(build_codon_code_lut(), np.int32)
    jst = JST.build(limbs, tax_rows, 12, 7, 12, S, ip)
    mesh = Mesh(np.asarray(jax.devices()[:dp * ip]).reshape(dp, ip),
                ("dp", "ip"))
    step = make_turbo_mesh_step(jst, mesh)
    Rl = R // dp
    jp, jht, jhk, jca, jcu = step(
        jnp.asarray(mat), jnp.asarray(lut), jnp.zeros((dp, 6, S)),
        jnp.zeros((dp, 6, S), jnp.int32), rows_pad=R, protein=False,
        one_frame=False, lpr=1, w=w, csr_cap=4 * Rl)
    jp, jht, jhk = np.asarray(jp), np.asarray(jht), np.asarray(jhk)
    assert packed.shape == jp.shape
    csr = slice(2 * Rl, 2 * Rl + 2 * 4 * Rl)
    np.testing.assert_array_equal(packed[:, :2 * Rl], jp[:, :2 * Rl])
    np.testing.assert_array_equal(packed[:, -2:], jp[:, -2:])
    np.testing.assert_array_equal(packed[:, csr][:, 0::2],
                                  jp[:, csr][:, 0::2])
    np.testing.assert_allclose(packed[:, csr][:, 1::2].view(np.float32),
                               jp[:, csr][:, 1::2].view(np.float32),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ht, jht)
    np.testing.assert_allclose(hk, jhk, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu, np.asarray(jcu).sum(axis=0))
    np.testing.assert_allclose(ca, np.asarray(jca).sum(axis=0), rtol=RTOL,
                               atol=ATOL)
    assert int((jp[:, Rl:2 * Rl] != 0).sum()) == int(jp[:, -1].sum())
    # the merged count flags are the OR of the shards' cuts
    np.testing.assert_array_equal(packed[:, Rl:2 * Rl] & 1,
                                  cuts.any(axis=1).astype(np.int32))
    if mb == FLAG_MB:
        assert int(jp[:, -1].sum()) > 0
        assert bool(one_shard.any())


def _numpy_merge(hts, hks, ofc, ofl, cap):
    """A direct merge: per read, the taxa of all shards summed in shard
    order, sorted, the first wout kept, then the CSR pack."""
    ip, R, wout = hts.shape
    hc = np.zeros(R, np.int32)
    flags = np.zeros(R, np.int32)
    ht = np.full((R, wout), 2 ** 31 - 1, np.int32)
    hk = np.zeros((R, wout), np.float32)
    for r in range(R):
        sums = {}
        for s in range(ip):
            for t, v in zip(hts[s, r], hks[s, r]):
                if t != 2 ** 31 - 1:
                    sums[int(t)] = np.float32(sums.get(int(t), 0.0) + v)
        keys = sorted(sums)
        hc[r] = min(len(keys), wout)
        for i, t in enumerate(keys[:wout]):
            ht[r, i], hk[r, i] = t, sums[t]
        flags[r] = int(ofc[r]) | (int(ofl[r] or len(keys) > wout) << 1)
    csr = np.zeros((cap, 2), np.int32)
    pos = 0
    for r in range(R):
        for i in range(hc[r]):
            if pos < cap:
                csr[pos] = (ht[r, i], hk[r, i:i + 1].view(np.int32)[0])
            pos += 1
    packed = np.concatenate([hc, flags, csr.reshape(-1),
                             [hc.sum(), (flags != 0).sum()]]).astype(np.int32)
    return packed, ht, hk


@pytest.mark.parametrize("ip,wout,cap", [(2, 8, 64), (3, 6, 20), (4, 5, 9)])
def test_mesh_merge_plain_matches_numpy(ip, wout, cap):
    """Seeded shard lists with taxa shared between shards, empty slots
    and reads with more than wout taxa; a CSR cap the hits overflow."""
    from kasa_tpu_torch.parallel.turbo_mesh import mesh_merge_plain
    rng = np.random.default_rng(ip * 100 + wout)
    R = 12
    hts = np.full((ip, R, wout), 2 ** 31 - 1, np.int32)
    hks = np.zeros((ip, R, wout), np.float32)
    for s in range(ip):
        for r in range(R):
            n = int(rng.integers(0, wout + 1))
            taxa = np.sort(rng.choice(3 * wout, size=n, replace=False))
            hts[s, r, :n] = taxa
            hks[s, r, :n] = rng.random(n).astype(np.float32) * 3
    ofc = rng.random(R) < 0.2
    ofl = ofc | (rng.random(R) < 0.2)
    want = _numpy_merge(hts, hks, ofc, ofl, cap)
    got = mesh_merge_plain(torch.from_numpy(hts), torch.from_numpy(hks),
                           torch.from_numpy(ofc), torch.from_numpy(ofl), cap)
    assert int((want[0][R:2 * R] >> 1).sum()) > int(ofl.sum())  # ntax > wout
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


SENT = 2 ** 31 - 1


def merge_rows_model(hts, hks, ofc, ofl, cap):
    """K14's row arm (csrc/mesh_merge.cu merge_rows_kernel) in numpy,
    pair for pair: each pair's place in the merge from lower bounds in
    the other shards' rows, the first copy's flag at that place, the
    flags' exclusive scan as the ranks, the sums in shard order (float32,
    from 0), the CSR offsets as the look-back gives them -> (packed,
    ht_m, hk_m) as mesh_merge_plain lays them out."""
    ip, R, wout = hts.shape
    hc = np.zeros(R, np.int32)
    flags = np.zeros(R, np.int32)
    ht = np.full((R, wout), SENT, np.int32)
    hk = np.zeros((R, wout), np.float32)
    csr = np.zeros((cap, 2), np.int32)
    off = 0
    for r in range(R):
        rows = hts[:, r]
        flag = np.zeros(ip * wout, np.int32)
        found = []
        for s in range(ip):
            for j in range(wout):
                t = rows[s, j]
                if t == SENT:
                    continue
                P, first, acc = j, True, np.float32(0)
                for s2 in range(ip):
                    if s2 == s:
                        acc = np.float32(acc + hks[s, r, j])
                        continue
                    lb = int(np.searchsorted(rows[s2], t, "left"))
                    P += lb
                    if lb < wout and rows[s2, lb] == t:
                        if s2 < s:
                            first = False
                        else:
                            acc = np.float32(acc + hks[s2, r, lb])
                if first:
                    flag[P] = 1
                    found.append((P, t, acc))
        rank = np.cumsum(flag) - flag
        ntax = int(flag.sum())
        hc[r] = min(ntax, wout)
        flags[r] = int(ofc[r]) | (int(ofl[r] or ntax > wout) << 1)
        for P, t, acc in found:
            k = rank[P]
            if k < wout:
                ht[r, k], hk[r, k] = t, acc
                if off + k < cap:
                    csr[off + k] = (t, np.float32(acc).view(np.int32))
        off += hc[r]
    packed = np.concatenate([hc, flags, csr.reshape(-1),
                             [hc.sum(), (flags != 0).sum()]]).astype(np.int32)
    return packed, ht, hk


MERGE_CASES = ("random", "one_shard", "same_taxa", "empty_rows",
               "wout_exact", "wout_plus_one")


def merge_case(case, ip=3, R=40, wout=12, seed=5):
    """K14's inputs for `case`, every shard row ascending with distinct
    taxa and SENT after them: "random" taxa shared at random, ip = 4;
    "one_shard" ip = 1; "same_taxa" every shard of a read holds the same
    taxa; "empty_rows" some shards' rows empty; "wout_exact" and
    "wout_plus_one" reads of exactly wout and wout + 1 taxa after the
    merge.  -> (hts, hks, ofc, ofl)."""
    rng = np.random.default_rng(MERGE_CASES.index(case) + seed)
    ip = {"random": 4, "one_shard": 1}.get(case, ip)
    hts = np.full((ip, R, wout), SENT, np.int32)
    hks = np.zeros((ip, R, wout), np.float32)
    for r in range(R):
        if case in ("wout_exact", "wout_plus_one"):
            ntax = wout + (case == "wout_plus_one")
            taxa = np.sort(rng.choice(5 * wout, ntax, replace=False))
            owner = np.arange(ntax) % ip
            rows = [taxa[owner == s] for s in range(ip)]
            # a shared copy of some taxa, within each row's wout
            rows = [np.union1d(rw, rng.choice(taxa, 2))[:wout]
                    for rw in rows]
        elif case == "same_taxa":
            taxa = np.sort(rng.choice(3 * wout, int(rng.integers(0, wout + 1)),
                                      replace=False))
            rows = [taxa] * ip
        else:
            rows = []
            for s in range(ip):
                n = int(rng.integers(0, wout + 1))
                if case == "empty_rows" and (r + s) % 2:
                    n = 0
                rows.append(np.sort(rng.choice(3 * wout, n, replace=False)))
        for s, taxa in enumerate(rows):
            hts[s, r, :len(taxa)] = taxa
            hks[s, r, :len(taxa)] = rng.random(len(taxa)).astype(
                np.float32) * 3
    return hts, hks, rng.random(R) < 0.1, rng.random(R) < 0.1


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_rows_model_matches_plain(case):
    """The model of K14's row arm gives mesh_merge_plain's packed row and
    merged lists bit for bit (its sums in shard order are the plain
    version's stable sort then sum), and the ksums equal a float32 sum in
    shard order taken here; a CSR cap that the hits overflow."""
    from kasa_tpu_torch.parallel.turbo_mesh import mesh_merge_plain
    hts, hks, ofc, ofl = merge_case(case)
    ip, R, wout = hts.shape
    for s in range(ip):
        d = np.diff(hts[s], axis=1)
        assert bool(((d > 0) | (hts[s][:, 1:] == SENT)).all())
    cap = 5 * R
    want = mesh_merge_plain(*(torch.from_numpy(a) for a in
                              (hts, hks, ofc, ofl | ofc)), cap)
    got = merge_rows_model(hts, hks, ofc, ofl | ofc, cap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    by_hand = np.zeros((R, wout), np.float32)
    for r in range(R):
        for k, t in enumerate(got[1][r]):
            if t != SENT:
                acc = np.float32(0)
                for s in range(ip):
                    acc = np.float32(acc + hks[s, r][hts[s, r] == t].sum())
                by_hand[r, k] = acc
    np.testing.assert_array_equal(got[2], by_hand)
    hc, list_of = got[0][:R], (got[0][R:2 * R] >> 1) & 1
    if case == "wout_exact":
        assert bool((hc == wout).all())
        np.testing.assert_array_equal(list_of, ofl | ofc)
    if case == "wout_plus_one":
        assert bool((hc == wout).all()) and bool(list_of.all())
    assert int(got[0][-2]) > cap or case in ("empty_rows", "same_taxa",
                                             "one_shard")


def test_shard_lists_sorted_and_match_jax(mesh_corpus):
    """The order K14 relies on: on the mesh corpus, each shard's hit
    lists from the port's turbo_core (plain) hold distinct taxa in
    ascending order, then SENT to the row's end, and equal kasa_tpu's
    _turbo_core lists of the same shard (taxa identical, ksums within
    the contract)."""
    import functools
    import jax
    import jax.numpy as jnp
    from kasa_tpu.match.turbo import _turbo_core
    from kasa_tpu.parallel.turbo_mesh import ShardedTurboTables as JST
    from kasa_tpu_torch.core.encode import encode_windows
    from kasa_tpu_torch.match.turbo import (CSR_CAP_FACTOR, EXP_BUDGET,
                                            MULTI_BUDGET, WOUT, turbo_core)
    from kasa_tpu_torch.parallel.turbo_mesh import ShardedTurboTables
    _, idx, fq = mesh_corpus
    limbs, tax_rows, S = _index(idx)
    ip, R = 2, 256
    mat, w, lut = _batch(idx, fq, R)
    q = encode_windows(torch.from_numpy(mat), torch.from_numpy(lut), w,
                       False, False, 12)
    jst = JST.build(limbs, tax_rows, 12, 7, 12, S, ip)
    core = jax.jit(functools.partial(
        _turbo_core, num_steps=jst.num_steps, min_k=7, max_k=12,
        highest_k=12, num_species=S, num_reads=R, kmers_per_read=w))
    hits = 0
    for s in range(ip):
        st = ShardedTurboTables.build(limbs, tax_rows, 12, 7, 12, S, ip, s,
                                      "cpu")
        acc_ca = torch.zeros((6, S), dtype=torch.float32)
        acc_cu = torch.zeros((6, S), dtype=torch.int32)
        _, ht, hk = turbo_core(st.shard, q, R, w, acc_ca, acc_cu,
                               CSR_CAP_FACTOR * R, MULTI_BUDGET, EXP_BUDGET,
                               wout=WOUT)
        ht, hk = ht.numpy(), hk.numpy()
        real = ht != SENT
        # SENT only after the taxa, the taxa strictly ascending
        assert not (~real[:, :-1] & real[:, 1:]).any()
        assert bool((np.diff(ht, axis=1)[real[:, 1:]] > 0).all())
        jht, jhk = core(jst.keys2[s], jst.rowdat[s], jst.router[s],
                        jst.sub2[s], jst.grp2[s], jst.d_tax4[s], jst.weights,
                        jst.masks2, jst.hotmask_s[s], jst.t_hot_s[s],
                        jnp.asarray(q.numpy()))[:2]
        np.testing.assert_array_equal(ht, np.asarray(jht))
        np.testing.assert_allclose(hk, np.asarray(jhk), rtol=RTOL, atol=ATOL)
        hits += int(real.sum())
    assert hits > R


def test_mesh_merge_warps_edges():
    """K14's arm function: eight reads a block of the row arm while eight
    warps' rows fit the card's shared memory, fewer as the rows widen,
    the long arm (0) once one warp's row does not fit."""
    from kasa_tpu_torch import kernels as K
    smem = K.H100_SMEM_OPTIN
    assert K.mesh_merge_warps(2, 160, smem) == K.MERGE_ROW_WARPS
    assert K.mesh_merge_warps(4, 160, smem) == K.MERGE_ROW_WARPS
    wout = 1
    while K.mesh_merge_warps(2, wout + 1, smem) > 0:
        wout += 1
    assert K.mesh_merge_warps(2, wout, smem) == 1
    assert K.mesh_merge_warps(2, wout + 1, smem) == 0
    n = 2 * wout
    assert 4 * (n + 2 * -(-n // 32) + 3) <= smem
    widths = [K.mesh_merge_warps(2, w, smem) for w in range(160, wout, 997)]
    assert widths == sorted(widths, reverse=True)
