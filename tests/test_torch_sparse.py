"""kasa_tpu_torch's sparse fold (indices of more than SPARSE_FOLD_S
species, no hot tier: K4's counts-only arm, K6 and K3's list arm)
against kasa_tpu's sparse branch of _turbo_core, on the CPU.

Both packages switch regime on SPARSE_FOLD_S, so the tests force it low
in both: kasa_tpu reads it when a jit traces (its caches are cleared),
the port and both table builders when they run.  An index copied into
tmp_path keeps a sidecar built in another regime out of the way.

The contract (ROADMAP.md): integers identical (hit taxa, hit counts,
both overflow flags, unique counts, the packed readback), floats within
rtol 2e-5 / atol 1e-4; per-file all-counts of identify_multiple within
rtol 2e-5 / atol 2e-3, as kasa_tpu's packed-multi test allows."""

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from test_torch_identify import assert_identify_agrees
from test_torch_tables import _assert_same_arrays, jax_arrays

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"
RTOL, ATOL = 2e-5, 1e-4
S = 40


def _index_and_queries():
    """tests/test_turbo.py test_sparse_fold_matches_dense's index (S = 40,
    many multi-taxa groups from duplicated keys) and queries."""
    rng = np.random.default_rng(5)
    n = 6000
    base = rng.integers(0, 1 << 18, size=n).astype(np.int64)
    limb0 = (base << 12 | rng.integers(0, 1 << 12, size=n)).astype(np.int32) \
        & ((1 << 30) - 1)
    limb1 = rng.integers(0, 1 << 30, size=n, dtype=np.int64).astype(np.int32)
    dup = rng.integers(0, n, size=n // 2)
    limb0[dup] = limb0[(dup * 7) % n]
    limb1[dup] = limb1[(dup * 7) % n]
    tax = rng.integers(1, S, size=n).astype(np.int32)
    order = np.lexsort((tax, limb1, limb0))
    limbs = np.stack([limb0[order], limb1[order]], axis=1)
    taxr = tax[order]
    keep = np.ones(n, bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxr[1:] != taxr[:-1])
    limbs, taxr = np.ascontiguousarray(limbs[keep]), taxr[keep]
    R, kpr = 64, 24
    pick = rng.integers(0, len(limbs), size=R * kpr)
    return limbs, taxr, limbs[pick].copy(), R, kpr


@pytest.fixture
def sparse_regime(monkeypatch):
    """SPARSE_FOLD_S = 8 in both packages; kasa_tpu's jits retraced
    (jax.clear_caches: a jit's own _clear_cache keeps the traced program
    of the same shapes)."""
    import jax
    import kasa_tpu.match.turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    monkeypatch.setattr(JT, "SPARSE_FOLD_S", 8)
    monkeypatch.setattr(PT, "SPARSE_FOLD_S", 8)
    jax.clear_caches()
    yield monkeypatch
    jax.clear_caches()


def _tables(limbs, taxr):
    """kasa_tpu's tables in the sparse regime, and the port's builder
    checked against them bit for bit (no hot tier)."""
    from kasa_tpu.match.turbo import TurboTables
    from kasa_tpu_torch.match import turbo as PT
    jt = TurboTables.build_from_arrays(limbs, taxr, 12, 7, 12, S)
    assert jt.hotmask.shape[0] == 1, "the sparse regime has no hot tier"
    arrays, meta = PT.build_tables_np(limbs, taxr, 12, 7, 12, S)
    _assert_same_arrays(arrays, jax_arrays(jt)[0])
    return jt, PT.tables_from_numpy(arrays, meta, "cpu")


def _jax_core(jt, q, R, kpr, fo=None, num_files=1):
    import jax.numpy as jnp
    from kasa_tpu.match import turbo as JT
    args = (jt.keys2, jt.rowdat, jt.router, jt.sub2, jt.grp2, jt.d_tax4,
            jt.weights, jt.masks2, jt.hotmask, jt.t_hot, jnp.asarray(q),
            jt.num_steps, 7, 12, 12, S, R, kpr)
    if fo is None:
        out = JT.turbo_classify(*args)
    else:
        out = JT._turbo_core(*args, file_of_read=jnp.asarray(fo),
                             num_files=num_files)
    return [np.asarray(o) for o in out]


def _assert_core_agrees(jout, packed, ht, hk, ca, cu, R):
    ht_j, hk_j, hc_j, ca_j, cu_j, ofc_j, ofl_j = jout
    packed = packed.numpy()
    flags = packed[R:2 * R]
    np.testing.assert_array_equal(packed[:R], hc_j)
    np.testing.assert_array_equal(flags & 1, ofc_j.astype(np.int32))
    np.testing.assert_array_equal((flags >> 1) & 1, ofl_j.astype(np.int32))
    assert int(packed[-1]) == int((ofc_j | ofl_j).sum())
    # kasa_tpu's lists are min(WOUT, min(CW, SW) + WM) wide (148 with
    # WM = 4 here), the port's WOUT: the port's extra columns are padding
    w = ht_j.shape[1]
    np.testing.assert_array_equal(ht.numpy()[:, :w], ht_j)
    np.testing.assert_allclose(hk.numpy()[:, :w], hk_j, rtol=RTOL,
                               atol=ATOL)
    assert (ht.numpy()[:, w:] == 2**31 - 1).all()
    assert (hk.numpy()[:, w:] == 0).all()
    np.testing.assert_allclose(ca.numpy(), ca_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cu.numpy(), cu_j)
    assert hc_j.sum() > 0


@pytest.mark.parametrize("files", [None, 3], ids=["one_file", "three_files"])
def test_sparse_core_matches_jax(sparse_regime, files):
    """The batch step in the sparse regime against kasa_tpu's _turbo_core
    (turbo_classify, or the per-file counts of fused_turbo_files with a
    3-file map): the regime is the sparse one in both (no (R, S) rows in
    the port), and every output agrees under the contract."""
    from kasa_tpu_torch.match import turbo as PT
    limbs, taxr, q, R, kpr = _index_and_queries()
    jt, tt = _tables(limbs, taxr)
    fo = None
    lead = ()
    if files:
        fo = np.repeat(np.arange(files), [10, 30, R - 40]).astype(np.int32)
        lead = (files,)
    jout = _jax_core(jt, q, R, kpr, fo, files or 1)
    ca = torch.zeros(lead + (6, S))
    cu = torch.zeros(lead + (6, S), dtype=torch.int32)
    packed, ht, hk = PT.turbo_core(
        tt, torch.from_numpy(q), R, kpr, ca, cu, 160 * R, None, None,
        None if fo is None else torch.from_numpy(fo))
    _assert_core_agrees(jout, packed, ht, hk, ca, cu, R)
    if files:
        assert (cu.sum(dim=(1, 2)) > 0).all()


def test_sparse_core_more_than_wm_taxa(sparse_regime):
    """WM = 4 in both packages: most reads have more than WM distinct
    multi taxa, so multi_of sets their list flag while the first WM taxa
    still enter the hit lists; lists, flags and counts agree."""
    import kasa_tpu.match.turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    sparse_regime.setattr(JT, "WM", 4)
    sparse_regime.setattr(PT, "WM", 4)
    limbs, taxr, q, R, kpr = _index_and_queries()
    jt, tt = _tables(limbs, taxr)
    jout = _jax_core(jt, q, R, kpr)
    ca = torch.zeros((6, S))
    cu = torch.zeros((6, S), dtype=torch.int32)
    packed, ht, hk = PT.turbo_core(tt, torch.from_numpy(q), R, kpr, ca, cu,
                                   160 * R)
    _assert_core_agrees(jout, packed, ht, hk, ca, cu, R)
    ofc_j, ofl_j = jout[5], jout[6]
    assert (ofl_j & ~ofc_j).sum() > R // 4


def _fold_oracle(cp, mcnt, ofc, tt, wm):
    """Per unflagged read: the sums of w(k)/T over the taxa of its cold
    slots' groups, as a dict, from the host group tables."""
    n = tt.n
    grp2 = tt.grp2.numpy()
    d_tax4 = tt.d_tax4.numpy()
    w = tt.weights.numpy()
    out = []
    for r in range(cp.shape[0]):
        acc = {}
        if not ofc[r]:
            for mp in cp[r, :mcnt[r]]:
                ki, psel = int(mp) & 7, int(mp) >> 3
                row0 = int(grp2[min(ki * n + psel, len(grp2) - 1)])
                if row0 <= 0:
                    continue
                T = int(d_tax4[row0, 0])
                taxa = d_tax4[row0 + 1:].reshape(-1)[:T]
                for t in taxa:
                    acc[int(t)] = acc.get(int(t), 0.0) \
                        + float(w[ki] * np.float32(1.0 / np.float32(T)))
        out.append(sorted(acc.items()))
    return out


@pytest.mark.parametrize("wm", [160, 3], ids=["wm160", "wm3"])
def test_sparse_fold_plain_matches_oracle(sparse_regime, wm):
    """K6's plain version against a numpy oracle on a real batch: the
    first WM taxa of each read in taxon order with their sums, multi_of
    when a read has more than WM, nothing for a flagged read."""
    from kasa_tpu_torch.match import turbo as PT
    sparse_regime.setattr(PT, "WM", wm)
    limbs, taxr, q, R, kpr = _index_and_queries()
    _, tt = _tables(limbs, taxr)
    skey, mpay = PT.turbo_match(torch.from_numpy(q), tt, R, kpr)
    _, _, runs, mcnt, cp = PT.turbo_reads_pre(skey, mpay)
    ofc = torch.zeros(R, dtype=torch.bool)
    ofc[::7] = True
    mk, mv, multi_of = PT.sparse_fold_plain(cp, mcnt, ofc, tt)
    assert mk.shape == (R, wm) and mv.shape == (R, wm)
    want = _fold_oracle(cp.numpy(), mcnt.numpy(), ofc.numpy(), tt, wm)
    for r in range(R):
        got_n = int((mk[r] != PT.SENT).sum())
        assert bool(multi_of[r]) == (len(want[r]) > wm)
        assert got_n == min(len(want[r]), wm)
        np.testing.assert_array_equal(mk[r, :got_n].numpy(),
                                      [t for t, _ in want[r][:wm]])
        np.testing.assert_allclose(mv[r, :got_n].numpy(),
                                   [v for _, v in want[r][:wm]],
                                   rtol=RTOL, atol=ATOL)
        assert (mv[r, got_n:] == 0).all()
    assert sum(len(x) for x in want) > R
    if wm == 3:
        assert multi_of.sum() > R // 4


INDEX_FILES = ("exampleIndex", "exampleIndex_info.txt", "exampleIndex_f.txt",
               "exampleIndex_content.txt", "exampleIndex_trie",
               "exampleIndex_trie.txt")


@pytest.fixture
def sparse_index(tmp_path, monkeypatch):
    """A private copy of the golden index (no sidecar of the dense
    regime) with SPARSE_FOLD_S one below its species count in both
    packages, and the port's table RAM cache cleared."""
    import jax
    import kasa_tpu.match.turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    from kasa_tpu_torch.match.pipeline import load_content_for_identify
    d = tmp_path / "index"
    d.mkdir()
    for f in INDEX_FILES:
        shutil.copy(GOLDEN / f, d / f)
    s = load_content_for_identify(str(d / "exampleIndex_content.txt")) \
        .num_species
    monkeypatch.setattr(JT, "SPARSE_FOLD_S", s - 1)
    monkeypatch.setattr(PT, "SPARSE_FOLD_S", s - 1)
    monkeypatch.setenv("KASA_MESH_DP", "1")
    monkeypatch.setenv("KASA_MESH_IP", "1")
    jax.clear_caches()
    PT._TT_RAM_CACHE.clear()
    yield d
    jax.clear_caches()
    PT._TT_RAM_CACHE.clear()


def test_identify_sparse_agrees_with_jax_turbo(tmp_path, sparse_index):
    """identify on the golden index in the sparse regime: the port (K4's
    counts-only arm, K6, K3's list arm, all as plain versions) against
    kasa_tpu's turbo run in the same regime."""
    from kasa_tpu.config import Config as JConfig
    from kasa_tpu.match.pipeline import identify as jidentify
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify
    d = sparse_index
    src = str(FIXTURES / "reads.fastq")
    kw = dict(index_path=str(d / "exampleIndex"), input_path=src)
    cfg = JConfig()
    cfg.engine = "tpu"
    cfg.content_file = str(d / "exampleIndex_content.txt")
    jidentify(cfg, out_file=str(tmp_path / "j.json"),
              profile_file=str(tmp_path / "j.csv"), **kw)
    cfg = Config()
    cfg.content_file = str(d / "exampleIndex_content.txt")
    ca, cu, nreads, _ = identify(cfg, out_file=str(tmp_path / "t.json"),
                                 profile_file=str(tmp_path / "t.csv"),
                                 device="cpu", **kw)
    assert nreads == 300 and cu.sum() > 0
    assert fast.LAST_DISPATCH.tt.hotmask.shape[0] == 1
    assert_identify_agrees(json.load(open(tmp_path / "j.json")),
                           json.load(open(tmp_path / "t.json")),
                           (tmp_path / "j.csv").read_text(),
                           (tmp_path / "t.csv").read_text(), 6)


def test_identify_multiple_sparse_agrees_with_jax_turbo(tmp_path,
                                                        sparse_index):
    """identify_multiple with profiles in the sparse regime: per-file
    counts (K4's counts-only arm with the file offsets) and outputs
    against kasa_tpu's packed run in the same regime."""
    from kasa_tpu.config import Config as JConfig
    from kasa_tpu.match.pipeline import identify as jidentify
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify_multiple
    d = sparse_index
    cfg = JConfig()
    cfg.engine = "tpu"
    cfg.content_file = str(d / "exampleIndex_content.txt")
    ref = jidentify(cfg, index_path=str(d / "exampleIndex"),
                    input_path=str(FIXTURES / "multi"),
                    out_file=str(tmp_path / "jq_"),
                    profile_file=str(tmp_path / "jp_"))
    cfg = Config()
    cfg.content_file = str(d / "exampleIndex_content.txt")
    cfg.index_file = str(d / "exampleIndex")
    cfg.input = str(FIXTURES / "multi")
    cfg.read_to_taxa_file = str(tmp_path / "tq_")
    cfg.table_file = str(tmp_path / "tp_")
    got = identify_multiple(cfg, device="cpu")
    assert len(got) == len(ref) == 2
    for (ca1, cu1, n1, k1), (ca2, cu2, n2, k2) in zip(got, ref):
        assert (n1, k1) == (n2, k2)
        np.testing.assert_array_equal(np.asarray(cu1, np.int64),
                                      np.asarray(cu2, np.int64))
        np.testing.assert_allclose(ca1, ca2, rtol=2e-5, atol=2e-3)
    for name in ("a", "b"):
        assert_identify_agrees(
            json.load(open(tmp_path / f"jq_{name}.json")),
            json.load(open(tmp_path / f"tq_{name}.json")),
            (tmp_path / f"jp_{name}.csv").read_text(),
            (tmp_path / f"tp_{name}.csv").read_text(), 6)
