"""The port's classic meshes (kasa_tpu_torch/parallel/mesh.py: K9 on
each rank's prefix-aligned index shard, partials summed over "ip")
against kasa_tpu's (kasa_tpu/parallel/mesh.py) on the CPU: the two tests
of tests/test_mesh.py at world 4.  The port's ranks are CPU gloo
processes (parallel/launch.py, a file:// rendezvous in tmp_path);
kasa_tpu's mesh runs on the 8 virtual CPU devices of tests/conftest.py.
Integer counts identical, floats within rtol 2e-5 / atol 1e-4."""

import sys
import pathlib

import numpy as np
import pytest
import torch

from test_mesh import _toy

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-4
RANK_TIMEOUT = 300       # seconds before hung ranks are killed
M_PER_DP, R_PER_DP = 512, 64


def _queries(limbs, dp, seed=1):
    """tests/test_mesh.py's queries: picks of the index, half of them
    perturbed in limb 1 so they miss."""
    rng = np.random.default_rng(seed)
    m = dp * M_PER_DP
    pick = rng.integers(0, len(limbs), size=m)
    q = limbs[pick].copy()
    q[m // 2:, 1] ^= rng.integers(1, 31, size=m - m // 2).astype(
        np.int32) << 5
    rid = rng.integers(0, R_PER_DP, size=m).astype(np.int32)
    return q, rid


def _routed_inputs():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from __graft_entry__ import _toy_index, _toy_queries
    limbs, taxids, ns = _toy_index(num_entries=4096)
    q, rid, valid = _toy_queries(limbs, m=1024)
    return limbs, taxids, ns + 1, q, rid % 128, valid


def _rank_sharded(dp, ip):
    """One rank: the broadcast classifier on the (dp, ip) mesh."""
    from kasa_tpu_torch.parallel.dist import make_identify_mesh
    from kasa_tpu_torch.parallel.mesh import (ShardedIndex,
                                              make_sharded_classifier)
    mesh = make_identify_mesh(ip=ip, dp=dp)
    limbs, taxids, ns = _toy()
    S = ns + 1
    si = ShardedIndex.build(limbs, taxids, {t: t for t in range(S)}, 12, 7,
                            12, S, ip, mesh.ip_index, "cpu")
    q, rid = _queries(limbs, dp)
    run, _ = make_sharded_classifier(si, mesh, R_PER_DP, M_PER_DP)
    out = run(q.reshape(dp, M_PER_DP, 2), rid.reshape(dp, M_PER_DP),
              np.ones((dp, M_PER_DP), bool))
    return tuple(t.numpy() for t in out)


def _rank_routed(ip):
    """One rank: the routed and the broadcast classifier at dp = 1."""
    from kasa_tpu_torch.parallel.dist import make_identify_mesh
    from kasa_tpu_torch.parallel.mesh import (ShardedIndex,
                                              make_routed_classifier,
                                              make_sharded_classifier,
                                              route_queries)
    mesh = make_identify_mesh(ip=ip, dp=1)
    limbs, taxids, S, q, rid, valid = _routed_inputs()
    si = ShardedIndex.build(limbs, taxids, {t: t for t in range(S)}, 12, 7,
                            12, S, ip, mesh.ip_index, "cpu")
    m = len(rid)
    run_b, _ = make_sharded_classifier(si, mesh, 128, m)
    sb = run_b(q[None], rid[None], valid[None])
    qr, rr, vr, dropped = route_queries(si, q, rid, valid, dp=1, m_cap=m)
    assert dropped == 0
    run_r, _ = make_routed_classifier(si, mesh, 128, m)
    sr = run_r(qr, rr, vr)
    return tuple(t.numpy() for t in sb), tuple(t.numpy() for t in sr)


def _jax_mesh(dp, ip):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:dp * ip]).reshape(dp, ip),
                ("dp", "ip"))


def _agree(port, ref):
    """(scores, counts_all, counts_unique, tail pairs) under the
    contract."""
    ps, pca, pcu, pt = port
    js, jca, jcu, jt = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(pcu, jcu)
    np.testing.assert_array_equal(pt.reshape(-1), jt.reshape(-1))
    np.testing.assert_allclose(pca, jca, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ps, js, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dp,ip", [(2, 2), (1, 4), (4, 1)])
def test_sharded_classify_matches_jax_mesh(tmp_path, dp, ip):
    """The broadcast classifier at world 4 against kasa_tpu's
    make_sharded_classifier at the same (dp, ip), and against the
    port's single-device K9 run of each dp block."""
    import jax.numpy as jnp
    from kasa_tpu.parallel.mesh import (ShardedIndex as JSI,
                                        make_sharded_classifier as jmake)
    from kasa_tpu_torch.match.device import StackedTables, run_classify
    from kasa_tpu_torch.match.join import DeviceIndex
    from kasa_tpu_torch.parallel.launch import run_ranks
    recs = run_ranks(dp * ip, "test_torch_mesh:_rank_sharded", (dp, ip),
                     out_dir=str(tmp_path / "ranks"), device="cpu",
                     threads=1, timeout=RANK_TIMEOUT)
    port = recs[0]["result"]

    limbs, taxids, ns = _toy()
    S = ns + 1
    t2r = {t: t for t in range(S)}
    q, rid = _queries(limbs, dp)
    si = JSI.build(limbs, taxids, t2r, 12, 7, 12, S, num_shards=ip)
    run, _ = jmake(si, _jax_mesh(dp, ip), R_PER_DP, M_PER_DP)
    ref = run(jnp.asarray(q.reshape(dp, M_PER_DP, 2)),
              jnp.asarray(rid.reshape(dp, M_PER_DP)),
              jnp.ones((dp, M_PER_DP), bool))
    _agree(port, ref)

    tabs = StackedTables.build(DeviceIndex(limbs, taxids, t2r, 12, 7, 12, S,
                                           "cpu"))
    cuniq = 0
    for d in range(dp):
        sl = slice(d * M_PER_DP, (d + 1) * M_PER_DP)
        s1, _, cu1, _ = run_classify(tabs, q[sl], rid[sl], R_PER_DP)
        np.testing.assert_allclose(port[0][d], s1.numpy(), rtol=RTOL,
                                   atol=ATOL)
        cuniq = cuniq + cu1.numpy()
    np.testing.assert_array_equal(port[2].sum(axis=0), cuniq)


def test_routed_classifier_agrees_with_broadcast_and_jax(tmp_path):
    """Host prefix routing at ip = 4: the routed classifier equals the
    broadcast one (integer counts bit for bit) and kasa_tpu's routed
    classifier at the same shape; route_queries packs the same blocks
    as kasa_tpu's."""
    import jax.numpy as jnp
    from kasa_tpu.parallel.mesh import (ShardedIndex as JSI,
                                        make_routed_classifier as jrouted,
                                        route_queries as jroute)
    from kasa_tpu_torch.parallel.launch import run_ranks
    from kasa_tpu_torch.parallel.mesh import ShardedIndex, route_queries
    ip = 4
    recs = run_ranks(ip, "test_torch_mesh:_rank_routed", (ip,),
                     out_dir=str(tmp_path / "ranks"), device="cpu",
                     threads=1, timeout=RANK_TIMEOUT)
    pb, pr = recs[0]["result"]
    np.testing.assert_array_equal(pr[2], pb[2])
    np.testing.assert_allclose(pr[1], pb[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pr[0], pb[0], rtol=RTOL, atol=ATOL)

    limbs, taxids, S, q, rid, valid = _routed_inputs()
    t2r = {t: t for t in range(S)}
    m = len(rid)
    jsi = JSI.build(limbs, taxids, t2r, 12, 7, 12, S, num_shards=ip)
    jblocks = jroute(jsi, q, rid, valid, dp=1, m_cap=m)
    psi = ShardedIndex.build(limbs, taxids, t2r, 12, 7, 12, S, ip, 0, "cpu")
    np.testing.assert_array_equal(psi.shard_lo, jsi.shard_lo)
    for a, b in zip(route_queries(psi, q, rid, valid, dp=1, m_cap=m),
                    jblocks):
        np.testing.assert_array_equal(a, b)
    run, _ = jrouted(jsi, _jax_mesh(1, ip), 128, m)
    ref = run(*(jnp.asarray(a) for a in jblocks[:3]))
    _agree(pr, ref)
