"""kasa_tpu_torch turbo tables against kasa_tpu: the numpy builder gives
the same arrays bit for bit, tables_from_numpy carries a kasa_tpu table
over unchanged, and each package reads the .tabs sidecar the other
wrote."""

import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
FIELDS = ("keys2", "rowdat", "router", "sub2", "grp2", "d_tax4", "weights",
          "masks2", "hotmask", "t_hot")
META = ("num_steps", "min_k", "max_k", "highest_k", "num_species", "n")


def _golden_inputs():
    from kasa_tpu.index import artifacts
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.match.pipeline import load_content_for_identify
    limbs, taxids, _, _ = artifacts.read_index(str(GOLDEN / "exampleIndex"))
    content = load_content_for_identify(
        str(GOLDEN / "exampleIndex_content.txt"))
    return limbs, map_tax_rows(taxids, content.tax_to_idx), \
        content.num_species


def _tiers_inputs():
    from test_turbo import _index_with_tiers, S
    limbs, taxids, _ = _index_with_tiers()
    return limbs, taxids.astype(np.int32), S


def jax_arrays(jt):
    """kasa_tpu TurboTables fields as the (arrays, meta) of
    tables_from_numpy."""
    arrays = {f: np.asarray(getattr(jt, f)) for f in FIELDS}
    arrays.update(host_limbs=jt.host_limbs,
                  host_grp_start=jt.host_grp_start,
                  host_d_tax=jt.host_d_tax, host_grp_id=jt.host_grp_id,
                  host_masks=jt.host_masks)
    return arrays, {f: getattr(jt, f) for f in META}


def _assert_same_arrays(a, b):
    for f in FIELDS:
        x, y = np.asarray(a[f]), np.asarray(b[f])
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("host_grp_start", "host_d_tax", "host_grp_id"):
        assert len(a[f]) == len(b[f])
        for x, y in zip(a[f], b[f]):
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("which", ["golden", "tiers"])
def test_builder_matches_jax(which):
    from kasa_tpu.match.turbo import TurboTables
    from kasa_tpu_torch.match import turbo as PT
    limbs, tax_rows, S = (_golden_inputs() if which == "golden"
                          else _tiers_inputs())
    jt = TurboTables.build_from_arrays(limbs, tax_rows, 12, 7, 12, S)
    arrays, meta = PT.build_tables_np(limbs, tax_rows, 12, 7, 12, S)
    ja, jm = jax_arrays(jt)
    _assert_same_arrays(arrays, ja)
    assert meta == jm
    if which == "tiers":
        assert ja["hotmask"].shape[0] > 1 and (ja["grp2"] != 0).any()


def test_tables_from_numpy_carries_jax_tables():
    from kasa_tpu.match.turbo import TurboTables
    from kasa_tpu_torch.match import turbo as PT
    limbs, tax_rows, S = _golden_inputs()
    jt = TurboTables.build_from_arrays(limbs, tax_rows, 12, 7, 12, S)
    tt = PT.tables_from_numpy(*jax_arrays(jt), "cpu")
    for f in FIELDS:
        t = getattr(tt, f)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jt, f)))
    assert all(getattr(tt, f) == getattr(jt, f) for f in META)
    np.testing.assert_array_equal(tt.host_masks, jt.host_masks)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecar_read_by_the_other_package(tmp_path, writer):
    from kasa_tpu.match import turbo as JT
    from kasa_tpu_torch.match import turbo as PT
    limbs, tax_rows, S = _golden_inputs()
    crc = PT._tax_rows_crc(tax_rows)
    assert crc == JT._tax_rows_crc(tax_rows)
    path = str(tmp_path / "idx.turbo_7_12.npz")
    jt = JT.TurboTables.build_from_arrays(limbs, tax_rows, 12, 7, 12, S)
    ja, jm = jax_arrays(jt)
    if writer == "jax":
        JT.save_turbo(jt, path, crc)
        arrays, meta = PT.load_turbo_np(path, limbs, crc)
        _assert_same_arrays(arrays, ja)
        assert meta == jm
    else:
        PT.save_turbo(*PT.build_tables_np(limbs, tax_rows, 12, 7, 12, S),
                      path, crc)
        back = JT.load_turbo(path, limbs, crc)
        assert back is not None
        _assert_same_arrays(jax_arrays(back)[0], ja)
        assert jax_arrays(back)[1] == jm
