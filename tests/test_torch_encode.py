"""kasa_tpu_torch encoder (kernel K1's plain version) against kasa_tpu:
the same padded read rows through JAX dna_to_aa_codes + encode_windows +
the fused_turbo_acc windowing prologue and through the port must give
bit-identical limbs."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ALPHABET = np.frombuffer(b"ACGTXZacgt", np.uint8)


def _jax_windows(mat, lut, w):
    """kasa_tpu/match/turbo.py fused_turbo_acc prologue (lines 1206-1216)."""
    import jax.numpy as jnp
    from kasa_tpu.core.encode import dna_to_aa_codes, encode_windows
    rows, maxlen = mat.shape
    flat = jnp.concatenate([jnp.asarray(mat).reshape(-1),
                            jnp.zeros((36,), jnp.uint8)])
    aa = dna_to_aa_codes(flat, jnp.asarray(lut), protein=False)
    win = encode_windows(aa, 12, 3)
    win = win[:rows * maxlen].reshape(rows, maxlen, -1)
    return np.asarray(win[:, :w].reshape(rows * w, -1))


@pytest.mark.parametrize("rows,maxlen", [(8, 36), (64, 176), (33, 97)])
def test_plain_encoder_matches_jax(rows, maxlen):
    from kasa_tpu.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.core import encode as PE
    rng = np.random.default_rng(rows * 1000 + maxlen)
    mat = rng.choice(ALPHABET, size=(rows, maxlen))
    lut = build_codon_code_lut().astype(np.int32)
    w = maxlen - 35
    got = PE.encode_windows(torch.from_numpy(mat), torch.from_numpy(lut), w)
    assert got.dtype == torch.int32 and got.shape == (rows * w, 2)
    np.testing.assert_array_equal(got.numpy(), _jax_windows(mat, lut, w))


def test_numpy_twins_match_jax_twins():
    from kasa_tpu.core import encode as JE
    from kasa_tpu_torch.core import encode as PE
    rng = np.random.default_rng(7)
    buf = rng.choice(ALPHABET, size=500)
    lut = PE.build_codon_code_lut().astype(np.int32)
    aa = PE.dna_to_aa_codes_np(buf, lut)
    np.testing.assert_array_equal(aa, JE.dna_to_aa_codes_np(buf, lut))
    np.testing.assert_array_equal(PE.encode_windows_np(aa, 12, 3),
                                  JE.encode_windows_np(aa, 12, 3))


def test_encoder_rejects_bad_inputs():
    from kasa_tpu_torch.core import encode as PE
    lut = torch.from_numpy(PE.build_codon_code_lut().astype(np.int32))
    mat = torch.zeros((4, 40), dtype=torch.uint8)
    with pytest.raises(ValueError):
        PE.encode_windows(mat, lut, 6)          # 40 chars hold 5 windows
    with pytest.raises(ValueError):
        PE.encode_windows(mat.to(torch.int32), lut, 5)
