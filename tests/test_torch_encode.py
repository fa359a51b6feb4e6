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


# ---------------------------------------------------------------------------
# K1's tiles (csrc/encode.cu): the cases the card tests run, and a numpy
# model of the kernel's tile arithmetic held to the plain version here

# name -> (rows, maxlen, highest_k, mode, w or None for the most windows,
# leading rows the matrix is a view past); mode: dna, one, protein,
# sloppy, sloppy_protein
ENCODE_CASES = {
    "k7": (40, 176, 7, "dna", None, 0),
    "k12": (40, 176, 12, "dna", None, 0),
    "k13": (40, 176, 13, "dna", None, 0),
    "k18": (40, 176, 18, "dna", None, 0),
    "k24": (40, 176, 24, "dna", None, 0),
    "k25": (40, 176, 25, "dna", None, 0),
    "one_k12": (40, 176, 12, "one", None, 0),
    "one_k25_odd_row": (40, 100, 25, "one", None, 0),
    "protein_k12": (40, 176, 12, "protein", None, 0),
    "protein_k25": (40, 176, 25, "protein", None, 0),
    "sloppy": (40, 176, 12, "sloppy", None, 0),
    "sloppy_protein": (40, 176, 12, "sloppy_protein", None, 0),
    "flat_under_tile": (1, 500, 25, "dna", None, 0),
    "flat_one_tile": (1, 1024, 25, "dna", None, 0),
    "flat_tiles": (1, 3 * 1024 + 123, 25, "dna", None, 0),
    "flat_tiles_k12": (1, 3 * 1024 + 123, 12, "dna", None, 0),
    "w1": (300, 60, 12, "dna", 1, 0),
    "short_rows": (3000, 40, 12, "dna", None, 0),
    "view": (40, 177, 12, "dna", None, 1),
}


def encode_case(name):
    """-> (matrix (rows + lead, maxlen) uint8, lut (512,) int32, w, lead,
    keyword arguments of encode_windows but aas_lut, sloppy) for case
    `name` of ENCODE_CASES: random DNA letters, N and '^'; the first
    `lead` rows are not the case's (a view past them starts off a word
    boundary)."""
    from kasa_tpu_torch.core import encode as PE
    rows, maxlen, hk, mode, w, lead = ENCODE_CASES[name]
    rng = np.random.default_rng(sorted(ENCODE_CASES).index(name) + 300)
    mat = rng.choice(np.frombuffer(b"ACGTXZacgtN^", np.uint8),
                     size=(rows + lead, maxlen))
    protein = mode in ("protein", "sloppy_protein")
    one = mode == "one"
    if w is None:
        span, step = PE.window_span(protein, one, hk)
        w = (maxlen - span) // step + 1
    kw = dict(protein=protein, one_frame=one, highest_k=hk)
    return (mat, PE.build_codon_code_lut().astype(np.int32), w, lead, kw,
            mode.startswith("sloppy"))


def encode_tile_model(mat, lut, w, protein=False, one_frame=False,
                      highest_k=12, aas=None, tile=1024):
    """K1's tile arithmetic in numpy (csrc/encode.cu): the flat slot
    space of every mode, the bytes of a tile's slots and halo (0 past the
    matrix), a code a slot, a pack (or under -j a folded pair) a slot,
    each window's limbs from the packs, and the tile's windows as one
    run of output rows [m0, m1) -> (rows * w, L) int32."""
    rows, maxlen = mat.shape
    mode = "protein" if protein else ("one" if one_frame else "dna")
    U = maxlen // 3 if mode == "one" else maxlen
    ls = 3 if mode == "dna" else 1
    L = -(-highest_k // 6)
    last = highest_k - 6 * (L - 1)
    mask = np.int64(~((1 << (5 * (6 - last))) - 1))
    npack = tile + (10 * ls if aas is not None else 6 * ls * (L - 1))
    ncode = npack + 5 * ls
    flat = mat.reshape(-1).astype(np.int64)
    nbytes, slots = rows * maxlen, rows * U
    lut512 = lut[np.minimum(np.arange(512), len(lut) - 1)].astype(np.int64)

    def first_byte(x):
        r, u = np.divmod(x, U)
        return r * maxlen + (3 * u if mode == "one" else u)

    def staged(b, b1):
        return np.where(b < b1, flat[np.minimum(b, nbytes - 1)], 0)

    def count(x):             # windows of the slots before x
        r, u = np.divmod(x, U)
        return r * w + np.minimum(u, w)
    out = np.full((rows * w, L), -7, np.int64)
    written = np.zeros(rows * w, np.int64)
    for s0 in range(0, slots, tile):
        cend = min(s0 + ncode, slots)
        b1 = min(int(first_byte(cend - 1)) + (1 if protein else 3), nbytes)
        x = s0 + np.arange(ncode)
        inb = x < cend
        b = np.where(inb, first_byte(np.minimum(x, slots - 1)), 0)
        c1 = staged(b, b1)
        if protein:
            code = c1 & 31
        else:
            h = ((c1 & 14) << 5) | ((staged(b + 1, b1) & 14) << 2) \
                | ((staged(b + 2, b1) & 14) >> 1)
            code = lut512[h]
        code = np.where(inb, code, 0)
        k = np.arange(npack)
        if aas is not None:
            pack = aas.astype(np.int64)[(code[k] << 5) | code[k + ls]]
        else:
            pack = sum(code[k + ls * j] << (5 * (5 - j)) for j in range(6))
        send = min(s0 + tile, slots)
        m0, m1 = int(count(s0)), int(count(send))
        k = np.arange(send - s0)
        r, c = np.divmod(s0 + k, U)
        k, m = k[c < w], (r * w + c)[c < w]
        # the tile's windows are the output rows [m0, m1), each once
        assert np.array_equal(m, np.arange(m0, m1))
        if aas is not None:
            out[m, 0] = sum(pack[k + 2 * ls * p] << (5 * (5 - p))
                            for p in range(6))
            out[m, 1] = 0
        else:
            for i in range(L - 1):
                out[m, i] = pack[k + 6 * ls * i]
            out[m, L - 1] = pack[k + 6 * ls * (L - 1)] & mask
        written[m] += 1
    assert bool((written == 1).all())
    return out.astype(np.int32)


@pytest.mark.parametrize("tile", [64, 1024])
@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_tile_model(case, tile):
    """K1's tile arithmetic (encode_tile_model, at the kernel's tile and
    at one of 64 slots, so that windows and halos cross many tiles)
    gives the plain version's limbs on every case the card tests run:
    highestK 7-25, DNA, one frame (rows of 3 U + 1 bytes too), protein,
    the sloppy fold, flat rows under, at and over a tile, w = 1, many
    short rows, a matrix that is a view."""
    from kasa_tpu_torch.core import encode as PE
    mat, lut, w, lead, kw, sloppy = encode_case(case)
    mat = mat[lead:]
    aas = PE.aas_code_lut() if sloppy else None
    want = PE.encode_windows_plain(
        torch.from_numpy(mat), torch.from_numpy(lut), w, **kw,
        aas_lut=None if aas is None else torch.from_numpy(aas))
    got = encode_tile_model(mat, lut, w, aas=aas, tile=tile, **kw)
    np.testing.assert_array_equal(got, want.numpy())


def fast_div(d):
    """K1's divider of 32-bit numerators by d (csrc/encode.cu fast_div):
    -> (m, s) with n // d == (umulhi(n, m) + n) >> s."""
    s = 0
    while s < 32 and (1 << s) < d:
        s += 1
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


@pytest.mark.parametrize("d", [1, 2, 3, 40, 58, 100, 176, 1024, 12_386_304,
                               (1 << 31) - 1])
def test_fast_div(d):
    """K1 splits slots into (row, column) by a multiply and a shift: the
    magic number fits 32 bits and gives n // d for numerators around
    every multiple of d it meets, random ones and the 32-bit edges."""
    m, s = fast_div(d)
    assert 0 < m < 1 << 32
    rng = np.random.default_rng(d % 1000)
    k = rng.integers(0, (1 << 32) // d, 2000, dtype=np.uint64)
    n = np.concatenate([k * d, k * d - 1, k * d + d - 1,
                        rng.integers(0, 1 << 32, 2000, dtype=np.uint64),
                        np.array([0, 1, d - 1, d, (1 << 32) - 1],
                                 np.uint64)])
    n = n[n < 1 << 32].astype(object)
    got = [((x * m >> 32) + x) >> s for x in n]
    assert got == [x // d for x in n]
