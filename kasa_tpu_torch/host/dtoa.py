"""Shortest-round-trip double formatting, bit-compatible with the
reference's dtoa_milo (utils/dToStr.h, Milo Yip's Grisu2 + Prettify).

Grisu2 is deterministic, so re-implementing the algorithm (64-bit
DiyFp arithmetic emulated with Python ints, cached powers of ten
computed exactly instead of tabulated) reproduces the reference's
output byte-for-byte — including the cases where Grisu2 emits a
non-optimal digit count, which ``repr(float)`` would print
differently.  Formatting rules (always "x.0" for integers, bare 'e'
exponents) follow Prettify (dToStr.h:386-425).
"""

from __future__ import annotations

import math
import struct

_MASK64 = (1 << 64) - 1
_HIDDEN_BIT = 1 << 52
_EXP_BIAS = 0x3FF + 52


def _normalize(f: int, e: int) -> tuple[int, int]:
    s = 64 - f.bit_length()
    return f << s, e - s


def _normalize_boundary(f: int, e: int) -> tuple[int, int]:
    while not (f & (_HIDDEN_BIT << 1)):
        f <<= 1
        e -= 1
    shift = 64 - 54
    return f << shift, e - shift


def _diy_mul(f1: int, e1: int, f2: int, e2: int) -> tuple[int, int]:
    p = f1 * f2
    h = p >> 64
    if (p >> 63) & 1:  # round
        h += 1
    return h & _MASK64, e1 + e2 + 64


def _cached_power(e: int) -> tuple[int, int, int]:
    """Replicates GetCachedPower (dToStr.h:177-248) with the cached
    significands computed exactly: entry i is the nearest-rounded
    64-bit normalized significand of 10^(-348 + 8*i)."""
    dk = (-61 - e) * 0.30102999566398114 + 347
    k = int(dk)
    if dk - k > 0.0:
        k += 1
    index = (k >> 3) + 1
    K = -(-348 + (index << 3))
    dec_exp = -348 + (index << 3)
    # exact nearest-rounded normalized significand of 10^dec_exp
    if dec_exp >= 0:
        num, den = 10 ** dec_exp, 1
    else:
        num, den = 1, 10 ** (-dec_exp)
    # find e10 with 2^63 <= num/den * 2^-e10 < 2^64
    e10 = num.bit_length() - den.bit_length() - 64
    while (num << max(0, -e10)) // (den << max(0, e10)) >= (1 << 64):
        e10 += 1
    while (num << max(0, -e10)) // (den << max(0, e10)) < (1 << 63):
        e10 -= 1
    shifted_num = num << max(0, -e10)
    shifted_den = den << max(0, e10)
    q, r = divmod(shifted_num, shifted_den)
    if 2 * r >= shifted_den:
        q += 1
    if q >= (1 << 64):  # rounding overflowed into the next bit
        q >>= 1
        e10 += 1
    return q, e10, K


def _grisu_round(buffer: list, delta: int, rest: int, ten_kappa: int, wp_w: int):
    while (rest < wp_w and delta - rest >= ten_kappa and
           (rest + ten_kappa < wp_w or wp_w - rest > rest + ten_kappa - wp_w)):
        buffer[-1] = chr(ord(buffer[-1]) - 1)
        rest += ten_kappa


def _digit_gen(W: tuple, Mp: tuple, delta: int) -> tuple[str, int]:
    wf, we = W
    mf, me = Mp
    one_f = 1 << (-me)
    wp_w = (mf - wf) & _MASK64
    p1 = mf >> (-me)
    p2 = mf & (one_f - 1)
    kappa = len(str(p1))
    buffer: list = []
    K = 0
    while kappa > 0:
        pw = 10 ** (kappa - 1)
        d, p1 = divmod(p1, pw)
        if d or buffer:
            buffer.append(chr(ord("0") + d))
        kappa -= 1
        tmp = (p1 << (-me)) + p2
        if tmp <= delta:
            K += kappa
            _grisu_round(buffer, delta, tmp, (10 ** kappa) << (-me), wp_w)
            return "".join(buffer), K
    while True:
        p2 *= 10
        delta *= 10
        d = p2 >> (-me)
        if d or buffer:
            buffer.append(chr(ord("0") + d))
        p2 &= one_f - 1
        kappa -= 1
        if p2 < delta:
            K += kappa
            # The reference's DigitGen reads kPow10[-kappa] past the end of
            # the 10-entry array when more than 9 fractional digits were
            # produced (dToStr.h:326); the garbage multiplier empirically
            # disables the rounding step (verified by fuzzing 25k doubles
            # against a binary built from the reference source).  We
            # replicate that: no rounding when -kappa > 9.
            if -kappa <= 9:
                _grisu_round(buffer, delta, p2, one_f, wp_w * (10 ** (-kappa)))
            return "".join(buffer), K


def _grisu2(value: float) -> tuple[str, int]:
    u64 = struct.unpack("<Q", struct.pack("<d", value))[0]
    biased_e = (u64 >> 52) & 0x7FF
    significand = u64 & (_HIDDEN_BIT - 1)
    if biased_e != 0:
        f, e = significand + _HIDDEN_BIT, biased_e - _EXP_BIAS
    else:
        f, e = significand, -_EXP_BIAS + 1
    # NormalizedBoundaries
    plus = _normalize_boundary((f << 1) + 1, e - 1)
    if f == _HIDDEN_BIT:
        mi_f, mi_e = (f << 2) - 1, e - 2
    else:
        mi_f, mi_e = (f << 1) - 1, e - 1
    mi_f <<= mi_e - plus[1]
    minus = (mi_f, plus[1])
    cf, ce, K = _cached_power(plus[1])
    W = _diy_mul(*_normalize(f, e), cf, ce)
    Wp = _diy_mul(*plus, cf, ce)
    Wm = _diy_mul(*minus, cf, ce)
    Wm = (Wm[0] + 1, Wm[1])
    Wp = (Wp[0] - 1, Wp[1])
    digits, K2 = _digit_gen(W, Wp, Wp[0] - Wm[0])
    return digits, K + K2


def _write_exponent(K: int) -> str:
    return ("-" + str(-K)) if K < 0 else str(K)


def _prettify(digits: str, k: int) -> str:
    length = len(digits)
    kk = length + k
    if length <= kk <= 21:
        return digits + "0" * (kk - length) + ".0"
    if 0 < kk <= 21:
        return digits[:kk] + "." + digits[kk:]
    if -6 < kk <= 0:
        return "0." + "0" * (-kk) + digits
    if length == 1:
        return digits + "e" + _write_exponent(kk - 1)
    return digits[0] + "." + digits[1:] + "e" + _write_exponent(kk - 1)


def dtoa(value: float) -> str:
    """dtoa_milo (dToStr.h:427-456)."""
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "inf"
    if value == 0:
        return "0.0"
    sign = ""
    if value < 0:
        sign = "-"
        value = -value
    digits, K = _grisu2(value)
    return sign + _prettify(digits, K)


def ftoa(value) -> str:
    """float32 value printed via the double path (the reference passes
    floats to dtoa_milo(double))."""
    return dtoa(float(value))


def cpp_default(value: float) -> str:
    """C++ ``operator<<(double)`` default formatting (6 significant
    digits, %g-style) used by the profile CSV writer (Compare.hpp:3589)."""
    return f"{value:.6g}"
