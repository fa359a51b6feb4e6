"""Decode of the packed per-batch readback (port of
kasa_tpu/match/tiered.py:778 SingleTurboDispatch_decode).  The tiered
beyond-resident path itself is a later slice of the port."""

from __future__ import annotations

import numpy as np


def SingleTurboDispatch_decode(packed, rows_pad, rb, cap, want_lists,
                               ht_d, hk_d):
    """packed (2R + 2*cap + 4,) int32 -> (hc, ofc, ofl, nflag, ht, hk)
    for the batch's first rb reads.  When the batch's hits overflow the
    CSR (total > cap) the dense (R, WOUT) device lists are fetched."""
    hc_full = packed[:rows_pad]
    fl = packed[rows_pad:2 * rows_pad]
    ofc = (fl[:rb] & 1).astype(bool)
    ofl = (fl[:rb] >> 1).astype(bool)
    nflag = int(packed[-1])
    total = int(packed[-2])
    ht = hk = None
    if want_lists:
        hc = hc_full[:rb]
        maxc = max(int(hc.max()) if rb else 0, 1)
        if total <= cap:
            csr = packed[2 * rows_pad:2 * rows_pad + 2 * cap] \
                .reshape(cap, 2)
            ht = np.zeros((rb, maxc), np.int32)
            hk = np.zeros((rb, maxc), np.float32)
            rr = np.repeat(np.arange(rb), hc)
            cum = np.cumsum(hc) - hc
            cc = np.arange(len(rr)) - np.repeat(cum, hc)
            ht[rr, cc] = csr[:len(rr), 0]
            hk[rr, cc] = csr[:len(rr), 1].view(np.float32)
        else:
            ht = ht_d[:rb].cpu().numpy().copy()
            hk = hk_d[:rb].cpu().numpy().copy()
    return hc_full[:rb].copy(), ofc, ofl, nflag, ht, hk
