"""--visualize debug aid: per-batch match visualization.
(a copy of kasa_tpu/match/visualize.py)

Reimplements the reference's visualization path byte-for-byte:
frame-string accumulation during translation (Read.hpp:90-111,
155-156, 192-193), the _matchedkMers pushes during the merge-join
(Compare.hpp:902-904, recorded here by the faithful walk in
walk128.py), and the aligned print + per-taxon score summary
(Compare.hpp:3330-3386).
"""

from __future__ import annotations

import numpy as np


def _decode_suffix(val: int, k: int) -> str:
    """kMerToAminoacid (kASA.hpp:383-396): k letters, (code&31)|64."""
    return "".join(chr(((val >> (5 * (k - 1 - i))) & 31) | 64)
                   for i in range(k))


def frame_strings(batch, highest_k: int, lut: np.ndarray,
                  frames: list | None = None,
                  protein: bool = False) -> list:
    """Accumulate _translatedFramesForVisualization over the batch's
    buffer lines (forward AND reverse-complement lines both append to
    the same <=3 frame strings, convert_dnaTokMer Read.hpp:90-111;
    protein input appends the raw AA line to ONE frame,
    proteinTokMers Read.hpp:229-238)."""
    frames = frames if frames is not None else []
    if protein:
        if not frames:
            frames.append("")
        for line in batch.buffers:
            frames[0] += line.tobytes().decode("latin-1")
        return frames
    max_k_times3 = 3 * highest_k

    def aa(buf: np.ndarray, pos: int) -> str:
        c1, c2, c3 = int(buf[pos]), int(buf[pos + 1]), int(buf[pos + 2])
        idx = ((c1 & 14) << 5) | ((c2 & 14) << 2) | ((c3 & 14) >> 1)
        return chr(lut[idx])

    for line, max_range in zip(batch.buffers, batch.line_counts):
        if max_range < 1:
            continue
        num_frames = 3 if max_range >= 3 else int(max_range)
        if not frames:
            frames.extend([""] * num_frames)
        # initial highest_k AAs per frame
        for j in range(num_frames):
            frames[j] += "".join(aa(line, j + 3 * i)
                                 for i in range(highest_k))
        if max_range > 3:
            mod3 = int(max_range % 3)
            neg = 1 if mod3 else 0
            j2 = 1
            while 3 * (j2 + neg) < max_range:
                for k in range(3):
                    frames[k] += aa(line, k + max_k_times3 + 3 * (j2 - 1))
                j2 += 1
            for j in range(mod3):
                frames[j] += aa(line, j + max_k_times3
                                + 3 * (max_range // 3 - 1))
    return frames


def print_visualization(frames: list, matched: list, out=None):
    """The per-batch print (Compare.hpp:3330-3386): each frame string,
    then every matched k-mer aligned under its first occurrence in the
    frame, then per-taxon scores (sum of matched lengths) descending."""
    import sys
    out = out or sys.stdout
    strings = [( _decode_suffix(v, k).lstrip("@"), tax)
               for (v, k, tax) in matched]
    for entry in frames:
        lines = []
        out.write(entry + "\n")
        for s, tax in strings:
            pos = entry.find(s)
            if pos != -1:
                txt = " " * pos + s + "," + str(tax)
                txt += " " * (len(entry) - len(txt))
                lines.append((txt, pos, len(s), tax))
        if not lines:
            continue
        lines.sort(key=lambda t: (t[1], t[2], t[3]))
        for txt, *_ in lines:
            out.write(txt + "\n")
        lines.sort(key=lambda t: t[3])
        scores = []
        seen_tax, score = lines[0][3], 0
        for _, _, ln, tax in lines:
            if tax == seen_tax:
                score += ln
            else:
                scores.append((seen_tax, score))
                seen_tax, score = tax, ln
        scores.append((seen_tax, score))
        scores.sort(key=lambda t: -t[1])
        out.write("Scores: \n")
        for tax, sc in scores:
            out.write(f"{tax} {sc}\n")
        out.write("\n")
