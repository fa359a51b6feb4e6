"""Long-read chunking + memory-bounded batch planning for identify,
faithful to the reference binary's streaming machinery so that output
stays byte-identical even when giant contigs are split mid-read:

  * ``Reader2048`` emulates Utilities::FileReader (Utilities.hpp:449-550)
    exactly: 2048-byte blocks, getChunk up to the next newline or block
    end, a '\\n' injected after a partial final block, eof only after a
    zero-byte read.
  * ``scan_info_fasta/fastq`` emulate readFileAndGenerateInfos
    (Read.hpp:372-609): each line of the info file is
    (skipped-lines, dna-parts, chunk-number), where chunk-number counts
    DOWN to 1 across the ~100MB-of-k-mer-memory chunks of one read.
  * ``identify_soft_budget`` reproduces the byte-exact memory ledger the
    binary uses to close a batch (main.cpp:1050-1062 subtractions,
    Compare.hpp:2799-2815 average-usage estimate, the once-only 0.1%
    shrink at Compare.hpp:3126-3133).
  * ``chunked_batches`` drives readFastqa_singleEnd's loop
    (Read.hpp:1054-1232): per info line it consumes skip lines + parts,
    sanitizes, prepends the previous chunk's 3k-1-char overhang
    (generateOverhang, Read.hpp:678-695), pads, emits the marker-suffixed
    line(s), and maintains the strTransfer carry (name, accumulated
    length -- including the reference's odd double-counting of earlier
    chunks when a read spans 3+ chunk-lines before finishing --
    finished/addTail flags, info-line cursor).

The cross-batch score carry (vSavedScores, Compare.hpp:2342-2426) lives
in match/pipeline.py; this module only shapes the batches.  Port of
kasa_tpu/match/chunking.py (host code).
"""

from __future__ import annotations

import numpy as np

from . import ingest as ingest_mod

_HUNDRED_MB = 100 * 1024 * 1024
GB = 1024 ** 3


class Reader2048:
    """Utilities::FileReader emulation over a binary file-like object."""

    BUF = 2048

    def __init__(self, fh):
        self._fh = fh
        self._block = b""
        self._m = 0           # valid chars in current block (gcount)
        self._pos = 0         # cursor within block
        self._eof = False     # stream eofbit (set only by a zero-read)

    def eof(self) -> bool:
        return self._eof

    def _refill(self) -> bool:
        if self._pos >= self._m:
            blk = self._fh.read(self.BUF)
            self._m = len(blk)
            self._pos = 0
            if self._m == 0:
                self._eof = True
                return False
            # partial block: the reference writes '\n' after the last
            # valid byte (Utilities.hpp:478-480)
            self._block = blk + b"\n" if self._m < self.BUF else blk
        return True

    def get_chunk(self):
        """-> (bytes without newline, saw_newline, chars consumed);
        the newline (possibly the injected phantom one) counts as +1."""
        if not self._refill():
            return b"", False, 0
        nl = self._block.find(b"\n", self._pos, self.BUF)
        if nl != -1:
            out = self._block[self._pos:nl]
            n = nl - self._pos + 1
            self._pos = nl + 1
            return out, True, n
        out = self._block[self._pos:self.BUF]
        n = self.BUF - self._pos
        self._pos = self.BUF
        return out, False, n

    def read_line(self) -> bytes:
        """Consume getChunk calls until a newline (skip-line loop of
        processInput, Read.hpp:703-710)."""
        line = b""
        saw = False
        while not saw:
            s, saw, _ = self.get_chunk()
            line += s
            if self._eof:
                break
        return line

    def drain(self):
        """Read to EOF so the stream's good() turns false
        (Read.hpp:1222-1229)."""
        while not self._eof:
            self.get_chunk()


def _mem_from_kmers(count: int, elem_size: int, six: bool, protein: bool) -> int:
    """calculateMemoryUsageFromkMerCount (Read.hpp:362-368)."""
    if not protein and six:
        return count * elem_size * 2
    return count * elem_size


def scan_info_fasta(fh, count_fn, elem_size: int, six: bool, protein: bool):
    """readFileAndGenerateInfos fasta branch (Read.hpp:390-480) ->
    list of (skipped_lines, dna_parts, chunk_number)."""
    rdr = Reader2048(fh)
    lines = []
    skipped = 0
    parts = 0
    chunkno = 0
    read_chars = 0
    saved = []

    def flush():
        nonlocal skipped, parts, chunkno, read_chars, saved
        if chunkno == 1:
            lines.append((skipped, parts, 1))
            parts = 0
            read_chars = 0
            saved = []
        else:
            saved.append(parts)
            while chunkno >= 1:
                lines.append((skipped, saved[len(saved) - chunkno], chunkno))
                skipped = 0
                chunkno -= 1
            parts = 0
            chunkno = 1
            read_chars = 0
            saved = []

    while not rdr.eof():
        s, saw_nl, n = rdr.get_chunk()
        if s:
            if s[0] == 0x3E:  # '>'
                flush()
                while not saw_nl:
                    s, saw_nl, _ = rdr.get_chunk()
                    if rdr.eof():
                        break
                skipped = 1
            else:
                parts += 1
                read_chars += n
                if _mem_from_kmers(count_fn(read_chars), elem_size, six,
                                   protein) > _HUNDRED_MB:
                    chunkno += 1
                    saved.append(parts)
                    parts = 0
                    read_chars = 0
        else:
            parts += 1

    # save info from last read (Read.hpp:457-480); at this point flush()
    # without the trailing reset matches both branches
    if chunkno == 1:
        lines.append((skipped, parts, 1))
    else:
        saved.append(parts)
        while chunkno >= 1:
            lines.append((skipped, saved[len(saved) - chunkno], chunkno))
            skipped = 0
            chunkno -= 1
    return lines


def scan_info_fastq(fh, count_fn, elem_size: int, six: bool, protein: bool):
    """readFileAndGenerateInfos fastq branch (Read.hpp:482-609)."""
    rdr = Reader2048(fh)
    lines = []
    skipped = 0
    parts = 0
    chunkno = 1
    read_chars = 0
    dna_chars = 0
    qual_chars = 0
    saved = []
    state = 0  # 0 name line, 1 dna, 2 '+' line, 3 quality

    while not rdr.eof():
        s, saw_nl, n = rdr.get_chunk()
        if s:
            if saw_nl:
                n -= 1  # newline char is of no use (Read.hpp:496)
            if s[0] == 0x2B and state == 1:  # '+'
                state = 2
            if state == 0:
                while not saw_nl:
                    s, saw_nl, _ = rdr.get_chunk()
                    if rdr.eof():
                        break
                skipped += 1
                state = 1
            elif state == 1:
                parts += 1
                read_chars += n
                dna_chars += n
                if _mem_from_kmers(count_fn(read_chars), elem_size, six,
                                   protein) > _HUNDRED_MB:
                    chunkno += 1
                    saved.append(parts)
                    parts = 0
                    read_chars = 0
            elif state == 2:
                if chunkno == 1:
                    lines.append((skipped, parts, 1))
                    parts = 0
                    read_chars = 0
                    saved = []
                else:
                    saved.append(parts)
                    while chunkno >= 1:
                        lines.append((skipped, saved[len(saved) - chunkno],
                                      chunkno))
                        skipped = 0
                        chunkno -= 1
                    parts = 0
                    chunkno = 1
                    read_chars = 0
                    saved = []
                while not saw_nl:
                    s, saw_nl, _ = rdr.get_chunk()
                    if rdr.eof():
                        break
                skipped = 1
                state = 3
            elif state == 3:
                qual_chars += n
                d = 0
                used = False
                while not saw_nl:
                    s, saw_nl, d = rdr.get_chunk()
                    qual_chars += d
                    used = True
                    if rdr.eof():
                        break
                if used and d > 0:
                    qual_chars -= 1
                if qual_chars == dna_chars:
                    dna_chars = 0
                    qual_chars = 0
                    state = 0
                elif qual_chars > dna_chars:
                    raise RuntimeError("Quality string and DNA string do not "
                                       "have the same length!")
                skipped += 1
        else:
            parts += 1

    # the last part of a fastq is marked unusable (Read.hpp:598-606)
    lines.append((skipped, 0, 0))
    return lines


def umap_bytes(keys) -> int:
    """Exact byte cost of the reference's taxid->row unordered_map
    (Utilities.hpp:1028-1040) via the native libstdc++ helper."""
    from ..native import umap_bytes as native_umap_bytes
    return native_umap_bytes(np.asarray(keys, dtype=np.uint32))


def trie_ram_bytes(index_path: str) -> int:
    """In-RAM pointer-trie size (the default iPrefixCheckMode):
    LoadFromStxxlVec adds 256 bytes per new Node at levels 1-4 and
    sizeof(Leaf5)=384 per new level-5 leaf (Trie.hpp:74-106, 138-145)."""
    from ..index import artifacts
    prefixes, _counts = artifacts.read_trie(index_path)
    if len(prefixes) == 0:
        return 0
    p = prefixes.astype(np.uint32)
    size = 0
    for lvl in range(1, 5):
        size += 256 * len(np.unique(p >> np.uint32(5 * (6 - lvl))))
    size += 384 * len(np.unique(p >> np.uint32(5)))
    return size


def input_elem_size(itype_is_128: bool, post_process: bool) -> int:
    """sizeof of one InputType row (MetaHeader.h:165-224; standard
    tuple 24/32 B, post-process tuple 32/40 B for 64/128-bit keys)."""
    if itype_is_128:
        return 40 if post_process else 32
    return 32 if post_process else 24


def identify_soft_budget(cfg, index_path: str, organisms, idx_to_tax,
                         min_k: int, max_k: int, itype: int,
                         index_len: int) -> int:
    """The soft memory budget one batch may consume, byte-identical to
    the reference ledger:

      -m bytes
      - in-RAM trie size                    (main.cpp:1054)
      - content/frequency metadata          (Compare.hpp:111-160)
      - stxxl vector buffers or RAM index   (Compare.hpp:182-328)
      - averaged per-run usage              (Compare.hpp:2799-2815)
    """
    from ..index import artifacts

    S = len(idx_to_tax)
    num_k = max_k - min_k + 1
    threads = max(cfg.threads, 1)

    mem = int(cfg.memory_avail)
    mem -= trie_ram_bytes(index_path)

    # loadContentAndFrequencyFiles subtractions
    mem -= sum(len(o) for o in organisms[1:])
    mem -= umap_bytes([0] + [int(t) for t in idx_to_tax[1:]])
    mem -= S * 4
    mem -= S * 8 * (max_k - min_k)
    if mem < 0:
        mem = GB

    # loadIndex
    halved = itype == artifacts.INDEX_TYPE_HALF
    is128 = itype == artifacts.INDEX_TYPE_128
    if cfg.ram:
        elem = 6 if (halved or (min_k > 6 and S - 1 <= 65535
                                and not cfg.sloppy and max_k <= 12)) \
            else (20 if is128 else 12)
        if mem - index_len * elem >= 0:
            mem -= index_len * elem
        else:
            block = 2048000 if is128 else 2101248
            mem -= threads * block * 4 * 4
    else:
        block = 2048000 if is128 else 2101248
        mem -= threads * block * 4 * 4

    # CompareWithLib average-usage estimate
    imult = threads * num_k * S
    sbit = ((S + 63) // 64) * 8 + 48 + 8 * S  # sBitArray::sizeInBytes
    usage = GB + imult * 24 + threads * sbit + 14399756 + 4 * S
    soft = mem - usage if mem > usage else mem
    return soft


def batch_soft_limit(soft0: int, batch_index: int) -> int:
    """Once-only 0.1% shrink after the first batch
    (Compare.hpp:3126-3133)."""
    if batch_index == 0:
        return soft0
    cut = int(soft0 * 0.001)
    return soft0 - cut if soft0 - cut > 0 else soft0


def _generate_overhang(padded: np.ndarray, highest_k: int,
                       protein: bool) -> np.ndarray:
    """generateOverhang (Read.hpp:678-695): the last 3k-1 (protein: k-1)
    chars of the padded chunk, or the whole chunk if shorter."""
    span = highest_k if protein else highest_k * 3
    if len(padded) < span:
        return padded
    return padded[len(padded) + 1 - span:]


def chunked_batches(open_fh, is_fasta: bool, builder, soft0: int,
                    num_species: int, read_ids_interesting: bool,
                    post_process: bool, elem_size: int):
    """Yield ReadBatches exactly as readFastqa_singleEnd would fill them
    (Read.hpp:1054-1232), including mid-read batch boundaries.

    ``open_fh`` is a zero-arg callable returning a fresh binary stream
    (the reference re-opens the file after the info pre-scan).  Batch
    fields set here: rows (score-matrix height = completed + partial),
    add_tail / finished (end-of-batch strTransfer flags), names/lengths
    for COMPLETED rows only (vReadNameAndLength)."""
    fh = open_fh()
    try:
        scan = scan_info_fasta if is_fasta else scan_info_fastq
        info = scan(fh, lambda n: ingest_mod.calculate_kmer_count(
            n, builder.highest_k, builder.protein, builder.one_frame),
            elem_size, builder.six_frames, builder.protein)
    finally:
        fh.close()

    fh = open_fh()
    rdr = Reader2048(fh)
    cursor = 0
    name = ""
    length_carry = 0
    overhang = np.zeros(0, np.uint8)
    finished = True
    batch_index = 0

    try:
        while True:
            soft = batch_soft_limit(soft0, batch_index)
            batch = ingest_mod.ReadBatch([], [], [], [], [])
            prev_finished = finished
            local_rid = 0
            length = length_carry
            add_tail = True
            ok = True

            while True:
                if cursor < len(info):
                    entries = info[cursor]
                    cursor += 1
                else:
                    ok = False
                if soft <= _HUNDRED_MB or not ok or local_rid == 0xFFFFFFFF:
                    cursor -= 1
                    break
                skip, nparts, chunkno = entries

                if chunkno > 0:
                    # processInput (Read.hpp:699-760)
                    last_line = b""
                    for _ in range(skip):
                        last_line = rdr.read_line()
                    if skip:
                        name += last_line[1:].decode("latin-1") + " "
                    buf = bytearray()
                    for _ in range(nparts):
                        s, _saw, n = rdr.get_chunk()
                        buf += s
                        length += n
                    raw = np.frombuffer(bytes(buf), np.uint8)
                    if np.any((raw == 0x20) | (raw == 0x09)):
                        raise RuntimeError("Spaces or tabs inside read, "
                                           "please check your input.")
                    chunk = np.concatenate([overhang, builder.sanitize[raw]])
                    chunk = builder.pad(chunk)
                    for line, frame in builder.emit_lines(chunk):
                        cnt = ingest_mod.calculate_kmer_count(
                            len(line), builder.highest_k, builder.protein,
                            builder.one_frame)
                        batch.buffers.append(line)
                        batch.line_read_ids.append(local_rid)
                        batch.line_counts.append(cnt)
                        batch.line_frames.append(frame)
                        batch.num_kmers += cnt
                        soft -= cnt * elem_size
                        soft -= len(line) + 16
                    if chunkno == 1:
                        local_rid += 1
                        finished = True
                        add_tail = False
                        if read_ids_interesting and name and length:
                            soft -= 40 + len(name) + 4
                            batch.names.append(name)
                            batch.lengths.append(length & 0xFFFFFFFF)
                            length_carry = 0
                        name = ""
                        length = 0
                        overhang = np.zeros(0, np.uint8)
                    else:
                        finished = False
                        add_tail = True
                        if read_ids_interesting and name and length:
                            length_carry += length
                        overhang = _generate_overhang(
                            chunk, builder.highest_k, builder.protein)
                # entries[2]==0 (fastq tail line): no processing, skip
                # lines stay unconsumed, flags unchanged (Read.hpp:1160)
                if read_ids_interesting and finished:
                    soft -= num_species * 4 + (4 if post_process else 0)

            batch.rows = local_rid + (1 if add_tail else 0)
            batch.incomplete_last = add_tail
            batch.continued_first = not prev_finished
            batch.add_tail = add_tail
            batch.finished = finished
            if not ok:
                rdr.drain()
            yield batch
            batch_index += 1
            if rdr.eof():
                break
    finally:
        fh.close()
