"""Read-batch preparation for identify, replicating the reference's
ingestion semantics exactly (Read.hpp:612-760, 1054-1232):

  * sanitize: non-ACGTacgt -> 'Z' (protein: '*' -> '['), spaces/tabs are
    an error (searchAndReplaceLettersOfRead, Read.hpp:657-675)
  * pad tiny reads with 'X' ('^' for protein) until a single window fits
    (paddingOfSmallReads, Read.hpp:633-654)
  * append the false-k-mer marker of (highestK-minK)*3 'X' per read
    ((highestK-minK) '^' for protein) so smaller k remain scoreable at
    read tails (Read.hpp:1068-1078)
  * for --six additionally emit the reverse complement (of the
    sanitized+padded read) + marker (putReadIntoLocalMemory,
    Read.hpp:612-630)
  * k-mer count per line: len-3*highestK+1 if len > 3*highestK+1 else 0
    (calculatekMerCount, Read.hpp:36-57) -- note the strict >, which
    zeroes reads at exactly the window size
  * read name = header line after '>'/'@' plus a trailing space
    (processInput, Read.hpp:712-713); length = raw sequence length

Port of kasa_tpu/match/ingest.py.  The per-read byte buffers are
encoded to k-mer windows on the device (core/encode.py Encoder, K1);
this module owns the host-side string handling.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.alphabet import build_sanitize_lut, build_revcomp_lut
from ..host import fastx


@dataclass
class ReadBatch:
    """One memory-bounded batch of reads, ready for device encoding."""
    names: list            # per read: specifier (with reference's trailing space)
    lengths: list          # per read: raw sequence length (uint32 in reference)
    buffers: list          # per line: sanitized+padded+marker uint8 array
    line_read_ids: list    # per line: read id within batch
    line_counts: list      # per line: number of k-mers (calculatekMerCount)
    line_frames: list = field(default_factory=list)  # per line: 0 fwd / 1 RC
    num_kmers: int = 0     # iSumOfkMers over the batch
    # mid-read chunking state (the reference's strTransfer carry,
    # Read.hpp:343-356), set by match/chunking.py: the first read
    # continues the previous batch's last read / the last read is
    # incomplete and continues next batch; `rows` is the score-matrix
    # height (completed reads + the partial one), `finished`/`add_tail`
    # are the end-of-batch strTransfer flags consumed by the
    # saveResults-equivalent carry in the pipeline (Compare.hpp:2342).
    continued_first: bool = False
    incomplete_last: bool = False
    rows: int | None = None
    add_tail: bool = False
    finished: bool = True

    @property
    def num_reads(self) -> int:
        """Score-matrix rows (iNumOfNewReads); equals len(names) for
        whole-read batches."""
        return self.rows if self.rows is not None else len(self.names)


def calculate_kmer_count(length: int, highest_k: int, protein: bool,
                         one_frame: bool) -> int:
    """calculatekMerCount (Read.hpp:36-57)."""
    if protein:
        if length > highest_k + 1:
            return length - highest_k + 1
    elif one_frame:
        d3 = length // 3
        if d3 > highest_k + 1:
            return d3 - highest_k + 1
    else:
        if length > 3 * highest_k + 1:
            return length - 3 * highest_k + 1
    return 0


class BatchBuilder:
    def __init__(self, highest_k: int, min_k: int, protein: bool = False,
                 six_frames: bool = False, one_frame: bool = False):
        self.highest_k = highest_k
        self.min_k = min_k
        self.protein = protein
        self.six_frames = six_frames
        self.one_frame = one_frame
        self.sanitize = build_sanitize_lut(protein=protein)
        self.revcomp = build_revcomp_lut()
        if protein:
            self.marker = np.full(highest_k - min_k, ord("^"), dtype=np.uint8)
        else:
            self.marker = np.full((highest_k - min_k) * 3, ord("X"), dtype=np.uint8)

    def pad(self, read: np.ndarray) -> np.ndarray:
        """paddingOfSmallReads (Read.hpp:633-654)."""
        mlen = len(self.marker)
        n = len(read)
        if n == 0:
            return read
        if self.protein:
            need = self.highest_k - mlen - n
            padc = ord("^")
        elif self.one_frame:
            need = 0
            while (n + need + mlen) // 3 < self.highest_k:
                need += 1
            padc = ord("X")
        else:
            need = self.highest_k * 3 - mlen - n
            padc = ord("X")
        if need > 0:
            return np.concatenate([read, np.full(need, padc, dtype=np.uint8)])
        return read

    def emit_lines(self, padded: np.ndarray):
        """Yield (line, frame) buffers for one sanitized+padded chunk in
        the reference's emission order (putReadIntoLocalMemory,
        Read.hpp:612-630): reverse complement first under --six, then
        forward, each with the false-k-mer marker appended."""
        if not self.protein and self.six_frames:
            rc = self.revcomp[padded][::-1]
            yield np.concatenate([rc, self.marker]), 1
        yield np.concatenate([padded, self.marker]), 0

    def add_read(self, batch: ReadBatch, name: str, seq: str,
                 read_id: int | None = None, count_name: bool = True,
                 nlines: int = 1):
        """Process one whole read (sanitize, pad, marker, optional RC)."""
        raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        # the reference's length counter tallies getChunk chars, which
        # include one newline per sequence line (Read.hpp:730-731)
        rlen = len(raw) + nlines
        if count_name:
            batch.names.append(name + " ")
            batch.lengths.append(rlen & 0xFFFFFFFF)
        else:
            # paired-end mate: append to existing name, accumulate length
            batch.names[-1] += name + " "
            batch.lengths[-1] = (batch.lengths[-1] + rlen) & 0xFFFFFFFF
        rid = read_id if read_id is not None else len(batch.names) - 1
        clean = self.sanitize[raw]
        if np.any((raw == ord(" ")) | (raw == ord("\t"))):
            raise RuntimeError("Spaces or tabs inside read, please check your input.")
        padded = self.pad(clean)

        if not self.protein and self.six_frames:
            rc = self.revcomp[padded][::-1]
            line = np.concatenate([rc, self.marker])
            cnt = calculate_kmer_count(len(line), self.highest_k,
                                       self.protein, self.one_frame)
            batch.buffers.append(line)
            batch.line_read_ids.append(rid)
            batch.line_counts.append(cnt)
            batch.line_frames.append(1)
            batch.num_kmers += cnt

        line = np.concatenate([padded, self.marker])
        cnt = calculate_kmer_count(len(line), self.highest_k,
                                   self.protein, self.one_frame)
        batch.buffers.append(line)
        batch.line_read_ids.append(rid)
        batch.line_counts.append(cnt)
        batch.line_frames.append(0)
        batch.num_kmers += cnt


def read_file_batches(path: str, builder: BatchBuilder,
                      max_reads_per_batch: int = 1 << 62,
                      max_kmers_per_batch: int = 1 << 62):
    """Yield ReadBatches from a fasta/fastq(.gz) file (whole reads).

    Batches close at read boundaries once either bound is hit -- the
    memory-bounded outer loop of the reference (Compare.hpp:3100-3429,
    iSumOfkMers soft limit); cross-batch read numbering / profile
    accumulation is handled by the identify loop."""
    batch = ReadBatch([], [], [], [], [])
    for rec in fastx.iter_records(path):
        builder.add_read(batch, rec.name, rec.seq, nlines=rec.nlines)
        if (batch.num_reads >= max_reads_per_batch
                or batch.num_kmers >= max_kmers_per_batch):
            yield batch
            batch = ReadBatch([], [], [], [], [])
    if batch.num_reads:
        yield batch


def read_paired_batches(path1: str, path2: str, builder: BatchBuilder,
                        max_reads_per_batch: int = 1 << 62,
                        max_kmers_per_batch: int = 1 << 62):
    """Paired-end: mates share one read id; the reference interleaves
    (first mate line, then second mate line per read; names concatenated
    with trailing spaces, lengths summed) (readFastqa_pairedEnd,
    Read.hpp:834-1050)."""
    batch = ReadBatch([], [], [], [], [])
    it1 = fastx.iter_records(path1)
    it2 = fastx.iter_records(path2)
    for rec1, rec2 in zip(it1, it2):
        builder.add_read(batch, rec1.name, rec1.seq, nlines=rec1.nlines)
        builder.add_read(batch, rec2.name, rec2.seq, nlines=rec2.nlines,
                         read_id=batch.num_reads - 1, count_name=False)
        if (batch.num_reads >= max_reads_per_batch
                or batch.num_kmers >= max_kmers_per_batch):
            yield batch
            batch = ReadBatch([], [], [], [], [])
    if batch.num_reads:
        yield batch
