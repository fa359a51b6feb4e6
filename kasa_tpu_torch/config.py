"""Run configuration — the equivalent of the reference's single
``InputParameters`` global (MetaHeader.h:154-161) plus YAML support
(main.cpp:264-302, Utilities.hpp:1114).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    # mode + paths
    mode: str = ""
    db_out: str = ""            # -d / -o output index
    temp_path: str = ""         # -t
    input: str = ""             # -i (file or dir)
    content_file: str = ""      # -c
    content_file1: str = ""     # -c1
    content_file2: str = ""     # -c2
    content_file_after_update: str = ""  # -co
    first_old_index: str = ""   # --firstIndex
    second_old_index: str = ""  # --secondIndex
    read_to_taxa_file: str = ""  # -q
    table_file: str = ""        # -p
    index_file: str = ""        # -d for identify
    delnodes_file: str = ""     # -l
    codon_table: str = ""       # -a <file>
    codon_id: str = "1"         # -a <file> <id>
    taxonomy_path: str = ""     # -y
    acc_to_tax_files: str = ""  # -f
    tax_level: str = ""         # -u
    paired_end_1: str = ""      # -1
    paired_end_2: str = ""      # -2
    filtered_clean_out: str = "_"         # --filter <clean> <contaminated>
    filtered_contaminants_out: str = "_"

    # flags
    verbose: bool = False       # -v
    translated: bool = False    # -z (protein input)
    ram: bool = False           # -r (index fully in memory)
    unique: bool = False        # -e
    sloppy: bool = False        # -j ("unfunny")
    six_frames: bool = False    # --six
    three_frames: bool = False  # --three
    one_frame: bool = False     # --one
    taxids_as_strings: bool = False  # --taxidasstr
    continue_build: bool = False     # --continue
    coverage: bool = False      # --coverage
    filter: bool = False        # --filter
    gzip_out: bool = False      # --gzip
    i_got_space: bool = False   # --igotspace
    post_process: bool = False  # --coherence
    visualize: bool = False     # --visualize (debug aid)

    # numbers
    threads: int = 1            # -n
    highest_k: int = 12         # fixed by --kH>12 switch to 25
    higher_k: int = 12          # -k hi / --kH
    lower_k: int = 7            # -k lo / --kL
    call_idx: int = 0           # -x
    num_of_beasts: int = 3      # -b
    memory_avail: int = 5 * 1024 * 1024 * 1024  # -m (bytes); default 5GB (main.cpp:590)
    shrink_percentage: float = 0.0  # -g
    threshold: float = 0.0          # --threshold
    # --engine: "tpu" (the default here, as on kasa_tpu's CLI), "join"
    # or "exact" (match/pipeline.py)
    engine: str = "tpu"
    engine_explicit: bool = False
    device: str | None = None       # --device (port): None = cuda
    turbo_sidecar: bool = True
    error_threshold: float = 0.5    # --errorThreshold
    coherence_threshold: float = 11.0  # --coherenceThreshold
    shrink_strategy: int = 2        # -s (main.cpp default when shrinking is 2)
    output_format: str = "json"     # --json/--jsonl/--tsv/--kraken


    @property
    def num_frames(self) -> int:
        # reference kASA ctor (kASA.hpp:295)
        if self.one_frame:
            return 1
        if self.three_frames:
            return 3
        if self.six_frames:
            return 6
        return 3

    @property
    def num_k(self) -> int:
        return self.higher_k - self.lower_k + 1

    @property
    def ks(self) -> list:
        """k values ordered largest -> smallest like the reference's
        _aOfK (kASA.hpp:299-302)."""
        return list(range(self.higher_k, self.lower_k - 1, -1))

    def clamp_ks(self):
        """Reference ctor semantics (kASA.hpp:290-293)."""
        if not (self.higher_k <= self.highest_k and self.higher_k >= self.lower_k):
            self.higher_k = self.highest_k
        if self.lower_k < 1:
            self.lower_k = 1


def load_yaml_config(path: str) -> dict:
    """Minimal YAML 'key: value' parser compatible with the reference's
    parameters.yaml schema (Utilities.hpp:1114).  Values may be quoted."""
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, val = line.split(":", 1)
            val = val.strip().strip('"').strip("'")
            out[key.strip()] = val
    return out
