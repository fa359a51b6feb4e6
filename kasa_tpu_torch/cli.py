"""Command-line entry point (port of kasa_tpu/cli.py): the reference's flag
surface and every kasa_tpu mode.  Invoke as ``python -m kasa_tpu_torch
<mode> ...``, e.g. ``identify -d <index> -c <content> -i <reads> -q <out>
-p <profile> [--device cpu]`` or ``build -i <fasta> -c <content> -d
<index> [-k 25 1] [--device cpu]``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

from .config import Config, load_yaml_config

USAGE = """kasa_tpu_torch -- kASA-compatible metagenomic classifier on CUDA
Modes: generateCF build identify identify_multiple update delete shrink
       merge getFrequency redundancy trie half checkContentFile translate
       test howmuchtaxids showVec transform fuckit
Flags mirror the reference kASA binary (see README); --device cpu runs
the plain PyTorch versions of the kernels (identify, and the sort of a
128-bit index's entries in build and update)."""


def parse_args(argv: list[str]) -> Config:
    cfg = Config()
    if len(argv) < 2:
        print(USAGE)
        sys.exit(1)
    if argv[1] in ("-h", "--help"):
        print(USAGE)
        sys.exit(0)
    if argv[1] == "--parameters":
        params = load_yaml_config(argv[2])
        return config_from_yaml(params)
    cfg.mode = argv[1]
    i = 2
    mem_mb = None

    def nxt():
        nonlocal i
        i += 1
        return argv[i]

    while i < len(argv):
        p = argv[i]
        if p in ("-h", "--help"):
            print(USAGE); sys.exit(0)
        elif p in ("-o", "--outgoing"):
            cfg.db_out = nxt()
        elif p in ("-t", "--temp"):
            cfg.temp_path = nxt()
        elif p in ("-u", "--level"):
            cfg.tax_level = nxt()
            if cfg.tax_level == "sequence":
                cfg.tax_level = "lowest"
        elif p in ("-e", "--unique"):
            cfg.unique = True
        elif p == "--continue":
            cfg.continue_build = True
        elif p in ("-f", "--acc2tax"):
            cfg.acc_to_tax_files = nxt()
        elif p in ("-y", "--taxonomy"):
            cfg.taxonomy_path = nxt()
        elif p in ("-v", "--verbose"):
            cfg.verbose = True
        elif p in ("-z", "--translated"):
            cfg.translated = True
        elif p in ("-j", "--sloppy"):
            cfg.sloppy = True
        elif p in ("-d", "--database"):
            cfg.index_file = cfg.db_out = nxt()
        elif p == "--firstIndex":
            cfg.first_old_index = nxt()
        elif p == "--secondIndex":
            cfg.second_old_index = nxt()
        elif p in ("-a", "--alphabet"):
            cfg.codon_table = nxt()
            cfg.codon_id = nxt()
        elif p in ("-b", "--beasts"):
            cfg.num_of_beasts = max(int(nxt()), 1)
        elif p in ("-r", "--ram"):
            cfg.ram = True
        elif p in ("-g", "--percentage"):
            cfg.shrink_percentage = float(nxt())
        elif p in ("-x", "--callidx"):
            cfg.call_idx = int(nxt())
        elif p in ("-n", "--threads"):
            cfg.threads = int(nxt())
        elif p == "-k":
            cfg.higher_k = int(nxt())
            cfg.lower_k = int(nxt())
            cfg.higher_k = min(cfg.higher_k, 25)
            cfg.lower_k = max(cfg.lower_k, 1)
            if cfg.lower_k > cfg.higher_k:
                cfg.lower_k, cfg.higher_k = cfg.higher_k, cfg.lower_k
        elif p == "--kH":
            cfg.higher_k = min(int(nxt()), 25)
        elif p == "--kL":
            cfg.lower_k = max(int(nxt()), 1)
        elif p in ("-i", "--input"):
            cfg.input = nxt()
        elif p in ("-q", "--rtt"):
            cfg.read_to_taxa_file = nxt()
        elif p in ("-p", "--profile"):
            cfg.table_file = nxt()
        elif p in ("-m", "--memory"):
            v = nxt()
            mem_mb = ((1 << 64) - 1) // (1024 * 1024) if v == "inf" else 1024 * int(v)
        elif p in ("-s", "--strategy"):
            c = int(nxt())
            cfg.shrink_strategy = c if c in (1, 2, 3, 4) else 2
        elif p in ("-c", "--content"):
            cfg.content_file = nxt()
        elif p == "-c1":
            cfg.content_file1 = nxt()
        elif p == "-c2":
            cfg.content_file2 = nxt()
        elif p == "-co":
            cfg.content_file_after_update = nxt()
        elif p == "-1":
            cfg.paired_end_1 = nxt()
        elif p == "-2":
            cfg.paired_end_2 = nxt()
        elif p in ("-l", "--deleted"):
            cfg.delnodes_file = nxt()
        elif p == "--json":
            cfg.output_format = "json"
        elif p == "--jsonl":
            cfg.output_format = "jsonl"
        elif p == "--tsv":
            cfg.output_format = "tsv"
        elif p == "--kraken":
            cfg.output_format = "kraken"
        elif p == "--stxxl":
            nxt()  # accepted for compatibility; no stxxl here
        elif p == "--six":
            cfg.six_frames = True
        elif p == "--three":
            cfg.three_frames = True
        elif p == "--one":
            cfg.one_frame = True
        elif p == "--threshold":
            cfg.threshold = float(nxt())
        elif p == "--taxidasstr":
            cfg.taxids_as_strings = True
        elif p == "--coverage":
            cfg.coverage = True
        elif p == "--filter":
            cfg.filter = True
            cfg.filtered_clean_out = nxt()
            cfg.filtered_contaminants_out = nxt()
        elif p == "--errorThreshold":
            cfg.error_threshold = float(nxt())
        elif p == "--gzip":
            cfg.gzip_out = True
        elif p == "--igotspace":
            cfg.i_got_space = True
        elif p == "--coherence":
            cfg.post_process = True
        elif p == "--coherenceThreshold":
            cfg.coherence_threshold = float(nxt())
        elif p == "--visualize":
            cfg.visualize = True
        elif p == "--engine":
            cfg.engine = nxt()
            cfg.engine_explicit = True
            if cfg.engine not in ("exact", "tpu", "join"):
                raise RuntimeError("--engine must be exact, tpu or join")
        elif p == "--device":
            # port extension: cuda (default) or cpu (plain versions)
            cfg.device = nxt()
        elif p in ("--sidecar", "--no-sidecar"):
            # build: write the identify tables' sidecar with the index
            cfg.turbo_sidecar = p == "--sidecar"
        elif p in ("--debug", "--spaced"):
            pass  # dev flags accepted, no-op
        elif p == "--mask":
            nxt()
        else:
            raise RuntimeError(
                "Some unknown parameter has been inserted, please check your command line.")
        i += 1

    if mem_mb is None:
        mem_mb = 5120  # main.cpp:590
    cfg.memory_avail = mem_mb * 1024 * 1024
    return cfg


_YAML_STR_KEYS = {
    # parameters.yaml key -> Config field (readParametersFromYaml,
    # Utilities.hpp:1114-1420; schema parameters.yaml:11-94)
    "Mode": "mode",
    "ContentFile": "content_file",
    "FilePathForTemporaryFiles": "temp_path",
    "AlphabetFile": "codon_table",
    "AlphabetIndex": "codon_id",
    "InputFileOrFolder": "input",
    "PairedEnd-First": "paired_end_1",
    "PairedEnd-Second": "paired_end_2",
    "TaxonomicLevel": "tax_level",
    "AccessionToTaxIDFileOrFolder": "acc_to_tax_files",
    "TaxonomyFolder": "taxonomy_path",
    "ProfileOutputfile": "table_file",
    "ReadIDtoTaxIDOutputfile": "read_to_taxa_file",
    "ReadIDtoTaxIDOutputFormat": "output_format",
    "FileWithDeletedTaxa": "delnodes_file",
    "ContentFile-First": "content_file1",
    "ContentFile-Second": "content_file2",
    "ContentFile-Out": "content_file_after_update",
    "FirstOldIndex": "first_old_index",
    "SecondOldIndex": "second_old_index",
}

_YAML_BOOL_KEYS = {
    "Verbose": "verbose",
    "AlreadyTranslated": "translated",
    "TaxIDsAreStrings": "taxids_as_strings",
    "IGotSpace": "i_got_space",
    "One": "one_frame",
    "Three": "three_frames",
    "Six": "six_frames",
    "UseRAMOnly": "ram",
    "UniqueKmersOnly": "unique",
    "Coherence": "post_process",
    "PrintCoverage": "coverage",
    "Gzip": "gzip_out",
}


def config_from_yaml(params: dict) -> Config:
    """--parameters <yaml>: the reference's parameters.yaml schema
    (main.cpp:264-302; reader Utilities.hpp:1114)."""
    cfg = Config()
    for key, val in params.items():
        if key in _YAML_STR_KEYS:
            if val:
                setattr(cfg, _YAML_STR_KEYS[key], val)
        elif key in _YAML_BOOL_KEYS:
            setattr(cfg, _YAML_BOOL_KEYS[key], val.lower() == "true")
        elif not val:
            continue
        elif key == "Index":
            cfg.index_file = cfg.db_out = val
        elif key == "NewIndex":
            cfg.db_out = val
        elif key == "kHigh":
            cfg.higher_k = min(int(val), 25)
        elif key == "kLow":
            cfg.lower_k = max(int(val), 1)
        elif key == "NumberOfThreads":
            cfg.threads = int(val)
        elif key == "AvailableRAMinGB":
            cfg.memory_avail = int(val) * 1024 * 1024 * 1024
        elif key == "CallIndex":
            cfg.call_idx = int(val)
        elif key == "NumberOfTaxaPerRead":
            cfg.num_of_beasts = max(int(val), 1)
        elif key == "ThresholdForScore":
            cfg.threshold = float(val)
        elif key == "ErrorThreshold":
            cfg.error_threshold = float(val)
        elif key == "CoherenceThreshold":
            cfg.coherence_threshold = float(val)
        elif key == "ShrinkingStrategy":
            c = int(val)
            cfg.shrink_strategy = c if c in (1, 2, 3, 4) else 2
        elif key == "ShrinkPercentage":
            cfg.shrink_percentage = float(val)
        elif key == "Filter":
            parts = val.split()
            if len(parts) == 2 and parts != ["_", "_"]:
                cfg.filter = True
                cfg.filtered_clean_out = parts[0]
                cfg.filtered_contaminants_out = parts[1]
        # DeveloperOnly keys (Debug/Visualize/Spaced/SpacedMaskIdx) are
        # accepted no-ops, matching the CLI flags.
    if cfg.lower_k > cfg.higher_k:
        cfg.lower_k, cfg.higher_k = cfg.higher_k, cfg.lower_k
    return cfg


# the modes that may run the turbo mesh, on every rank of a
# multi-process run; rank 0 alone runs the others
MESH_MODES = ("identify", "identify_multiple")


def main(argv: list[str] | None = None) -> int:
    """Under torchrun (or parallel/launch.py) every rank runs this: it
    joins the process group first (parallel/dist.py init_distributed);
    ranks other than 0 print nothing to stdout and write no file."""
    argv = argv if argv is not None else sys.argv
    try:
        cfg = parse_args(argv)
        from .parallel import dist as pdist
        joined = not pdist.dist.is_initialized()
        multi = pdist.init_distributed(cfg.device)
        try:
            if cfg.mode not in MESH_MODES:
                pdist.writer_only()
            quiet = multi and not pdist.is_writer()
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null if quiet
                                               else sys.stdout):
                t0 = time.time()
                run_mode(cfg)
                print(f"OUT: Time: {time.time() - t0} s")
        except pdist.NotWriter:
            pass
        finally:
            if joined:
                pdist.shutdown()
        return 0
    except SystemExit as e:
        return int(e.code or 0)
    except Exception as e:  # reference prints ERROR: to stderr (main.cpp:1718)
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def run_mode(cfg: Config):
    mode = cfg.mode
    if mode == "generateCF":
        from .index.content import generate_content_file
        if not cfg.content_file:
            raise RuntimeError("Please specify an output file with -c")
        generate_content_file(cfg.input, cfg.content_file,
                              acc2tax_path=cfg.acc_to_tax_files,
                              taxonomy_path=cfg.taxonomy_path,
                              tax_level=cfg.tax_level or "species",
                              taxids_as_strings=cfg.taxids_as_strings,
                              verbose=cfg.verbose,
                              memory_bound=cfg.memory_avail // 2)
    elif mode == "build":
        from .index.build import build_index
        from .index.content import generate_content_file
        content = cfg.content_file
        if not content:
            content = cfg.db_out + "_content.txt"
            generate_content_file(cfg.input, content,
                                  acc2tax_path=cfg.acc_to_tax_files,
                                  taxonomy_path=cfg.taxonomy_path,
                                  tax_level=cfg.tax_level or "species",
                                  taxids_as_strings=cfg.taxids_as_strings,
                                  verbose=cfg.verbose,
                                  memory_bound=cfg.memory_avail // 2)
        highest_k = 25 if cfg.higher_k > 12 else 12
        encoder = None
        if cfg.codon_table:
            from .core.encode import Encoder, custom_code_lut
            encoder = Encoder(codon_code_lut=custom_code_lut(cfg),
                              sloppy=cfg.sloppy, device="cpu")
        build_index(cfg.input, content, cfg.db_out,
                    highest_k=highest_k,
                    six_frames=cfg.six_frames, one_frame=cfg.one_frame,
                    protein=cfg.translated, sloppy=cfg.sloppy,
                    shrink_percentage=cfg.shrink_percentage,
                    temp_dir=cfg.temp_path or None, verbose=cfg.verbose,
                    encoder=encoder, continue_build=cfg.continue_build,
                    call_idx=cfg.call_idx, threads=cfg.threads,
                    memory_bound=cfg.memory_avail,
                    turbo_sidecar=cfg.turbo_sidecar, device=cfg.device)
    elif mode == "identify":
        from .match.pipeline import identify
        identify(cfg, device=cfg.device)
    elif mode == "identify_multiple":
        from .match.pipeline import identify_multiple
        identify_multiple(cfg, device=cfg.device)
    elif mode == "update":
        from .index.update import update_index
        update_index(cfg)
    elif mode == "delete":
        from .index.update import delete_from_index
        delete_from_index(cfg)
    elif mode in ("shrink", "half"):
        from .index.shrink import shrink_index
        if mode == "half":
            cfg.shrink_strategy = 2
        shrink_index(cfg)
    elif mode == "merge":
        from .index.update import merge_indices
        merge_indices(cfg)
    elif mode == "getFrequency":
        from .index.aux_modes import get_frequency
        get_frequency(cfg)
    elif mode == "trie":
        from .index.aux_modes import rebuild_trie
        rebuild_trie(cfg)
    elif mode == "redundancy":
        from .index.aux_modes import redundancy
        redundancy(cfg)
    elif mode == "checkContentFile":
        from .index.aux_modes import check_content_file
        check_content_file(cfg)
    elif mode == "translate":
        from .index.aux_modes import translate_file
        translate_file(cfg)
    elif mode == "test":
        from .index.aux_modes import test_kmers
        test_kmers(cfg, cfg.input)
    elif mode == "howmuchtaxids":
        from .index.aux_modes import how_much_taxids
        how_much_taxids(cfg)
    elif mode == "showVec":
        from .index.aux_modes import show_vec
        show_vec(cfg)
    elif mode == "transform":
        from .index.aux_modes import transform_index
        transform_index(cfg)
    elif mode == "fuckit":
        from .index.aux_modes import fuckit_reencode
        fuckit_reencode(cfg)
    elif mode == "debug":
        # the reference's unit tests are disabled in its source
        # (main.cpp:1475-1486); ours live in tests/ -- point there.
        print("OUT: run `python -m pytest tests/` for the test suite.")
    else:
        raise RuntimeError(f"Unknown mode: {mode}. See --help.")
