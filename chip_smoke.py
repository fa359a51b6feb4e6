#!/usr/bin/env python3
"""On-card smoke run of kasa_tpu_torch: the port's identify and index
build on one NVIDIA GPU, through its fourteen CUDA kernels, checked
against references.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure ends the run with a non-zero exit; none is caught):

  prep     from the start, three host processes (python -m
           kasa_tpu_torch.synth <name> --tables [--tiered BYTES], CPU
           only) generate the three synthetic corpora of
           kasa_tpu_torch/synth.py into .synth_corpus/ and build their
           turbo-table sidecars, and for the default and 10,001-species
           corpora the tiered chunk caches of a 256 MiB device budget;
           the run waits for each before its first phase, before
           anything of it is timed;
  build    compile the CUDA kernels (one nvcc per source, in parallel)
           and the host C++ library;
  golden   identify fixtures/reads.fastq on tests/golden/exampleIndex on
           the card; agree with the reference outputs
           (tests/golden/reads_identify.json, reads_profile.csv) under
           the contract: same hit taxa, k-mer scores within rtol 2e-5 /
           atol 1e-4, identical unique counts; every kernel launched;
  golden-classic  the classic engine (K1, K9; K5 under -e) on the golden
           fixtures, each call on the card and then with device="cpu"
           (the plain versions, which the CPU tests hold to kasa_tpu),
           held together under the contract with every hit written:
           tests/golden/exampleIndex128 at -k 25 12 (14 levels: default,
           --six, --one, -e, fasta, gz, and paired reads through the
           per-batch engine), exampleIndex at -k 12 4 and under
           KASA_TPU_NO_TURBO, --coherence (also against
           tests/golden/reads_coh.json), -j (on exampleIndex and on its
           sloppy-reduced twin, which the reduced windows hit), reads
           above MAXLEN_CAP (per-batch engine) and an empty input (the
           format check refuses it, as in kasa_tpu); the classic runs
           launch no turbo or tiered kernel;
  golden-engines  the join and exact engines, --visualize and the
           over-budget routes on the golden fixtures, each launch count
           checked: --coverage on the default engine (the join engine: K1,
           K12, K10, K11 and nothing else), --engine exact (K1 only) and
           --engine join over the cases of tests/test_identify_parity.py,
           --visualize on fixtures/one_read.fastq, exampleIndex128 at k
           20..25 through the exact engine's walk and the join engine,
           the two over-budget inputs that keep resident turbo tables
           (KASA_DEVICE_BUDGET=1: exampleIndex128 k 20..25, exampleIndex
           k 5..10), and -j and paired input under KASA_TPU_NO_TURBO over
           a 1 MiB -m (oocore: K9 once per chunk per batch); byte for
           byte against the goldens where the engine gives them (the
           exact engine, the join engine's profiles, --visualize), else
           under the contract against the goldens, the port's CPU run or
           the run without a budget;
  golden-long  fixtures/multi under --six (b.fasta's read: 9,144 slots,
           K3's long arm) on the card, every output file byte-identical
           to the port's CPU run;
  build-golden  every golden index family of tests/test_modes_parity.py
           and tests/test_golden_parity.py through the port's CLI on the
           card, byte for byte: build (64-bit, --kH 25 through K13, -a,
           -j, -z), shrink -s 1/2/3, half, update and generateCF (over a
           taxonomy written from the golden content file), delete, merge;
           the spill and --continue builds at highestK 12 and 25 against
           the one-pass goldens;
  golden-flags  the same for --six, --one, -e, paired-end, -z (protIndex),
           a halved index, --filter (split files byte-identical) and
           identify_multiple on fixtures/multi, each with its kernels'
           launch counts reset before and checked after; and seeded
           protein reads that hit protIndex (synth.protein_reads), held
           against the port's own run on the CPU, with hits required;
  full     the 2047-species synthetic corpus (~32.7 M entries): tables,
           one 8,192-read warm-up run, then 65,536 reads (8 batches)
           through identify with the launch counts reset just before and
           read just after; reads/s, host stage times, host-recompute
           share, peak device memory; 512 sampled reads of a real batch
           held against the exact host recompute (host_classify_read);
  full-flags  the same 65,536 reads under --six -e (K5 on every batch;
           512 sampled reads against host_classify_read of the deduped
           windows), 32,768 read pairs of the corpus (both mates from one
           fragment, mate 2 reverse-complemented) with and without
           --six, and the 65,536 reads
           as 4 files of 16,384 through identify_multiple with profiles
           (summed per-file unique counts identical to the single-file
           run's, all-counts within rtol 2e-5 / atol 2e-3);
  long     8,192 long reads (1-8 kbp) of the default corpus: the first
           1,024, default and -e, and 8,192 pairs of 2 x 250 bp under
           --six through identify (K3's long arm on every batch, K5's
           shared-memory arm under -e), each with the launch counts reset
           just before and read just after; K3 pre's shared-memory and
           global long arms and K5's long arm against their plain
           versions on the batch of all 8,192, timed beside torch.sort
           (K5), and the stage split of that batch; the first 256 long
           reads, default and -e, against the port's CPU run;
  budgets  multi slots and flagged reads of a --six, a paired and a
           paired --six batch at kasa_tpu's fixed budgets and at twice
           them, beside the worklist the drive loop gives each;
  kernels  on real batches, each kernel against its plain PyTorch version
           on the card (same contract), with its time, the plain
           version's time, its memory bound and, where one PyTorch call
           computes the same function, that call's time as a yardstick
           the port never uses; the new arms (K1 one-frame and protein,
           the per-file counts of K3 and K4) against their plain
           versions too, and the whole batch step timed per mode; the
           stage split of the default batch (and of the sparse and long
           batches in their phases): K3 pre and post apart, K4's four
           launches apart (CUDA events between them), each row's share of
           sentinel slot keys;
  classic-vs-turbo  the default corpus at k 7..12 (after the full
           phases) and the 128-bit corpus at k 20..25 (after the wide
           phase) under KASA_TPU_NO_TURBO, the 65,536 smoke reads with
           every hit written, held to the turbo run of the same reads:
           hit taxa and unique counts identical, all-counts within rtol
           2e-5 / atol 2e-3; K9 on a real batch of the default run and
           K1's sloppy arm on a batch of the default reads against their
           plain versions, timed, with torch.searchsorted over the 60-bit
           keys as K9's yardstick;
  join     the 65,536 smoke reads of the default corpus through
           --engine join --coverage against their turbo run (every hit
           written; hit taxa and unique counts identical, all-counts
           within rtol 2e-5 / atol 2e-3, scores within the contract):
           reads/s, the join/* and identify/* host stages, the device's
           busy share; then K12 (as the path calls it, the batch's read
           ids ascending, and its read-id arm; each stage timed), K10
           and K11 on the run's first batch against their plain versions,
           timed, with torch.sort, torch.searchsorted and index_put_ as
           yardsticks;
  oocore   8,192 read pairs of the default corpus under KASA_TPU_NO_TURBO
           with a 700 MiB -m (6 index chunks, their cache built first)
           against the resident per-batch run (-r): chunks, batches, MB
           uploaded per batch, K9 per chunk on the first batch against its
           plain version, timed;
  mesh     the turbo mesh (parallel/) on the default corpus (the ranks
           of the first ip = 2 run build the shards' sidecars): the
           65,536 smoke reads through the CLI on two ranks that share the
           card over gloo (parallel/launch.py), at (dp, ip) = (1, 2) and
           (2, 1) and, unforced, under KASA_DEVICE_BUDGET = 0.6 x the
           tables (the mesh shards them over ip = 2), each with every hit
           written and held to the single-card run under the contract,
           each rank's launch counts from its own process (K4's split and
           K14 launched); on a real 8,192-read batch at (1, 2): K4's split
           against its plain version and against both shards' cut flags
           ORed by hand, the mesh step and its collectives timed, K14 on
           the gathered lists against its plain version, timed on rank 0
           alone; the classic meshes (broadcast and routed K9 on two
           shards) against the single K9 run; a world of one over NCCL
           (MeshTurboDispatch at (1, 1)) against the single-card run;
           with four cards, also the CLI on four ranks over NCCL, one card
           each, at (dp, ip) = (2, 2) and (1, 4), held to the single-card
           run (on one card this logs that it was skipped).  Rates of two
           ranks on one card are not multi-GPU rates;
  sparse   the 10,001-species corpus (~80 M entries, no hot tier: the
           sparse fold): tables, a warm-up, 65,536 reads through identify
           (K6 launched on every batch, beside K4's counts-only arm and
           K3's list arm) and as 4 files through identify_multiple with
           profiles (per-file counts against the single-file run's), peak
           device memory beside the resident tables, 512 sampled reads
           against host_classify_read; then K4's counts-only arm, K6 and
           K3's list arm against their plain versions on a real batch,
           timed, with K6's yardstick torch.sort of the lane keys;
  wide     the 128-bit corpus (the default genomes at highestK 25, ~32.6 M
           five-limb entries) at k 20..25: the 65,536 smoke reads,
           default and --six -e, with the same prints and sample checks;
           then the five-limb arms of K1, K2 and K5 against their plain
           versions on real batches, timed; the first 256 long reads
           under --six -e (~16,000 windows of five limbs a read: K5's
           global arm), and that arm against its plain version on
           synthetic batches above the shared-memory capacity, timed;
  build-wide  the default corpus's 2,047 genomes as a FASTA built at -k
           25 through the port's CLI (one K13 call over ~32.9 M entries);
           the first 512 genomes built with a soft limit of 2^21 entries
           (K13 per run, the host merge) and in one pass: byte-identical
           artifacts; the full build's entries inside the genomes equal
           the wide index; K13 on the consolidate input
           against its plain version, timed beside torch.unique(dim=0);
           the 64-bit build of the same genomes (no kernel), timed;
  join wide  the wide index at k 20..25: the 8,192 warm-up reads through
           the join engine against their turbo run, then K12, K10 and K11
           at L = 5 on its first batch;
  classic  the 128-bit corpus at -k 25 12 (all 14 levels) through the
           classic engine: tables (host build seconds), a warm-up, the
           65,536 smoke reads default and -e, and 32,768 read pairs
           through the per-batch engine; reads/s, host stages, peak
           device memory, the step per batch; K9 on a real batch of the
           fused path (uniform layout) against its plain version, timed;
           then the pairs run's batch as the per-batch engine builds it:
           K1 on its (1, n) line buffer and K9 in the scatter layout
           (S = 2,048 > 512), each against its plain version, timed;
  tiered   the beyond-resident path under KASA_DEVICE_BUDGET = 256 MiB
           (chunks of 8,388,608 entries): the default corpus's 65,536
           reads (2 batches of 32,768), default and --six -e, and the
           first 32,768 reads of the 10,001-species corpus (one batch),
           each through identify with every hit written, with the launch
           counts reset just before and read just after (K7, K8 and K3
           launched, K2 and K4 not); chunks, chunks kept on the device,
           bytes streamed per batch, the tiered/* host timers, reads/s,
           the host-ADD and host-rebuild shares and peak device memory;
           each held to the port's resident run on the same reads
           (unique counts identical, all-counts within rtol 2e-5 / atol
           2e-3, every read's taxa identical, scores within rtol 2e-4);
           then K7, K8 and K3's additive arm against their plain versions
           on a real batch of each run, timed, with torch.sort of the
           batch's 60-bit window keys (K7) and torch.searchsorted over
           each chunk's keys (K8) as yardsticks, K3's additive pre and
           post apart; K7's global arm on the first run's windows over
           20,000 synthetic chunk starts, against its plain version,
           timed.

Prints the card's name and power limit, a JSON line of the kernels and
their new arms, and last the line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --cards  # on a machine with four cards

runs only build, the default corpus, its single-card run and the mesh
over four cards (the cards entry of the mesh phase), and prints the
card line and the ok line.

    python3 chip_smoke.py --stages

runs only build and the stage splits of K3, K4 and K7 on the default
corpus (default, long and 32,768-read additive batches, synthetic chunk
plans of 4 to 20,000 chunks) and the sparse corpus, each held to its
plain version, into .synth_corpus/out/chip_smoke_stages.json.  Longer
logs and the full-size outputs go to .synth_corpus/out/.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, ".synth_corpus", "out")
RTOL, ATOL = 2e-5, 1e-4
HBM_BYTES_PER_S = 3.35e12       # H100 SXM peak device-memory rate
DEVICE = "cuda"


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def log(msg):
    """One line of the run's log, stamped with the seconds since the
    script started."""
    print(f"[{time.perf_counter() - T_START:7.1f}] {msg}", flush=True)


def smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the contract

def json_agrees(ref_json, got_json):
    import numpy as np
    if len(ref_json) != len(got_json):
        fail(f"{len(got_json)} reads written, reference {len(ref_json)}")
    for er, tr in zip(ref_json, got_json):
        for field in ("Read number", "Specifier from input file", "Length"):
            if er[field] != tr[field]:
                fail(f"read {er['Read number']}: {field} differs")
        eh = {h["tax ID"]: h for h in er["Top hits"] + er["Further hits"]}
        th = {h["tax ID"]: h for h in tr["Top hits"] + tr["Further hits"]}
        if set(eh) != set(th):
            fail(f"read {er['Read number']}: hit taxa differ")
        for tid, h in eh.items():
            np.testing.assert_allclose(float(th[tid]["k-mer Score"]),
                                       float(h["k-mer Score"]),
                                       rtol=RTOL, atol=ATOL)


def assert_identify_agrees(ref_json, got_json, ref_prof, got_prof, num_k):
    import numpy as np
    json_agrees(ref_json, got_json)
    el, tl = ref_prof.splitlines(), got_prof.splitlines()
    if len(el) != len(tl) or el[0] != tl[0]:
        fail("profile rows differ")
    for e, t in zip(el[1:], tl[1:]):
        ec, tc = e.split(","), t.split(",")
        if ec[:2 + num_k] != tc[:2 + num_k]:
            fail(f"profile unique counts differ: {ec[:2 + num_k]} vs "
                 f"{tc[:2 + num_k]}")
        np.testing.assert_allclose(np.array(tc[2 + num_k:], float),
                                   np.array(ec[2 + num_k:], float),
                                   rtol=RTOL, atol=ATOL)


def same(name, a, b):
    import torch
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or not torch.equal(a, b):
        bad = int((a != b).sum()) if a.shape == b.shape else -1
        fail(f"{name}: kernel and plain version differ ({bad} elements)")
    return 0.0


def close(name, a, b):
    import torch
    a, b = a.cpu().double(), b.cpu().double()
    if a.shape != b.shape:
        fail(f"{name}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
        fail(f"{name}: kernel and plain version disagree, max abs "
             f"{float((a - b).abs().max())}")
    return float((a - b).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phases

def phase_build():
    from kasa_tpu_torch import kernels, native
    t0 = time.perf_counter()
    host = threading.Thread(target=native.get_lib)
    host.start()
    reports = kernels.build_all(force=True)
    host.join()
    if native.get_lib() is None:
        fail("the host C++ library did not build")
    with open(os.path.join(OUT, "ptxas.txt"), "w") as fh:
        for name, rep in reports.items():
            fh.write(f"--- {name}.cu\n{rep}\n")
    used = [ln.split("info    :")[-1].strip()
            for rep in reports.values() for ln in rep.splitlines()
            if "Used" in ln]
    log(f"build: {len(reports)} CUDA sources + host library in "
        f"{time.perf_counter() - t0:.2f} s; ptxas: {'; '.join(used)}")


def phase_golden():
    import torch
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    gold = os.path.join(HERE, "tests", "golden")
    cfg = Config()
    cfg.content_file = os.path.join(gold, "exampleIndex_content.txt")
    out_j = os.path.join(OUT, "golden.json")
    out_p = os.path.join(OUT, "golden_profile.csv")
    kernels.reset_counts()
    identify(cfg, index_path=os.path.join(gold, "exampleIndex"),
             input_path=os.path.join(HERE, "fixtures", "reads.fastq"),
             out_file=out_j, profile_file=out_p, device=DEVICE)
    torch.cuda.synchronize()
    counts = dict(kernels.COUNTS)
    expect_launched("golden", counts, PATH_KERNELS)
    assert_identify_agrees(
        json.load(open(os.path.join(gold, "reads_identify.json"))),
        json.load(open(out_j)),
        open(os.path.join(gold, "reads_profile.csv")).read(),
        open(out_p).read(), 6)
    log(f"golden: agrees with tests/golden/reads_identify.json and "
        f"reads_profile.csv under the contract; launches {counts}")


PATH_KERNELS = ("encode", "turbo_match", "turbo_reads", "turbo_multi")

# tag, index, input, Config overrides, golden per-read output, golden
# profile (fixtures/ and tests/golden/ paths)
GOLDEN_FLAGS = (
    ("six", "exampleIndex", "reads.fastq", {"six_frames": True},
     "reads_six.json", "reads_six_profile.csv"),
    ("one", "exampleIndex", "reads.fastq", {"one_frame": True},
     "reads_one.json", "reads_one_profile.csv"),
    ("unique", "exampleIndex", "reads.fastq", {"unique": True},
     "reads_unique.json", "reads_unique_profile.csv"),
    ("paired", "exampleIndex", "", {"paired_end_1": "reads_1.fastq",
                                    "paired_end_2": "reads_2.fastq"},
     "reads_paired.json", "reads_paired_profile.csv"),
    ("protein", "protIndex", "protein_reads.fasta", {"translated": True},
     "prot_reads.json", "prot_reads_profile.csv"),
    ("halved", "exampleIndex_s", "reads.fastq", {},
     "reads_half.json", "reads_half_profile.csv"),
)


def expect_launched(tag, counts, names):
    missed = [n for n in names if counts[n] <= 0]
    if missed:
        fail(f"{tag}: the run launched no {missed}: {counts}")


def phase_golden_flags():
    """The flag variants on the golden fixtures, each against the
    reference binary's outputs under the contract."""
    import filecmp
    import torch
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify, identify_multiple
    gold = os.path.join(HERE, "tests", "golden")
    fix = os.path.join(HERE, "fixtures")
    launched = {}
    for tag, index, inp, over, gj, gp in GOLDEN_FLAGS:
        cfg = Config()
        cfg.content_file = os.path.join(
            gold, ("protIndex" if index == "protIndex" else "exampleIndex")
            + "_content.txt")
        for k, v in over.items():
            setattr(cfg, k, os.path.join(fix, v) if isinstance(v, str)
                    else v)
        out_j = os.path.join(OUT, f"golden_{tag}.json")
        out_p = os.path.join(OUT, f"golden_{tag}.csv")
        kernels.reset_counts()
        identify(cfg, index_path=os.path.join(gold, index),
                 input_path=os.path.join(fix, inp) if inp else "",
                 out_file=out_j, profile_file=out_p, device=DEVICE)
        torch.cuda.synchronize()
        counts = dict(kernels.COUNTS)
        expect_launched(tag, counts, PATH_KERNELS
                        + (("dedup",) if over.get("unique") else ()))
        assert_identify_agrees(json.load(open(os.path.join(gold, gj))),
                               json.load(open(out_j)),
                               open(os.path.join(gold, gp)).read(),
                               open(out_p).read(), 6)
        launched[tag] = counts

    # --filter: split files byte-identical to the reference's
    cfg = Config()
    cfg.content_file = os.path.join(gold, "exampleIndex_content.txt")
    cfg.filter = True
    cfg.filtered_clean_out = os.path.join(OUT, "filt_clean")
    cfg.filtered_contaminants_out = os.path.join(OUT, "filt_cont")
    kernels.reset_counts()
    identify(cfg, index_path=os.path.join(gold, "exampleIndex"),
             input_path=os.path.join(fix, "reads.fastq"),
             out_file=os.path.join(OUT, "golden_filter.json"), device=DEVICE)
    torch.cuda.synchronize()
    launched["filter"] = dict(kernels.COUNTS)
    expect_launched("filter", launched["filter"], PATH_KERNELS)
    json_agrees(json.load(open(os.path.join(gold, "reads_filt.json"))),
                json.load(open(os.path.join(OUT, "golden_filter.json"))))
    for f in ("filt_clean.fastq", "filt_cont.fastq"):
        if not filecmp.cmp(os.path.join(OUT, f), os.path.join(gold, f),
                           shallow=False):
            fail(f"filter: {f} differs from tests/golden/{f}")

    # identify_multiple: per-file outputs and profiles
    cfg = Config()
    cfg.content_file = os.path.join(gold, "exampleIndex_content.txt")
    cfg.index_file = os.path.join(gold, "exampleIndex")
    cfg.input = os.path.join(fix, "multi")
    cfg.read_to_taxa_file = os.path.join(OUT, "multi_q_")
    cfg.table_file = os.path.join(OUT, "multi_p_")
    kernels.reset_counts()
    identify_multiple(cfg, device=DEVICE)
    torch.cuda.synchronize()
    launched["multi"] = dict(kernels.COUNTS)
    expect_launched("multi", launched["multi"], PATH_KERNELS)
    for n in ("a", "b"):
        assert_identify_agrees(
            json.load(open(os.path.join(gold, f"multi_q_{n}.json"))),
            json.load(open(os.path.join(OUT, f"multi_q_{n}.json"))),
            open(os.path.join(gold, f"multi_p_{n}.csv")).read(),
            open(os.path.join(OUT, f"multi_p_{n}.csv")).read(), 6)
    log("golden-flags: six, one, unique, paired, protein, halved, filter "
        "and multi agree with tests/golden under the contract (filter "
        "split files byte-identical); launches "
        + json.dumps({t: {k: v for k, v in c.items() if v}
                      for t, c in launched.items()}))

    # tests/golden's protein reads hit nothing: seeded protein reads that
    # hit protIndex, the card's run against the port's CPU run
    from kasa_tpu_torch import synth
    prot = synth.protein_reads(os.path.join(fix, "protein.fasta"),
                               os.path.join(OUT, "protein_hits.fasta"))
    outs = {}
    for dev in (DEVICE, "cpu"):
        cfg = Config()
        cfg.content_file = os.path.join(gold, "protIndex_content.txt")
        cfg.translated = True
        outs[dev] = (os.path.join(OUT, f"protein_hits_{dev}.json"),
                     os.path.join(OUT, f"protein_hits_{dev}.csv"))
        kernels.reset_counts()
        identify(cfg, index_path=os.path.join(gold, "protIndex"),
                 input_path=prot, out_file=outs[dev][0],
                 profile_file=outs[dev][1], device=dev)
        if dev == DEVICE:
            torch.cuda.synchronize()
            counts = dict(kernels.COUNTS)
            expect_launched("protein hits", counts, PATH_KERNELS)
    got = json.load(open(outs[DEVICE][0]))
    assert_identify_agrees(json.load(open(outs["cpu"][0])), got,
                           open(outs["cpu"][1]).read(),
                           open(outs[DEVICE][1]).read(), 6)
    hits = sum(len(r["Top hits"]) + len(r["Further hits"]) for r in got)
    if hits == 0:
        fail("protein hits: the seeded protein reads matched nothing")
    log(f"golden-flags protein hits: {len(got)} seeded protein reads, "
        f"{hits} hits, agree with the port's CPU run under the contract; "
        f"launches {counts}")


# ---------------------------------------------------------------------------
# the classic engine (K9), where the turbo structure declines

CLASSIC_KERNELS = ("encode", "classic_classify")
TURBO_ONLY = ("turbo_match", "turbo_reads", "turbo_multi", "sparse_fold",
              "tiered_route", "tiered_route.global", "tiered_pass")
K128 = {"lower_k": 12, "higher_k": 25}


def expect_classic(tag, counts, extra=()):
    """The run launched K1 and K9 (and `extra`), and no turbo or tiered
    kernel."""
    expect_launched(tag, counts, CLASSIC_KERNELS + tuple(extra))
    bad = {k: counts[k] for k in TURBO_ONLY if counts[k]}
    if bad:
        fail(f"{tag}: a classic run launched turbo kernels {bad}")


def reduced_index(directory):
    """tests/golden/exampleIndex with its k-mers folded by the sloppy
    reduction (deduplicated, beside the golden frequency and content
    files): the index -j reads hit."""
    import shutil
    import numpy as np
    import torch
    from kasa_tpu_torch.core.encode import aas_code_lut, sloppy_reduce_plain
    from kasa_tpu_torch.index import artifacts as A
    gold = os.path.join(HERE, "tests", "golden")
    limbs, taxids, _, _ = A.read_index(os.path.join(gold, "exampleIndex"))
    red = sloppy_reduce_plain(torch.from_numpy(limbs),
                              torch.from_numpy(aas_code_lut())).numpy()
    order = np.lexsort((taxids, red[:, 1], red[:, 0]))
    red, taxids = red[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(red[1:] != red[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    out = os.path.join(directory, "reducedIndex")
    A.write_index(out, red[keep], taxids[keep], 12)
    A.write_trie(out, *A.trie_from_sorted_prefixes(red[keep][:, 0]))
    shutil.copy(os.path.join(gold, "exampleIndex_f.txt"), out + "_f.txt")
    return out


def giant_reads(path):
    """fixtures/example.fasta's genomes joined into two reads above
    MAXLEN_CAP (70-character lines) and one short read."""
    from kasa_tpu_torch.host.fastx import iter_records
    seqs = [r.seq for r in iter_records(os.path.join(HERE, "fixtures",
                                                     "example.fasta"))]
    reads = ["".join(seqs[:4]), "".join(seqs[4:]), seqs[0][:150]]
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">g{i}\n" + "".join(r[j:j + 70] + "\n"
                                         for j in range(0, len(r), 70)))
    return path


def phase_golden_classic():
    """Every route to the classic engine on the golden fixtures: the
    card's run against the port's CPU run (every hit written), the
    --coherence run also against the reference binary's output.
    -> launches of the -j run (the sloppy arm's main-path run)."""
    import torch
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import identify
    gold = os.path.join(HERE, "tests", "golden")
    fix = os.path.join(HERE, "fixtures")
    rq = os.path.join(fix, "reads.fastq")
    paired = {"paired_end_1": os.path.join(fix, "reads_1.fastq"),
              "paired_end_2": os.path.join(fix, "reads_2.fastq")}
    red = reduced_index(OUT)
    cases = (
        ("128 k25-12", "exampleIndex128", rq, K128, (), None),
        ("128 --six", "exampleIndex128", rq, dict(K128, six_frames=True),
         (), None),
        ("128 --one", "exampleIndex128", rq, dict(K128, one_frame=True),
         (), None),
        ("128 -e", "exampleIndex128", rq, dict(K128, unique=True),
         ("dedup",), None),
        ("128 fasta", "exampleIndex128", os.path.join(fix, "reads.fasta"),
         K128, (), None),
        ("128 gz", "exampleIndex128", os.path.join(fix, "reads.fastq.gz"),
         K128, (), None),
        ("128 paired", "exampleIndex128", "", dict(K128, **paired), (),
         None),
        ("k12-4", "exampleIndex", rq, {"lower_k": 4}, (), None),
        ("no-turbo", "exampleIndex", rq, {}, (), "KASA_TPU_NO_TURBO"),
        ("no-turbo -e", "exampleIndex", rq, {"unique": True}, ("dedup",),
         "KASA_TPU_NO_TURBO"),
        ("coherence", "exampleIndex", rq, {"post_process": True}, (), None),
        ("-j", "exampleIndex", rq, {"sloppy": True}, (), None),
        ("-j reduced", red, rq, {"sloppy": True}, (), None),
        ("giant reads", "exampleIndex",
         giant_reads(os.path.join(OUT, "giant.fasta")), {}, (), None),
    )
    launched = {}
    for tag, index, inp, over, extra, env in cases:
        outs = {}
        for dev in (DEVICE, "cpu"):
            cfg = Config()
            cfg.content_file = os.path.join(gold, "exampleIndex_content.txt")
            cfg.num_of_beasts = ALL_HITS
            for k, v in over.items():
                setattr(cfg, k, v)
            stem = os.path.join(OUT, "gc_" + tag.replace(" ", "_")
                                .replace("-", "") + f"_{dev}")
            if env:
                os.environ[env] = "1"
            kernels.reset_counts()
            try:
                identify(cfg, index_path=os.path.join(gold, index),
                         input_path=inp, out_file=stem + ".json",
                         profile_file=stem + ".csv", device=dev)
            finally:
                os.environ.pop(env or "", None)
            if dev == DEVICE:
                torch.cuda.synchronize()
                launched[tag] = dict(kernels.COUNTS)
                expect_classic(tag, launched[tag], extra)
            outs[dev] = (json.load(open(stem + ".json")),
                         open(stem + ".csv").read())
        num_k = over.get("higher_k", 12) - over.get("lower_k", 7) + 1
        assert_identify_agrees(outs["cpu"][0], outs[DEVICE][0],
                               outs["cpu"][1], outs[DEVICE][1], num_k)
        hits = sum(1 for r in outs[DEVICE][0] if r["Top hits"])
        if (hits == 0) != (tag == "-j"):
            fail(f"golden-classic {tag}: {hits} reads with hits")
    # --coherence against the reference binary (its three hits per read)
    cfg = Config()
    cfg.content_file = os.path.join(gold, "exampleIndex_content.txt")
    cfg.post_process = True
    out_j = os.path.join(OUT, "gc_coherence_golden.json")
    out_p = os.path.join(OUT, "gc_coherence_golden.csv")
    identify(cfg, index_path=os.path.join(gold, "exampleIndex"),
             input_path=rq, out_file=out_j, profile_file=out_p,
             device=DEVICE)
    ref = json.load(open(os.path.join(gold, "reads_coh.json")))
    got = json.load(open(out_j))
    assert_identify_agrees(ref, got,
                           open(os.path.join(gold,
                                             "reads_coh_profile.csv")).read(),
                           open(out_p).read(), 6)
    for a, b in zip(ref, got):
        if [h.get("Coherence") for h in a["Top hits"]] != \
                [h.get("Coherence") for h in b["Top hits"]]:
            fail(f"coherence: read {a['Read number']}: coherence differs "
                 "from tests/golden/reads_coh.json")
    # an empty input: refused by the format check in both packages
    empty = os.path.join(OUT, "empty.fastq")
    open(empty, "w").close()
    try:
        identify(Config(), index_path=os.path.join(gold, "exampleIndex"),
                 input_path=empty, out_file=os.path.join(OUT, "e.json"),
                 device=DEVICE)
        fail("an empty input was not refused")
    except ValueError as e:
        if "does not start with" not in str(e):
            raise
    log("golden-classic: " + ", ".join(launched) + " agree with the port's "
        "CPU runs under the contract (every hit written); --coherence "
        "agrees with tests/golden/reads_coh.json; an empty input is "
        "refused by the format check; launches "
        + json.dumps({t: {k: v for k, v in c.items() if v}
                      for t, c in launched.items()}))
    return launched["-j reduced"]


def span_sectors(start, width):
    """The 32-byte sector ids that reads of `width` bytes (at most 32; an
    int or a tensor) at byte offsets `start` touch."""
    a = start.long().reshape(-1)
    return __import__("torch").cat([a // 32, (a + width - 1) // 32])


def search_sectors(t, qa):
    """The full-key lower bound of the queries qa (common.cuh
    lower_bound_full, as K9 and K10 take it) and what its reads touch ->
    (pos, the distinct 32-byte index sectors: limb 0 at each limb-0 bisect
    midpoint and at the run start, limbs 1.. up to the first differing
    limb at each run-bisect midpoint, the full rows at pos and pos - 1;
    the prefix buckets b; the runs whose run_end it reads)."""
    import torch
    n, L = t.n, qa.shape[1]
    row_b = 4 * L
    b = (qa[:, 0] >> 10).long()
    lo, hi = t.prefix_tbl[b].long(), t.prefix_tbl[b + 1].long()
    idx_sec = []

    def touch(sectors):
        # keep the distinct sectors only: a batch of ~10 M windows reads
        # billions of bytes of midpoints
        idx_sec.append(sectors)
        if len(idx_sec) > 4:
            idx_sec[:] = [torch.unique(torch.cat(idx_sec))]
    while bool((lo < hi).any()):
        o = lo < hi
        mid = (lo + hi) >> 1
        touch(span_sectors(mid[o] * row_b, 4))
        less = t.idx_limbs[mid.clamp(max=n - 1), 0] < qa[:, 0]
        lo = torch.where(o & less, mid + 1, lo)
        hi = torch.where(o & ~less, mid, hi)
    touch(span_sectors(lo[lo < n] * row_b, 4))
    present = (lo < n) & (t.idx_limbs[lo.clamp(max=n - 1), 0] == qa[:, 0])
    runs = lo[present]
    hi = torch.where(present, t.run_end[lo.clamp(max=n - 1)].long(), lo)
    while bool((lo < hi).any()):
        o = lo < hi
        mid = (lo + hi) >> 1
        row = t.idx_limbs[mid.clamp(max=n - 1)]
        less = torch.zeros_like(o)
        dec = torch.zeros_like(o)
        width = torch.zeros_like(mid)
        for i in range(1, L):
            width += (~dec).long() * 4
            less |= ~dec & (row[:, i] < qa[:, i])
            dec |= row[:, i] != qa[:, i]
        touch(span_sectors(mid[o] * row_b + 4, width[o]))
        lo = torch.where(o & less, mid + 1, lo)
        hi = torch.where(o & ~less, mid, hi)
    pos = lo
    touch(span_sectors(pos[pos < n] * row_b, row_b))
    touch(span_sectors((pos - 1)[pos > 0] * row_b, row_b))
    return pos, torch.unique(torch.cat(idx_sec)), b, runs


def classic_bytes(t, q, read_ids, valid, R):
    """Least bytes K9 moves on this batch: the flags once, the valid
    windows, the read ids of the windows it classifies (scatter layout),
    the prefix entries, the distinct sectors of the index that its
    search reads (search_sectors) and of run_end, the grp_id, grp_start
    and d_tax cells of the matched groups, the masks and weights, and
    the outputs once (the (R, S) score rows, the two count tables).
    -> (bytes, the (window, level, taxon) adds: the sum of T over the
    matched (window, level) pairs)."""
    import torch
    from kasa_tpu_torch.match.device import _valid_levels
    n, L, nk, S = t.n, q.shape[1], t.num_k, t.num_species
    dev = q.device
    vi = torch.nonzero(valid)[:, 0]
    kv_all = _valid_levels(q[vi], t.min_k, t.max_k)
    act = kv_all >= t.min_k
    ai, qa, kv = vi[act], q[vi][act], kv_all[act]
    row_b = 4 * L
    pos, idx_sec, b, runs = search_sectors(t, qa)
    at = t.idx_limbs[pos.clamp(max=n - 1)]
    pr = t.idx_limbs[(pos - 1).clamp(min=0)]
    gid, gst, dtx = [], [], []
    adds = 0
    for ki in range(nk):
        m = t.masks[ki]
        qm = qa & m
        e_at = (pos < n) & ((at & m) == qm).all(1)
        e_pr = (pos > 0) & ((pr & m) == qm).all(1)
        ok = (e_at | e_pr) & (kv >= t.max_k - ki)
        e = torch.where(e_at, pos, pos - 1)[ok]
        g = t.grp_id[ki][e].long()
        ts = t.grp_start[ki][g].long()
        T = t.grp_start[ki][g + 1].long() - ts
        adds += int(T.sum())
        gid.append(torch.unique(ki * n + e))
        gst.append(torch.unique(ki * t.grp_start.shape[1]
                                + torch.cat([g, g + 1])))
        rep = torch.repeat_interleave(torch.arange(len(T), device=dev), T)
        j = torch.arange(len(rep), device=dev) - (torch.cumsum(T, 0) - T)[rep]
        dtx.append(torch.unique(ki * t.d_tax.shape[1] + ts[rep] + j))
    cat = torch.cat
    return (q.shape[0] + sector_bytes(vi, row_b)
            + (sector_bytes(ai, 4) if read_ids is not None else 0)
            + sector_bytes(cat([b, b + 1]), 4)
            + 32 * int(idx_sec.numel())
            + sector_bytes(runs, 4) + sector_bytes(cat(gid), 4)
            + sector_bytes(cat(gst), 4) + sector_bytes(cat(dtx), 4)
            + nk * (L + 1) * 4 + R * S * 4 + 2 * nk * S * 4 + 4), adds


K9_ARMS = ("classic_classify", "classic_classify.global")


def k9_launches(tag, counts):
    """K9's launches on a path of this script, every one on its local
    arm: each path hands K9 the uniform layout or read ids that ascend
    (the global arm takes the others, and rows above the card's shared
    memory; phase_kernels_per_batch holds it to its plain version)."""
    if counts["classic_classify.global"]:
        fail(f"{tag}: K9's global arm ran {counts['classic_classify.global']}"
             " times on a path whose read ids ascend")
    return counts["classic_classify"]


def k9_against_plain(tables, q, read_ids, valid, R, kpr, suffix, what,
                     arm="classic_classify"):
    """K9 on one batch against its plain version (hit cells, unique
    counts and tail_pairs identical, floats within the contract), then
    both timed; fails unless the batch took the arm `arm` (its counter).
    -> (max abs err, ms, plain ms, bytes of its bound)."""
    import torch
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.match import device as D
    from kasa_tpu_torch.match.engine import CAP

    def k9():
        return D.classify_batch(tables, q, read_ids, valid, R, CAP, kpr)

    def plain():
        return D.classify_batch_plain(tables, q, read_ids, valid, R, CAP,
                                      kpr)
    before = {a: kernels.COUNTS[a] for a in K9_ARMS}
    got, want = k9(), plain()
    took = [a for a in K9_ARMS if kernels.COUNTS[a] > before[a]]
    if took != [arm]:
        fail(f"{arm}{suffix}: the batch took K9's arm {took}")
    same(f"classic_classify{suffix}.hit_cells", got[0] > 0, want[0] > 0)
    same(f"classic_classify{suffix}.counts_unique", got[2], want[2])
    if int(got[3]) != want[3]:
        fail(f"classic_classify{suffix}: tail_pairs {int(got[3])} vs "
             f"{want[3]}")
    err = max(close(f"classic_classify{suffix}.scores", got[0], want[0]),
              close(f"classic_classify{suffix}.counts_all", got[1], want[1]))
    torch.cuda.synchronize()
    nbytes, adds = classic_bytes(tables, q, read_ids, valid, R)
    ms = time_ms(k9, 10)
    log(f"kernels classic: classic_classify{suffix} agrees with its plain "
        f"version on a {R}-read batch of the {what} (M={q.shape[0]:,} "
        f"windows, {int(valid.sum()):,} valid, L={q.shape[1]}, "
        f"{tables.num_k} levels, n={tables.n:,}, S={tables.num_species}, "
        f"hit cells {int((want[0] > 0).sum()):,}, tail_pairs {want[3]:,}); "
        f"arm {arm}, (window, level, taxon) adds {adds:,}, "
        f"{1e6 * ms / q.shape[0]:.4f} ns a window")
    return err, ms, time_ms(plain, 3), nbytes


def phase_kernels_classic(tables, mat, R, w, launches, tag, suffix,
                          sloppy_launches=None):
    """K9 on a real batch (the windows K1 gives it in the fused path)
    against its plain version, timed, with its bound; at L = 2 the
    yardstick torch.searchsorted over the packed 60-bit keys.  With
    sloppy_launches, K1's sloppy arm on the same batch too.  -> (kernel
    entries, step ms of fused_classify)."""
    import numpy as np
    import torch
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match.fast import fused_classify
    dev = torch.device(DEVICE)
    hk = tables.highest_k
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    mat_d = torch.from_numpy(mat).to(dev)
    q = E.encode_windows(mat_d, lut, w, highest_k=hk)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    err, ms, plain_ms, nbytes = k9_against_plain(
        tables, q, None, valid, R, w, suffix, f"{tag} run (uniform layout)")
    lib_ms = None
    if q.shape[1] == 2:
        keys64 = (tables.idx_limbs[:, 0].long() << 30) \
            | tables.idx_limbs[:, 1].long()
        q64 = (q[:, 0].long() << 30) | q[:, 1].long()
        lib_ms = time_ms(lambda: torch.searchsorted(keys64, q64), 20)
    step_ms = time_ms(lambda: fused_classify(tables, mat_d, lut, R, w), 10)
    log(f"step: fused_classify {step_ms:.4f} ms per {R}-read batch of the "
        f"{tag} run (K1, K9, the zeroed score rows)")
    out = [kernel_entry(
        f"classic_classify{suffix}", "kasa_tpu_torch/csrc/classic_classify.cu",
        "kasa_tpu/match/device.py:156",
        k9_launches(f"classic_classify{suffix}", launches), err, ms,
        plain_ms, nbytes, lib_ms, "torch.searchsorted over the 60-bit keys")]
    if sloppy_launches is not None:
        aas = torch.from_numpy(E.aas_code_lut()).to(dev)
        qs = E.encode_windows(mat_d, lut, w, aas_lut=aas)
        same("encode.sloppy", qs, E.sloppy_reduce_plain(
            E.encode_windows_plain(mat_d, lut, w), aas))
        ms_s = time_ms(lambda: E.encode_windows(mat_d, lut, w, aas_lut=aas),
                       20)
        plain_s = time_ms(lambda: E.sloppy_reduce_plain(
            E.encode_windows_plain(mat_d, lut, w), aas), 5)
        out.append(kernel_entry(
            "encode.sloppy", "kasa_tpu_torch/csrc/encode.cu",
            "kasa_tpu/core/encode.py:103", sloppy_launches["encode"], 0.0,
            ms_s, plain_s, R * mat.shape[1] + 4 * 1024 + qs.numel() * 4,
            None))
    return out, step_ms


def phase_kernels_per_batch(tables, pairs, launches):
    """The per-batch engine's first batch of the classic pairs run, built
    as _identify_per_batch builds it: K1 on the (1, n) line buffer
    against its plain version, then K9 in the layout TpuEngine gives the
    batch (the scatter layout: S > DENSE_MAX_S) against its plain
    version, each timed; then K9's global arm on the same windows in key
    order (as -e's dedup hands them), held to its plain version and
    timed, off every path this script drives.  -> kernel entries."""
    import numpy as np
    import torch
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.match import engine as EN
    from kasa_tpu_torch.match import ingest
    from kasa_tpu_torch.match.pipeline import encode_batch
    cfg = Config()
    for k, v in K128.items():
        setattr(cfg, k, v)
    hk = tables.highest_k
    builder = ingest.BatchBuilder(hk, cfg.lower_k, protein=False,
                                  six_frames=cfg.six_frames,
                                  one_frame=cfg.one_frame)
    batch = next(iter(ingest.read_paired_batches(
        pairs[0], pairs[1], builder,
        max_kmers_per_batch=max(int(cfg.memory_avail) // 64, 1 << 16))))
    encoder = E.Encoder(codon_code_lut=E.custom_code_lut(cfg),
                        device=DEVICE)
    # K1 on the flat buffer
    buf = np.ascontiguousarray(np.concatenate(batch.buffers), np.uint8)
    row = torch.from_numpy(buf.reshape(1, -1)).to(DEVICE)
    w = len(buf) - 3 * hk + 1
    q1 = E.encode_windows(row, encoder.lut, w, highest_k=hk)
    err1 = same("encode.flat", q1,
                E.encode_windows_plain(row, encoder.lut, w, highest_k=hk))
    ms1 = time_ms(lambda: E.encode_windows(row, encoder.lut, w,
                                           highest_k=hk), 10)
    plain1 = time_ms(lambda: E.encode_windows_plain(row, encoder.lut, w,
                                                    highest_k=hk), 3)
    log(f"kernels per-batch: encode agrees with its plain version on the "
        f"(1, {len(buf):,}) line buffer of the pairs run's batch "
        f"({w:,} windows, L={q1.shape[1]})")
    # K9 in the engine's layout
    R = batch.num_reads
    q_limbs, read_ids = encode_batch(batch, encoder, hk, False,
                                     cfg.one_frame)
    q, r, v, kpr = EN.layout(q_limbs, read_ids, R, tables.num_species)
    if r is None:
        fail("per-batch: the pairs batch took the uniform layout, "
             "expected the scatter layout")
    order = np.lexsort(q.T[::-1])
    qd, rd, vd = (torch.from_numpy(a).to(DEVICE) for a in (q, r, v))
    err9, ms9, plain9, bytes9 = k9_against_plain(
        tables, qd, rd, vd, R, kpr, ".scatter",
        "classic pairs run (per-batch engine, scatter layout)")
    qd, rd, vd = (torch.from_numpy(np.ascontiguousarray(a[order])).to(DEVICE)
                  for a in (q, r, v))
    errg, msg, plaing, _ = k9_against_plain(
        tables, qd, rd, vd, R, kpr, ".scatter",
        "classic pairs run, its windows in key order", "classic_classify.global")
    log(f"kernels classic: classic_classify.global (the global arm, on no "
        f"path of this script) on the pairs batch in key order: {msg:.4f} ms "
        f"(plain version {plaing:.4f} ms, max abs err {errg}) against the "
        f"local arm's {ms9:.4f} ms on the batch in read order")
    del qd, rd, vd
    return [kernel_entry(
        "encode.flat", "kasa_tpu_torch/csrc/encode.cu",
        "kasa_tpu/core/encode.py:70", launches["encode"], err1, ms1, plain1,
        len(buf) + q1.numel() * 4, None),
        kernel_entry(
        "classic_classify.scatter", "kasa_tpu_torch/csrc/classic_classify.cu",
        "kasa_tpu/match/device.py:156",
        k9_launches("classic_classify.scatter", launches), err9, ms9,
        plain9, bytes9, None)]


def classic_vs_turbo(tag, index, reads, over, n_reads):
    """The turbo run and the KASA_TPU_NO_TURBO classic run of the same
    reads, every hit written: hit taxa and unique counts identical,
    all-counts within rtol 2e-5 / atol 2e-3.  -> (classic launches, info,
    classic tables)."""
    from kasa_tpu_torch.match import fast
    corpus = {"index": index}
    over = dict(over, num_of_beasts=ALL_HITS)
    stem = tag.replace(" ", "_").replace("-", "")
    outs = {}
    for kind in ("turbo", "classic"):
        if kind == "classic":
            os.environ["KASA_TPU_NO_TURBO"] = "1"
        try:
            j = os.path.join(OUT, f"{stem}_{kind}.json")
            res, launches, info = drive(
                f"{tag} ({kind})", reads, j, None,
                PATH_KERNELS if kind == "turbo" else CLASSIC_KERNELS,
                over=over, corpus=corpus)
        finally:
            os.environ.pop("KASA_TPU_NO_TURBO", None)
        with open(j) as fh:
            outs[kind] = (res, json.load(fh))
        os.remove(j)
    expect_classic(tag, launches)
    if res[2] != n_reads:
        fail(f"{tag}: {res[2]} reads identified, expected {n_reads}")
    tiered_agree(f"{tag} classic", outs["turbo"], outs["classic"], RTOL,
                 ATOL)
    return launches, info, fast.LAST_DISPATCH


def phase_classic(corpus):
    """The 128-bit corpus at -k 25 12, all 14 levels, through the classic
    engine: the smoke reads default and -e (fused path), 32,768 pairs
    (per-batch engine).  -> (launches, infos, tables)."""
    import numpy as np
    import torch
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify
    from kasa_tpu_torch.utils import timers
    wide = synth.generate_wide(log=log)
    timers.reset()
    t0 = time.perf_counter()
    cfg = Config()
    for k, v in K128.items():
        setattr(cfg, k, v)
    identify(cfg, index_path=wide["index"], input_path=corpus["warm"],
             out_file=os.path.join(OUT, "classic_warm.json"),
             profile_file=None, device=DEVICE)
    torch.cuda.synchronize()
    tables = fast.LAST_DISPATCH
    tstages = {k: round(v, 3) for k, v in timers.report(lambda *_: None)
               .items() if k.startswith("classic/")}
    tbytes = sum(getattr(tables, f).numel() * 4 for f in
                 ("idx_limbs", "grp_id", "grp_start", "d_tax", "run_end",
                  "prefix_tbl"))
    log(f"classic: tables (n={tables.n:,}, L={tables.idx_limbs.shape[1]}, "
        f"{tables.num_k} levels, {tbytes / 2**30:.3f} GiB on the device) + "
        f"{synth.WARM_READS}-read warm-up run {time.perf_counter() - t0:.1f}"
        f" s; table stages {tstages}")
    infos, launches = {}, {}
    for tag, extra, expect, inp in (
            ("classic", {}, (), corpus["smoke"]),
            ("classic -e", {"unique": True}, ("dedup",), corpus["smoke"]),
            ("classic pairs", {"paired_end_1": corpus["pairs"][0],
                               "paired_end_2": corpus["pairs"][1]}, (),
             "")):
        stem = tag.replace(" ", "_").replace("-", "")
        (ca, cu, nreads, _), launches[tag], infos[tag] = drive(
            tag, inp, os.path.join(OUT, f"{stem}.json"),
            os.path.join(OUT, f"{stem}.csv"), CLASSIC_KERNELS + expect,
            over=dict(K128, **extra), corpus=wide,
            unit="pairs" if "pairs" in tag else "reads")
        expect_classic(tag, launches[tag], expect)
        want = synth.SMOKE_READS // (2 if "pairs" in tag else 1)
        if nreads != want or not np.isfinite(ca).all() or cu.sum() <= 0:
            fail(f"{tag}: wrong read count or empty / non-finite counts")
    infos["tables"] = tstages
    return launches, infos, tables


def phase_corpus():
    from kasa_tpu_torch import synth
    t0 = time.perf_counter()
    corpus = synth.generate(log=log)
    log(f"corpus: n_entries={corpus['n_entries']} "
        f"S={corpus['num_species'] + 1} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    return corpus


def drive(tag, inp, out_j, out_p, expect, over=(), corpus=None,
          multi=False, unit="reads"):
    """One identify run with the launch counts set to 0 just before it
    and read just after; prints reads/s, the host-recompute share and
    peak device memory.  -> (identify's result, launches, info)."""
    import torch
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify, identify_multiple
    from kasa_tpu_torch.utils import timers
    cfg = Config()
    for k, v in dict(over).items():
        setattr(cfg, k, v)
    timers.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    if multi:
        cfg.index_file, cfg.input = corpus["index"], inp
        cfg.read_to_taxa_file, cfg.table_file = out_j, out_p
        res = identify_multiple(cfg, device=DEVICE)
    else:
        res = identify(cfg, index_path=corpus["index"], input_path=inp,
                       out_file=out_j, profile_file=out_p, device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.COUNTS)
    expect_launched(tag, launches, expect)
    fb, tot = fast.LAST_FALLBACK
    stages = {k: round(v, 4) for k, v in
              timers.report(lambda *_: None).items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: {tot} {unit} in {dt:.3f} s = {tot / dt:.1f} {unit}/s; "
        f"host recompute {fb}/{tot} = {100.0 * fb / tot:.4f} %; peak "
        f"device memory {peak / 2**30:.3f} GiB; launches {launches}")
    log(f"{tag}: host stage seconds {json.dumps(stages)}")
    return res, launches, dict(reads=tot, seconds=dt, reads_per_s=tot / dt,
                               fallback_pct=100.0 * fb / tot,
                               peak_bytes=peak, stages=stages)


def phase_full(corpus):
    import numpy as np
    import torch
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify
    from kasa_tpu_torch.utils import timers

    timers.reset()
    t0 = time.perf_counter()
    identify(Config(), index_path=corpus["index"], input_path=corpus["warm"],
             out_file=os.path.join(OUT, "warm.json"), profile_file=None,
             device=DEVICE)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    tstages = {k: round(v, 3) for k, v in timers.report(lambda *_: None)
               .items() if k.startswith(("turbo/", "ttbuild/"))}
    log(f"full: tables + {synth.WARM_READS}-read warm-up run "
        f"{t_warm:.1f} s; table stages {tstages}")

    (ca, cu, nreads, nk), launches, info = drive(
        "full", corpus["smoke"], os.path.join(OUT, "smoke.json"),
        os.path.join(OUT, "smoke_profile.csv"), PATH_KERNELS, corpus=corpus)
    if nreads != synth.SMOKE_READS:
        fail(f"{nreads} reads identified, expected {synth.SMOKE_READS}")
    if not (np.isfinite(ca).all() and cu.sum() > 0 and ca.shape == cu.shape):
        fail("count matrices are not finite / empty")
    with open(os.path.join(OUT, "smoke.json")) as fh:
        n_out = sum(1 for ln in fh if '"Read number"' in ln)
    if n_out != nreads:
        fail(f"{n_out} reads in the output file, expected {nreads}")
    return fast.LAST_DISPATCH, launches, info, (ca, cu)


def split_fastq(src, parts, directory):
    """The reads of `src` in `parts` equal consecutive files."""
    os.makedirs(directory, exist_ok=True)
    with open(src, "rb") as fh:
        lines = fh.readlines()
    n = len(lines) // 4 // parts
    names = []
    for i in range(parts):
        names.append(os.path.join(directory, f"part{i}.fastq"))
        with open(names[-1], "wb") as fh:
            fh.writelines(lines[4 * n * i:4 * n * (i + 1)])
    return names


def phase_full_flags(corpus, single_counts):
    """--six -e, paired-end and identify_multiple on the smoke set."""
    import numpy as np
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.match import fast
    N = synth.SMOKE_READS
    infos, launches = {}, {}
    (ca, cu, nreads, _), launches["six_e"], infos["six_e"] = drive(
        "full-flags six -e", corpus["smoke"],
        os.path.join(OUT, "smoke_six_e.json"),
        os.path.join(OUT, "smoke_six_e.csv"), PATH_KERNELS + ("dedup",),
        over={"six_frames": True, "unique": True}, corpus=corpus)
    if nreads != N or not np.isfinite(ca).all() or cu.sum() <= 0:
        fail("six -e: wrong read count or empty / non-finite counts")
    nb = N // fast.READS_PER_BATCH
    if launches["six_e"]["dedup"] != nb:
        fail(f"six -e: dedup launched {launches['six_e']['dedup']} times, "
             f"expected {nb}")

    mates = corpus["pairs"]
    (ca, cu, nreads, _), launches["paired"], infos["paired"] = drive(
        "full-flags paired", "", os.path.join(OUT, "smoke_paired.json"),
        os.path.join(OUT, "smoke_paired.csv"), PATH_KERNELS,
        over={"paired_end_1": mates[0], "paired_end_2": mates[1]},
        corpus=corpus, unit="pairs")
    if nreads != N // 2 or not np.isfinite(ca).all() or cu.sum() <= 0:
        fail("paired: wrong pair count or empty / non-finite counts")
    (ca, cu, nreads, _), launches["paired_six"], infos["paired_six"] = \
        drive("full-flags paired --six", "",
              os.path.join(OUT, "smoke_paired_six.json"),
              os.path.join(OUT, "smoke_paired_six.csv"), PATH_KERNELS,
              over={"paired_end_1": mates[0], "paired_end_2": mates[1],
                    "six_frames": True}, corpus=corpus, unit="pairs")
    if nreads != N // 2 or not np.isfinite(ca).all() or cu.sum() <= 0:
        fail("paired --six: wrong pair count or empty / non-finite counts")

    folder = os.path.join(HERE, ".synth_corpus", "multi4")
    split_fastq(corpus["smoke"], 4, folder)
    res, launches["multi"], infos["multi"] = drive(
        "full-flags multi", folder, os.path.join(OUT, "multi4_q_"),
        os.path.join(OUT, "multi4_p_"), PATH_KERNELS, corpus=corpus,
        multi=True)
    per_file_agree("full-flags multi", res, single_counts, 4, N)
    return launches, infos


def real_batch(corpus, six=False, highest_k=12, min_k=7, R=None,
               path=None):
    """The first R (8,192) reads of the smoke set (or of the fastq file
    `path`) as the main path lays them out for an index of highest_k and
    a k range from min_k (two rows per read under --six).
    -> (mat, R, w, lpr)."""
    import numpy as np
    from kasa_tpu_torch.match.fast import BatchAssembler, READS_PER_BATCH
    from kasa_tpu_torch.native import load_fastx, sanitize_inplace
    seq, so, _, _, _ = load_fastx(path or corpus["smoke"], True)
    sanitize_inplace(seq, False)
    R = R or READS_PER_BATCH
    asm = BatchAssembler(highest_k, min_k, six=six)
    lens = np.diff(so[:R + 1])
    maxlen = (int(lens.max()) + asm.marker_len + 15) // 16 * 16
    mat = asm.assemble(seq[:so[R]], so[:R + 1].astype(np.int64), maxlen, R)
    return mat, R, asm.window_target(maxlen), 2 if six else 1


def phase_sample(disp, mat, R, w, lpr=1, unique=False):
    """512 sampled unflagged reads of a real batch: the device hit lists
    against the exact host recompute (of the deduped windows under
    -e)."""
    import numpy as np
    import torch
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    tt = disp.tt
    lut_np = build_codon_code_lut().astype(np.int32)
    lut = torch.from_numpy(lut_np).to(DEVICE)
    acc_ca, acc_cu = disp.new_acc()
    cap = disp.csr_cap(R)
    packed, ht_d, hk_d = T.fused_turbo_acc(
        tt, torch.from_numpy(mat).to(DEVICE), lut, acc_ca, acc_cu, R, w, cap,
        disp.multi_budget, disp.exp_budget, lines_per_read=lpr,
        unique=unique)
    packed = packed.cpu().numpy()
    hc, ofc, ofl, _, ht, hk = disp.decode(packed, R, R, cap, True, ht_d,
                                          hk_d)
    rng = np.random.default_rng(512)
    n_sample = min(512, R)
    sample = rng.choice(R, size=n_sample, replace=False)
    checked = 0
    for r in sample:
        if ofl[r]:
            continue            # the host recomputes these reads anyway
        q = T.read_windows_np(mat[r * lpr:(r + 1) * lpr], lut_np,
                              tt.highest_k, False, False, w)
        if unique:
            q = T.dedup_windows_np(q)
        exact, _, _ = T.host_classify_read(tt, q)
        want = sorted((t, v) for t, v in exact.items() if v > 0)
        got = [(int(ht[r, i]), float(hk[r, i])) for i in range(hc[r])]
        if [t for t, _ in want] != [t for t, _ in got]:
            fail(f"read {r}: device hit taxa differ from the host recompute")
        np.testing.assert_allclose([v for _, v in got],
                                   [float(v) for _, v in want],
                                   rtol=RTOL, atol=ATOL)
        checked += 1
    if checked < 0.75 * n_sample:
        fail(f"only {checked} of {n_sample} sampled reads were unflagged")
    log(f"sample{' (--six -e)' if unique else ''} (S={tt.num_species}, "
        f"L={tt.keys2.shape[1]}): {checked} of {n_sample} "
        "sampled reads agree with host_classify_read "
        f"({n_sample - checked} flagged, recomputed on the host by design)")


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sector_bytes(idx, row_bytes):
    """Bytes of the distinct 32-byte sectors that reads of rows `idx` of
    a table with `row_bytes`-byte rows touch: a gather that lands on a
    sector already read moves nothing new."""
    import torch
    if idx.numel() == 0:
        return 0
    a = idx.long().reshape(-1) * row_bytes
    return 32 * int(torch.unique(torch.cat([a // 32,
                                            (a + row_bytes - 1) // 32]))
                    .numel())


def match_bytes(q, tt, R, SW):
    """Least bytes K2 moves on these windows: q once, the outputs once,
    and the distinct sectors of router, sub-router, keys2 (every bisect
    midpoint, repeated ones included) and rowdat (pos and pos-1) that
    the search touches."""
    import torch
    from kasa_tpu_torch.match import turbo as T
    n, L = tt.n, q.shape[1]
    q0, q1 = q[:, 0], q[:, 1]
    bucket = (q0 >> (T.LIMB_BITS - T.ROUTER_BITS)).long()
    rr = tt.router[bucket]
    lo, meta = rr[:, 0], rr[:, 1]
    is_sub = meta < 0
    code = torch.where(is_sub, -meta, torch.full_like(meta, 32))
    s = torch.where(is_sub, code & 31, torch.full_like(code, T.SUB_BITS))
    subkey = ((q0 & 0x3F) << (T.SUB_BITS - 6)) \
        | (q1 >> (T.LIMB_BITS - (T.SUB_BITS - 6)))
    sidx = (code >> 5) + (subkey >> (T.SUB_BITS - s))
    srow = tt.sub2[torch.where(is_sub, sidx, torch.zeros_like(sidx)).long()]
    lo = torch.where(is_sub, srow[:, 0], lo)
    hi = torch.where(is_sub, srow[:, 1], meta)
    mids = []
    for _ in range(tt.num_steps):
        mid = (lo + hi) >> 1
        mids.append(mid.clamp(max=n - 1))
        kk = tt.keys2[mids[-1].long()]
        less = kk[:, L - 1] < q[:, L - 1]
        for i in range(L - 2, -1, -1):
            less = (kk[:, i] < q[:, i]) | ((kk[:, i] == q[:, i]) & less)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    rows = torch.cat([lo.clamp(max=n - 1), (lo - 1).clamp(0, n - 1)])
    return (q.numel() * 4 + 2 * R * SW * 4
            + sector_bytes(bucket, 8) + sector_bytes(sidx[is_sub], 8)
            + sector_bytes(torch.cat(mids), 4 * L)
            + sector_bytes(rows, 4 * (L + 2)))


def multi_bytes(cp, mcnt, ofc, tt, R, S, H, B, counts_only=False):
    """Least bytes K4 moves: the read counts, the multi payloads, the
    distinct sectors of grp2, t_hot and d_tax4 (headers of the cold
    slots, taxa rows of the admitted ones) and of the count cells the
    expansion adds to (read and written), and its outputs once (no
    score rows or hot credits in the counts-only arm)."""
    import torch
    nk, n = tt.num_k, tt.n
    valid = cp >= 0
    pos = torch.nonzero(valid.reshape(-1)).reshape(-1)[:B]
    mp = cp.reshape(-1)[pos]
    rid = pos // cp.shape[1]
    ki = (mp & 7).long()
    g = (ki * n + (mp >> 3).long()).clamp(max=nk * n - 1)
    row0 = tt.grp2[g].long()
    cold, hot = row0 > 0, row0 < 0
    T_ = tt.d_tax4[row0[cold], 0].long()
    ok = ~ofc[rid[cold]].bool()
    nrow = (T_[ok] + 3) >> 2
    first = row0[cold][ok] + 1
    sl = torch.repeat_interleave(torch.arange(len(nrow), device=cp.device),
                                 nrow)
    j = torch.arange(len(sl), device=cp.device) \
        - (torch.cumsum(nrow, 0) - nrow)[sl]
    taxa_rows = (first[sl] + j).clamp(max=tt.d_tax4.shape[0] - 1)
    taxa = tt.d_tax4[taxa_rows]
    cells = (ki[cold][ok][sl][:, None] * S + taxa)[taxa >= 0]
    outs = R + 8 + (0 if counts_only else R * S * 4 + R * H * 4
                    + nk * H * 4)
    return (2 * R * 4 + sector_bytes(pos, 4) + sector_bytes(g, 4)
            + sector_bytes(-row0[hot] - 1, 4)
            + sector_bytes(torch.cat([row0[cold], taxa_rows]), 16)
            + 2 * sector_bytes(cells, 4) + outs)


def phase_kernels(disp, mat, R, w, launches):
    import numpy as np
    import torch
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    tt = disp.tt
    dev = torch.device(DEVICE)
    nk, S, H = tt.num_k, tt.num_species, tt.hotmask.shape[0]
    mb, eb = disp.multi_budget, disp.exp_budget
    cap = disp.csr_cap(R)
    mat_d = torch.from_numpy(mat).to(dev)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)

    def acc():
        return (torch.zeros((nk, S), dtype=torch.float32, device=dev),
                torch.zeros((nk, S), dtype=torch.int32, device=dev))

    # K1
    q = E.encode_windows(mat_d, lut, w)
    err1 = same("encode", q, E.encode_windows_plain(mat_d, lut, w))
    M = q.shape[0]
    SW = w * nk
    # K2
    skey, mpay = T.turbo_match(q, tt, R, w)
    sk2, mp2 = T.turbo_match_plain(q, tt, R, w)
    same("turbo_match.skey", skey, sk2)
    err2 = same("turbo_match.mpay", mpay, mp2)
    # K3 pre
    pre_k = T.turbo_reads_pre(skey, mpay)
    pre_p = T.turbo_reads_pre_plain(skey, mpay)
    for nm, a, b in zip(("ck", "cc", "runs", "mcnt", "cp"), pre_k, pre_p):
        same(f"turbo_reads.{nm}", a, b)
    ck, cc, runs, mcnt, cp = pre_p
    # K4
    ca_k, _ = acc()
    ca_p, _ = acc()
    mk = T.turbo_multi(cp, mcnt, runs, tt, ca_k, mb, eb)
    mp_ = T.turbo_multi_plain(cp, mcnt, runs, tt, ca_p, mb, eb)
    same("turbo_multi.ofc", mk[0], mp_[0])
    same("turbo_multi.diag", mk[4], mp_[4])
    err4 = max(close("turbo_multi.dm", mk[1], mp_[1]),
               close("turbo_multi.a3w", mk[2], mp_[2]),
               close("turbo_multi.a3c", mk[3], mp_[3]),
               close("turbo_multi.acc_ca", ca_k, ca_p))
    ofc, dm, a3w, a3c, diag = mp_
    dm = dm.clone()
    dm.addmm_(a3w, tt.hotmask)
    # K3 post
    ca_k, cu_k = acc()
    ca_p, cu_p = acc()
    po_k = T.turbo_reads_post(ck, cc, ofc, dm, tt.weights, ca_k, cu_k, diag,
                              cap)
    po_p = T.turbo_reads_post_plain(ck, cc, ofc, dm, tt.weights, ca_p, cu_p,
                                    diag, cap)
    pk, pp = po_k[0].cpu(), po_p[0].cpu()
    ints = torch.ones(len(pk), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    same("turbo_reads.packed", pk[ints], pp[ints])
    same("turbo_reads.ht", po_k[1], po_p[1])
    same("turbo_reads.acc_cu", cu_k, cu_p)
    err3 = max(close("turbo_reads.ksum", pk[2 * R + 1:2 * R + 2 * cap:2]
                     .view(torch.float32),
                     pp[2 * R + 1:2 * R + 2 * cap:2].view(torch.float32)),
               close("turbo_reads.hk", po_k[2], po_p[2]),
               close("turbo_reads.acc_ca", ca_k, ca_p))
    torch.cuda.synchronize()
    mtot, eused = (int(x) for x in diag.tolist())
    hits = int(pp[-2])
    log(f"kernels: all four agree with their plain versions on a "
        f"{R}-read batch (M={M} windows, SW={SW}, multi slots {mtot}, "
        f"expansion rows {eused}, hits {hits})")

    # times: kernel reps, then plain reps, on the same inputs
    ca_t, cu_t = acc()
    kms = {
        "encode": time_ms(lambda: E.encode_windows(mat_d, lut, w), 20),
        "turbo_match": time_ms(lambda: T.turbo_match(q, tt, R, w), 20),
        "turbo_reads": time_ms(lambda: T.turbo_reads_pre(skey, mpay), 10)
        + time_ms(lambda: T.turbo_reads_post(ck, cc, ofc, dm, tt.weights,
                                             ca_t, cu_t, diag, cap), 10),
        "turbo_multi": time_ms(lambda: T.turbo_multi(cp, mcnt, runs, tt,
                                                     ca_t, mb, eb), 10),
    }
    pms = {
        "encode": time_ms(lambda: E.encode_windows_plain(mat_d, lut, w), 5),
        "turbo_match": time_ms(lambda: T.turbo_match_plain(q, tt, R, w), 5),
        "turbo_reads": time_ms(lambda: T.turbo_reads_pre_plain(skey, mpay),
                               3)
        + time_ms(lambda: T.turbo_reads_post_plain(
            ck, cc, ofc, dm, tt.weights, ca_t, cu_t, diag, cap), 3),
        "turbo_multi": time_ms(lambda: T.turbo_multi_plain(
            cp, mcnt, runs, tt, ca_t, mb, eb), 3),
    }
    # the whole batch step as the main path queues it (K1-K4, the zeroed
    # score rows, the two hot-set products), on the device's clock
    step_ms = time_ms(lambda: T.fused_turbo_acc(tt, mat_d, lut, ca_t, cu_t,
                                                R, w, cap, mb, eb), 10)
    keys64 = (tt.keys2[:, 0].long() << 30) | tt.keys2[:, 1].long()
    q64 = (q[:, 0].long() << 30) | q[:, 1].long()
    lib_ms = time_ms(lambda: torch.searchsorted(keys64, q64), 20)

    # least bytes each function must move on this batch: each input read
    # once and each output written once; a gathered table counts the
    # distinct 32-byte sectors its gathers touch, an accumulator the
    # sectors of the cells added to (read and written)
    t1 = ck[(ck != T.SENT) & ~ofc.bool()[:, None]]
    t1_cells = (t1 & 7).long() * S + (t1 >> 3).long()
    bytes_ = {
        "encode": R * mat.shape[1] + M * 8,
        "turbo_match": match_bytes(q, tt, R, SW),
        # pre: skey and mpay in, cp, runs and mcnt out (to K4); post:
        # ofc and the score rows in, ht / hk and the packed readback out,
        # the T1 cells of both accumulators read and written; the (R, CW)
        # runs pre hands post stay inside the function
        "turbo_reads": (2 * R * SW * 4 + R * SW * 4 + 2 * R * 4)
        + (R + R * S * 4 + 2 * R * T.WOUT * 4 + (2 * R + 2 * cap + 4) * 4
           + 2 * 2 * sector_bytes(t1_cells, 4)),
        "turbo_multi": multi_bytes(cp, mcnt, ofc, tt, R, S, H, mb),
    }
    sources = {"encode": ("kasa_tpu_torch/csrc/encode.cu",
                          "kasa_tpu/core/encode.py:52"),
               "turbo_match": ("kasa_tpu_torch/csrc/turbo_match.cu",
                               "kasa_tpu/match/turbo.py:569"),
               "turbo_reads": ("kasa_tpu_torch/csrc/turbo_reads.cu",
                               "kasa_tpu/match/turbo.py:717"),
               "turbo_multi": ("kasa_tpu_torch/csrc/turbo_multi.cu",
                               "kasa_tpu/match/turbo.py:740")}
    errs = {"encode": err1, "turbo_match": err2, "turbo_reads": err3,
            "turbo_multi": err4}
    out = []
    for name in ("encode", "turbo_match", "turbo_reads", "turbo_multi"):
        src, rep = sources[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": kms[name],
                    "plain_ms": pms[name],
                    "bound_ms": bytes_[name] / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes",
                    "library_ms": lib_ms if name == "turbo_match" else None})
        log(f"kernel {name}: {kms[name]:.4f} ms (plain {pms[name]:.4f} ms, "
            f"bound {out[-1]['bound_ms']:.4f} ms from "
            f"{bytes_[name] / 1e6:.2f} MB), {launches[name]} launches in "
            "the main run")
    log(f"library: torch.searchsorted over packed 60-bit keys {lib_ms:.4f} "
        "ms (yardstick for turbo_match's search; the port never calls it)")
    log(f"step: fused_turbo_acc {step_ms:.4f} ms per {R}-read batch on the "
        "device (all four kernels and the two hot-set products)")
    turbo_stages("default", tt, mat, R, w, mb, eb, cap)
    return out, step_ms


def paired_batch(corpus, R, six=False):
    """The corpus's first R read pairs as the paired-end path lays them
    out (two rows per pair, four under --six).  -> (mat, w, lpr)."""
    import numpy as np
    from kasa_tpu_torch.match.fast import BatchAssembler
    from kasa_tpu_torch.native import load_fastx, sanitize_inplace
    asm = BatchAssembler(12, 7, six=six)
    blobs, offs = [], []
    for path in corpus["pairs"]:
        seq, so, _, _, _ = load_fastx(path, True)
        sanitize_inplace(seq, False)
        blobs.append(seq[:so[R]])
        offs.append(so[:R + 1].astype(np.int64))
    lens = np.concatenate([np.diff(o) for o in offs])
    maxlen = (int(lens.max()) + asm.marker_len + 15) // 16 * 16
    return (asm.assemble_multi(blobs, offs, maxlen, R),
            asm.window_target(maxlen), 2 * (2 if six else 1))


def phase_kernels_flags(disp, corpus, mat, R, w, launches_e):
    """The new arms against their plain versions on real batches: K5 on
    a --six -e batch, K1 one-frame and protein on the default batch's
    bytes, the per-file counts of K4 and K3 (post) with a 4-file map;
    K5's time beside torch.sort of the same keys; the whole batch step
    per mode on the device's clock."""
    import numpy as np
    import torch
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    tt = disp.tt
    dev = torch.device(DEVICE)
    nk, S = tt.num_k, tt.num_species
    mb, eb = disp.multi_budget, disp.exp_budget
    cap = disp.csr_cap(R)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    mat_d = torch.from_numpy(mat).to(dev)

    # K5 on the --six -e batch
    mat6, _, w6, lpr = real_batch(corpus, six=True)
    mat6_d = torch.from_numpy(mat6).to(dev)
    kpr = w6 * lpr
    q6 = E.encode_windows(mat6_d, lut, w6)
    same("dedup", T.dedup_windows(q6, R, kpr),
         T.dedup_windows_plain(q6, R, kpr))
    # K1's new arms
    w1 = mat.shape[1] // 3 - 11
    same("encode.one_frame", E.encode_windows(mat_d, lut, w1, one_frame=True),
         E.encode_windows_plain(mat_d, lut, w1, one_frame=True))
    wp = mat.shape[1] - 11
    same("encode.protein", E.encode_windows(mat_d, lut, wp, protein=True),
         E.encode_windows_plain(mat_d, lut, wp, protein=True))
    # the per-file arms of K4 and K3 (post), 4 files of R/4 reads
    F = 4
    fo = (torch.arange(R, device=dev) // (R // F)).to(torch.int32)
    q = E.encode_windows(mat_d, lut, w)
    skey, mpay = T.turbo_match(q, tt, R, w)
    ck, cc, runs, mcnt, cp = T.turbo_reads_pre(skey, mpay)

    def acc_f():
        return (torch.zeros((F, nk, S), dtype=torch.float32, device=dev),
                torch.zeros((F, nk, S), dtype=torch.int32, device=dev))
    (ca_k, _), (ca_p, _) = acc_f(), acc_f()
    mk = T.turbo_multi(cp, mcnt, runs, tt, ca_k, mb, eb, fo)
    mp_ = T.turbo_multi_plain(cp, mcnt, runs, tt, ca_p, mb, eb, fo)
    same("turbo_multi.files.ofc", mk[0], mp_[0])
    errf = max(close("turbo_multi.files.dm", mk[1], mp_[1]),
               close("turbo_multi.files.a3c", mk[3], mp_[3]),
               close("turbo_multi.files.acc_ca", ca_k, ca_p))
    ofc, dm, a3w, a3c, diag = mp_
    dm = dm.clone()
    dm.addmm_(a3w, tt.hotmask)
    (ca_k, cu_k), (ca_p, cu_p) = acc_f(), acc_f()
    po_k = T.turbo_reads_post(ck, cc, ofc, dm, tt.weights, ca_k, cu_k, diag,
                              cap, fo)
    po_p = T.turbo_reads_post_plain(ck, cc, ofc, dm, tt.weights, ca_p, cu_p,
                                    diag, cap, fo)
    same("turbo_reads.files.ht", po_k[1], po_p[1])
    same("turbo_reads.files.acc_cu", cu_k, cu_p)
    errf = max(errf, close("turbo_reads.files.acc_ca", ca_k, ca_p))
    if int(cu_p.sum(dim=(1, 2)).min()) <= 0:
        fail("files arm: a file of the batch counted nothing")
    torch.cuda.synchronize()
    log(f"kernels: dedup (R={R}, kpr={kpr}), encode one-frame (w={w1}) and "
        f"protein (w={wp}), and the {F}-file count arms of turbo_multi and "
        f"turbo_reads agree with their plain versions (files max abs err "
        f"{errf:.3g})")

    keys = ((q6[:, 0].long() << 30) | q6[:, 1].long()).reshape(R, kpr)
    ms = time_ms(lambda: T.dedup_windows(q6, R, kpr), 20)
    plain_ms = time_ms(lambda: T.dedup_windows_plain(q6, R, kpr), 5)
    lib_ms = time_ms(lambda: torch.sort(keys, dim=1), 20)
    nbytes = 2 * R * kpr * 8
    entry = {"name": "dedup", "route": "cuda",
             "source": "kasa_tpu_torch/csrc/dedup.cu",
             "replaces": "kasa_tpu/match/turbo.py:128",
             "launches": launches_e["dedup"], "max_abs_err": 0.0, "ms": ms,
             "plain_ms": plain_ms,
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "library_ms": lib_ms}
    log(f"kernel dedup: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms from {nbytes / 1e6:.2f} MB; torch.sort "
        f"of the (R, kpr) int64 keys {lib_ms:.4f} ms), "
        f"{launches_e['dedup']} launches in the --six -e run")

    # each kernel's time on the --six -e batch (after K5)
    q6d = T.dedup_windows(q6, R, kpr)
    skey6, mpay6 = T.turbo_match(q6d, tt, R, kpr)
    ck6, cc6, runs6, mcnt6, cp6 = T.turbo_reads_pre(skey6, mpay6)
    ca_t = torch.zeros((nk, S), dtype=torch.float32, device=dev)
    cu_t = torch.zeros((nk, S), dtype=torch.int32, device=dev)
    ofc6, dm6, _, _, diag6 = T.turbo_multi(cp6, mcnt6, runs6, tt, ca_t, mb,
                                           eb)
    six_e_ms = {
        "encode": time_ms(lambda: E.encode_windows(mat6_d, lut, w6), 20),
        "dedup": ms,
        "turbo_match": time_ms(lambda: T.turbo_match(q6d, tt, R, kpr), 20),
        "turbo_reads": time_ms(lambda: T.turbo_reads_pre(skey6, mpay6), 10)
        + time_ms(lambda: T.turbo_reads_post(ck6, cc6, ofc6, dm6, tt.weights,
                                             ca_t, cu_t, diag6, cap), 10),
        "turbo_multi": time_ms(lambda: T.turbo_multi(
            cp6, mcnt6, runs6, tt, ca_t, mb, eb), 10),
    }
    log(f"kernels on the --six -e batch (kpr={kpr}, SW={kpr * nk}, multi "
        f"slots {int(diag6[0])}): ms "
        + json.dumps({k: round(v, 4) for k, v in six_e_ms.items()}))

    # the whole batch step per mode, on the device's clock
    matp, wpair, _ = paired_batch(corpus, R)
    matp_d = torch.from_numpy(matp).to(dev)
    matp6, wpair6, _ = paired_batch(corpus, R, six=True)
    matp6_d = torch.from_numpy(matp6).to(dev)
    caf, cuf = acc_f()
    mb6, eb6, wout6 = disp.budgets_for(4, wpair6)
    steps = {
        "six": time_ms(lambda: T.fused_turbo_acc(
            tt, mat6_d, lut, ca_t, cu_t, R, w6, cap, mb, eb,
            lines_per_read=2), 10),
        "six_e": time_ms(lambda: T.fused_turbo_acc(
            tt, mat6_d, lut, ca_t, cu_t, R, w6, cap, mb, eb,
            lines_per_read=2, unique=True), 10),
        "unique": time_ms(lambda: T.fused_turbo_acc(
            tt, mat_d, lut, ca_t, cu_t, R, w, cap, mb, eb, unique=True), 10),
        "paired": time_ms(lambda: T.fused_turbo_acc(
            tt, matp_d, lut, ca_t, cu_t, R, wpair, cap, mb, eb,
            lines_per_read=2), 10),
        "paired_six": time_ms(lambda: T.fused_turbo_acc(
            tt, matp6_d, lut, ca_t, cu_t, R, wpair6, cap, mb6, eb6,
            lines_per_read=4, wout=wout6), 10),
        "files4": time_ms(lambda: T.fused_turbo_acc(
            tt, mat_d, lut, caf, cuf, R, w, cap, mb, eb, file_of_read=fo),
            10),
        "one": time_ms(lambda: T.fused_turbo_acc(
            tt, mat_d, lut, ca_t, cu_t, R, w1, cap, mb, eb, one_frame=True),
            10),
    }
    log(f"step: fused_turbo_acc ms per {R}-read batch by mode "
        + json.dumps({k: round(v, 4) for k, v in steps.items()}))
    return entry, steps, six_e_ms


def phase_budgets(disp, corpus, R):
    """Multi slots (the K4 worklist's demand) and flagged reads of a
    --six, a paired and a paired --six batch at kasa_tpu's fixed budgets
    (MULTI_BUDGET, EXP_BUDGET) and at twice them: whether a read of
    several lines overflows the fixed worklist."""
    import numpy as np
    import torch
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    tt = disp.tt
    dev = torch.device(DEVICE)
    nk, S = tt.num_k, tt.num_species
    cap = disp.csr_cap(R)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    mat6, _, w6, lpr6 = real_batch(corpus, six=True)
    batches = {"six": (mat6, w6, lpr6),
               "paired": paired_batch(corpus, R),
               "paired_six": paired_batch(corpus, R, six=True)}
    out = {}
    for tag, (mat, w, lpr) in batches.items():
        mat_d = torch.from_numpy(mat).to(dev)
        kpr = w * lpr
        skey, mpay = T.turbo_match(E.encode_windows(mat_d, lut, w), tt, R,
                                   kpr)
        _, _, runs, mcnt, cp = T.turbo_reads_pre(skey, mpay, num_species=S)
        ca = torch.zeros((nk, S), dtype=torch.float32, device=dev)
        cu = torch.zeros((nk, S), dtype=torch.int32, device=dev)
        diag = T.turbo_multi(cp, mcnt, runs, tt, ca, 1 << 30, 1 << 30)[4]
        row = {"kpr": kpr, "multi_slots": int(diag[0]),
               "expansion_rows": int(diag[1]),
               "drive_loop_budgets": disp.budgets_for(lpr, w)}
        for scale in (1, 2):
            mb, eb = disp.multi_budget * scale, disp.exp_budget * scale
            packed, ht, hk = T.fused_turbo_acc(
                tt, mat_d, lut, ca, cu, R, w, cap, mb, eb,
                lines_per_read=lpr)
            _, ofc, ofl, _, _, _ = disp.decode(packed.cpu().numpy(), R, R,
                                               cap, True, ht, hk)
            row[f"x{scale}"] = {"multi_budget": mb,
                                "count_flagged": int(ofc.sum()),
                                "list_flagged": int(ofl.sum())}
        out[tag] = row
        log(f"budgets {tag}: " + json.dumps(row))
    return out


# ---------------------------------------------------------------------------
# large indices: the sparse fold (more than SPARSE_FOLD_S species) and
# 128-bit indices (five limbs)

PREP = ("default", "bigS", "wide")
# the tiered runs' device budget: chunks of 8,388,608 entries
TIERED_BUDGET = 256 << 20
TIERED_PREP = ("default", "bigS")


def start_prep(names=PREP, tiered=True):
    """Generate the three corpora and build their turbo-table sidecars
    (and the tiered chunk caches of TIERED_BUDGET) in three host
    processes started together (python -m kasa_tpu_torch.synth <name>
    --tables [--tiered BYTES]; CPU only, they never touch the card), each
    logging to .synth_corpus/out/prep_<name>.log."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = {}
    for name in names:
        path = os.path.join(OUT, f"prep_{name}.log")
        fh = open(path, "w")
        extra = (["--tiered", str(TIERED_BUDGET)]
                 if tiered and name in TIERED_PREP else [])
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "kasa_tpu_torch.synth", name, "--tables",
             *extra], cwd=HERE, stdout=fh, stderr=subprocess.STDOUT,
            env=env), fh, path)
    return procs


def wait_prep(procs, t0, names):
    for name in names:
        proc, fh, path = procs[name]
        rc = proc.wait()
        if fh.closed:
            continue
        fh.close()
        with open(path) as f:
            text = f.read()
        if rc != 0:
            fail(f"preparing the {name} corpus failed (rc {rc}):\n"
                 f"{text[-3000:]}")
        log(f"prep {name}: " + "; ".join(
            ln[2:] for ln in text.splitlines() if ln.startswith("# ")))
        log(f"prep {name}: ready {time.perf_counter() - t0:.1f} s after the "
            "start")


def stop_prep(procs):
    for proc, fh, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if not fh.closed:
            fh.close()


def table_bytes(tt):
    from kasa_tpu_torch.match.turbo import DEVICE_FIELDS
    return sum(getattr(tt, f).numel() * getattr(tt, f).element_size()
               for f in DEVICE_FIELDS)


def warm_up(tag, index, reads, over=()):
    """Tables (from the sidecar) and one warm-up identify run; -> the
    dispatch."""
    import torch
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify
    from kasa_tpu_torch.utils import timers
    cfg = Config()
    for k, v in dict(over).items():
        setattr(cfg, k, v)
    timers.reset()
    t0 = time.perf_counter()
    identify(cfg, index_path=index, input_path=reads,
             out_file=os.path.join(OUT, f"{tag}_warm.json"),
             profile_file=None, device=DEVICE)
    torch.cuda.synchronize()
    disp = fast.LAST_DISPATCH
    tt = disp.tt
    tstages = {k: round(v, 3) for k, v in timers.report(lambda *_: None)
               .items() if k.startswith(("turbo/", "ttbuild/"))}
    log(f"{tag}: tables (S={tt.num_species}, n={tt.n:,}, L="
        f"{tt.keys2.shape[1]}, hot sets {tt.hotmask.shape[0]}, "
        f"{table_bytes(tt) / 2**30:.3f} GiB on the device) + warm-up run "
        f"{time.perf_counter() - t0:.1f} s; table stages {tstages}")
    return disp


def per_file_agree(tag, res, single, n_files, n):
    import numpy as np
    if [r[2] for r in res] != [n // n_files] * n_files:
        fail(f"{tag}: per-file reads {[r[2] for r in res]}")
    ca_sum = sum(r[0] for r in res)
    cu_sum = sum(r[1].astype(np.int64) for r in res)
    if not np.array_equal(cu_sum, single[1].astype(np.int64)):
        fail(f"{tag}: summed per-file unique counts differ from the "
             "single-file run's")
    np.testing.assert_allclose(ca_sum, single[0], rtol=2e-5, atol=2e-3)
    log(f"{tag}: summed per-file unique counts identical to the "
        "single-file run's, all-counts within rtol 2e-5 / atol 2e-3 (max "
        f"abs diff {float(np.abs(ca_sum - single[0]).max()):.3g})")


def phase_sparse():
    """The 10,001-species corpus through the sparse fold: tables without
    a hot tier, a warm-up, 65,536 reads through identify (K6 on every
    batch beside K4's counts-only arm and K3's list arm), the same reads
    as 4 files through identify_multiple with profiles, and 512 sampled
    reads of a real batch against host_classify_read."""
    import numpy as np
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match import turbo as T
    big = synth.generate_big_s(log=log)
    disp = warm_up("sparse", big["index"], big["warm"])
    tt = disp.tt
    if tt.hotmask.shape[0] != 1 or tt.num_species <= T.SPARSE_FOLD_S:
        fail(f"sparse: S={tt.num_species} with {tt.hotmask.shape[0]} hot "
             "sets does not take the sparse fold")
    N, R = synth.SMOKE_READS, fast.READS_PER_BATCH
    expect = PATH_KERNELS + ("sparse_fold",)
    (ca, cu, nreads, _), launches, info = drive(
        "sparse", big["smoke"], os.path.join(OUT, "bigS_smoke.json"),
        os.path.join(OUT, "bigS_smoke.csv"), expect, corpus=big)
    if nreads != N or not np.isfinite(ca).all() or cu.sum() <= 0:
        fail("sparse: wrong read count or empty / non-finite counts")
    if launches["sparse_fold"] != N // R or launches["turbo_multi"] != N // R:
        fail(f"sparse: K6 and K4 must launch once per batch: {launches}")
    info["tables_bytes"] = table_bytes(tt)
    log(f"sparse: peak device memory {info['peak_bytes'] / 2**20:.1f} MiB, "
        f"{(info['peak_bytes'] - info['tables_bytes']) / 2**20:.1f} MiB "
        "above the resident tables; the dense fold's (R, S) score rows "
        f"alone would take {R * tt.num_species * 4 / 2**20:.1f} MiB per "
        "batch")
    folder = os.path.join(HERE, ".synth_corpus", "bigS_multi4")
    split_fastq(big["smoke"], 4, folder)
    res, launches_m, info_m = drive(
        "sparse multi", folder, os.path.join(OUT, "bigS_multi4_q_"),
        os.path.join(OUT, "bigS_multi4_p_"), expect, corpus=big, multi=True)
    per_file_agree("sparse multi", res, (ca, cu), 4, N)
    mat, R, w, _ = real_batch(big)
    phase_sample(disp, mat, R, w)
    return disp, big, launches, info, info_m


def phase_wide(corpus):
    """The 128-bit corpus (the default corpus's genomes at highestK 25)
    at k 20..25: the 65,536 smoke reads, default and --six -e, each
    with 512 sampled reads against host_classify_read."""
    import numpy as np
    from kasa_tpu_torch import synth
    wide = synth.generate_wide(log=log)
    over = {"lower_k": 20, "higher_k": 25}
    disp = warm_up("wide", wide["index"], corpus["warm"], over)
    tt = disp.tt
    if tt.keys2.shape[1] != 5 or tt.highest_k != 25:
        fail(f"wide: tables of {tt.keys2.shape[1]} limbs, highestK "
             f"{tt.highest_k}")
    N = synth.SMOKE_READS
    infos, launches = {}, {}
    for tag, extra, expect in (
            ("wide", {}, PATH_KERNELS),
            ("wide --six -e", {"six_frames": True, "unique": True},
             PATH_KERNELS + ("dedup",))):
        stem = tag.replace(" ", "_").replace("-", "")
        (ca, cu, nreads, _), launches[tag], infos[tag] = drive(
            tag, corpus["smoke"], os.path.join(OUT, f"{stem}.json"),
            os.path.join(OUT, f"{stem}.csv"), expect,
            over=dict(over, **extra), corpus=wide)
        if nreads != N or not np.isfinite(ca).all() or cu.sum() <= 0:
            fail(f"{tag}: wrong read count or empty / non-finite counts")
    mat, R, w, _ = real_batch(corpus, highest_k=25, min_k=20)
    phase_sample(disp, mat, R, w)
    mat6, _, w6, lpr = real_batch(corpus, six=True, highest_k=25, min_k=20)
    phase_sample(disp, mat6, R, w6, lpr=lpr, unique=True)
    return disp, launches, infos


def kernel_entry(name, src, rep, launches, err, ms, plain_ms, nbytes,
                 lib_ms, note=""):
    e = {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": lib_ms}
    log(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{e['bound_ms']:.4f} ms from {nbytes / 1e6:.2f} MB"
        + (f"; {note} {lib_ms:.4f} ms" if lib_ms is not None else "")
        + f"), {launches} launches in the main run")
    return e


def fold_bytes(cp, mcnt, ofc, tt):
    """Least bytes K6 moves: the read counts and flags, the payloads of
    the unflagged reads' slots, the distinct sectors of grp2 and of the
    d_tax4 header and taxa rows they reach, and the (R, WM) lists."""
    import torch
    from kasa_tpu_torch.match import turbo as T
    R, SW = cp.shape
    n, nk = tt.n, tt.num_k
    valid = (torch.arange(SW, device=cp.device)[None, :] < mcnt[:, None]) \
        & ~ofc[:, None]
    pos = torch.nonzero(valid.reshape(-1)).reshape(-1)
    mp = cp.reshape(-1)[pos]
    g = ((mp & 7).long() * n + (mp >> 3).long()).clamp(max=nk * n - 1)
    row0 = tt.grp2[g].long()
    row0 = row0[row0 > 0]
    nrow = (tt.d_tax4[row0, 0].long() + 3) >> 2
    sl = torch.repeat_interleave(torch.arange(len(nrow), device=cp.device),
                                 nrow)
    j = torch.arange(len(sl), device=cp.device) \
        - (torch.cumsum(nrow, 0) - nrow)[sl]
    rows = torch.cat([row0, row0[sl] + 1 + j])
    return (R * 4 + R + sector_bytes(pos, 4) + sector_bytes(g, 4)
            + sector_bytes(rows, 16) + nk * 4 + R * T.WM * 8 + R)


def phase_kernels_sparse(disp, big, launches):
    """On a real batch of the 10,001-species corpus: K4's counts-only
    arm, K6 and K3's list arm against their plain versions, with their
    times, bounds and K6's yardstick (torch.sort of the batch's
    (read << 24 | tax) int64 lane keys, part of the same function)."""
    import numpy as np
    import torch
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    tt = disp.tt
    dev = torch.device(DEVICE)
    nk, S = tt.num_k, tt.num_species
    mb, eb = disp.multi_budget, disp.exp_budget
    mat, R, w, _ = real_batch(big)
    cap = disp.csr_cap(R)
    mat_d = torch.from_numpy(mat).to(dev)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)

    def acc():
        return (torch.zeros((nk, S), dtype=torch.float32, device=dev),
                torch.zeros((nk, S), dtype=torch.int32, device=dev))
    q = E.encode_windows(mat_d, lut, w)
    skey, mpay = T.turbo_match(q, tt, R, w)
    ck, cc, runs, mcnt, cp = T.turbo_reads_pre(skey, mpay)
    (ca_k, _), (ca_p, _) = acc(), acc()
    mk = T.turbo_multi(cp, mcnt, runs, tt, ca_k, mb, eb, counts_only=True)
    mp_ = T.turbo_multi_plain(cp, mcnt, runs, tt, ca_p, mb, eb,
                              counts_only=True)
    if mk[1] is not None or mk[2] is not None:
        fail("turbo_multi counts-only arm returned score rows")
    same("turbo_multi.counts_only.ofc", mk[0], mp_[0])
    same("turbo_multi.counts_only.diag", mk[4], mp_[4])
    err4 = close("turbo_multi.counts_only.acc_ca", ca_k, ca_p)
    ofc, diag = mp_[0], mp_[4]
    fk = T.sparse_fold(cp, mcnt, ofc, tt)
    fp = T.sparse_fold_plain(cp, mcnt, ofc, tt)
    same("sparse_fold.mk", fk[0], fp[0])
    same("sparse_fold.multi_of", fk[2], fp[2])
    err6 = close("sparse_fold.mv", fk[1], fp[1])
    (ca_k, cu_k), (ca_p, cu_p) = acc(), acc()
    po_k = T.turbo_reads_post(ck, cc, ofc, None, tt.weights, ca_k, cu_k,
                              diag, cap, None, fp)
    po_p = T.turbo_reads_post_plain(ck, cc, ofc, None, tt.weights, ca_p,
                                    cu_p, diag, cap, None, fp)
    pk, pp = po_k[0].cpu(), po_p[0].cpu()
    ints = torch.ones(len(pk), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    same("turbo_reads.list.packed", pk[ints], pp[ints])
    same("turbo_reads.list.ht", po_k[1], po_p[1])
    same("turbo_reads.list.acc_cu", cu_k, cu_p)
    err3 = max(close("turbo_reads.list.ksum", pk[2 * R + 1:2 * R + 2 * cap:2]
                     .view(torch.float32),
                     pp[2 * R + 1:2 * R + 2 * cap:2].view(torch.float32)),
               close("turbo_reads.list.hk", po_k[2], po_p[2]),
               close("turbo_reads.list.acc_ca", ca_k, ca_p))
    rid, tax, _ = T.fold_lanes(cp, mcnt, ofc, tt)
    lane_keys = (rid << 24) | tax
    torch.cuda.synchronize()
    log(f"kernels sparse: turbo_multi (counts-only), sparse_fold and "
        f"turbo_reads (list) agree with their plain versions on a {R}-read "
        f"batch of S={S} (multi slots {int(diag[0])}, {len(rid):,} lanes, "
        f"{int(fp[2].sum())} reads over WM, {int(ofc.sum())} flagged)")

    ca_t, cu_t = acc()
    ms6 = time_ms(lambda: T.sparse_fold(cp, mcnt, ofc, tt), 20)
    plain6 = time_ms(lambda: T.sparse_fold_plain(cp, mcnt, ofc, tt), 3)
    lib6 = time_ms(lambda: torch.sort(lane_keys), 20)
    turbo_stages("sparse", tt, mat, R, w, mb, eb, cap)
    ms4 = time_ms(lambda: T.turbo_multi(cp, mcnt, runs, tt, ca_t, mb, eb,
                                        counts_only=True), 10)
    plain4 = time_ms(lambda: T.turbo_multi_plain(
        cp, mcnt, runs, tt, ca_t, mb, eb, counts_only=True), 3)
    ms3 = time_ms(lambda: T.turbo_reads_pre(skey, mpay), 10) \
        + time_ms(lambda: T.turbo_reads_post(ck, cc, ofc, None, tt.weights,
                                             ca_t, cu_t, diag, cap, None,
                                             fp), 10)
    plain3 = time_ms(lambda: T.turbo_reads_pre_plain(skey, mpay), 3) \
        + time_ms(lambda: T.turbo_reads_post_plain(
            ck, cc, ofc, None, tt.weights, ca_t, cu_t, diag, cap, None,
            fp), 3)
    step_ms = time_ms(lambda: T.fused_turbo_acc(tt, mat_d, lut, ca_t, cu_t,
                                                R, w, cap, mb, eb), 10)
    kms = {"encode": time_ms(lambda: E.encode_windows(mat_d, lut, w), 20),
           "turbo_match": time_ms(lambda: T.turbo_match(q, tt, R, w), 20),
           "turbo_reads.list": ms3, "turbo_multi.counts_only": ms4,
           "sparse_fold": ms6}
    log("kernels on the sparse batch: ms "
        + json.dumps({k: round(v, 4) for k, v in kms.items()}))
    # without a hot tier every multi slot expands: the rows the batch
    # needs, and the reads flagged at 1x, 2x and 4x the expansion budget
    need = T.turbo_multi(cp, mcnt, runs, tt, ca_t, 1 << 30, 1 << 30,
                         counts_only=True)[4]
    kms["budgets"] = {"multi_slots": int(need[0]),
                      "expansion_rows": int(need[1])}
    for scale in (1, 2, 4):
        ofc_s = T.turbo_multi(cp, mcnt, runs, tt, ca_t, mb, eb * scale,
                              counts_only=True)[0]
        kms["budgets"][f"x{scale}"] = {"exp_budget": eb * scale,
                                       "count_flagged": int(ofc_s.sum())}
    log("budgets sparse: " + json.dumps(kms["budgets"]))
    log(f"step: fused_turbo_acc {step_ms:.4f} ms per {R}-read batch of the "
        "10,001-species corpus (sparse fold)")
    SW = w * nk
    t1 = ck[(ck != T.SENT) & ~ofc[:, None]]
    t1_cells = (t1 & 7).long() * S + (t1 >> 3).long()
    b3 = (2 * R * SW * 4 + R * SW * 4 + 2 * R * 4
          + R + R * T.WM * 8 + R
          + 2 * R * T.WOUT * 4 + (2 * R + 2 * cap + 4) * 4
          + 2 * 2 * sector_bytes(t1_cells, 4))
    entries = [
        kernel_entry("sparse_fold", "kasa_tpu_torch/csrc/sparse_fold.cu",
                     "kasa_tpu/match/turbo.py:870", launches["sparse_fold"],
                     err6, ms6, plain6, fold_bytes(cp, mcnt, ofc, tt), lib6,
                     "torch.sort of the (read << 24 | tax) lane keys"),
        kernel_entry("turbo_multi.counts_only",
                     "kasa_tpu_torch/csrc/turbo_multi.cu",
                     "kasa_tpu/match/turbo.py:871", launches["turbo_multi"],
                     err4, ms4, plain4,
                     multi_bytes(cp, mcnt, ofc, tt, R, S, 1, mb, True),
                     None),
        kernel_entry("turbo_reads.list", "kasa_tpu_torch/csrc/turbo_reads.cu",
                     "kasa_tpu/match/turbo.py:950", launches["turbo_reads"],
                     err3, ms3, plain3, b3, None)]
    return entries, step_ms, kms


def phase_kernels_wide(disp, corpus, launches, launches_e):
    """The five-limb arms of K1, K2 and K5 on real batches of the
    128-bit corpus against their plain versions, with their times and
    bounds; the batch step, default and --six -e."""
    import numpy as np
    import torch
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    tt = disp.tt
    dev = torch.device(DEVICE)
    nk, S = tt.num_k, tt.num_species
    mb, eb = disp.multi_budget, disp.exp_budget
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    mat, R, w, _ = real_batch(corpus, highest_k=25, min_k=20)
    mat6, _, w6, lpr = real_batch(corpus, six=True, highest_k=25, min_k=20)
    cap = disp.csr_cap(R)
    mat_d = torch.from_numpy(mat).to(dev)
    mat6_d = torch.from_numpy(mat6).to(dev)
    q = E.encode_windows(mat_d, lut, w, highest_k=25)
    same("encode.L5", q, E.encode_windows_plain(mat_d, lut, w, highest_k=25))
    skey, mpay = T.turbo_match(q, tt, R, w)
    sk2, mp2 = T.turbo_match_plain(q, tt, R, w)
    same("turbo_match.L5.skey", skey, sk2)
    same("turbo_match.L5.mpay", mpay, mp2)
    kpr6 = w6 * lpr
    q6 = E.encode_windows(mat6_d, lut, w6, highest_k=25)
    same("dedup.L5", T.dedup_windows(q6, R, kpr6),
         T.dedup_windows_plain(q6, R, kpr6))
    torch.cuda.synchronize()
    log(f"kernels wide: encode, turbo_match and dedup agree with their "
        f"plain versions in their five-limb arms (R={R}, w={w}, --six -e "
        f"kpr={kpr6}, n={tt.n:,})")
    M = q.shape[0]
    ms = {"encode.L5": time_ms(lambda: E.encode_windows(mat_d, lut, w,
                                                          highest_k=25), 20),
          "turbo_match.L5": time_ms(lambda: T.turbo_match(q, tt, R, w), 20),
          "dedup.L5": time_ms(lambda: T.dedup_windows(q6, R, kpr6), 20)}
    plain = {"encode.L5": time_ms(lambda: E.encode_windows_plain(
                 mat_d, lut, w, highest_k=25), 5),
             "turbo_match.L5": time_ms(lambda: T.turbo_match_plain(
                 q, tt, R, w), 5),
             "dedup.L5": time_ms(lambda: T.dedup_windows_plain(q6, R, kpr6),
                                 5)}
    ca_t = torch.zeros((nk, S), dtype=torch.float32, device=dev)
    cu_t = torch.zeros((nk, S), dtype=torch.int32, device=dev)
    steps = {"wide": time_ms(lambda: T.fused_turbo_acc(
                 tt, mat_d, lut, ca_t, cu_t, R, w, cap, mb, eb), 10),
             "wide_six_e": time_ms(lambda: T.fused_turbo_acc(
                 tt, mat6_d, lut, ca_t, cu_t, R, w6, cap, mb, eb,
                 lines_per_read=2, unique=True), 10)}
    log(f"step: fused_turbo_acc ms per {R}-read batch of the 128-bit corpus "
        + json.dumps({k: round(v, 4) for k, v in steps.items()}))
    nbytes = {"encode.L5": R * mat.shape[1] + M * 20,
              "turbo_match.L5": match_bytes(q, tt, R, w * nk),
              "dedup.L5": 2 * q6.numel() * 4}
    src = {"encode.L5": ("encode", "kasa_tpu/core/encode.py:71",
                         launches["encode"]),
           "turbo_match.L5": ("turbo_match", "kasa_tpu/match/turbo.py:599",
                              launches["turbo_match"]),
           "dedup.L5": ("dedup", "kasa_tpu/match/turbo.py:128",
                        launches_e["dedup"])}
    entries = [kernel_entry(name, f"kasa_tpu_torch/csrc/{src[name][0]}.cu",
                            src[name][1], src[name][2], 0.0, ms[name],
                            plain[name], nbytes[name], None)
               for name in ("encode.L5", "turbo_match.L5", "dedup.L5")]
    return entries, steps, ms


# ---------------------------------------------------------------------------
# the tiered beyond-resident path (a device budget below the tables)

# K7 launches one of its arms, picked by the chunk count
# (kernels.tiered_route_arm); tiered_drive checks that one did
TIERED_KERNELS = ("encode", "tiered_pass.prefix",
                  "tiered_pass", "turbo_reads")
ALL_HITS = 100_000      # -b: write every hit (reads tie at the third best)


def forget_tables():
    """Free the resident tables of the last run on the card."""
    import torch
    from kasa_tpu_torch.match import device as D
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match import turbo as T
    T._TT_RAM_CACHE.clear()
    D._ST_RAM_CACHE.clear()
    fast.LAST_DISPATCH = None
    torch.cuda.empty_cache()


def tiered_agree(tag, ref, got, srtol=2e-4, satol=2e-4):
    """The tiered run against the resident run of the same reads: unique
    counts identical, all-counts within rtol 2e-5 / atol 2e-3 (the level
    the CPU tests and the identify_multiple phase hold them to: both runs
    sum thousands of float32 adds per (k, taxon) cell, in another order),
    every read's taxa identical, scores within rtol 2e-4 (kasa_tpu's own
    tiered contract, tests/test_tiered.py:117-131; the classic runs are
    held to the contract's 2e-5 / 1e-4)."""
    import numpy as np
    (ra, ja), (rb, jb) = ref, got
    if ra[2:] != rb[2:]:
        fail(f"{tag}: reads / k-mers {rb[2:]} vs {ra[2:]}")
    if not np.array_equal(np.asarray(ra[1], np.int64),
                          np.asarray(rb[1], np.int64)):
        fail(f"{tag}: unique counts differ from the resident run's")
    dca = np.abs(rb[0] - ra[0])
    # the share of its allowance the worst cell uses (fails above 1)
    used = float((dca / (2e-3 + 2e-5 * np.abs(ra[0]))).max())
    if not np.isfinite(rb[0]).all() or used > 1.0:
        fail(f"{tag}: all-counts differ from the resident run's beyond rtol "
             f"2e-5 / atol 2e-3 (max abs diff {float(dca.max()):.4g}, "
             f"{used:.3g} of the allowance)")
    if len(ja) != len(jb):
        fail(f"{tag}: {len(jb)} reads written, resident {len(ja)}")
    worst = 0.0
    for x, y in zip(ja, jb):
        hx = {h["tax ID"]: float(h["k-mer Score"])
              for h in x["Top hits"] + x["Further hits"]}
        hy = {h["tax ID"]: float(h["k-mer Score"])
              for h in y["Top hits"] + y["Further hits"]}
        if set(hx) != set(hy):
            fail(f"{tag}: read {x['Read number']}: taxa differ from the "
                 "resident run's")
        for t, v in hx.items():
            if abs(hy[t] - v) > srtol * abs(v) + satol:
                fail(f"{tag}: read {x['Read number']} taxon {t}: score "
                     f"{hy[t]} vs {v}")
            worst = max(worst, abs(hy[t] - v))
    log(f"{tag}: agrees with the resident run (unique counts identical, "
        f"{len(jb)} reads' taxa identical, max score diff {worst:.3g}; "
        f"all-counts within rtol 2e-5 / atol 2e-3, max abs diff "
        f"{float(dca.max()):.4g} of counts up to "
        f"{float(np.abs(ra[0]).max()):.6g}, {used:.3g} of the allowance)")


K7_COUNTER = {"shared": "tiered_route", "global": "tiered_route.global"}


def tiered_route_arm(C):
    from kasa_tpu_torch import kernels
    return kernels.tiered_route_arm(C)


def tiered_drive(tag, index, reads, over, expect, n_reads):
    """The resident run and the tiered run (KASA_DEVICE_BUDGET =
    TIERED_BUDGET) of the same reads, every hit written, each with its
    launch counts; the tiered one's chunk and host-fixup telemetry.
    -> (tiered launches, info, dispatch)."""
    from kasa_tpu_torch.match import fast
    corpus = {"index": index}
    over = dict(over, num_of_beasts=ALL_HITS)
    stem = tag.replace(" ", "_").replace("-", "")
    outs = {}
    for kind in ("resident", "tiered"):
        forget_tables()
        if kind == "tiered":
            os.environ["KASA_DEVICE_BUDGET"] = str(TIERED_BUDGET)
        try:
            j = os.path.join(OUT, f"{stem}_{kind}.json")
            res, launches, info = drive(
                f"{tag} ({kind})", reads, j, None,
                expect if kind == "tiered" else PATH_KERNELS, over=over,
                corpus=corpus)
        finally:
            os.environ.pop("KASA_DEVICE_BUDGET", None)
        with open(j) as fh:
            outs[kind] = (res, json.load(fh))
        os.remove(j)
    disp = fast.LAST_DISPATCH
    if type(disp).__name__ != "TieredTurboDispatch":
        fail(f"{tag}: the budget did not select the tiered path")
    if launches["turbo_match"] or launches["turbo_multi"]:
        fail(f"{tag}: the tiered run launched K2/K4: {launches}")
    arm = K7_COUNTER[tiered_route_arm(len(disp.chunks))]
    if launches[arm] <= 0:
        fail(f"{tag}: K7's {arm} arm ({len(disp.chunks)} chunks) did not "
             f"launch: {launches}")
    if res[2] != n_reads:
        fail(f"{tag}: {res[2]} reads identified, expected {n_reads}")
    tiered_agree(tag, outs["resident"], outs["tiered"])
    nb = disp.batches
    info.update(chunks=len(disp.chunks), chunk_pad=disp.chunk_pad,
                chunks_on_device=len(disp._dev_chunks),
                streamed_mb_per_batch=disp.streamed_bytes / nb / 1e6,
                batches=nb, host_add_pct=100.0 * disp.host_add_reads / n_reads,
                host_rebuild_pct=100.0 * disp.host_rebuild_reads / n_reads,
                tiered_stages={k: v for k, v in info["stages"].items()
                               if k.startswith("tiered/")})
    log(f"{tag}: {info['chunks']} chunks of <= {disp.chunk_pad:,} entries, "
        f"{info['chunks_on_device']} kept on the device, "
        f"{info['streamed_mb_per_batch']:.1f} MB streamed per batch "
        f"({nb} batches of {disp.reads_per_batch}); host ADD "
        f"{disp.host_add_reads} reads ({info['host_add_pct']:.4f} %), host "
        f"list rebuild {disp.host_rebuild_reads} reads "
        f"({info['host_rebuild_pct']:.4f} %); timers "
        + json.dumps({k: round(v, 4)
                      for k, v in info["tiered_stages"].items()}))
    return launches, info, disp


def phase_tiered(corpus, big):
    """The tiered path on the default corpus (default and --six -e) and
    on the first 32,768 reads of the 10,001-species corpus."""
    from kasa_tpu_torch import synth
    N = synth.SMOKE_READS
    runs = {}
    runs["tiered"] = tiered_drive("tiered", corpus["index"], corpus["smoke"],
                                  {}, TIERED_KERNELS, N)
    runs["tiered --six -e"] = tiered_drive(
        "tiered --six -e", corpus["index"], corpus["smoke"],
        {"six_frames": True, "unique": True}, TIERED_KERNELS + ("dedup",), N)
    half = split_fastq(big["smoke"], 2,
                       os.path.join(HERE, ".synth_corpus", "bigS_half"))[0]
    runs["tiered bigS"] = tiered_drive("tiered bigS", big["index"], half, {},
                                       TIERED_KERNELS, N // 2)
    return runs


def pass_bytes(tabs, qr, vbr, posr, lo, hi, disp, R):
    """Least bytes K8 moves on one chunk's windows: the routed windows
    once, their slot rows written once, the distinct 32-byte sectors of
    rowdat (every bisect row and the two rows at the hit), of mstart at
    the multi hits' bisect midpoints and of mrow at their final index,
    of the taxa rows they expand, and of the score and count cells they
    add to (read and written), the big flags."""
    import torch
    from kasa_tpu_torch.match.tiered import TMAX
    rowdat, mstart, mrow, moff, d_tax4 = tabs[:5]
    n, mp, dr = rowdat.shape[0], mstart.shape[0], d_tax4.shape[0]
    q, vb, ps = qr[lo:hi], vbr[lo:hi], posr[lo:hi].long()
    lo_, hi_ = torch.zeros_like(ps), torch.full_like(ps, n)
    rows = []
    for _ in range(disp.num_steps):
        mid = (lo_ + hi_) >> 1
        rows.append(mid.clamp(max=n - 1))
        kk = rowdat[rows[-1]]
        less = (kk[:, 0] < q[:, 0]) | ((kk[:, 0] == q[:, 0])
                                       & (kk[:, 1] < q[:, 1]))
        lo_ = torch.where(less, mid + 1, lo_)
        hi_ = torch.where(less, hi_, mid)
    pos_c, prev = lo_.clamp(max=n - 1), (lo_ - 1).clamp(0, n - 1)
    rows += [pos_c, prev]
    at, pv = rowdat[pos_c], rowdat[prev]
    mids, grows, trows, scells, ccells = [], [], [], [], []
    moff_h = moff.tolist()
    S = disp.S
    for ki in range(disp.num_k):
        mk = disp.masks[ki].tolist()
        hit_at = lo_ < n
        hit_pv = lo_ > 0
        for i in range(2):
            if mk[i]:
                qi = q[:, i] & mk[i]
                hit_at &= (at[:, i] & mk[i]) == qi
                hit_pv &= (pv[:, i] & mk[i]) == qi
        ok = (hit_at | hit_pv) & (((vb >> ki) & 1) == 1)
        tp = torch.where(hit_pv, pv[:, 3], at[:, 3])
        tc = torch.where(ok, (tp >> (5 * ki)) & 31, torch.zeros_like(tp))
        small = (tc >= 2) & (tc <= TMAX)
        psel = torch.where(hit_pv, lo_ - 1, pos_c)[small]
        base, cnt = moff_h[ki], moff_h[ki + 1] - moff_h[ki]
        if not len(psel):
            continue
        ml, mh = torch.zeros_like(psel), torch.full_like(psel, cnt)
        for _ in range(disp.msteps):
            act = ml < mh
            mid = (ml + mh) >> 1
            idx = (base + mid).clamp(max=mp - 1)
            mids.append(idx)
            le = mstart[idx] <= psel
            ml = torch.where(act & le, mid + 1, ml)
            mh = torch.where(act & ~le, mid, mh)
        g = (base + (ml - 1).clamp(min=0)).clamp(max=mp - 1)
        grows.append(g)
        rowb = mrow[g].long()
        T = tc[small].long()
        nrow = (T + 3) >> 2
        sl = torch.repeat_interleave(torch.arange(len(T), device=q.device),
                                     nrow)
        j = torch.arange(len(sl), device=q.device) \
            - (torch.cumsum(nrow, 0) - nrow)[sl]
        tr = (rowb[sl] + j).clamp(max=dr - 1)
        trows.append(tr)
        taxa = d_tax4[tr].long()
        okt = taxa >= 0
        rid = (ps[small] // (len(posr) // R))[sl]
        scells.append((rid[:, None] * S + taxa)[okt])
        ccells.append((ki * S + taxa)[okt])
    cat = (lambda xs: torch.cat(xs) if xs else
           torch.zeros(0, dtype=torch.long, device=q.device))
    m = hi - lo
    return (m * 16 + m * disp.num_k * 4 + sector_bytes(torch.cat(rows), 16)
            + sector_bytes(cat(mids), 4) + sector_bytes(cat(grows), 4)
            + sector_bytes(cat(trows), 16)
            + 2 * sector_bytes(cat(scells), 4)
            + 2 * sector_bytes(cat(ccells), 4) + R * 4)


def phase_kernels_tiered(disp, mat, R, w, lpr, unique, launches, tag,
                         suffix=""):
    """K7, K8 (every chunk) and K3's additive arm against their plain
    versions on one real batch of a tiered run, timed, with their bounds
    and yardsticks; K8 with the chunks' prefix tables, which each upload
    builds (TieredTurboDispatch._tables).  -> (kernel entries, ms by
    kernel)."""
    import numpy as np
    import torch
    from kasa_tpu_torch import kernels as K
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import tiered as TI
    from kasa_tpu_torch.match import turbo as T
    dev = torch.device(DEVICE)
    nk, S = disp.num_k, disp.S
    kpr = w * lpr
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    q = E.encode_windows(torch.from_numpy(mat).to(dev), lut, w)
    if unique:
        q = T.dedup_windows(q, R, kpr)
    M = q.shape[0]
    l0 = disp.chunk_limb0
    # K7
    got = TI.tiered_route(q, l0, disp.min_k, disp.max_k)
    want = TI.tiered_route_plain(q, l0, disp.min_k, disp.max_k)
    for nm, a, b in zip(("qr", "vbr", "posr", "cuts"), got, want):
        same(f"tiered_route.{nm}", a, b)
    qr, vbr, posr, cuts = got
    cuts_h = cuts.tolist()
    ranges = [(c, e) for c, e in zip(cuts_h, cuts_h[1:] + [M])]
    tabs = [disp._tables(ci) for ci in range(len(disp.chunks))]
    # K8's prefix tables, the last of each chunk's device tables
    for ci, t in enumerate(tabs):
        same(f"tiered_pass.prefix (chunk {ci})", t[5],
             TI.tiered_prefix_plain(t[0]))

    def state():
        return (torch.full((M + 1, nk), T.SENT, dtype=torch.int32,
                           device=dev),
                torch.zeros(R * S + 1, device=dev),
                torch.zeros(nk * S + 1, device=dev),
                torch.zeros(R + 1, dtype=torch.int32, device=dev))

    def passes(fn, st, vb=vbr):
        for ci, (a, b) in enumerate(ranges):
            if b > a:
                fn(tabs[ci], disp.weights, qr, vb, posr, a, b, *st,
                   disp.num_steps, disp.msteps, disp.masks, disp.full, S,
                   kpr)
        return st

    # K8
    k8 = TI.tiered_pass
    sk, sp = passes(k8, state()), passes(TI.tiered_pass_plain, state())
    same("tiered_pass.skey", sk[0], sp[0])
    same("tiered_pass.big", sk[3], sp[3])
    err8 = max(close("tiered_pass.sflat", sk[1], sp[1]),
               close("tiered_pass.cflat", sk[2], sp[2]))
    # K3's additive arm (pre with cw = SW, post additive)
    cap = disp.csr_cap(R)

    def acc():
        return (torch.zeros((nk, S), device=dev),
                torch.zeros((nk, S), dtype=torch.int32, device=dev))
    (ca_k, cu_k), (ca_p, cu_p) = acc(), acc()
    fk = TI.tiered_finish(*sp, disp.weights, ca_k, cu_k, R, kpr, cap)
    SW = kpr * nk
    skv = sp[0][:R * kpr].view(R, SW)
    ck, cc, _, _, _ = T.turbo_reads_pre_plain(skv, None, cw=SW)
    ofc = sp[3][:R] > 0
    dm = sp[1][:R * S].view(R, S)
    zero2 = torch.zeros(2, dtype=torch.int32, device=dev)
    wm = min(S, 256)
    fp = T.turbo_reads_post_plain(ck, cc, ofc, dm, disp.weights, ca_p, cu_p,
                                  zero2, cap, wm=wm, additive=True,
                                  cadd=sp[2][:nk * S])
    pk, pp = fk[0].cpu(), fp[0].cpu()
    ints = torch.ones(len(pk), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    same("turbo_reads.additive.packed", pk[ints], pp[ints])
    same("turbo_reads.additive.ht", fk[1], fp[1])
    same("turbo_reads.additive.acc_cu", cu_k, cu_p)
    err3 = max(close("turbo_reads.additive.ksum",
                     pk[~ints].view(torch.float32),
                     pp[~ints].view(torch.float32)),
               close("turbo_reads.additive.hk", fk[2], fp[2]),
               close("turbo_reads.additive.acc_ca", ca_k, ca_p))
    torch.cuda.synchronize()
    flags = pp[R:2 * R]
    log(f"kernels {tag}: tiered_route, tiered_pass ({len(ranges)} chunks) "
        f"and turbo_reads (additive) agree with their plain versions on a "
        f"{R}-read batch (M={M}, SW={SW}, S={S}, big reads "
        f"{int((flags & 1).sum())}, rebuilt {int((flags >> 1 & 1).sum())}, "
        f"hits {int(pp[-2])})")

    # times, kernel reps then plain reps on the same inputs
    st = state()
    ca_t, cu_t = acc()
    ms = {"tiered_route": time_ms(lambda: TI.tiered_route(
              q, l0, disp.min_k, disp.max_k), 20),
          "tiered_pass": time_ms(lambda: passes(k8, st), 10),
          "turbo_reads.additive": time_ms(lambda: TI.tiered_finish(
              *sp, disp.weights, ca_t, cu_t, R, kpr, cap), 10)}
    # K8's search alone: no validity bit set, so no level matches and
    # nothing expands
    no_level = torch.zeros_like(vbr)
    search_ms = time_ms(lambda: passes(k8, state(), no_level), 10)
    log(f"kernel tiered_pass{suffix}: search (prefix table, bisect, the two "
        f"rows) {search_ms:.4f} ms, levels and expansion "
        f"{ms['tiered_pass'] - search_ms:.4f} ms of {ms['tiered_pass']:.4f}"
        f" ms over {len(ranges)} chunks")
    ms["tiered_pass.prefix"] = time_ms(
        lambda: [K.tiered_prefix(t[0]) for t in tabs], 10)
    plain_pfx = time_ms(lambda: [TI.tiered_prefix_plain(t[0]) for t in tabs],
                        10)
    # the one torch.searchsorted of tiered_prefix_plain: every bucket's
    # first key over each chunk's limb 0
    limb0 = [t[0][:, 0].long().contiguous() for t in tabs]
    bucket_keys = [int(t[5][-2]) + (torch.arange(
        (1 << TI.PREFIX_BITS) + 1, dtype=torch.int64, device=dev)
        << int(t[5][-1])) for t in tabs]
    lib_pfx = time_ms(lambda: [torch.searchsorted(x, k) for x, k in
                               zip(limb0, bucket_keys)], 10)
    plain = {"tiered_route": time_ms(lambda: TI.tiered_route_plain(
                 q, l0, disp.min_k, disp.max_k), 3),
             "tiered_pass": time_ms(lambda: passes(TI.tiered_pass_plain, st),
                                    2),
             "turbo_reads.additive": time_ms(
                 lambda: T.turbo_reads_post_plain(
                     *T.turbo_reads_pre_plain(skv, None, cw=SW)[:2], ofc, dm,
                     disp.weights, ca_t, cu_t, zero2, cap, wm=wm,
                     additive=True, cadd=sp[2][:nk * S]), 2)}
    keys = (q[:, 0].long() << 30) | q[:, 1].long()
    lib_route = time_ms(lambda: torch.sort(keys), 20)
    chunk_keys = [((t[0][:, 0].long() << 30) | t[0][:, 1].long())
                  for t in tabs]
    qkeys = (qr[:, 0].long() << 30) | qr[:, 1].long()

    def searches():
        for ci, (a, b) in enumerate(ranges):
            if b > a:
                torch.searchsorted(chunk_keys[ci], qkeys[a:b])
    lib_pass = time_ms(searches, 10)
    # the step as the main path queues it (tables on the device)
    step_ms = ms["tiered_route"] + ms["tiered_pass"] \
        + ms["turbo_reads.additive"] + time_ms(
            lambda: E.encode_windows(torch.from_numpy(mat).to(dev), lut, w),
            10)
    t1 = ck[ck != T.SENT]
    t1_cells = (t1 & 7).long() * S + (t1 >> 3).long()
    plain["tiered_pass.prefix"] = plain_pfx
    nbytes = {
        # the tables written, and the rows where each bucket starts
        "tiered_pass.prefix": sum(4 * t[5].numel() + sector_bytes(
            t[5][:-2][t[5][:-2] < t[0].shape[0]].long(), 16) for t in tabs),
        "tiered_route": M * 8 + M * 16 + l0.numel() * 4 * 2,
        "tiered_pass": sum(pass_bytes(tabs[ci], qr, vbr, posr, a, b, disp, R)
                           for ci, (a, b) in enumerate(ranges) if b > a),
        # skey rows and the big flags in, the (R, S) score rows, acc_ca
        # read and written whole with cflat added, acc_cu at the T1 cells
        # (read and written), ht / hk and the packed readback out; the
        # (R, SW) runs pre hands post stay inside the function
        "turbo_reads.additive": (R * SW * 4 + R * 4 + R * S * 4
                                 + 3 * nk * S * 4
                                 + 2 * sector_bytes(t1_cells, 4)
                                 + 2 * R * T.WOUT * 4
                                 + (2 * R + 2 * cap + 4) * 4),
    }
    src = {"tiered_route": ("tiered_route", "kasa_tpu/match/tiered.py:140",
                            lib_route, "torch.sort of the 60-bit keys"),
           "tiered_pass": ("tiered_pass", "kasa_tpu/match/tiered.py:201",
                           lib_pass, "torch.searchsorted in each chunk's "
                           "keys"),
           "turbo_reads.additive": ("turbo_reads",
                                    "kasa_tpu/match/tiered.py:354", None,
                                    ""),
           "tiered_pass.prefix": ("tiered_pass",
                                  "kasa_tpu/match/tiered.py:201", lib_pfx,
                                  "torch.searchsorted of the bucket starts")}
    entries = []
    for name in ("tiered_route", "tiered_pass.prefix", "tiered_pass",
                 "turbo_reads.additive"):
        f, rep, lib, note = src[name]
        err = {"tiered_route": 0.0, "tiered_pass.prefix": 0.0,
               "tiered_pass": err8, "turbo_reads.additive": err3}[name]
        counter = name if name == "tiered_pass.prefix" else f
        label = name
        if name == "tiered_route":
            # the arm the wrapper takes for this run's chunks
            counter = label = K7_COUNTER[tiered_route_arm(l0.numel())]
        entries.append(kernel_entry(
            label + suffix, f"kasa_tpu_torch/csrc/{f}.cu", rep,
            launches[counter], err, ms[name], plain[name], nbytes[name], lib,
            note))
    log(f"step {tag}: K1 + K7 + K8 over {len(ranges)} chunks + K3 additive "
        f"{step_ms:.4f} ms per {R}-read batch with every chunk on the "
        "device")
    # K3's additive arm, pre and post apart
    pre_ms = time_ms(lambda: T.turbo_reads_pre(skv, None, cw=SW,
                                               num_species=S), 10)
    post_ms = time_ms(lambda: T.turbo_reads_post(
        ck, cc, ofc, dm, disp.weights, ca_t, cu_t, zero2, cap, wm=wm,
        additive=True, cadd=sp[2][:nk * S]), 10)
    STAGES[tag] = {"additive_pre": pre_ms, "additive_post": post_ms,
                   "slots": slot_stats(skv)}
    log(f"stages {tag}: K3 additive pre {pre_ms:.4f} ms, post "
        f"{post_ms:.4f} ms; " + json.dumps(STAGES[tag]))
    if not suffix:
        entries.append(route_global_entry(q))
    return entries, dict(ms, step=step_ms)


ROUTE_CHUNKS = 20_000     # K7's global arm: a synthetic chunk plan


def route_global_entry(q):
    """K7's global arm on a tiered batch's windows over ROUTE_CHUNKS
    synthetic chunk starts (route_chunks), against its plain version,
    timed, with torch.sort of the windows' 60-bit keys as its yardstick;
    no run of this script has that many chunks, so its launches on a
    path are 0.  -> the kernel entry."""
    import torch
    from kasa_tpu_torch import kernels as K
    from kasa_tpu_torch.match import tiered as TI
    l0 = route_chunks(q, ROUTE_CHUNKS)
    C, M = l0.numel(), q.shape[0]
    K.reset_counts()
    got = TI.tiered_route(q, l0, 7, 12)
    if K.COUNTS["tiered_route.global"] != 1:
        fail(f"tiered_route at C={C}: the global arm did not launch")
    want = TI.tiered_route_plain(q, l0, 7, 12)
    for nm, a, b in zip(("qr", "vbr", "posr", "cuts"), got, want):
        same(f"tiered_route.global.{nm}", a, b)
    ms = time_ms(lambda: TI.tiered_route(q, l0, 7, 12), 10)
    plain_ms = time_ms(lambda: TI.tiered_route_plain(q, l0, 7, 12), 3)
    keys = (q[:, 0].long() << 30) | q[:, 1].long()
    lib = time_ms(lambda: torch.sort(keys), 10)
    log(f"kernel tiered_route.global: {M} windows over {C} chunks")
    return kernel_entry("tiered_route.global",
                        "kasa_tpu_torch/csrc/tiered_route.cu",
                        "kasa_tpu/match/tiered.py:184", 0, 0.0, ms, plain_ms,
                        M * 8 + M * 16 + C * 4 * 2, lib,
                        "torch.sort of the 60-bit keys")


# ---------------------------------------------------------------------------
# the join and exact engines, --visualize, the per-batch engine over -m

JOIN_KERNELS = ("encode", "query_sort", "join_match", "join_scatter")
OOCORE_MEM = 700 << 20    # -m of the oocore phase: 6 chunks
OOCORE_PAIRS = 8_192


def expect_only(tag, counts, want):
    """The run launched every kernel of `want` and no other."""
    expect_launched(tag, counts, want)
    bad = {k: v for k, v in counts.items() if v and k not in want}
    if bad:
        fail(f"{tag}: launched {bad} besides {want}")


def golden_run(index, inp, over, stem, dev, env=None):
    """identify on the golden index family (tests/golden/<index>, or a
    path) -> (launches, stdout, output path, profile path)."""
    import contextlib
    import io
    import torch
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.host.output import file_ending
    from kasa_tpu_torch.match.pipeline import identify
    gold = os.path.join(HERE, "tests", "golden")
    cfg = Config()
    cfg.content_file = os.path.join(gold, "exampleIndex_content.txt")
    for k, v in dict(over).items():
        setattr(cfg, k, v)
    out = os.path.join(OUT, f"{stem}_{dev}" + file_ending(cfg.output_format))
    prof = os.path.join(OUT, f"{stem}_{dev}.csv")
    for k, v in dict(env or {}).items():
        os.environ[k] = v
    buf = io.StringIO()
    kernels.reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            identify(cfg, index_path=os.path.join(gold, index),
                     input_path=inp, out_file=out, profile_file=prof,
                     device=dev)
    finally:
        for k in dict(env or {}):
            os.environ.pop(k, None)
    if dev != "cpu":
        torch.cuda.synchronize()
    return dict(kernels.COUNTS), buf.getvalue(), out, prof


def same_file(tag, a, b):
    import filecmp
    if not filecmp.cmp(a, b, shallow=False):
        fail(f"{tag}: {os.path.basename(a)} differs from {b}")


def json_file_agrees(tag, ref, got):
    with open(ref) as f1, open(got) as f2:
        r, g = json.load(f1), json.load(f2)
    if not r:
        fail(f"{tag}: no reads written")
    json_agrees(r, g)


# the cases of tests/test_identify_parity.py:20-42 (and its paired case):
# tag, input, golden output, golden profile, Config overrides
PARITY_CASES = (
    ("default", "reads.fastq", "reads_identify.json", "reads_profile.csv",
     {}),
    ("tsv", "reads.fastq", "reads_identify.tsv", "reads_profile_tsv.csv",
     {"output_format": "tsv"}),
    ("jsonl", "reads.fastq", "reads_identify.jsonl", None,
     {"output_format": "jsonl"}),
    ("kraken", "reads.fastq", "reads_identify.ktsv", None,
     {"output_format": "kraken"}),
    ("k12", "reads.fastq", "reads_k12.json", "reads_k12_profile.csv",
     {"lower_k": 12, "higher_k": 12}),
    ("six", "reads.fastq", "reads_six.json", "reads_six_profile.csv",
     {"six_frames": True}),
    ("one", "reads.fastq", "reads_one.json", "reads_one_profile.csv",
     {"one_frame": True}),
    ("unique", "reads.fastq", "reads_unique.json", "reads_unique_profile.csv",
     {"unique": True}),
    ("fasta", "reads.fasta", "reads_fasta.json", "reads_fasta_profile.csv",
     {}),
    # tests/golden/reads_gz.json is empty: the reads are reads.fastq's
    ("gz", "reads.fastq.gz", "reads_identify.json", None, {}),
    ("edge", "edge.fasta", "edge.json", "edge_profile.csv", {}),
    ("coverage", "reads.fastq", "reads_cov.json", "reads_cov_profile.csv",
     {"coverage": True}),
    ("paired", "", "reads_paired.json", "reads_paired_profile.csv",
     {"paired_end_1": "reads_1.fastq", "paired_end_2": "reads_2.fastq"}),
)


def phase_golden_engines():
    """The join and exact engines, --visualize, the over-budget routes
    (F1 and oocore) on the golden fixtures, on the card: byte for byte
    against the reference binary's goldens where the engine gives them
    (the exact engine's outputs; every profile of the join engine, whose
    float64 group sums are the exact engine's; --visualize), else under
    the contract against the goldens or the port's CPU run of the same
    call.  -> the launches of the --coverage run."""
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.oocore import TieredIndex
    gold = os.path.join(HERE, "tests", "golden")
    fix = os.path.join(HERE, "fixtures")

    def g(name):
        return os.path.join(gold, name)

    def fixture_over(over):
        return {k: (os.path.join(fix, v) if k.startswith("paired") else v)
                for k, v in over.items()}
    done = []
    # --coverage on the default engine: the join engine
    cov, text, out, prof = golden_run(
        "exampleIndex", os.path.join(fix, "reads.fastq"),
        {"coverage": True}, "ge_cov", DEVICE)
    if "OUT: --coverage uses the join engine" not in text:
        fail("--coverage did not take the join engine")
    expect_only("--coverage", cov, JOIN_KERNELS)
    same_file("--coverage", prof, g("reads_cov_profile.csv"))
    json_file_agrees("--coverage", g("reads_cov.json"), out)
    done.append("--coverage")
    for engine in ("exact", "join"):
        for tag, inp, gout, gprof, over in PARITY_CASES:
            if engine == "join" and not gout.endswith(".json"):
                continue        # the writer's formats: the exact engine
            t = f"--engine {engine} {tag}"
            counts, _, out, prof = golden_run(
                "exampleIndex", os.path.join(fix, inp) if inp else "",
                dict(fixture_over(over), engine=engine),
                f"ge_{engine}_{tag}", DEVICE)
            expect_only(t, counts, ("encode",) if engine == "exact"
                        else JOIN_KERNELS)
            if engine == "exact":
                same_file(t, out, g(gout))
            else:
                json_file_agrees(t, g(gout), out)
            if gprof:
                same_file(t, prof, g(gprof))
            done.append(t)
    # --visualize: the per-batch engine and the reference's print
    counts, text, _, _ = golden_run(
        "exampleIndex", os.path.join(fix, "one_read.fastq"),
        {"visualize": True}, "ge_vis", DEVICE)
    with open(g("visualize_one_read.txt")) as fh:
        if text != fh.read():
            fail("--visualize: the print differs from "
                 "tests/golden/visualize_one_read.txt")
    expect_only("--visualize", counts, CLASSIC_KERNELS)
    done.append("--visualize")
    # the 128-bit index at -k 25 20: the exact engine's walk and the join
    # engine, each against the port's CPU run
    for engine in ("exact", "join"):
        t = f"128-bit k 20..25 --engine {engine}"
        over = {"lower_k": 20, "higher_k": 25, "engine": engine}
        res = {dev: golden_run("exampleIndex128",
                               os.path.join(fix, "reads.fastq"), over,
                               f"ge128_{engine}", dev)
               for dev in (DEVICE, "cpu")}
        expect_only(t, res[DEVICE][0], ("encode",) if engine == "exact"
                    else JOIN_KERNELS)
        same_file(t, res[DEVICE][3], res["cpu"][3])
        if engine == "exact":
            same_file(t, res[DEVICE][2], res["cpu"][2])
        else:
            json_file_agrees(t, res["cpu"][2], res[DEVICE][2])
        done.append(t)
    # F1: an over-budget index the tiered path cannot take keeps resident
    # turbo tables, as in kasa_tpu: the same outputs as without a budget
    for index, over in (("exampleIndex128", {"lower_k": 20, "higher_k": 25}),
                        ("exampleIndex", {"lower_k": 5, "higher_k": 10})):
        t = f"over budget {index} k {over['lower_k']}..{over['higher_k']}"
        over = dict(over, num_of_beasts=ALL_HITS)
        inp = os.path.join(fix, "reads.fastq")
        ref = golden_run(index, inp, over, "ge_f1_ref", DEVICE)
        got = golden_run(index, inp, over, "ge_f1", DEVICE,
                         env={"KASA_DEVICE_BUDGET": "1"})
        if type(fast.LAST_DISPATCH).__name__ != "SingleTurboDispatch":
            fail(f"{t}: {type(fast.LAST_DISPATCH).__name__}, expected "
                 "resident turbo tables")
        expect_launched(t, got[0], PATH_KERNELS)
        same_file(t, got[3], ref[3])
        json_file_agrees(t, ref[2], got[2])
        done.append(t)
    # the per-batch engine over -m (oocore): -j on the sloppy-reduced
    # index, paired input under KASA_TPU_NO_TURBO; K9 once per chunk per
    # batch; the same outputs as the resident per-batch run
    red = reduced_index(OUT)
    for t, index, inp, over, env in (
            ("-j over -m", red, os.path.join(fix, "reads.fastq"),
             {"sloppy": True}, None),
            ("paired no-turbo over -m", "exampleIndex", "",
             fixture_over({"paired_end_1": "reads_1.fastq",
                           "paired_end_2": "reads_2.fastq"}),
             {"KASA_TPU_NO_TURBO": "1"})):
        over = dict(over, num_of_beasts=ALL_HITS)
        ref = golden_run(index, inp, over, "ge_oo_ref", DEVICE, env=env)
        got = golden_run(index, inp, dict(over, memory_avail=1 << 20,
                                          temp_path=OUT, call_idx=61),
                         "ge_oo", DEVICE, env=env)
        disp = fast.LAST_DISPATCH
        if not isinstance(disp, TieredIndex):
            fail(f"{t}: the run did not stream index chunks")
        expect_only(t, got[0], CLASSIC_KERNELS)
        if k9_launches(t, got[0]) != len(disp.chunks) * disp.batches:
            fail(f"{t}: {k9_launches(t, got[0])} K9 launches for "
                 f"{len(disp.chunks)} chunks x {disp.batches} batches")
        same_file(t, got[3], ref[3])
        json_file_agrees(t, ref[2], got[2])
        done.append(t)
    log(f"golden-engines: {len(done)} runs on the card agree: "
        + ", ".join(done) + f"; --coverage launches "
        + json.dumps({k: v for k, v in cov.items() if v}))
    return cov


class FirstCall:
    """Records the arguments of the first call of module.name (the first
    batch a run hands an engine) while the run goes on unchanged."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = None

    def __enter__(self):
        def wrapped(*a, **k):
            if self.args is None:
                self.args = a
            return self.orig(*a, **k)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_join(tag, index, inp, over, n_reads):
    """The turbo run and the join engine's run (--engine join, or
    --coverage on the default engine) of the same reads, every hit
    written: hit taxa and unique counts identical, all-counts within rtol
    2e-5 / atol 2e-3, scores within the contract.  -> (join launches,
    info, the join run's first batch)."""
    from kasa_tpu_torch.match import join as J
    corpus = {"index": index}
    over = dict(over, num_of_beasts=ALL_HITS)
    stem = tag.replace(" ", "_").replace("-", "")
    outs = {}
    for kind in ("turbo", "join"):
        j = os.path.join(OUT, f"{stem}_{kind}.json")
        p = os.path.join(OUT, f"{stem}_{kind}.csv") if kind == "join" \
            else None
        with FirstCall(J, "match_and_score") as first:
            res, launches, info = drive(
                f"{tag} ({kind})", inp, j, p,
                PATH_KERNELS if kind == "turbo" else JOIN_KERNELS,
                over=over if kind == "turbo" else dict(
                    over, engine="join", coverage=True), corpus=corpus)
        with open(j) as fh:
            outs[kind] = (res, json.load(fh))
        os.remove(j)
    expect_only(tag, launches, JOIN_KERNELS)
    if res[2] != n_reads:
        fail(f"{tag}: {res[2]} reads identified, expected {n_reads}")
    with open(p) as fh:
        head = fh.readline()
    if "Genome Coverage" not in head:
        fail(f"{tag}: the profile has no coverage columns")
    tiered_agree(f"{tag} join", outs["turbo"], outs["join"], RTOL, ATOL)
    info["join_stages"] = {k: v for k, v in info["stages"].items()
                           if k.startswith(("join/", "identify/"))}
    info["batches"] = launches["join_match"]
    log(f"{tag}: {info['batches']} batches; host stages "
        + json.dumps(info["join_stages"]))
    return launches, info, first.args


def join_match_bytes(t, q, out):
    """Least bytes K10 moves: the queries, the prefix entries, the
    distinct index sectors of the search and the run_end entries it
    reads, the grp_id cells of the matched levels, the grp_start cells
    (g and g + 1 of the matched, entry 0 of the unmatched), the masks,
    and the five (numK, M) outputs once."""
    import torch
    n, M, L, nk = t.n, q.shape[0], q.shape[1], t.num_k
    pos, idx_sec, b, runs = search_sectors(t, q)
    matched, g = out[0], out[1]
    at = pos.clamp(max=n - 1)
    gid, gst = [], []
    for ki in range(nk):
        m = matched[ki]
        eq_at = m & (pos < n) & ((t.idx_limbs[at] & t.masks[ki])
                                 == (q & t.masks[ki])).all(1)
        e = torch.where(eq_at, pos, pos - 1)[m]
        gid.append(ki * n + e)
        gk = g[ki][m].long()
        gst.append(ki * t.grp_start.shape[1] + torch.cat(
            [gk, gk + 1, torch.zeros(1, dtype=torch.long, device=q.device)]))
    cat = torch.cat
    return (M * L * 4 + sector_bytes(cat([b, b + 1]), 4)
            + 32 * int(idx_sec.numel()) + sector_bytes(runs, 4)
            + sector_bytes(cat(gid), 4) + sector_bytes(cat(gst), 4)
            + nk * L * 4 + nk * M * (1 + 4 + 4 + 4 + 1))


def scatter_pairs(t, valid, T, start, read_ids):
    """Every (occurrence, taxon) pair K11 adds -> (flat score cells,
    float32 values, d_tax cells): the expansion, for the bound and for
    the index_put_ yardstick."""
    import torch
    dev = read_ids.device
    S = t.num_species
    cells, vals, dcells = [], [], []
    for ki in range(t.num_k):
        idx = torch.nonzero(valid[ki])[:, 0]
        Tv = T[ki][idx].long()
        pair = torch.repeat_interleave(torch.arange(len(idx), device=dev),
                                       Tv)
        j = torch.arange(len(pair), device=dev) \
            - (torch.cumsum(Tv, 0) - Tv)[pair]
        dc = start[ki][idx].long()[pair] + j
        tax = t.d_tax[ki][dc].long()
        cells.append(read_ids[idx].long()[pair] * S + tax)
        vals.append((t.weights[ki] * (1.0 / Tv.float()))[pair])
        dcells.append(ki * t.d_tax.shape[1] + dc)
    return torch.cat(cells), torch.cat(vals), torch.cat(dcells)


def phase_kernels_join(t, batch, launches, suffix, what):
    """K12, K10 and K11 on the first batch of a join run, in the engine's
    order, each against its plain version (integers identical, scores
    within the contract), timed with CUDA events after a warm-up, with
    its bound and, where one exists, a PyTorch call as yardstick.
    -> (kernel entries, the three kernels' ms per batch, K12's read-id
    arm and stage times)."""
    import numpy as np
    import torch
    from kasa_tpu_torch.match import join as J
    q_np, r_np, R = batch[1], batch[2], batch[3]
    d = torch.device(DEVICE)
    q = torch.from_numpy(np.ascontiguousarray(q_np, np.int32)).to(d)
    r = torch.from_numpy(np.ascontiguousarray(r_np, np.int32)).to(d)
    M, L = q.shape
    # K12 as the join path calls it (the batch's read ids ascend: the
    # limbs alone), then its read-id arm on the same batch; the plain
    # version sorts by (limbs, read id) in both
    qs, rs = J.sort_queries(q, r, R, ids_ascending=True)
    pq, pr = J.sort_queries_plain(q, r)
    same(f"query_sort{suffix}.limbs", qs, pq)
    same(f"query_sort{suffix}.read_ids", rs, pr)
    q2, r2 = J.sort_queries(q, r, R)
    same(f"query_sort{suffix}.rid_arm.limbs", q2, pq)
    same(f"query_sort{suffix}.rid_arm.read_ids", r2, pr)
    del q2, r2
    ms12 = time_ms(lambda: J.sort_queries(q, r, R, ids_ascending=True), 10)
    rid_bits = max(R - 1, 0).bit_length()
    k12 = {"ms_rid_arm": time_ms(lambda: J.sort_queries(q, r, R), 10),
           "rid_bits": rid_bits,
           "stages_ms": k12_stages(q, r, 0),
           "stages_ms_rid_arm": k12_stages(q, r, rid_bits)}
    plain12 = time_ms(lambda: J.sort_queries_plain(q, r), 3)
    lib12 = None
    if L == 2:
        keys = (q[:, 0].long() << 30) | q[:, 1].long()
        lib12 = time_ms(lambda: torch.sort(keys, stable=True), 10)
    log(f"kernel query_sort{suffix}: the read-id arm ({rid_bits} bits) "
        f"{k12['ms_rid_arm']:.4f} ms; stage ms (histogram and scan, then "
        f"each pass): ids ascending {k12['stages_ms']}, read-id arm "
        f"{k12['stages_ms_rid_arm']}")
    # K10
    got = J.join_match(t, qs)
    want = J.join_match_plain(t, qs)
    for name, a, b in zip(("matched", "g", "T", "start", "ok"), got, want):
        same(f"join_match{suffix}.{name}", a, b)
    ms10 = time_ms(lambda: J.join_match(t, qs), 10)
    plain10 = time_ms(lambda: J.join_match_plain(t, qs), 3)
    lib10 = None
    if L == 2:
        k64 = (t.idx_limbs[:, 0].long() << 30) | t.idx_limbs[:, 1].long()
        q64 = (qs[:, 0].long() << 30) | qs[:, 1].long()
        lib10 = time_ms(lambda: torch.searchsorted(k64, q64), 10)
    # K11
    matched, g, T, start, ok = want
    valid = matched & ok
    s1 = J.join_scatter(t, valid, T, start, rs, R)
    s2 = J.join_scatter_plain(t, valid, T, start, rs, R)
    same(f"join_scatter{suffix}.hit_cells", s1 > 0, s2 > 0)
    err11 = close(f"join_scatter{suffix}.scores", s1, s2)
    ms11 = time_ms(lambda: J.join_scatter(t, valid, T, start, rs, R), 10)
    plain11 = time_ms(lambda: J.join_scatter_plain(t, valid, T, start, rs,
                                                   R), 3)
    cells, vals, dcells = scatter_pairs(t, valid, T, start, rs)
    acc = torch.zeros(R * t.num_species, dtype=torch.float32, device=d)
    lib11 = time_ms(lambda: acc.index_put_((cells,), vals, accumulate=True),
                    10)
    occ = torch.nonzero(valid.reshape(-1))[:, 0]
    nk, S = t.num_k, t.num_species
    bytes11 = (nk * M + 2 * sector_bytes(occ, 4)
               + sector_bytes(occ % M, 4) + sector_bytes(dcells, 4)
               + nk * 4 + R * S * 4)
    torch.cuda.synchronize()
    log(f"kernels join{suffix}: query_sort, join_match and join_scatter "
        f"agree with their plain versions on the first batch of the {what} "
        f"({R} reads, M={M:,} windows, L={L}, {nk} levels, n={t.n:,}, "
        f"S={S}; valid occurrences {int(valid.sum()):,}, (occurrence, "
        f"taxon) pairs {cells.numel():,}, largest T {int(T.max())})")
    log(f"yardstick for K9: join_match + join_scatter{suffix} "
        f"{1e6 * (ms10 + ms11) / M:.4f} ns a window, with query_sort "
        f"{1e6 * (ms12 + ms10 + ms11) / M:.4f} ns ({M:,} windows sorted "
        "by key)")
    e = [kernel_entry(f"query_sort{suffix}",
                      "kasa_tpu_torch/csrc/query_sort.cu",
                      "kasa_tpu/match/join.py:225", launches["query_sort"],
                      0.0, ms12, plain12, 2 * M * (L + 1) * 4, lib12,
                      "torch.sort(stable=True) of the 60-bit keys"),
         kernel_entry(f"join_match{suffix}",
                      "kasa_tpu_torch/csrc/join_match.cu",
                      "kasa_tpu/match/join.py:175", launches["join_match"],
                      0.0, ms10, plain10, join_match_bytes(t, qs, want),
                      lib10, "torch.searchsorted over the 60-bit keys"),
         kernel_entry(f"join_scatter{suffix}",
                      "kasa_tpu_torch/csrc/join_scatter.cu",
                      "kasa_tpu/match/join.py:200", launches["join_scatter"],
                      err11, ms11, plain11, bytes11, lib11,
                      "index_put_(accumulate=True) of the expanded pairs")]
    return e, ms12 + ms10 + ms11, k12


def k12_stages(q, r, rid_bits):
    """K12's stage times on (q, r) over rid_bits bits of the read ids, in
    ms: the memset, histogram and scan launches, then each digit pass
    (CUDA events between the launches; the second of two calls)."""
    import torch
    from kasa_tpu_torch import kernels
    passes, _ = kernels.query_sort_plan(q.shape[0], q.shape[1], rid_bits)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(passes + 2)]
    for _ in range(2):
        kernels.query_sort(q, r, rid_bits, marks=marks)
        torch.cuda.synchronize()
    return [round(marks[i].elapsed_time(marks[i + 1]), 4)
            for i in range(passes + 1)]


def phase_oocore(corpus):
    """The per-batch engine over -m on the default corpus: 8,192 read
    pairs under KASA_TPU_NO_TURBO with a memory budget of OOCORE_MEM
    (index chunks of ~5.6 M entries), against the resident per-batch run
    (-r) of the same pairs (integers identical, floats within the
    contract); chunks, MB uploaded per batch, and K9 on every chunk held
    to its plain version and timed.  -> (launches, info, kernel
    entry)."""
    import numpy as np
    import torch
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.oocore import TieredIndex, bytes_per_entry
    from kasa_tpu_torch.match.pipeline import load_content_for_identify
    pairs = []
    for i, src in enumerate(corpus["pairs"]):
        pairs.append(os.path.join(OUT, f"oocore_{i + 1}.fastq"))
        with open(src, "rb") as f1, open(pairs[-1], "wb") as f2:
            for _ in range(4 * OOCORE_PAIRS):
                f2.write(f1.readline())
    over = {"paired_end_1": pairs[0], "paired_end_2": pairs[1],
            "memory_avail": OOCORE_MEM, "num_of_beasts": ALL_HITS,
            "temp_path": OUT, "call_idx": 6}
    # the chunk cache, built once per index before the timed run
    t0 = time.perf_counter()
    content = load_content_for_identify(corpus["index"] + "_content.txt")
    TieredIndex(corpus["index"], content.tax_to_idx, 7, 12,
                content.num_species,
                max(int(OOCORE_MEM * 0.8) // bytes_per_entry(2, 6), 1 << 16),
                "cpu", cache_dir=os.path.join(OUT, "oocache_torch_6"))
    build_s = time.perf_counter() - t0
    os.environ["KASA_TPU_NO_TURBO"] = "1"
    outs = {}
    try:
        for kind in ("resident", "oocore"):
            j = os.path.join(OUT, f"oocore_{kind}.json")
            with FirstCall(TieredIndex, "classify") as first:
                res, launches, info = drive(
                    f"oocore ({kind})", "", j, None, CLASSIC_KERNELS,
                    over=dict(over, ram=kind == "resident"), corpus=corpus,
                    unit="pairs")
            with open(j) as fh:
                outs[kind] = (res, json.load(fh))
            os.remove(j)
    finally:
        os.environ.pop("KASA_TPU_NO_TURBO", None)
    disp = fast.LAST_DISPATCH
    if not isinstance(disp, TieredIndex) or not 4 <= len(disp.chunks) <= 8:
        fail(f"oocore: {type(disp).__name__}, expected 4-8 index chunks")
    expect_only("oocore", launches, CLASSIC_KERNELS)
    if k9_launches("oocore", launches) != len(disp.chunks) * disp.batches:
        fail(f"oocore: {k9_launches('oocore', launches)} K9 launches for "
             f"{len(disp.chunks)} chunks x {disp.batches} batches")
    if res[2] != OOCORE_PAIRS:
        fail(f"oocore: {res[2]} pairs identified, expected {OOCORE_PAIRS}")
    tiered_agree("oocore", outs["resident"], outs["oocore"], RTOL, ATOL)
    info.update(chunks=len(disp.chunks), batches=disp.batches,
                chunk_build_s=build_s,
                uploaded_mb_per_batch=disp.uploaded_bytes / disp.batches
                / 1e6,
                oocore_stages={k: v for k, v in info["stages"].items()
                               if k.startswith("oocore/")})
    # K9 per chunk on the run's first batch (scatter layout)
    _, q_np, r_np, R = first.args[:4]
    d = torch.device(DEVICE)
    q = torch.from_numpy(np.ascontiguousarray(q_np, np.int32)).to(d)
    r = torch.from_numpy(np.ascontiguousarray(r_np, np.int32)).to(d)
    v = torch.ones(q.shape[0], dtype=torch.bool, device=d)
    chunk_ms, chunk_plain, chunk_bytes, err = [], [], 0, 0.0
    for ci, t in enumerate(disp.device_tables()):
        e, ms, plain, nbytes = k9_against_plain(
            t, q, r, v, R, 0, ".oocore", f"oocore run (chunk {ci} of "
            f"{len(disp.chunks)}, n={t.n:,}, scatter layout)")
        err = max(err, e)
        chunk_ms.append(ms)
        chunk_plain.append(plain)
        chunk_bytes += nbytes
        del t
    info["k9_ms_per_chunk"] = chunk_ms
    log(f"oocore: {len(disp.chunks)} chunks ({disp.chunks[:2]} ...), "
        f"chunk cache built in {build_s:.1f} s, {disp.batches} batches, "
        f"{info['uploaded_mb_per_batch']:.1f} MB uploaded per batch; K9 "
        f"ms per chunk {[round(x, 4) for x in chunk_ms]} (plain "
        f"{[round(x, 4) for x in chunk_plain]}); timers "
        + json.dumps({k: round(x, 4) for k, x in
                      info["oocore_stages"].items()}))
    entry = kernel_entry(
        "classic_classify.oocore", "kasa_tpu_torch/csrc/classic_classify.cu",
        "kasa_tpu/match/oocore.py:203", k9_launches("oocore", launches), err,
        sum(chunk_ms), sum(chunk_plain), chunk_bytes, None)
    return launches, info, entry


# ---------------------------------------------------------------------------
# long read lines (K3's and K5's long arms), the index build (K13) and
# the other CLI modes

LONG_KERNELS = ("encode", "turbo_match", "turbo_reads",
                "turbo_reads.long_smem", "turbo_multi")
# K3 pre's long arms: the shared-memory arm while a batch's rows fit one
# block, else the global arm
LONG_ARMS = ("turbo_reads.long_smem", "turbo_reads.long")
LONG_CPU_READS = 256      # long reads held to the port's CPU run
LONG_FALLBACK_PCT = 1.0   # most of the long reads the host may recompute


def expect_long_arm(tag, counts):
    """The run's long batches went through one of K3 pre's long arms."""
    if not any(counts[a] > 0 for a in LONG_ARMS):
        fail(f"{tag}: no long arm of K3 pre launched: {counts}")


def phase_golden_long():
    """fixtures/multi under --six on the golden index: b.fasta's read has
    9,144 slots, so every batch of it takes K3's long arm; each output
    file of the card's run byte-identical to the port's CPU run."""
    fix = os.path.join(HERE, "fixtures", "multi")
    runs = {dev: golden_run("exampleIndex", fix, {"six_frames": True},
                            "long_multi", dev)
            for dev in ("cpu", DEVICE)}
    expect_launched("golden-long multi --six", runs[DEVICE][0],
                    PATH_KERNELS)
    expect_long_arm("golden-long multi --six", runs[DEVICE][0])
    n = 0
    for name in ("a", "b"):
        # a folder's outputs are <out><name>.json and <profile><name>.csv
        for i, ext in ((2, ".json"), (3, ".csv")):
            same_file(f"golden-long multi --six {name}{ext}",
                      runs[DEVICE][i] + name + ext,
                      runs["cpu"][i] + name + ext)
            n += 1
    log(f"golden-long: fixtures/multi under --six, {n} output files "
        "byte-identical to the port's CPU run; launches "
        f"{runs[DEVICE][0]}")


def phase_long(corpus):
    """Long read lines on the default corpus: 8,192 single-end reads of
    1-8 kbp (default and -e) and 8,192 pairs of 2 x 250 bp under --six
    through identify, each with the launch counts reset just before and
    read just after, and each with at most LONG_FALLBACK_PCT % of its
    reads recomputed on the host; K3's and K5's long arms against their
    plain versions on the batch of all 8,192 long reads, timed; the
    first 256 long reads (default and -e) against the port's CPU run.
    -> (kernel entries, launches, infos)."""
    import numpy as np
    import torch
    from kasa_tpu_torch import kernels, synth
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match import turbo as T
    from kasa_tpu_torch.match.pipeline import identify
    d = os.path.join(HERE, ".synth_corpus", "long")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    lp = synth.long_reads(d, synth.LONG_READS, synth.LONG_PAIRS)
    log(f"long: {synth.LONG_READS} reads of {synth.LONG_MIN}-"
        f"{synth.LONG_MAX} bp and {synth.LONG_PAIRS} pairs of 2 x "
        f"{synth.LONG_MATE} bp written in {time.perf_counter() - t0:.1f} s")

    def head(n):
        path = os.path.join(d, f"long_head{n}.fastq")
        with open(lp["reads"], "rb") as src, open(path, "wb") as dst:
            for _ in range(4 * n):
                dst.write(src.readline())
        return path
    runs = {}
    for tag, inp, over, extra, unit in (
            ("long", lp["reads"], {}, (), "reads"),
            ("long -e", lp["reads"], {"unique": True}, ("dedup.long",),
             "reads"),
            ("long pairs --six", "", {"six_frames": True,
                                      "paired_end_1": lp["pairs"][0],
                                      "paired_end_2": lp["pairs"][1]}, (),
             "pairs")):
        stem = os.path.join(OUT, tag.replace(" ", "_"))
        (ca, cu, _, _), launches, info = drive(
            tag, inp, stem + ".json", stem + ".csv", LONG_KERNELS + extra,
            over, corpus=corpus, unit=unit)
        if not (np.isfinite(ca).all() and cu.sum() > 0):
            fail(f"{tag}: count matrices are not finite / empty")
        if info["fallback_pct"] > LONG_FALLBACK_PCT:
            fail(f"{tag}: {info['fallback_pct']:.2f} % of the reads were "
                 f"recomputed on the host (at most {LONG_FALLBACK_PCT} %)")
        runs[tag] = (launches, info)

    # the long arms on the batch of all the long reads, on the tables of
    # the last run
    disp = fast.LAST_DISPATCH
    mat, R, w, _ = real_batch(corpus, R=synth.LONG_READS, path=lp["reads"])
    dev = torch.device(DEVICE)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    mat_d = torch.from_numpy(mat).to(dev)
    tt = disp.tt if disp is not None and disp.tt.device.type == dev.type \
        else None
    if tt is None:
        fail("long: no resident tables on the card after the runs")
    q = E.encode_windows(mat_d, lut, w)
    skey, mpay = T.turbo_match(q, tt, R, w)
    SW = skey.shape[1]
    S = tt.num_species
    kernels.reset_counts()
    got = T.turbo_reads_pre(skey, mpay, num_species=S)
    if kernels.COUNTS["turbo_reads.long_smem"] != 1:
        fail(f"long: K3 pre took another arm than long_smem on the batch of "
             f"all long reads: {kernels.COUNTS}")
    want = T.turbo_reads_pre_plain(skey, mpay)
    for name, a, b in zip(("ck", "cc", "runs", "mcnt", "cp"), got, want):
        same(f"turbo_reads.long_smem.{name}", a, b)
    # the global arm on the same rows (no batch of this script's paths
    # takes it while a batch's rows fit one block)
    keep = kernels.reads_hist_max
    kernels.reads_hist_max = lambda *a: 0
    try:
        got = T.turbo_reads_pre(skey, mpay, num_species=S)
        if kernels.COUNTS["turbo_reads.long"] != 1:
            fail("long: the global arm of K3 pre did not launch")
        for name, a, b in zip(("ck", "cc", "runs", "mcnt", "cp"), got, want):
            same(f"turbo_reads.long.{name}", a, b)
        ms_g = time_ms(lambda: T.turbo_reads_pre(skey, mpay,
                                                 num_species=S), 3)
    finally:
        kernels.reads_hist_max = keep
    max_runs = int(want[2].max())
    real = slot_stats(skey)
    del got, want
    # the batch's demand on the sizes that batch_budgets scales, and the
    # flags of the batch step at the scaled sizes
    mb, eb, wout = disp.budgets_for(1, w)
    ca_l, cu_l = disp.new_acc()
    packed = T.fused_turbo_acc(tt, mat_d, lut, ca_l, cu_l, R, w,
                               disp.csr_cap(R), mb, eb, wout=wout)[0]
    packed = packed.cpu().numpy()
    hc, fl = packed[:R], packed[R:2 * R]
    demand = {"multi_slots": int(packed[-4]),
              "expansion_rows": int(packed[-3]), "max_runs": max_runs,
              "hits_median": float(np.median(hc)), "hits_max": int(hc.max()),
              "reads_over_WOUT": int((hc > T.WOUT).sum()),
              "budgets": [mb, eb, wout],
              "fixed_budgets": [T.MULTI_BUDGET, T.EXP_BUDGET, T.WOUT],
              "count_flagged": int((fl & 1).sum()),
              "list_flagged": int(((fl >> 1) & 1).sum())}
    log("long budgets: " + json.dumps(demand))
    del ca_l, cu_l, packed
    ms = time_ms(lambda: T.turbo_reads_pre(skey, mpay, num_species=S), 5)
    plain_ms = time_ms(lambda: T.turbo_reads_pre_plain(skey, mpay), 2)
    nbytes = 3 * R * SW * 4 + 2 * R * T.CW * 4 + 2 * R * 4
    k3 = kernel_entry("turbo_reads.long_smem",
                      "kasa_tpu_torch/csrc/turbo_reads.cu",
                      "kasa_tpu/match/turbo.py:717",
                      runs["long"][0]["turbo_reads.long_smem"], 0.0, ms,
                      plain_ms, nbytes, None)
    k3g = kernel_entry("turbo_reads.long",
                       "kasa_tpu_torch/csrc/turbo_reads.cu",
                       "kasa_tpu/match/turbo.py:717",
                       runs["long"][0]["turbo_reads.long"], 0.0, ms_g,
                       plain_ms, nbytes, None)
    log(f"kernel turbo_reads.long_smem / turbo_reads.long (pre, the "
        f"shared-memory and global arms) on a real batch: R={R}, SW={SW}, "
        f"w={w}, real slot keys {json.dumps(real)}")
    del skey, mpay
    stages_long = turbo_stages("long", tt, mat, R, w, mb, eb,
                               disp.csr_cap(R), wout=wout)
    got = T.dedup_windows(q, R, w)
    want = T.dedup_windows_plain(q, R, w)
    same("dedup.long", got, want)
    npois = int((want[:, 0] == T.POISON_LIMB).sum())
    del got, want
    keys = ((q[:, 0].long() << 30) | q[:, 1].long()).reshape(R, w)
    ms = time_ms(lambda: T.dedup_windows(q, R, w), 5)
    plain_ms = time_ms(lambda: T.dedup_windows_plain(q, R, w), 2)
    lib_ms = time_ms(lambda: torch.sort(keys, dim=1), 5)
    k5 = kernel_entry("dedup.long", "kasa_tpu_torch/csrc/dedup.cu",
                      "kasa_tpu/match/turbo.py:128",
                      runs["long -e"][0]["dedup.long"], 0.0, ms, plain_ms,
                      2 * q.numel() * 4, lib_ms,
                      "torch.sort of the (R, kpr) int64 keys")
    log(f"kernel dedup.long on the same batch: {R * w} windows, {npois} "
        "poisoned")
    del q, keys, mat_d
    torch.cuda.empty_cache()

    # the first LONG_CPU_READS long reads on the card and on the CPU
    sub = head(LONG_CPU_READS)
    for unique in (False, True):
        got = {}
        for dev in (DEVICE, "cpu"):
            cfg = Config()
            cfg.num_of_beasts = ALL_HITS
            cfg.unique = unique
            stem = os.path.join(
                OUT, f"long_head_{dev}{'_e' if unique else ''}")
            res = identify(cfg, index_path=corpus["index"], input_path=sub,
                           out_file=stem + ".json", profile_file=stem + ".csv",
                           device=dev)
            got[dev] = (res, stem)
        if not np.array_equal(got[DEVICE][0][1], got["cpu"][0][1]):
            fail("long: unique counts of the card and the CPU differ")
        assert_identify_agrees(
            json.load(open(got["cpu"][1] + ".json")),
            json.load(open(got[DEVICE][1] + ".json")),
            open(got["cpu"][1] + ".csv").read(),
            open(got[DEVICE][1] + ".csv").read(), 6)
        log(f"long: the first {LONG_CPU_READS} long reads"
            f"{' under -e' if unique else ''} on the card agree with the "
            "port's CPU run (unique counts identical, every hit)")

    infos = {t: r[1] for t, r in runs.items()}
    infos["stages"] = stages_long
    return [k3, k3g, k5], {t: r[0] for t, r in runs.items()}, infos


def phase_dedup_global(wide_index):
    """K5's global arm, for reads too long for the shared-memory arm: the
    first LONG_CPU_READS long reads under --six -e on the wide index at k
    20..25 (about 16,000 windows of five limbs a read) through identify,
    the launch counts reset just before and read just after; then the
    arm against its plain version on that run's batch (the same reads as
    the main path lays them out, encoded at L = 5), timed; and on
    synthetic batches above the shared-memory capacity (256 reads of
    12,000 windows at L = 5, of 20,000 at L = 2, logged), beside
    torch.sort of the (R, kpr) 60-bit keys at L = 2.
    -> (the real batch's kernel entry, info)."""
    import numpy as np
    import torch
    from kasa_tpu_torch import kernels
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    tag = "wide long --six -e"
    sub = os.path.join(HERE, ".synth_corpus", "long",
                       f"long_head{LONG_CPU_READS}.fastq")
    stem = os.path.join(OUT, "wide_long_six_e")
    (ca, cu, nreads, _), launches, info = drive(
        tag, sub, stem + ".json", stem + ".csv",
        PATH_KERNELS + ("dedup.global",),
        over={"lower_k": 20, "higher_k": 25, "six_frames": True,
              "unique": True}, corpus={"index": wide_index})
    expect_long_arm(tag, launches)
    if nreads != LONG_CPU_READS or not np.isfinite(ca).all() \
            or cu.sum() <= 0:
        fail(f"{tag}: wrong read count or empty / non-finite counts")
    if launches["dedup.long"] or launches["dedup"]:
        fail(f"{tag}: K5 took another arm: {launches}")
    dev = torch.device(DEVICE)

    def arm(kpr, L):
        got = kernels.dedup_arm(kpr, kernels.dedup_long_max(L, dev))
        if got != "global":
            fail(f"dedup.global: {kpr} windows at L = {L} take the {got} "
                 "arm")

    # the run's batch: its reads, both frames' rows a read, at L = 5
    mat, R, w, lpr = real_batch(None, six=True, highest_k=25, min_k=20,
                                R=LONG_CPU_READS, path=sub)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    mat_d = torch.from_numpy(mat).to(dev)
    q = E.encode_windows(mat_d, lut, w, highest_k=25)
    kpr, L = w * lpr, q.shape[1]
    arm(kpr, L)
    want = T.dedup_windows_plain(q, R, kpr)
    same("dedup.global", T.dedup_windows(q, R, kpr), want)
    npois = int((want[:, 0] == T.POISON_LIMB).sum())
    del want
    ms = time_ms(lambda: T.dedup_windows(q, R, kpr), 5)
    plain_ms = time_ms(lambda: T.dedup_windows_plain(q, R, kpr), 2)
    entry = kernel_entry("dedup.global", "kasa_tpu_torch/csrc/dedup.cu",
                         "kasa_tpu/match/turbo.py:128",
                         launches["dedup.global"], 0.0, ms, plain_ms,
                         2 * q.numel() * 4, None)
    log(f"kernel dedup.global on the run's batch: R={R}, kpr={kpr}, "
        f"L={L}, {npois} poisoned (no single PyTorch call sorts "
        "five-limb rows per read)")
    info["batch"] = dict(R=R, kpr=kpr, L=L, ms=ms, plain_ms=plain_ms)
    del q, mat_d
    torch.cuda.empty_cache()

    rng = np.random.default_rng(20261017)
    info["synthetic"] = {}
    for R, kpr, L in ((256, 20_000, 2), (256, 12_000, 5)):
        arm(kpr, L)
        q = rng.integers(1 << 24, 1 << 30, size=(R * kpr, L),
                         dtype=np.int32)
        src = rng.integers(0, R * kpr, size=R * kpr // 10)
        q[(src // kpr) * kpr + rng.integers(0, kpr, size=len(src))] = q[src]
        q = torch.from_numpy(q).to(dev)
        same(f"dedup.global L={L}", T.dedup_windows(q, R, kpr),
             T.dedup_windows_plain(q, R, kpr))
        ms = time_ms(lambda: T.dedup_windows(q, R, kpr), 5)
        plain_ms = time_ms(lambda: T.dedup_windows_plain(q, R, kpr), 2)
        lib_ms = None
        if L == 2:
            keys = ((q[:, 0].long() << 30) | q[:, 1].long()).reshape(R, kpr)
            lib_ms = time_ms(lambda: torch.sort(keys, dim=1), 5)
            del keys
        info["synthetic"][f"L{L}"] = dict(R=R, kpr=kpr, ms=ms,
                                          plain_ms=plain_ms, lib_ms=lib_ms)
        log(f"kernel dedup.global on a synthetic batch ({R} x {kpr}, "
            f"L = {L}): {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{2 * q.numel() * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms"
            + (f"; torch.sort of the (R, kpr) int64 keys {lib_ms:.4f} ms"
               if lib_ms is not None else "") + ")")
        del q
        torch.cuda.empty_cache()
    log(f"{tag}: K5's global arm launched {launches['dedup.global']} "
        "times; on the run's batch and on synthetic batches above the "
        "shared-memory capacity it agrees with its plain version")
    return entry, info


GOLDEN_BUILDS = (
    # tag, CLI arguments (G: tests/golden, F: fixtures, O: the output
    # directory, T: the test taxonomy), golden, artifact suffixes
    ("build", "build -c G/exampleIndex_content.txt -d O/x -i F/example.fasta",
     "exampleIndex", None),
    ("build --kH 25", "build -c G/exampleIndex_content.txt -d O/x "
     "-i F/example.fasta --kH 25", "exampleIndex128", None),
    ("build -a", "build -c G/exampleIndex_content.txt -d O/x "
     "-i F/example.fasta -a O/gc.prt 1", "alphaIndex", None),
    ("build -j", "build -c G/exampleIndex_content.txt -d O/x "
     "-i F/example.fasta -j", "exampleIndexSloppy",
     ("", "_taxOnly", "_info.txt", "_trie", "_trie.txt")),
    ("build -z", "build -c G/protIndex_content.txt -d O/x "
     "-i F/protein.fasta -z", "protIndex", None),
    ("shrink -s 2", "shrink -s 2 -d G/exampleIndex -o O/x "
     "-c G/exampleIndex_content.txt", "exampleIndex_s", None),
    ("half", "half -d G/exampleIndex -o O/x -c G/exampleIndex_content.txt",
     "exampleIndex_s", None),
    ("shrink -s 1 -g 50", "shrink -s 1 -g 50 -d G/exampleIndex -o O/x "
     "-c G/exampleIndex_content.txt", "exampleIndex_g50", None),
    ("shrink -s 3", "shrink -s 3 -d G/exampleIndex -o O/x "
     "-c G/exampleIndex_content.txt", "exampleIndex_ent", None),
    ("update", "update -d G/exampleIndex -o O/x -i F/example2.fasta "
     "-f T/acc2tax.txt -y T -u species", "exampleIndex_u",
     ("", "_info.txt", "_trie", "_trie.txt", "_f.txt", "_content.txt")),
    ("delete", "delete -d G/exampleIndex -o O/x -l G/delnodes_test.dmp "
     "-c G/exampleIndex_content.txt", "exampleIndex_del", None),
    ("merge", "merge --firstIndex G/exampleIndex --secondIndex G/index2 "
     "-o O/x -c1 G/exampleIndex_content.txt -c2 G/index2_content.txt",
     "index_merged", ("", "_trie", "_trie.txt", "_f.txt", "_content.txt")),
    ("generateCF", "generateCF -c O/x -i F/example.fasta -f T/acc2tax.txt "
     "-y T -u species", "exampleIndex_content.txt", ("",)),
)
ARTIFACTS = ("", "_info.txt", "_trie", "_trie.txt", "_f.txt")


def cli(args):
    """The port's CLI in this process (python -m kasa_tpu_torch args
    --device DEVICE)."""
    from kasa_tpu_torch.cli import main
    rc = main(["kasa_tpu_torch", *args, "--device", DEVICE])
    if rc != 0:
        fail(f"python -m kasa_tpu_torch {' '.join(args)}: exit code {rc}")


def phase_build_golden():
    """Every golden index family of tests/test_modes_parity.py and
    tests/test_golden_parity.py through the port's CLI on the card, byte
    for byte (update and generateCF read a taxonomy written from the
    golden content file, the custom alphabet NCBI's standard code), K13
    launched by the 128-bit build and by nothing else; then the spill
    (soft limit 10,000) and --continue builds at highestK 12 and 25
    against the one-pass goldens.  -> the 128-bit build's launches."""
    import shutil
    import torch
    from kasa_tpu_torch import kernels, synth
    from kasa_tpu_torch.index import build as B
    gold = os.path.join(HERE, "tests", "golden")
    root = os.path.join(OUT, "build_golden")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tax = synth.taxonomy_from_content(
        os.path.join(gold, "exampleIndex_u_content.txt"),
        os.path.join(root, "taxonomy"))
    with open(os.path.join(root, "gc.prt"), "w") as fh:
        fh.write(synth.STANDARD_GC_PRT)
    t0 = time.perf_counter()
    launches_128 = None
    for i, (tag, line, golden, suffixes) in enumerate(GOLDEN_BUILDS):
        o = os.path.join(root, f"m{i}")
        os.makedirs(o)
        where = {"G": gold, "F": os.path.join(HERE, "fixtures"), "O": o,
                 "T": tax}
        args = [where[a] if a in where else
                where[a[0]] + a[1:] if a[:2] in ("G/", "F/", "O/", "T/")
                else a for a in line.split()]
        shutil.copy(os.path.join(root, "gc.prt"), o)
        kernels.reset_counts()
        cli(args)
        torch.cuda.synchronize()
        launches = dict(kernels.COUNTS)
        want = {"sort_dedup"} if tag == "build --kH 25" else set()
        if {k for k, v in launches.items() if v} != want:
            fail(f"build-golden {tag}: launches {launches}")
        if want:
            launches_128 = launches
        for s in suffixes or ARTIFACTS:
            same_file(f"build-golden {tag}", os.path.join(o, "x") + s,
                      os.path.join(gold, golden) + s)
    log(f"build-golden: {len(GOLDEN_BUILDS)} CLI runs byte-identical to "
        f"the goldens in {time.perf_counter() - t0:.1f} s; the 128-bit "
        f"build launched {launches_128}")

    fasta = os.path.join(HERE, "fixtures", "example.fasta")
    content = os.path.join(gold, "exampleIndex_content.txt")
    for hk, golden in ((12, "exampleIndex"), (25, "exampleIndex128")):
        d = os.path.join(root, f"spill{hk}")
        os.makedirs(d)
        kernels.reset_counts()
        B.build_index(fasta, content, os.path.join(d, "x"), highest_k=hk,
                      soft_limit=10000, temp_dir=d, device=DEVICE)
        spill_k13 = kernels.COUNTS["sort_dedup"]
        for s in ARTIFACTS:
            same_file(f"build-golden spill k{hk}", os.path.join(d, "x") + s,
                      os.path.join(gold, golden) + s)
        # --continue: a build that spilled and stopped before its merge
        orig = B.KmerAccumulator.finalize

        def stop(self):
            self._spill()
            raise KeyboardInterrupt
        B.KmerAccumulator.finalize = stop
        try:
            B.build_index(fasta, content, os.path.join(d, "dead"),
                          highest_k=hk, soft_limit=10000, temp_dir=d,
                          call_idx=5, device=DEVICE)
            fail("build-golden: the interrupted build did not stop")
        except KeyboardInterrupt:
            pass
        finally:
            B.KmerAccumulator.finalize = orig
        B.build_index(fasta, content, os.path.join(d, "y"), highest_k=hk,
                      temp_dir=d, continue_build=True, call_idx=5,
                      device=DEVICE)
        for s in ARTIFACTS:
            same_file(f"build-golden --continue k{hk}",
                      os.path.join(d, "y") + s,
                      os.path.join(gold, golden) + s)
        log(f"build-golden: the spill build (soft limit 10,000; K13 "
            f"{spill_k13} launches) and the --continue build at highestK "
            f"{hk} equal the one-pass golden")
    return launches_128


SPILL_GENOMES = 512      # build-wide's spill build: ~8.2 M windows
SPILL_LIMIT = 1 << 21    # entries per spill: four K13 calls


def phase_build_wide(corpus, wide):
    """The index build at a size users build: the default corpus's 2,047
    genomes as a FASTA of SYN<i> records with the corpus's content file,
    built at -k 25 through the port's CLI (one K13 call over the ~32.9 M
    entries); the first SPILL_GENOMES genomes built with a soft limit of
    SPILL_LIMIT entries (K13 per run, then the host merge) and in one
    pass: byte-identical artifacts; the full build's entries
    without the build's trailing marker letter equal synth.py's wide
    index; K13 on the consolidate input held to its plain version and
    timed beside torch.unique(dim=0) and its bound; the 64-bit build of
    the same genomes (the native host path, no kernel).
    -> (K13's kernel entry, info)."""
    import shutil
    import numpy as np
    import torch
    from kasa_tpu_torch import kernels, synth
    from kasa_tpu_torch.core import kmer
    from kasa_tpu_torch.index import artifacts
    from kasa_tpu_torch.index import build as B
    from kasa_tpu_torch.utils import timers
    root = os.path.join(HERE, ".synth_corpus", "build_wide")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    fasta = synth.write_genomes_fasta(
        os.path.join(root, "genomes.fasta"), synth.NUM_SPECIES,
        synth.GENOME_LEN, synth.CORE_GENES)
    content = corpus["index"] + "_content.txt"
    log(f"build-wide: {synth.NUM_SPECIES} genomes of {synth.GENOME_LEN} bp "
        f"written in {time.perf_counter() - t0:.1f} s")
    captured = {}
    orig = B.sort_dedup_device

    def capture(limbs, taxids, device):
        captured.setdefault("input", (limbs.copy(), taxids.copy()))
        return orig(limbs, taxids, device)
    info = {}
    B.sort_dedup_device = capture
    try:
        timers.reset()
        kernels.reset_counts()
        t0 = time.perf_counter()
        cli(["build", "-i", fasta, "-c", content, "-d",
             os.path.join(root, "w25"), "--kH", "25", "-t", root, "-n",
             str(os.cpu_count() or 1)])
        torch.cuda.synchronize()
        info["seconds_k25"] = time.perf_counter() - t0
        info["launches_k25"] = dict(kernels.COUNTS)
        info["stages_k25"] = {k: round(v, 4) for k, v in timers.report(
            lambda *_: None).items() if k.startswith("build/")}
    finally:
        B.sort_dedup_device = orig
    if info["launches_k25"]["sort_dedup"] != 1:
        fail(f"build-wide: K13 launches {info['launches_k25']}")
    n, _ = artifacts.read_info(os.path.join(root, "w25"))
    info["entries"] = n
    log(f"build-wide: -k 25 build of {n:,} entries in "
        f"{info['seconds_k25']:.1f} s; stages {info['stages_k25']}; "
        f"launches {info['launches_k25']}")

    # the spill build on the first SPILL_GENOMES genomes (its host merge
    # of 32.7 M rows alone took ~50 s): four spills, byte-identical to
    # the one-pass build of the same genomes
    sub = synth.write_genomes_fasta(
        os.path.join(root, "sub.fasta"), SPILL_GENOMES, synth.GENOME_LEN,
        synth.CORE_GENES)
    common = dict(highest_k=25, temp_dir=root, device=DEVICE,
                  threads=os.cpu_count() or 1, turbo_sidecar=False)
    B.build_index(sub, content, os.path.join(root, "o25"), **common)
    kernels.reset_counts()
    t0 = time.perf_counter()
    B.build_index(sub, content, os.path.join(root, "s25"),
                  soft_limit=SPILL_LIMIT, **common)
    info["seconds_k25_spill"] = time.perf_counter() - t0
    info["launches_k25_spill"] = kernels.COUNTS["sort_dedup"]
    for s in ARTIFACTS:
        same_file("build-wide spill", os.path.join(root, "s25") + s,
                  os.path.join(root, "o25") + s)
    log(f"build-wide: the build of {SPILL_GENOMES} genomes with a soft "
        f"limit of {SPILL_LIMIT:,} entries ({info['launches_k25_spill']} "
        f"K13 launches, then the host merge) is byte-identical to their "
        f"one-pass build, {info['seconds_k25_spill']:.1f} s")

    # synth.py's wide index holds the windows inside each genome; the
    # build adds the windows over the trailing marker, whose last letter
    # is '^' (code 30)
    limbs, taxids, _, _ = artifacts.read_index(os.path.join(root, "w25"))
    inside = kmer.letter_at(limbs, 24, 25) != 30
    wl, wt, _, _ = artifacts.read_index(wide["index"])
    if not (np.array_equal(limbs[inside], wl)
            and np.array_equal(taxids[inside], wt)):
        fail("build-wide: the build's entries inside the genomes differ "
             "from synth.py's wide index")
    log(f"build-wide: the {int(inside.sum()):,} entries inside the genomes "
        f"equal synth.py's wide index; {int((~inside).sum()):,} marker "
        "entries besides")
    del limbs, taxids, wl, wt, inside

    # K13 on the consolidate input
    cl, ct = captured["input"]
    q = torch.from_numpy(cl).to(DEVICE)
    t = torch.from_numpy(ct.view(np.int32)).to(DEVICE)
    N, L = q.shape
    got = B.sort_dedup(q, t)
    want = B.sort_dedup_plain(q, t)
    same("sort_dedup.limbs", got[0], want[0])
    same("sort_dedup.taxids", got[1], want[1])
    nu = len(want[1])
    del got, want
    rows = torch.cat([q.long(), (t.long() & 0xFFFFFFFF)[:, None]], dim=1)
    ms = time_ms(lambda: B.sort_dedup(q, t), 3)
    plain_ms = time_ms(lambda: B.sort_dedup_plain(q, t), 2)
    lib_ms = time_ms(lambda: torch.unique(rows, dim=0), 2)
    del rows
    entry = kernel_entry(
        "sort_dedup", "kasa_tpu_torch/csrc/sort_dedup.cu",
        "kasa_tpu/index/build.py:112", info["launches_k25"]["sort_dedup"],
        0.0, ms, plain_ms, (N + nu) * 4 * (L + 1), lib_ms,
        "torch.unique(dim=0) of the (N, L + 1) int64 rows")
    log(f"kernel sort_dedup on the consolidate input: N={N:,}, L={L}, "
        f"Nu={nu:,}")
    info["k13"] = dict(N=N, L=L, Nu=nu)
    del q, t, cl, ct, captured
    torch.cuda.empty_cache()

    # the same genomes as a 64-bit index: the native host path
    timers.reset()
    kernels.reset_counts()
    t0 = time.perf_counter()
    cli(["build", "-i", fasta, "-c", content, "-d",
         os.path.join(root, "w12"), "-t", root, "-n",
         str(os.cpu_count() or 1), "--no-sidecar"])
    info["seconds_k12"] = time.perf_counter() - t0
    info["stages_k12"] = {k: round(v, 4) for k, v in timers.report(
        lambda *_: None).items() if k.startswith("build/")}
    if any(kernels.COUNTS.values()):
        fail(f"build-wide k12: launched {kernels.COUNTS}")
    log(f"build-wide: the 64-bit build of the same genomes "
        f"({artifacts.read_info(os.path.join(root, 'w12'))[0]:,} entries, "
        f"no kernel) in {info['seconds_k12']:.1f} s; stages "
        f"{info['stages_k12']}")
    shutil.rmtree(root, ignore_errors=True)
    return entry, info


# ---------------------------------------------------------------------------
# the mesh (parallel/): ranks that share the one card over gloo, and a
# world of one over NCCL

MESH_WORLD = 2           # ranks on the one card
MESH_IP = 2
MESH_KERNELS = ("encode", "turbo_match", "turbo_reads", "turbo_multi",
                "mesh_merge")
MESH_RATE_NOTE = ("two ranks sharing one H100 over gloo; not a multi-GPU "
                  "rate")


def _mesh_collectives(rec, batches):
    """ms per batch of each mesh/* host timer of a rank (gloo collectives
    return when they are done, so a timer spans the whole collective)."""
    return {k: 1e3 * v / batches for k, v in rec["timers"].items()
            if k.startswith("mesh/")}


def probe_cuda_gather():
    """Whether the process group's backend takes CUDA tensors in
    all_gather_into_tensor (gloo's answer depends on the PyTorch build):
    "ok" or the error's first line."""
    import torch
    from kasa_tpu_torch.parallel import dist as D
    n = D.world_size()
    t = torch.full((4,), D.rank(), dtype=torch.int32, device=DEVICE)
    out = torch.empty((n * 4,), dtype=torch.int32, device=DEVICE)
    try:
        D._all_gather(out, t)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return str(e).splitlines()[0] if str(e) else type(e).__name__
    want = torch.arange(n, device=DEVICE, dtype=torch.int32)
    return "ok" if bool((out.view(n, 4)[:, 0] == want).all()) \
        else "wrong values"


def identify_files_agree(tag, ref, got, num_k=6):
    """Two identify runs' json and profile files under the contract,
    fast at 65,536 reads with every hit written: records that are equal
    byte for byte pass; only the others are parsed and their taxa and
    k-mer scores compared.  -> the number of records that differ in
    bytes."""
    sep = b"\n},\n{"
    with open(ref[0], "rb") as fa, open(got[0], "rb") as fb:
        ra, rb = fa.read().split(sep), fb.read().split(sep)
    if len(ra) != len(rb):
        fail(f"{tag}: {len(rb)} reads written, reference {len(ra)}")

    def record(chunks, i):
        # the first record opens the array ("[" "{"), the last closes it
        c = chunks[i].strip()
        if i == 0:
            c = c[1:].strip()[1:]
        if i == len(chunks) - 1:
            c = c[:-1].rstrip()[:-1]
        return json.loads(b"{" + c + b"}")
    differ = [i for i, (x, y) in enumerate(zip(ra, rb)) if x != y]
    json_agrees([record(ra, i) for i in differ],
                [record(rb, i) for i in differ])
    with open(ref[1]) as pa, open(got[1]) as pb:
        assert_identify_agrees([], [], pa.read(), pb.read(), num_k)
    return len(differ)


def mesh_cli(tag, corpus, env, dp, ip, ref, world=MESH_WORLD,
             backend="gloo", note=MESH_RATE_NOTE, timeout=1800.0):
    """The CLI identify of the smoke reads on `world` ranks, every hit
    written; each rank's launch counts start at 0 in its own process and
    come back with its record.  Held to the single-card run `ref`."""
    import re
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.parallel.launch import run_cli
    stem = os.path.join(OUT, f"mesh_{tag}")
    out_j, out_p = stem + ".json", stem + ".csv"
    t0 = time.perf_counter()
    recs = run_cli(world, ["identify", "-d", corpus["index"], "-i",
                           corpus["smoke"], "-q", out_j, "-p", out_p, "-b",
                           str(ALL_HITS)], env=env, out_dir=stem + "_ranks",
                   timeout=timeout)
    dt = time.perf_counter() - t0
    with open(recs[0]["log"]) as fh:
        text = fh.read()
    if any(r["result"] != 0 for r in recs):
        fail(f"mesh {tag}: exit codes {[r['result'] for r in recs]}:\n"
             f"{text[-3000:]}")
    want = (f"turbo mesh active: dp={dp} x ip={ip} over {world} ranks, "
            f"{backend}")
    if want not in text:
        fail(f"mesh {tag}: no '{want}' in rank 0's log:\n{text[-2000:]}")
    for r, rec in enumerate(recs):
        expect_launched(f"mesh {tag} rank {r}", rec["counts"],
                        MESH_KERNELS + (("turbo_multi.split",) if ip > 1
                                        else ()))
    ndiff = identify_files_agree(f"mesh {tag}", ref, (out_j, out_p))
    os.remove(out_j)
    nb = -(-synth.SMOKE_READS // 8192)
    coll = [_mesh_collectives(rec, nb) for rec in recs]
    stages = {k: round(v, 3) for k, v in recs[0]["timers"].items()
              if k.startswith(("fast/", "turbo/", "mesh/"))}
    # rank 0's mode time ("OUT: Time:"), index load and tables included
    t_mode = float(re.findall(r"OUT: Time: ([0-9.]+) s", text)[-1])
    log(f"mesh {tag}: {synth.SMOKE_READS} reads in {dt:.3f} s (process "
        f"start to exit) = {synth.SMOKE_READS / dt:.1f} reads/s; identify "
        f"on rank 0 {t_mode:.3f} s (index and tables loaded) = "
        f"{synth.SMOKE_READS / t_mode:.1f} reads/s ({note}); "
        f"agrees with "
        f"the single-card run ({ndiff} reads' records differ in bytes, "
        f"within the contract); rank 0 launches {recs[0]['counts']}")
    log(f"mesh {tag}: collectives, ms per batch, by rank: "
        f"{json.dumps(coll)}; rank 0 stage seconds {json.dumps(stages)}")
    return recs[0]["counts"], dict(seconds=dt, identify_seconds=t_mode,
                                   collectives_ms=coll, stages=stages)


MESH_CARDS = 4


def phase_mesh_cards(corpus, ref):
    """The CLI on MESH_CARDS ranks over NCCL, one card each, at (dp, ip)
    = (2, 2) and (1, 4), held to the single-card run `ref`.  On a machine
    with fewer cards it logs that it was skipped.  -> {tag: (rank 0's
    launches, info)}."""
    import torch
    n = torch.cuda.device_count()
    if n < MESH_CARDS:
        log(f"mesh cards: skipped: {n} card(s) here; the NCCL mesh of "
            f"{MESH_CARDS} ranks runs on a machine with {MESH_CARDS} cards "
            "(python3 chip_smoke.py --cards)")
        return {}
    note = f"{MESH_CARDS} ranks on {MESH_CARDS} cards over NCCL"
    return {f"cards {dp}x{ip}": mesh_cli(
        f"cards_{dp}x{ip}", corpus,
        {"KASA_MESH_DP": str(dp), "KASA_MESH_IP": str(ip)}, dp, ip, ref,
        world=MESH_CARDS, backend="nccl", note=note, timeout=300.0)
        for dp, ip in ((2, 2), (1, 4))}


# ---------------------------------------------------------------------------
# stage splits of K3 and K4 (and K7's arms): in the full run's kernel
# phases, and alone under --stages

STAGE_REPS = 10
K4_STAGES = ("scan", "slots", "cut", "expand")
STAGES = {}     # tag -> the stage splits of turbo_stages, for the json


def slot_stats(skey):
    """How many of each row's SW slot keys are real (not the sentinel)."""
    import torch
    from kasa_tpu_torch.match import turbo as T
    n = (skey != T.SENT).sum(dim=1).float()
    return {"SW": skey.shape[1], "real_min": int(n.min()),
            "real_median": float(n.median()), "real_max": int(n.max()),
            "sentinel_pct": 100.0 * (1.0 - float(n.mean()) / skey.shape[1])}


def multi_counts_f64(cp, mcnt, ofc, tt):
    """The sums K4 adds over the reads, in float64: the counts (numK, S),
    1/T for each taxon of each cold slot of an unflagged read, and the
    hot credits (numK, H), 1/T for each of its hot slots."""
    import torch
    R, SW = cp.shape
    H = tt.hotmask.shape[0]
    iota = torch.arange(SW, device=cp.device)
    slot = torch.nonzero((iota[None, :] < mcnt[:, None]) & ~ofc[:, None])
    mp = cp[slot[:, 0], slot[:, 1]].long()
    ki = mp & 7
    row0 = tt.grp2[(ki * tt.n + (mp >> 3)).clamp(
        max=tt.num_k * tt.n - 1)].long()
    hot = row0 < 0
    hid = -row0[hot] - 1
    hot_c = torch.zeros(tt.num_k * H, dtype=torch.float64, device=cp.device)
    hot_c.index_add_(0, ki[hot] * H + hid,
                     1.0 / tt.t_hot[hid].double().clamp(min=1))
    cold = row0 > 0
    ki, row0 = ki[cold], row0[cold]
    T = tt.d_tax4[row0, 0].long()
    lanes = ((T + 3) >> 2) * 4
    sl = torch.repeat_interleave(torch.arange(len(T), device=cp.device),
                                 lanes)
    j = torch.arange(len(sl), device=cp.device) \
        - (torch.cumsum(lanes, 0) - lanes)[sl]
    taxa = tt.d_tax4.view(-1)[((row0[sl] + 1) * 4 + j).clamp(
        max=tt.d_tax4.numel() - 1)].long()
    ok = taxa >= 0
    S = tt.num_species
    out = torch.zeros(tt.num_k * S, dtype=torch.float64, device=cp.device)
    out.index_add_(0, (ki[sl] * S + taxa)[ok],
                   (1.0 / T.double())[sl][ok])
    return out.view(tt.num_k, S), hot_c.view(tt.num_k, H)


def marked_ms(fn, n, reps=STAGE_REPS):
    """The device times between n CUDA events that fn(marks) records
    around its launches (no host time between them), the mean of reps
    calls after one warm-up call -> n - 1 ms."""
    import torch
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    tot = [0.0] * (n - 1)
    for rep in range(reps + 1):
        fn(marks)
        torch.cuda.synchronize()
        if rep:
            for i in range(n - 1):
                tot[i] += marks[i].elapsed_time(marks[i + 1])
    return [t / reps for t in tot]


def k4_stages(cp, mcnt, runs, tt, acc_ca, mb, eb, counts_only=False,
              reps=STAGE_REPS):
    """K4's four launches timed apart (CUDA events between them) ->
    {stage: ms}."""
    from kasa_tpu_torch import kernels as K
    from kasa_tpu_torch.match import turbo as T
    ms = marked_ms(lambda m: K.turbo_multi(
        cp, mcnt, runs, tt, acc_ca, mb, eb, T.CW, T.SENT,
        counts_only=counts_only, marks=m), K.MULTI_MARKS, reps)
    return dict(zip(K4_STAGES, ms))


def turbo_stages(tag, tt, mat, R, w, mb, eb, cap, wout=None, lpr=1):
    """K3 pre, K4's four stages and K3 post timed apart on one real batch
    as the main path runs it, each held to its plain version first, with
    the share of sentinel slot keys and K3 pre's arm -> {name: ms or
    stats}."""
    import numpy as np
    import torch
    from kasa_tpu_torch import kernels as K
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    dev = torch.device(DEVICE)
    wout = wout or T.WOUT
    nk, S = tt.num_k, tt.num_species
    sparse = tt.hotmask.shape[0] <= 1 and S > T.SPARSE_FOLD_S
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    q = E.encode_windows(torch.from_numpy(mat).to(dev), lut, w)
    skey, mpay = T.turbo_match(q, tt, R, w * lpr)
    del q
    out = {"slots": slot_stats(skey)}
    K.reset_counts()
    got = T.turbo_reads_pre(skey, mpay, num_species=S)
    out["pre_arm"] = {k: v for k, v in K.COUNTS.items() if v}
    want = T.turbo_reads_pre_plain(skey, mpay)
    for nm, a, b in zip(("ck", "cc", "runs", "mcnt", "cp"), got, want):
        same(f"stages {tag} turbo_reads.{nm}", a, b)
    del got
    out["pre"] = time_ms(lambda: T.turbo_reads_pre(skey, mpay,
                                                   num_species=S), STAGE_REPS)
    if hasattr(K, "PRE_MARKS"):
        out["pre_device"] = marked_ms(lambda m: K.turbo_reads_pre(
            skey, mpay, T.SENT, T.CW, 8 * S, marks=m), K.PRE_MARKS)[0]
    ck, cc, runs, mcnt, cp = want
    del skey, mpay
    ca = torch.zeros((nk, S), device=dev)
    cu = torch.zeros((nk, S), dtype=torch.int32, device=dev)
    ca_p = torch.zeros((nk, S), device=dev)
    mk = T.turbo_multi(cp, mcnt, runs, tt, ca, mb, eb, counts_only=sparse)
    mp_ = T.turbo_multi_plain(cp, mcnt, runs, tt, ca_p, mb, eb,
                              counts_only=sparse)
    same(f"stages {tag} turbo_multi.ofc", mk[0], mp_[0])
    same(f"stages {tag} turbo_multi.diag", mk[4], mp_[4])
    # the counts against their float64 sum; a long-read batch adds ~10^5
    # terms to a cell, where float32 orders differ by more than the rtol,
    # so there the plain version's float32 sum is only logged beside it
    ref, ref_h = multi_counts_f64(cp, mcnt, mp_[0], tt)
    err4 = close(f"stages {tag} turbo_multi.acc_ca (float64 sum)", ca, ref)
    out["k4_plain_f32_err"] = float((ca_p.double() - ref).abs().max())
    if tag != "long":
        err4 = max(err4, close(f"stages {tag} turbo_multi.acc_ca", ca, ca_p))
    if not sparse:
        err4 = max(err4, close(f"stages {tag} turbo_multi.dm", mk[1], mp_[1]),
                   close(f"stages {tag} turbo_multi.a3w", mk[2], mp_[2]),
                   close(f"stages {tag} turbo_multi.a3c (float64 sum)",
                         mk[3], ref_h))
        if tag != "long":
            err4 = max(err4, close(f"stages {tag} turbo_multi.a3c", mk[3],
                                   mp_[3]))
    out["k4_err"] = err4
    del mk
    out["k4"] = k4_stages(cp, mcnt, runs, tt, ca, mb, eb, sparse)
    out["k4_total"] = time_ms(lambda: T.turbo_multi(
        cp, mcnt, runs, tt, ca, mb, eb, counts_only=sparse), STAGE_REPS)
    ofc, dm, a3w, _, diag = mp_
    if sparse:
        ml = T.sparse_fold(cp, mcnt, ofc, tt)

        def post(fn, a, u):
            return fn(ck, cc, ofc, None, tt.weights, a, u, diag, cap,
                      mlist=ml, wout=wout)

        def post_marked(m):
            return K.turbo_reads_post(ck, cc, ofc, None, tt.weights, ca, cu,
                                      diag, cap, T.SENT, wout, T.WM,
                                      mlist=ml, marks=m)
    else:
        dm = dm.clone()
        dm.addmm_(a3w, tt.hotmask)

        def post(fn, a, u):
            return fn(ck, cc, ofc, dm, tt.weights, a, u, diag, cap, wm=wout,
                      wout=wout)

        def post_marked(m):
            return K.turbo_reads_post(ck, cc, ofc, dm, tt.weights, ca, cu,
                                      diag, cap, T.SENT, wout, wout, marks=m)
    pk = post(T.turbo_reads_post, ca.clone(), cu.clone())
    pp = post(T.turbo_reads_post_plain, ca.clone(), cu.clone())
    ints = torch.ones(len(pk[0]), dtype=torch.bool)
    ints[2 * R + 1:2 * R + 2 * cap:2] = False
    same(f"stages {tag} turbo_reads.packed", pk[0].cpu()[ints],
         pp[0].cpu()[ints])
    same(f"stages {tag} turbo_reads.ht", pk[1], pp[1])
    out["post_err"] = close(f"stages {tag} turbo_reads.hk", pk[2], pp[2])
    out["post"] = time_ms(lambda: post(T.turbo_reads_post, ca, cu),
                          STAGE_REPS)
    if hasattr(K, "POST_MARKS"):
        out["post_device"] = dict(zip(("post", "scan", "scatter"), marked_ms(
            lambda m: post_marked(m), K.POST_MARKS)))
    mtot, eused = (int(x) for x in diag.tolist())
    out["multi_slots"], out["expansion_rows"] = mtot, eused
    out["flagged"] = int(ofc.sum())
    log(f"stages {tag} (R={R}, S={S}): " + json.dumps(out))
    STAGES[tag] = out
    return out


def additive_stages(tt, mat, R, w, cap):
    """K3's additive arm (pre with cw = SW and no payloads, post additive
    with the dense rows and a (numK * S) count vector) on a real batch of
    R reads searched in the resident tables: the tiered finish's shapes
    (its T1 keys sit where K8 writes them) -> {pre, post: ms}."""
    import numpy as np
    import torch
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import turbo as T
    dev = torch.device(DEVICE)
    nk, S = tt.num_k, tt.num_species
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    q = E.encode_windows(torch.from_numpy(mat).to(dev), lut, w)
    skey, mpay = T.turbo_match(q, tt, R, w)
    SW = skey.shape[1]
    ck0, cc0, runs, mcnt, cp = T.turbo_reads_pre(skey, mpay)
    ca = torch.zeros((nk, S), device=dev)
    cu = torch.zeros((nk, S), dtype=torch.int32, device=dev)
    ofc, dm, _, _, _ = T.turbo_multi(cp, mcnt, runs, tt, ca, 1 << 30,
                                     1 << 30)
    del ck0, cc0, cp, mpay, q
    out = {"slots": slot_stats(skey)}
    out["pre"] = time_ms(lambda: T.turbo_reads_pre(skey, None, cw=SW,
                                                   num_species=S),
                         STAGE_REPS)
    ck, cc = T.turbo_reads_pre(skey, None, cw=SW, num_species=S)[:2]
    zero2 = torch.zeros(2, dtype=torch.int32, device=dev)
    cadd = torch.rand(nk * S, device=dev)
    out["post"] = time_ms(lambda: T.turbo_reads_post(
        ck, cc, ofc, dm, tt.weights, ca, cu, zero2, cap, wm=min(S, 256),
        additive=True, cadd=cadd), STAGE_REPS)
    log(f"stages additive (R={R}, SW={SW}, S={S}): " + json.dumps(out))
    return out


def route_chunks(q, C):
    """C distinct sorted chunk starts over the limb 0 of windows q: the
    first limb 0 of C equal slices of the sorted keys, as a chunk plan
    over an index of those windows would place them."""
    import torch
    l0 = torch.unique(q[:, 0])
    pick = torch.linspace(0, l0.numel() - 1, C, device=q.device).long()
    return torch.unique(l0[pick]).to(torch.int32)


def route_stages(mat, R, w):
    """K7's arms on a real batch's windows over synthetic chunk plans of
    4 to 20,000 chunks, each against its plain version, timed: the arm
    the wrapper picks and, below the shared arm's limit, the global arm
    too -> {C: {arm: ms}}."""
    import numpy as np
    import torch
    from kasa_tpu_torch import kernels as K
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    from kasa_tpu_torch.match import tiered as TI
    dev = torch.device(DEVICE)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(dev)
    q = E.encode_windows(torch.from_numpy(mat).to(dev), lut, w)
    out = {"M": q.shape[0]}
    keep = K.ROUTE_SHARED_MAX
    for C in (4, 64, 512, 2048, 11_999, 20_000):
        l0 = route_chunks(q, C)
        res = {}
        for force in (False, True):
            if force:
                K.ROUTE_SHARED_MAX = 1
            try:
                K.reset_counts()
                got = TI.tiered_route(q, l0, 7, 12)
                arm = [k for k, v in K.COUNTS.items() if v]
                want = TI.tiered_route_plain(q, l0, 7, 12)
                for nm, a, b in zip(("qr", "vbr", "posr", "cuts"), got,
                                    want):
                    same(f"{arm}.{nm} (C={l0.numel()})", a, b)
                res[",".join(arm)] = time_ms(
                    lambda: TI.tiered_route(q, l0, 7, 12), 10)
            finally:
                K.ROUTE_SHARED_MAX = keep
        res["plain"] = time_ms(lambda: TI.tiered_route_plain(q, l0, 7, 12),
                               3)
        out[l0.numel()] = res
    log("stages tiered_route: " + json.dumps(out))
    return out


def run_stages(preps, smi, t_all):
    """--stages: build, then the stage splits of K3, K4 and K7 on the
    default corpus (the default batch, the long batch, a 32,768-read
    additive batch and synthetic chunk plans) and on the 10,001-species
    corpus (the sparse batch)."""
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.match import fast
    phase_build()
    wait_prep(preps, t_all, ("default",))
    corpus = phase_corpus()
    disp = warm_up("stages default", corpus["index"], corpus["warm"])
    tt = disp.tt
    out = {"card": smi}
    mat, R, w, _ = real_batch(corpus)
    out["default"] = turbo_stages("default", tt, mat, R, w,
                                  disp.multi_budget, disp.exp_budget,
                                  disp.csr_cap(R))
    d = os.path.join(HERE, ".synth_corpus", "long")
    os.makedirs(d, exist_ok=True)
    lp = synth.long_reads(d, synth.LONG_READS, synth.LONG_PAIRS)
    mat, R, w, _ = real_batch(corpus, R=synth.LONG_READS, path=lp["reads"])
    mb, eb, wout = disp.budgets_for(1, w)
    out["long"] = turbo_stages("long", tt, mat, R, w, mb, eb,
                               disp.csr_cap(R), wout=wout)
    mat, R, w, _ = real_batch(corpus, R=4 * fast.READS_PER_BATCH)
    out["additive"] = additive_stages(tt, mat, R, w, disp.csr_cap(R))
    out["route"] = route_stages(mat, R, w)
    del disp, tt
    forget_tables()
    wait_prep(preps, t_all, ("bigS",))
    big = synth.generate_big_s(log=log)
    disp = warm_up("stages sparse", big["index"], big["warm"])
    mat, R, w, _ = real_batch(big)
    out["sparse"] = turbo_stages("sparse", disp.tt, mat, R, w,
                                 disp.multi_budget, disp.exp_budget,
                                 disp.csr_cap(R))
    with open(os.path.join(OUT, "chip_smoke_stages.json"), "w") as fh:
        json.dump(out, fh, indent=1)


def run_cards(preps, smi, t_all):
    """--cards: build, the default corpus, its single-card run and the
    mesh over four cards."""
    from kasa_tpu_torch import synth
    phase_build()
    wait_prep(preps, t_all, ("default",))
    corpus = phase_corpus()
    ref = (os.path.join(OUT, "mesh_single.json"),
           os.path.join(OUT, "mesh_single.csv"))
    _, _, info_1 = drive("mesh single card", corpus["smoke"], *ref,
                         PATH_KERNELS, over={"num_of_beasts": ALL_HITS},
                         corpus=corpus)
    cards = phase_mesh_cards(corpus, ref)
    if not cards:
        fail(f"--cards needs {MESH_CARDS} cards")
    with open(os.path.join(OUT, "chip_smoke_cards.json"), "w") as fh:
        json.dump({"card": smi, "single": info_1, "reads": synth.SMOKE_READS,
                   "cards": {t: {"launches": c, "info": i}
                             for t, (c, i) in cards.items()}}, fh, indent=1)


def _mesh_batch(smoke, R):
    import numpy as np
    import torch
    from kasa_tpu_torch.core import encode as E
    from kasa_tpu_torch.core.alphabet import build_codon_code_lut
    mat, R, w, _ = real_batch({"smoke": smoke}, R=R)
    mat_d = torch.from_numpy(mat).to(DEVICE)
    lut = torch.from_numpy(build_codon_code_lut().astype(np.int32)).to(DEVICE)
    return mat_d, lut, w, E.encode_windows(mat_d, lut, w)


# K4's split on the mesh phase's batch runs with an expansion budget of
# 1/64 of EXP_BUDGET: at the full budget a shard flags no read of it
MESH_SPLIT_EB = 1 << 13


def mesh_kernels_rank(index, smoke, R, R_classic):
    """One of two ranks at (dp, ip) = (1, 2) on a real batch: K4's split
    (at MESH_SPLIT_EB) against its plain version and against the OR of
    both shards' cut flags; the mesh step timed; K14 on the batch's
    gathered lists against its plain version, timed on rank 0 alone;
    then the classic meshes (classic_mesh)."""
    import torch
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import turbo as T
    from kasa_tpu_torch.match.pipeline import _load_index
    from kasa_tpu_torch.parallel import dist as D
    from kasa_tpu_torch.parallel import turbo_mesh as TM
    from kasa_tpu_torch.utils import timers
    mesh = D.make_identify_mesh(ip=MESH_IP, dp=1)
    out = {"probe": probe_cuda_gather(), "backend": D.dist.get_backend()}
    limbs, _, hk, content, _, tax_rows = _load_index(Config(), index)
    S = content.num_species
    st = TM.ShardedTurboTables.build(limbs, tax_rows, hk, 7, 12, S, MESH_IP,
                                     mesh.ip_index, DEVICE, None, index)
    del limbs, tax_rows
    tt = st.shard
    mat_d, lut, w, q = _mesh_batch(smoke, R)
    mb, eb, wout = T.batch_budgets(w * tt.num_k, S)
    cap = T.CSR_CAP_FACTOR * R
    skey, mpay = T.turbo_match(q, tt, R, w)
    ck, cc, runs, mcnt, cp = T.turbo_reads_pre(skey, mpay)
    cut = {}

    def reduce(f):
        cut[len(cut)] = f.clone()
        return D.or_over(mesh.ip_group, f)
    acc = [torch.zeros((tt.num_k, S), device=DEVICE) for _ in range(2)]
    mk = T.turbo_multi(cp, mcnt, runs, tt, acc[0], mb, MESH_SPLIT_EB,
                       flag_reduce=reduce)
    mp_ = T.turbo_multi_plain(cp, mcnt, runs, tt, acc[1], mb, MESH_SPLIT_EB,
                              flag_reduce=reduce)
    both = D.gather_over(mesh.ip_group, cut[0].to(torch.uint8)).bool()
    out["k4"] = dict(
        same=bool(torch.equal(mk[0], mp_[0]) and torch.equal(cut[0], cut[1])
                  and torch.equal(mk[4], mp_[4])),
        by_hand=bool(torch.equal(mk[0], both.any(dim=0))),
        err=max(float((a - b).abs().max()) for a, b in
                zip(mk[1:4] + (acc[0],), mp_[1:4] + (acc[1],))),
        local=int(cut[0].sum()), merged=int(mk[0].sum()),
        other=int(both.sum()) - int(cut[0].sum()))
    # the step as the drive loop queues it, on rank 0's clock (it waits
    # for rank 1 inside the collectives)
    ca = torch.zeros((tt.num_k, S), device=DEVICE)
    cu = torch.zeros((tt.num_k, S), dtype=torch.int32, device=DEVICE)

    def step():
        return TM.turbo_mesh_step(st, mesh, mat_d, lut, ca, cu, R, w, cap,
                                  mb, eb, wout)
    step()
    timers.reset()
    out["step_ms"] = time_ms(step, 5)
    out["collectives_ms"] = {k: 1e3 * v / 6 for k, v in timers._ACC.items()}
    # K14 on this batch's gathered lists
    packed_s, ht, hkl = T.turbo_core(
        tt, q, R, w, ca, cu, cap, mb, eb, wout=wout,
        flag_reduce=lambda f: D.or_over(mesh.ip_group, f))
    fl = packed_s[R:2 * R]
    ofc = (fl & 1) > 0
    ofl = D.or_over(mesh.ip_group, (fl & 2) > 0)
    hts = D.gather_over(mesh.ip_group, ht)
    hks = D.gather_over(mesh.ip_group, hkl)
    args = (hts, hks, ofc.contiguous(), ofl.contiguous(), cap)
    D.dist.barrier()
    if mesh.rank == 0:
        kp, kt, kv = TM.mesh_merge(*args)
        pp, pt, pv = TM.mesh_merge_plain(*args)
        ints = torch.ones(kp.numel(), dtype=torch.bool, device=DEVICE)
        ints[2 * R + 1:2 * R + 2 * cap:2] = False
        out["k14"] = dict(
            same=bool(torch.equal(kp[ints], pp[ints])
                      and torch.equal(kt, pt)),
            err=max(float((kv - pv).abs().max()),
                    float((kp[~ints].view(torch.float32)
                           - pp[~ints].view(torch.float32)).abs().max())),
            ms=time_ms(lambda: TM.mesh_merge(*args), 20),
            plain_ms=time_ms(lambda: TM.mesh_merge_plain(*args), 5),
            bytes=(hts.numel() * 8 + 2 * R + kp.numel() * 4
                   + kt.numel() * 8),
            ip=MESH_IP, R=R, wout=wout, hits=int(kp[-2]),
            flagged=int(kp[-1]))
    D.dist.barrier()
    del st, tt, ca, cu, hts, hks
    out["classic"] = classic_mesh(mesh, index, smoke, R_classic)
    return out


def classic_mesh(mesh, index, smoke, R):
    """K9 on this rank's ip shard of the classic tables, over the
    broadcast and the host-routed windows of a real batch
    (parallel/mesh.py)."""
    import numpy as np
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match.pipeline import _load_index
    from kasa_tpu_torch.parallel import mesh as PM
    limbs, taxids, hk, content, _, _ = _load_index(Config(), index)
    S = content.num_species
    si = PM.ShardedIndex.build(limbs, taxids, content.tax_to_idx, hk, 7, 12,
                               S, MESH_IP, mesh.ip_index, DEVICE)
    del limbs, taxids
    _, _, w, q = _mesh_batch(smoke, R)
    q = q.cpu().numpy()
    m = len(q)
    rid = (np.arange(m) // w).astype(np.int32)
    valid = np.ones(m, bool)
    run_b, _ = PM.make_sharded_classifier(si, mesh, R, m)
    sb = run_b(q[None], rid[None], valid[None])
    blocks = PM.route_queries(si, q, rid, valid, 1, m)
    if blocks[3]:
        raise RuntimeError(f"{blocks[3]} routed windows dropped")
    run_r, _ = PM.make_routed_classifier(si, mesh, R, m)
    sr = run_r(*blocks[:3])
    return ([t.cpu().numpy() for t in sb], [t.cpu().numpy() for t in sr],
            [int(x) for x in np.bincount(
                np.searchsorted(si.shard_lo, q[:, 0], "right") - 1,
                minlength=MESH_IP)])


def nccl_one_rank(index, smoke, out_j, out_p):
    """A world of one over NCCL: one all_reduce and one all_gather, then
    the identify through MeshTurboDispatch at (dp, ip) = (1, 1)."""
    import torch
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.pipeline import identify
    from kasa_tpu_torch.parallel import dist as D
    t = torch.arange(4, dtype=torch.float32, device=DEVICE)
    D.dist.all_reduce(t)
    out = {"backend": D.dist.get_backend(), "all_reduce": t.tolist(),
           "probe": probe_cuda_gather()}
    fast.mesh_shape = lambda *a: (1, 1)
    cfg = Config()
    cfg.num_of_beasts = ALL_HITS
    identify(cfg, index_path=index, input_path=smoke, out_file=out_j,
             profile_file=out_p, device=DEVICE)
    out["dispatch"] = type(fast.LAST_DISPATCH).__name__
    return out


def phase_mesh(corpus):
    """The turbo mesh through the CLI on two ranks that share the card
    over gloo, at (dp, ip) = (1, 2) and (2, 1) and over a budget that
    only half the tables fit; K4's split and K14 on a real batch; the
    classic meshes at ip = 2 against the single K9 run; a world of one
    over NCCL against the single-card run.  -> (kernel entries, launches,
    info)."""
    import numpy as np
    import torch
    from kasa_tpu_torch import synth
    from kasa_tpu_torch.config import Config
    from kasa_tpu_torch.match import device as D
    from kasa_tpu_torch.match import fast
    from kasa_tpu_torch.match.device import load_or_build_classic
    from kasa_tpu_torch.match.pipeline import _load_index
    from kasa_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    ref = (os.path.join(OUT, "mesh_single.json"),
           os.path.join(OUT, "mesh_single.csv"))
    _, _, info_1 = drive("mesh single card", corpus["smoke"], *ref,
                         PATH_KERNELS, over={"num_of_beasts": ALL_HITS},
                         corpus=corpus)
    tables_b = table_bytes(fast.LAST_DISPATCH.tt)
    launches, info = {}, {"single": info_1}
    ta = time.perf_counter()
    for tag, env, dp, ip in (
            ("1x2", {"KASA_MESH_DP": "1", "KASA_MESH_IP": "2"}, 1, 2),
            ("2x1", {"KASA_MESH_DP": "2", "KASA_MESH_IP": "1"}, 2, 1),
            ("over-budget", {"KASA_DEVICE_BUDGET": str(int(0.6 * tables_b))},
             1, 2)):
        launches[tag], info[tag] = mesh_cli(tag, corpus, env, dp, ip, ref)
    t1 = time.perf_counter()
    R = 8192
    rec = run_ranks(MESH_WORLD, "chip_smoke:mesh_kernels_rank",
                    (corpus["index"], corpus["smoke"], R, 1024),
                    out_dir=os.path.join(OUT, "mesh_kernels"))
    t2 = time.perf_counter()
    r0, r1 = rec[0]["result"], rec[1]["result"]
    for r in (r0, r1):
        if not (r["k4"]["same"] and r["k4"]["by_hand"]) \
                or r["k4"]["err"] > ATOL:
            fail(f"mesh: K4's split disagrees: {r['k4']}")
    if r0["k4"]["merged"] <= max(r0["k4"]["local"], r1["k4"]["local"]):
        fail(f"mesh: the split's OR took in no other shard's flag: "
             f"{r0['k4']} {r1['k4']}")
    k14 = r0["k14"]
    if not k14["same"] or k14["err"] > ATOL:
        fail(f"mesh: K14 disagrees with its plain version: {k14}")
    log(f"mesh: gloo all_gather of CUDA tensors: {r0['probe']}; K4 split "
        f"on a {R}-read batch at an expansion budget of {MESH_SPLIT_EB} "
        f"rows: rank 0 cut {r0['k4']['local']} flags, rank 1 "
        f"{r1['k4']['local']}, both expanded under the OR "
        f"({r0['k4']['merged']}), equal to the flags ORed by hand and to "
        f"the plain split (max abs {max(r0['k4']['err'], r1['k4']['err'])})")
    log(f"mesh: step {r0['step_ms']:.4f} ms per {R}-read batch at (1, 2) "
        f"on rank 0's clock ({MESH_RATE_NOTE}); collectives ms per step: "
        f"{json.dumps(r0['collectives_ms'])}")
    entry = kernel_entry(
        "mesh_merge", "kasa_tpu_torch/csrc/mesh_merge.cu",
        "kasa_tpu/parallel/turbo_mesh.py:230", launches["1x2"]["mesh_merge"],
        k14["err"], k14["ms"], k14["plain_ms"], k14["bytes"], None)
    log(f"mesh: K14 on the batch's gathered lists (ip {k14['ip']}, wout "
        f"{k14['wout']}, {k14['hits']} hits, {k14['flagged']} flagged "
        "reads); no single PyTorch call computes the merge")

    # the classic meshes at ip = 2 against the single K9 run (the
    # default corpus's classic tables are in the RAM cache)
    sb, sr, owners = r0["classic"]
    cfg = Config()
    limbs, taxids, hk, content, _, tax_rows = _load_index(cfg,
                                                          corpus["index"])
    ctab = load_or_build_classic(corpus["index"], limbs, taxids,
                                 content.tax_to_idx, hk, 7, 12,
                                 content.num_species, DEVICE, tax_rows)
    del limbs, taxids, tax_rows
    _, _, w, q = _mesh_batch(corpus["smoke"], 1024)
    rid = (torch.arange(q.shape[0], device=DEVICE) // w).to(torch.int32)
    valid = torch.ones(q.shape[0], dtype=torch.bool, device=DEVICE)
    # the single run: K9 held to its plain version on the local arm
    k9_against_plain(ctab, q, rid, valid, 1024, 0, ".mesh",
                     "mesh batch (scatter layout, all the tables)")
    one = D.classify_batch(ctab, q, rid, valid, 1024, 16)
    one = [torch.as_tensor(t).cpu().numpy() for t in one]
    for name, got in (("broadcast", sb), ("routed", sr)):
        if not np.array_equal(got[2][0], one[2]) or \
                int(got[3].sum()) != int(one[3]):
            fail(f"mesh classic {name}: counts differ from the single K9 run")
        for a, b in ((got[0][0], one[0]), (got[1][0], one[1])):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    launches["classic"] = rec[0]["counts"]
    if not k9_launches("mesh classic", rec[0]["counts"]):
        fail("mesh classic: K9 was not launched on rank 0")
    log(f"mesh classic: broadcast and routed K9 on 2 shards of the classic "
        f"tables agree with the single K9 run (itself held to its plain "
        f"version) on {q.shape[0]} windows of "
        f"1,024 reads (windows routed per shard {owners}); rank 0 launches "
        + json.dumps({a: rec[0]["counts"][a] for a in K9_ARMS}))
    del ctab
    t3 = time.perf_counter()

    # a world of one over NCCL
    stem = os.path.join(OUT, "mesh_nccl")
    tn = time.perf_counter()
    nc = run_ranks(1, "chip_smoke:nccl_one_rank",
                   (corpus["index"], corpus["smoke"], stem + ".json",
                    stem + ".csv"), out_dir=stem + "_rank")
    dt = time.perf_counter() - tn
    res = nc[0]["result"]
    if res["backend"] != "nccl" or res["dispatch"] != "MeshTurboDispatch":
        fail(f"mesh nccl: {res}")
    expect_launched("mesh nccl", nc[0]["counts"], MESH_KERNELS)
    ndiff = identify_files_agree("mesh nccl", ref,
                                 (stem + ".json", stem + ".csv"))
    os.remove(stem + ".json")
    launches["nccl"] = nc[0]["counts"]
    info["nccl"] = dict(seconds=dt, **res)
    log(f"mesh nccl: a world of one over NCCL (all_reduce "
        f"{res['all_reduce']}, all_gather {res['probe']}) ran the "
        f"{synth.SMOKE_READS} smoke reads through MeshTurboDispatch at (1, 1) "
        f"in {dt:.3f} s (process start to exit) and agrees with the "
        f"single-card run ({ndiff} reads' records differ in bytes); "
        f"launches {nc[0]['counts']}")
    t4 = time.perf_counter()
    cards = phase_mesh_cards(corpus, ref)
    os.remove(ref[0])
    for tag, (counts, inf) in cards.items():
        launches[tag], info[tag] = counts, inf
    info["kernels_rank0"] = {k: v for k, v in r0.items() if k != "classic"}
    log(f"mesh: seconds: single card {ta - t0:.1f}, the three CLI runs "
        f"and their checks {t1 - ta:.1f}, kernel and classic ranks "
        f"{t2 - t1:.1f}, classic reference {t3 - t2:.1f}, nccl and its "
        f"check {t4 - t3:.1f}, four cards {time.perf_counter() - t4:.1f}; "
        f"phase {time.perf_counter() - t0:.1f}")
    return [entry], launches, info


def run(preps, smi, t_all):
    import torch
    from kasa_tpu_torch import synth

    def mark(name):
        log(f"chip_smoke: {name} done {time.perf_counter() - t_all:.1f} s "
            "after the start")
    phase_build()
    phase_golden()
    phase_golden_flags()
    launches_j = phase_golden_classic()
    launches_cov = phase_golden_engines()
    phase_golden_long()
    launches_b = phase_build_golden()
    mark("golden phases")
    forget_tables()
    wait_prep(preps, t_all, ("default",))
    corpus = phase_corpus()
    disp, launches, info, single_counts = phase_full(corpus)
    launches_f, infos_f = phase_full_flags(corpus, single_counts)
    mat, R, w, _ = real_batch(corpus)
    phase_sample(disp, mat, R, w)
    mat6, _, w6, lpr = real_batch(corpus, six=True)
    phase_sample(disp, mat6, R, w6, lpr=lpr, unique=True)
    kern, step_ms = phase_kernels(disp, mat, R, w, launches)
    k5, steps, six_e_ms = phase_kernels_flags(disp, corpus, mat, R, w,
                                              launches_f["six_e"])
    kern.append(k5)
    budgets = phase_budgets(disp, corpus, R)
    mark("full, flags, kernels")
    # long read lines on the same tables (K3's and K5's long arms)
    k_long, launches_long, infos_long = phase_long(corpus)
    kern += k_long
    mark("long")
    # the classic engine against the turbo run of the same reads (the
    # turbo tables are still on the card), then K9 and the sloppy arm
    cvt = {}
    launches_c, cvt["default"], ctab = classic_vs_turbo(
        "classic-vs-turbo default", corpus["index"], corpus["smoke"], {},
        synth.SMOKE_READS)
    k_cl, steps["classic_default"] = phase_kernels_classic(
        ctab, mat, R, w, launches_c, "default k 7..12", "", launches_j)
    kern += k_cl
    # the join engine (--coverage) and the per-batch engine over -m on
    # the same index, while its classic tables sit in the RAM cache
    launches_jn, info_jn, jbatch = phase_join(
        "join", corpus["index"], corpus["smoke"], {}, synth.SMOKE_READS)
    k_jn, steps["join"], info_jn["k12"] = phase_kernels_join(
        jbatch[0].tables, jbatch, launches_jn, "", "join run (L = 2)")
    kern += k_jn
    launches_oo, info_oo, k_oo = phase_oocore(corpus)
    kern.append(k_oo)
    mark("classic-vs-turbo, join, oocore")
    # the mesh on the default corpus
    k_mesh, launches_mesh, info_mesh = phase_mesh(corpus)
    kern += k_mesh
    mark("mesh")
    # one index on the card at a time: the next run's peak memory is its
    # own tables and batches
    del disp, ctab, jbatch
    forget_tables()
    wait_prep(preps, t_all, ("bigS",))
    disp_s, big, launches_s, info_s, info_sm = phase_sparse()
    k_sparse, steps["sparse"], sparse_ms = phase_kernels_sparse(
        disp_s, big, launches_s)
    del disp_s
    forget_tables()
    wait_prep(preps, t_all, ("wide",))
    disp_w, launches_w, infos_w = phase_wide(corpus)
    k_wide, steps_w, wide_ms = phase_kernels_wide(
        disp_w, corpus, launches_w["wide"], launches_w["wide --six -e"])
    steps.update(steps_w)
    kern += k_sparse + k_wide
    # K5's global arm: long reads under --six -e on the wide tables
    k5g, info_k5g = phase_dedup_global(synth.generate_wide(log=log)["index"])
    kern.append(k5g)
    mark("sparse, wide")
    wide_index = synth.generate_wide(log=log)["index"]
    _, cvt["wide"], _ = classic_vs_turbo(
        "classic-vs-turbo wide", wide_index, corpus["smoke"],
        {"lower_k": 20, "higher_k": 25}, synth.SMOKE_READS)
    # the join engine at L = 5 on the wide index (its classic tables of
    # k 20..25 sit in the RAM cache)
    launches_jw, info_jw, jbatch = phase_join(
        "join wide", wide_index, corpus["warm"],
        {"lower_k": 20, "higher_k": 25}, synth.WARM_READS)
    k_jw, steps["join_wide"], info_jw["k12"] = phase_kernels_join(
        jbatch[0].tables, jbatch, launches_jw, ".L5", "join wide run")
    kern += k_jw
    del disp_w, jbatch
    forget_tables()
    # the index build at the corpus's size (K13), against the wide index
    k13, info_bw = phase_build_wide(corpus, synth.generate_wide(log=log))
    kern.append(k13)
    mark("join wide, build-wide")
    # the classic engine at full width: the 128-bit corpus over 14 levels
    launches_cl, infos_cl, ctab = phase_classic(corpus)
    mat5, _, w5, _ = real_batch(corpus, highest_k=25, min_k=12)
    k_cl5, steps["classic"] = phase_kernels_classic(
        ctab, mat5, R, w5, launches_cl["classic"], "128-bit k 12..25", ".L5")
    kern += k_cl5 + phase_kernels_per_batch(ctab, corpus["pairs"],
                                            launches_cl["classic pairs"])
    mark("classic")
    del ctab
    forget_tables()
    # the tiered path: the runs, then each kernel on a batch of each run
    runs = phase_tiered(corpus, big)
    tiered_ms = {}
    for tag, src, six, suffix in (("tiered", corpus, False, ""),
                                  ("tiered --six -e", corpus, True,
                                   ".six_e"),
                                  ("tiered bigS", big, False, ".bigS")):
        tl, tinfo, tdisp = runs[tag]
        tmat, tR, tw, tlpr = real_batch(src, six=six,
                                        R=tdisp.reads_per_batch)
        entries, tiered_ms[tag] = phase_kernels_tiered(
            tdisp, tmat, tR, tw, tlpr, six, tl, tag, suffix)
        if suffix != ".six_e":
            kern += entries
        steps[tag] = tiered_ms[tag]["step"]
        runs[tag] = (tl, tinfo, None)
        del tdisp
        forget_tables()
    for tag, inf, ms in (("full", info, step_ms),
                         ("full-flags six -e", infos_f["six_e"],
                          steps["six_e"]),
                         ("full-flags paired", infos_f["paired"],
                          steps["paired"]),
                         ("full-flags paired --six", infos_f["paired_six"],
                          steps["paired_six"]),
                         ("full-flags multi", infos_f["multi"],
                          steps["files4"]),
                         ("sparse", info_s, steps["sparse"]),
                         ("sparse multi", info_sm, steps["sparse"]),
                         ("wide", infos_w["wide"], steps["wide"]),
                         ("wide --six -e", infos_w["wide --six -e"],
                          steps["wide_six_e"]),
                         ("classic-vs-turbo default (classic)",
                          cvt["default"], steps["classic_default"]),
                         ("classic", infos_cl["classic"], steps["classic"]),
                         ("join", info_jn, steps["join"]),
                         ("join wide", info_jw, steps["join_wide"])):
        nb = inf["batches"] if "batches" in inf else -(-inf["reads"] // R)
        inf["busy_pct"] = 100.0 * ms * 1e-3 * nb / inf["seconds"]
        log(f"{tag}: the device is busy about {inf['busy_pct']:.2f} % of "
            f"the identify run ({nb} batch steps of {ms:.4f} ms in "
            f"{inf['seconds']:.3f} s; copies not counted)")
    for tag, (_, inf, _) in runs.items():
        ms = steps[tag]
        inf["busy_pct"] = 100.0 * ms * 1e-3 * inf["batches"] \
            / inf["seconds"]
        log(f"{tag}: the device is busy about {inf['busy_pct']:.2f} % of "
            f"the identify run ({inf['batches']} batch steps of {ms:.4f} ms "
            f"in {inf['seconds']:.3f} s; chunk uploads not counted)")
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "full": info, "full_flags": infos_f,
                   "launches_flags": launches_f, "sparse": info_s,
                   "sparse_multi": info_sm, "launches_sparse": launches_s,
                   "wide": infos_w, "launches_wide": launches_w,
                   "classic_vs_turbo": cvt, "classic": infos_cl,
                   "launches_classic": launches_cl,
                   "tiered": {t: r[1] for t, r in runs.items()},
                   "launches_tiered": {t: r[0] for t, r in runs.items()},
                   "tiered_kernel_ms": tiered_ms,
                   "launches_golden_coverage": launches_cov,
                   "join": info_jn, "launches_join": launches_jn,
                   "join_wide": info_jw, "launches_join_wide": launches_jw,
                   "oocore": info_oo, "launches_oocore": launches_oo,
                   "long": infos_long, "launches_long": launches_long,
                   "dedup_global": info_k5g,
                   "mesh": info_mesh, "launches_mesh": launches_mesh,
                   "build_wide": info_bw,
                   "launches_build_golden_k25": launches_b,
                   "kernels": kern, "step_ms": step_ms,
                   "step_ms_by_mode": steps, "six_e_kernel_ms": six_e_ms,
                   "sparse_kernel_ms": sparse_ms, "wide_kernel_ms": wide_ms,
                   "budgets": budgets, "stages": STAGES}, fh, indent=1)
    return kern


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    if not os.path.isdir(os.path.join(HERE, "kasa_tpu_torch")) or \
            not os.path.isdir(os.path.join(HERE, "tests", "golden")):
        fail("run chip_smoke.py from the root of a kasa-tpu checkout")
    sys.path.insert(0, HERE)
    os.makedirs(OUT, exist_ok=True)
    t_all = time.perf_counter()
    smi = smi_line()
    log(smi)
    cards = sys.argv[1:] == ["--cards"]
    stages = sys.argv[1:] == ["--stages"]
    if sys.argv[1:] and not (cards or stages):
        fail(f"unknown arguments {sys.argv[1:]}: none, --cards or "
             "--stages")
    preps = start_prep(("default",) if cards else
                       ("default", "bigS") if stages else PREP,
                       tiered=not stages)
    try:
        kern = None if cards or stages else run(preps, smi, t_all)
        if cards:
            run_cards(preps, smi, t_all)
        if stages:
            run_stages(preps, smi, t_all)
    finally:
        stop_prep(preps)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_all:.1f} s")
    print(smi)
    if kern is not None:
        print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
