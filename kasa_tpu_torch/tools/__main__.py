"""Dispatcher CLI: ``python -m kasa_tpu_torch.tools <tool> [flags]``.

Tool names and getopt flags match the reference scripts (scripts/,
README.md:483-493) so existing pipelines can switch by replacing
``python scripts/<tool>.py`` with ``python -m kasa_tpu_torch.tools <tool>``.
"""

from __future__ import annotations

import getopt
import sys

from . import cami, frequencies, reads, reconstruct

TOOLS = {}


def _tool(name, optstring):
    def deco(fn):
        TOOLS[name] = (fn, optstring)
        return fn
    return deco


def _opts(argv, optstring):
    pairs, _ = getopt.getopt(argv, optstring)
    return dict(pairs)


@_tool("jsonToFrequencies", "i:o:t:")
def _json_to_freqs(o):
    frequencies.json_to_frequencies(o["-i"], o["-o"], float(o.get("-t", 0.0)))


@_tool("jsonToFrequenciesTopOnly", "i:o:t:")
def _json_to_freqs_top(o):
    frequencies.json_to_frequencies(o["-i"], o["-o"], float(o.get("-t", 0.0)),
                                    top_only=True)


@_tool("jsonLToFrequencies", "i:o:t:")
def _jsonl_to_freqs(o):
    frequencies.jsonl_to_frequencies(o["-i"], o["-o"], float(o.get("-t", 0.0)))


@_tool("jsonLToFrequenciesTopOnly", "i:o:t:")
def _jsonl_to_freqs_top(o):
    frequencies.jsonl_to_frequencies(o["-i"], o["-o"], float(o.get("-t", 0.0)),
                                     top_only=True)


@_tool("tsvToFrequencies", "i:o:t:")
def _tsv_to_freqs(o):
    frequencies.tsv_to_frequencies(o["-i"], o["-o"], float(o.get("-t", 0.0)))


@_tool("sumFreqsOnTaxLvl", "i:n:m:r:o:")
def _sum_freqs(o):
    frequencies.sum_freqs_on_tax_level(o["-i"], o["-n"], o["-m"], o["-r"], o["-o"])


@_tool("csvToCAMI", "i:n:m:o:k:u:t:")
def _csv_to_cami(o):
    cami.csv_to_cami(o["-i"], o["-n"], o["-m"], o["-o"], o.get("-k", "12"),
                     o.get("-u", "n"), float(o.get("-t", 0.0)))


@_tool("freqsToCAMI", "i:n:m:o:t:")
def _freqs_to_cami(o):
    cami.freqs_to_cami(o["-i"], o["-n"], o["-m"], o["-o"],
                       float(o.get("-t", 0.0)))


@_tool("jsonToCAMIBin", "i:o:")
def _json_to_cami_bin(o):
    cami.json_to_cami_bin(o["-i"], o["-o"])


@_tool("camiToKrona", "i:o:")
def _cami_to_krona(o):
    cami.cami_to_krona(o["-i"], o["-o"])


@_tool("jsonToJsonL", "")
def _json_to_jsonl(o, args):
    reads.json_to_jsonl(args[0], args[1])


@_tool("getNotIdentifiedJson", "i:f:o:t:")
def _not_idd_json(o):
    reads.get_not_identified_json(o["-i"], o["-f"], o["-o"],
                                  float(o.get("-t", 0.0)))


@_tool("getNotIdentifiedJsonL", "i:f:o:t:")
def _not_idd_jsonl(o):
    reads.get_not_identified_jsonl(o["-i"], o["-f"], o["-o"],
                                   float(o.get("-t", 0.0)))


@_tool("getReadsForTaxonFromJsonl", "i:f:o:t:")
def _reads_for_taxon(o):
    reads.get_reads_for_taxon(o["-i"], o["-f"], o["-o"], o["-t"])


@_tool("downloadGenomesFromContent", "i:o:")
def _download_genomes(o):
    reads.download_genomes_from_content(o["-i"], o["-o"])


@_tool("reconstructDNA", "")
def _reconstruct(o, args):
    ok = reconstruct.reconstruct_dna(args[0], len(args) > 1 and bool(args[1]))
    if ok is None:
        sys.exit(1)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in TOOLS:
        print("usage: python -m kasa_tpu_torch.tools <tool> [flags]\ntools:",
              " ".join(sorted(TOOLS)))
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    fn, optstring = TOOLS[argv[0]]
    if optstring:
        fn(_opts(argv[1:], optstring))
    else:
        fn({}, argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
