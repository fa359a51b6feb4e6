"""Tiny cells for the CPU tests: the two configurations and traffic mixes
at a size a test run holds, with the same keys as the real files."""

import json
import os

from benchmark import harness

BENCH = harness.BENCH


def _file(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


def config(name: str) -> dict:
    cfg = _file("configs", name + ".json")
    cfg.update(num_species=24, genome_len=1200, core_genes=4,
               core_per_genome=2, ultra_genomes=6)
    return cfg


def traffic(name: str) -> dict:
    tr = _file("traffic", name + ".json")
    tr.update(reads_per_batch=24, ring_batches=3, in_flight=2,
              sample_per_batch=6, warm_batches=3)
    if not tr["paired"]:
        tr.update(read_len_mean=400, read_len_sd=150, read_len_min=200,
                  read_len_max=700)
    return tr


def cell(name: str) -> harness.Cell:
    """The cell `name` (<config>.<traffic>, with limits/<name>.json) at
    the tiny size, reporting every metric that BENCHMARK.json names,
    whether or not BENCHMARK.json lists the cell."""
    man = _file("..", "BENCHMARK.json")
    conf, traf = name.split(".")
    return harness.Cell(name, 1, config(conf), traffic(traf),
                        _file("limits", name + ".json"), man["end_to_end"],
                        man["per_layer"])


def session(name: str, cache: str, log=lambda m: None, device="cpu"):
    """A Session of the tiny cell, its index generated under cache."""
    sess = harness.Session(cell(name), device, log, cache)
    sess.build()
    sess.prepare_index()
    return sess
