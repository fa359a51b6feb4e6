"""Post-processing tools around the classifier's output files (port of
kasa_tpu/tools, host code).

The reference ships these as standalone scripts (reference scripts/,
README.md:483-493); here they are a package of importable functions with
a single dispatcher CLI (``python -m kasa_tpu_torch.tools <tool> ...``) that
accepts the same getopt-style flags as the original scripts.  Behavior
(including column layouts, tie-breaking and sort orders) matches the
reference scripts; each function cites its script.
"""
