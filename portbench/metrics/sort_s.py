"""``sort_s``: per solve of the window, the host seconds of the program's
``cpapr.prep.sort`` spans (the entry's sort of the nonzeros by each
mode's index); read as ``validate_s`` reads its span."""
from pathlib import Path

from portbench.harness import load_metric

NAME = "cpapr.prep.sort"


def read(run):
    return load_metric("validate_s", Path(__file__).parent.parent) \
        .span_seconds(run, NAME)
