"""``layout_s``: per solve of the window, the host seconds of the
program's ``cpapr.prep.layout`` spans (the entry's policies and blocked
layouts, and the mode updates bound to them); read as ``validate_s``
reads its span."""
from pathlib import Path

from portbench.harness import load_metric

NAME = "cpapr.prep.layout"


def read(run):
    return load_metric("validate_s", Path(__file__).parent.parent) \
        .span_seconds(run, NAME)
