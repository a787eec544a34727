"""Levenberg-Marquardt iterations of stage 8 per item (summed over its LM
stages; the batch cell: the joint solve's), mean over the window's items."""

from benchmarks.metrics_common import lm_totals


def read(run):
    t = lm_totals(run)
    return t["iterations"] / t["items"] if t else None
