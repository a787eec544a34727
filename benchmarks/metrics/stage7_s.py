"""Seconds per item in stage 7 of the pipeline (``stage_timings_s`` of
``run_calibration``, a host-clock span that ends in a host read), mean over
the window's items."""

from benchmarks.metrics_common import stage_mean


def read(run):
    return stage_mean(run, ("7.",))
