"""Seconds per item in the pipeline's corner-file stages (0a + 0b of
``run_calibration``'s ``stage_timings_s``: ``utils/io.load_corners`` on the
resume path), mean over the window's items."""

from benchmarks.metrics_common import stage_mean


def read(run):
    return stage_mean(run, ("0a.", "0b."))
