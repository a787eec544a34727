"""Milliseconds of stage 8's LM loop per linearization: the loop's host-clock
seconds (``LMResult.seconds``) over its linearizations, all the window's
items together; a linearization plus the damped solves that follow it."""

from benchmarks.metrics_common import lm_totals


def read(run):
    t = lm_totals(run)
    return 1e3 * t["seconds"] / t["linearizations"] if t and t["linearizations"] else None
