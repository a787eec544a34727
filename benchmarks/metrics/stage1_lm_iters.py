"""Levenberg-Marquardt iterations per item of pipeline stage 1 (every
record of the summary's ``intrinsics_solves``: each multi-start solve and
the later stages' solves), mean over the window's items. None where the
items carry no such records."""


def read(run):
    vals = []
    for a in run["window"]["answers"]:
        solves = a.get("summary", {}).get("intrinsics_solves") if isinstance(a, dict) else None
        if not solves:
            return None
        vals.append(sum(s["iterations"] for s in solves))
    return sum(vals) / len(vals) if vals else None
