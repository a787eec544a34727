"""What several per-layer metric readers share: the program's own spans and
counters as the window's items carry them."""

from __future__ import annotations


def stage_mean(run, prefixes):
    """Mean over the window's items of the seconds of the
    ``stage_timings_s`` entries whose names start with ``prefixes``."""
    vals = []
    for a in run["window"]["answers"]:
        st = a.get("summary", {}).get("stage_timings_s") if isinstance(a, dict) else None
        if st is None:
            return None
        vals.append(sum(v for k, v in st.items() if k.startswith(prefixes)))
    return sum(vals) / len(vals) if vals else None


def lm_totals(run):
    """{items, iterations, seconds, linearizations} of stage 8's LM loops
    over the window's items, or None where the items carry none."""
    tot = {"items": 0, "iterations": 0, "seconds": 0.0, "linearizations": 0}
    for a in run["window"]["answers"]:
        if not isinstance(a, dict):
            return None
        stages = a.get("lm_stages") or ([a["lm"]] if "lm" in a else None)
        if stages is None:
            return None
        tot["items"] += 1
        for s in stages:
            for k in ("iterations", "seconds", "linearizations"):
                tot[k] += s[k]
    return tot if tot["items"] else None
