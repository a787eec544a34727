"""Seconds per item of stage 1's first-step LM solves over all its starts
(the double sphere's multi-start): the ``stage`` 1 records of the summary's
``intrinsics_solves``, each the host wall of one LM loop, summed per item,
mean over the window's items. None where the items carry no such records."""


def read(run):
    vals = []
    for a in run["window"]["answers"]:
        solves = a.get("summary", {}).get("intrinsics_solves") if isinstance(a, dict) else None
        if not solves:
            return None
        vals.append(sum(s["seconds"] for s in solves if s.get("stage") == 1))
    return sum(vals) / len(vals) if vals else None
