"""Share (%) of the traced item's host-clock window in which nothing ran on
the card: 100 * (1 - union of device activity / window). None when the
trace holds no device activity (a run without the card)."""


def read(run):
    tr = run["trace"]
    if not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.union_s() / tr.window_s)
