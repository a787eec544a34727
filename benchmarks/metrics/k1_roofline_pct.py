"""K1 (fused densify + Gram, ``solver/gram.py`` -> ``csrc/gram.cu``) in the
traced item: the least time its calls need at the card's published peaks
(``harness/peaks.gram_work`` of each call's shapes) over the device time of
its kernels, in %."""

from benchmarks.harness import peaks

KERNELS = ("fused_gram_kernel", "row_tile_ranges_kernel", "reduce_slabs_kernel")


def read(run):
    calls = run["calls"].get("gram", [])
    device_s = run["trace"].kernel_seconds(KERNELS)
    if not calls or device_s <= 0:
        return None
    bound = sum(peaks.bound_s(*peaks.gram_work(*c), run["kind"]) for c in calls)
    return 100.0 * bound / device_s
