"""K2's block mode (``detect/kernels.corner_response_block`` ->
``csrc/corner_nms.cu``) in the traced pass: the least time its calls need at
the card's published peaks (``harness/peaks.corner_block_work`` of each
block's shape) over the device time of its kernels, in %."""

from benchmarks.harness import peaks

KERNELS = ("corner_nms_kernel",)


def read(run):
    calls = run["calls"].get("k2_block", [])
    device_s = run["trace"].kernel_seconds(KERNELS)
    if not calls or device_s <= 0:
        return None
    bound = sum(peaks.bound_s(*peaks.corner_block_work(*shape), run["kind"])
                for shape in calls)
    return 100.0 * bound / device_s
