"""Published peaks of the card the benchmark runs on, and the work of each
hand-written kernel counted from the shapes its call needs.

NVIDIA H100 SXM data sheet, dense rates: 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s HBM3. The card's power limit, which can sit below
the 700 W these assume, is recorded beside every run (``device.power_limit``).
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flop_s": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    """The published peaks of the card ``kind``; a card without an entry
    has no roofline until its data sheet's rates are added here."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}; add its entry to PEAKS")
    return PEAKS[kind]


def gram_work(K: int, R: int, F: int, L: int, n_run: int) -> tuple[int, int]:
    """(bytes, operations) of one fused densify + Gram call (K1): J, r and
    the run indices read once, H and g written once; F nonzeros per row of
    D, the upper triangle of each row's outer product plus g."""
    return (K * R * (F + 1 + n_run) * 4 + K * (L * L + L) * 4,
            K * R * (F * (F + 1) + 2 * F))


def corner_block_work(F: int, H: int, W: int, radius: int = 6) -> tuple[int, int]:
    """(bytes, operations) of one block-mode corner response call (K2): the
    block read once and the response written once; per pixel the separable
    form's taps (6r at angle 0, 6(2r - 1) at pi/4, two operations each) and
    the response reduction (32)."""
    n_taps = 6 * radius + 6 * (2 * radius - 1)
    return F * H * W * 4 * 2, F * H * W * (2 * n_taps + 32)


def bound_s(nbytes: int, ops: int, kind: str) -> float:
    """Least seconds the card could take: the larger of the two bounds."""
    p = peaks(kind)
    return max(nbytes / p["hbm_bytes_s"], ops / p["fp32_flop_s"])
