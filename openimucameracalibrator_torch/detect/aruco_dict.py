"""ArUco marker dictionaries: encoding, rotation tables, batched decoding.

A copy of ``detect/aruco_dict.py`` of the JAX package (numpy only).

The reference detects charuco targets with OpenCV's DICT_ARUCO_ORIGINAL
(reference src/core/board_extractor.cc:46,135-173). That dictionary is
algorithmic (Garrido-Jurado et al., the original ArUco fiducial generator):
each of the 1024 markers is a 5x5 bit grid whose five rows each encode two
information bits of the 10-bit id through a modified Hamming code

    row bits (d1 d0) -> 5-cell pattern:  00 -> 10000   01 -> 10111
                                         10 -> 01001   11 -> 01110

with 1 = white cell, row 0 encoding the two most-significant id bits.

Decoding is expressed as one matmul: candidate bit vectors (M, 25) against
the (4*K, 25) rotation-augmented dictionary; Hamming distance
= popcount(a) + popcount(b) - 2 a.b is linear in the +/-1 encoding, so the
argmin over markers*rotations is an MXU-friendly ``(M, 25) @ (25, 4K)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_ROW_PATTERNS = np.array([
    [1, 0, 0, 0, 0],  # 00
    [1, 0, 1, 1, 1],  # 01
    [0, 1, 0, 0, 1],  # 10
    [0, 1, 1, 1, 0],  # 11
], dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class ArucoDictionary:
    """A square-marker dictionary: (K, n, n) bit grids, 1 = white cell."""

    name: str
    bits: np.ndarray  # (K, n, n) uint8
    max_correction_bits: int = 2

    @property
    def num_markers(self) -> int:
        return self.bits.shape[0]

    @property
    def marker_size(self) -> int:
        return self.bits.shape[1]

    def rotations(self) -> np.ndarray:
        """(4, K, n, n): marker bits under 0/90/180/270-degree rotation.

        rotations()[r, k] is marker k rotated r*90 degrees counter-clockwise
        in marker coordinates; a detector that observes that grid must rotate
        its corner ordering by r to recover the canonical orientation.
        """
        return np.stack([np.rot90(self.bits, r, axes=(1, 2)) for r in range(4)])

    def flat_codes(self) -> np.ndarray:
        """(4*K, n*n) float32 in {-1, +1} for matmul decoding; row index
        = r * K + k."""
        rot = self.rotations().reshape(4 * self.num_markers, -1)
        return (rot.astype(np.float32) * 2.0 - 1.0)


def subset_dictionary(dictionary: ArucoDictionary,
                      ids: np.ndarray) -> tuple:
    """(sub_dictionary, id_map): restrict decoding to a known id subset.

    A calibration target uses only a few dozen ids of its dictionary;
    decoding against the FULL dictionary (1024 markers x 25 bits for
    DICT_ARUCO_ORIGINAL) invites misdecodes under shear/defocus — a
    wrong-but-valid board id corrupts the local corner homographies and
    shifts whole corner neighborhoods by a square (observed: 16-70 px
    view RMSE outliers at 960x540). Restricting the code set raises the
    effective pairwise distance; the correction budget is RE-DERIVED from
    the subset's true minimum rotation-aware Hamming distance, capped at
    the parent dictionary's budget. ``id_map[k]`` maps a subset decode
    index back to the original marker id. Reference analog: OpenCV
    refineDetectedMarkers' board-aware rejection
    (board_extractor.cc:135-173).
    """
    ids = np.asarray(sorted(int(i) for i in ids), np.int64)
    bits = dictionary.bits[ids]
    rot = np.stack([np.rot90(bits, r, axes=(1, 2)) for r in range(4)])
    flat = rot.reshape(4, len(ids), -1).astype(np.int16)
    dmin = flat.shape[-1]
    for r in range(4):
        for s in range(4):
            d = np.abs(flat[r][:, None, :] - flat[s][None, :, :]).sum(-1)
            if r == s:
                np.fill_diagonal(d, dmin)
            else:
                # a marker colliding with a rotation of itself is also a
                # decode ambiguity unless the rotation is identical
                np.fill_diagonal(d, np.where(d.diagonal() == 0, dmin,
                                             d.diagonal()))
            dmin = min(dmin, int(d.min()))
    corr = min(dictionary.max_correction_bits, max((dmin - 1) // 2, 0))
    sub = ArucoDictionary(f"{dictionary.name}_subset{len(ids)}", bits,
                          max_correction_bits=corr)
    return sub, ids


def aruco_original_marker_bits(marker_id: int) -> np.ndarray:
    """5x5 bit grid (1 = white) of DICT_ARUCO_ORIGINAL marker ``marker_id``."""
    if not 0 <= marker_id < 1024:
        raise ValueError(f"ARUCO_ORIGINAL ids are 0..1023, got {marker_id}")
    rows = []
    for i in range(5):
        d = (marker_id >> (8 - 2 * i)) & 0x3
        rows.append(_ROW_PATTERNS[d])
    return np.stack(rows).astype(np.uint8)


_CACHE: dict = {}


def aruco_original_dictionary(num_markers: int = 1024) -> ArucoDictionary:
    key = ("aruco_original", num_markers)
    if key not in _CACHE:
        bits = np.stack([aruco_original_marker_bits(i) for i in range(num_markers)])
        _CACHE[key] = ArucoDictionary("DICT_ARUCO_ORIGINAL", bits)
    return _CACHE[key]


def tag36h11_dictionary() -> ArucoDictionary:
    """The real AprilTag 36h11 family (587 markers, min Hamming 11) from the
    embedded public code table — detects genuine Kalibr aprilgrid targets
    (reference third_party/apriltag/apriltag.h:10-25)."""
    key = ("tag36h11",)
    if key not in _CACHE:
        from openimucameracalibrator_torch.detect import tag36h11_data as t36
        _CACHE[key] = dictionary_from_codes(
            "DICT_APRILTAG_36H11", t36.codes(), t36.MARKER_SIZE,
            max_correction_bits=(t36.MIN_HAMMING - 1) // 2)
    return _CACHE[key]


def random_dictionary(num_markers: int, marker_size: int = 6, seed: int = 1,
                      min_hamming: int | None = None) -> ArucoDictionary:
    """Seeded random dictionary with a minimum pairwise Hamming distance over
    all rotations — stand-in for data-defined dictionaries (e.g. tag36h11,
    whose code table is not algorithmic; supply real codes via
    :func:`dictionary_from_codes` for cross-tool parity)."""
    n = marker_size
    if min_hamming is None:
        min_hamming = max(2, n * n // 5)
    rng = np.random.default_rng(seed)
    chosen: list[np.ndarray] = []
    chosen_rots: list[np.ndarray] = []
    attempts = 0
    while len(chosen) < num_markers:
        attempts += 1
        if attempts > 200000:
            raise RuntimeError("random_dictionary: cannot satisfy min_hamming")
        cand = rng.integers(0, 2, size=(n, n)).astype(np.uint8)
        rots = np.stack([np.rot90(cand, r) for r in range(4)]).reshape(4, -1)
        # self-distance between rotations (avoid rotation-ambiguous markers)
        ok = all(np.sum(rots[0] != rots[r]) >= min_hamming for r in range(1, 4))
        if ok and chosen_rots:
            prev = np.concatenate(chosen_rots)  # (4*len, n*n)
            dists = np.sum(prev[:, None, :] != rots[None, :, :], axis=-1)
            ok = dists.min() >= min_hamming
        if ok:
            chosen.append(cand)
            chosen_rots.append(rots)
    return ArucoDictionary(f"RANDOM_{n}X{n}_{num_markers}",
                           np.stack(chosen), max_correction_bits=(min_hamming - 1) // 2)


def dictionary_from_codes(name: str, codes: np.ndarray, marker_size: int,
                          max_correction_bits: int = 2) -> ArucoDictionary:
    """Build a dictionary from packed integer codes (row-major bits, MSB
    first), e.g. the published tag36h11 code table."""
    n = marker_size
    bits = np.zeros((len(codes), n * n), np.uint8)
    for k, code in enumerate(np.asarray(codes, dtype=np.uint64)):
        for b in range(n * n):
            bits[k, b] = (int(code) >> (n * n - 1 - b)) & 1
    return ArucoDictionary(name, bits.reshape(-1, n, n), max_correction_bits)


def decode_bits(observed: np.ndarray, dictionary: ArucoDictionary):
    """Batched decode of observed bit grids against a dictionary.

    observed: (M, n, n) in {0, 1}
    returns (ids (M,), rotations (M,), hamming (M,)) with id = -1 where the
    best match exceeds the dictionary's correction budget.
    """
    obs = np.asarray(observed, np.float32).reshape(observed.shape[0], -1) * 2.0 - 1.0
    codes = dictionary.flat_codes()  # (4K, B)
    B = obs.shape[1]
    # hamming = (B - a.b) / 2 in +/-1 encoding
    dots = obs @ codes.T
    ham = (B - dots) / 2.0
    best = np.argmin(ham, axis=1)
    best_ham = ham[np.arange(len(best)), best].astype(np.int64)
    k = dictionary.num_markers
    ids = (best % k).astype(np.int64)
    rots = (best // k).astype(np.int64)
    bad = best_ham > dictionary.max_correction_bits
    ids[bad] = -1
    return ids, rots, best_ham
