"""Video-scale batched charuco detection.

Port of ``detect/video.py`` of the JAX package. Frames are processed in
fixed-size blocks, decoded on a background thread; every stage runs
batched over the block. The JAX package's two ``jax.jit`` programs are
eager PyTorch here, and its host quad stage a kernel on the card:

1. ``_stage_pixels``: uint8 frames -> float32 gray + corner-response map
   (both stay on the device; the response is one launch of the CUDA
   kernel's block mode, ``kernels.corner_response_block``, on the card)
   and the adaptive-threshold dark mask.
2. the quad candidates of each frame's mask, as a static (F, Q, 4, 2)
   tensor and its (F, Q) validity. On the card: one launch of kernel K3
   (``quad_kernels.quad_candidates_block``, connected components and the
   quad fit), the mask never leaving the device. On the CPU: the host route
   ``_host_quads`` (``quads.find_quad_candidates`` frame by frame), from
   the mask bit-packed when ``pack_mask`` (the JAX package's choice, made
   for a TPU client link of ~25 MB/s) or one byte per pixel when not.
   Which route runs follows the block's device, as for K1 and K2.
3. ``_stage_decode_interp``: homography cell-grid sampling with an ignored
   cell margin, matmul dictionary decode, board-slot assignment,
   board-aware recovery of undecoded markers (refineDetectedMarkers
   analog), per-corner local-homography charuco interpolation, conv-field
   subpixel refinement, drift/response gates. All homographies are
   least-squares solves (``pnp.homography_ls``), not SVDs.

The block loop is a 2-deep software pipeline: block i's quad and decode
stages are enqueued after block i+1's pixel stage, before block i-1's
results are read; every device->host copy is asynchronous into pinned
memory with an event, so a fetch waits only for the work it needs. On the
card the frames go up from pinned memory, nothing from the upload to the
decode stage synchronises with the host (the host waits only for the
results of the block before last), and the quad and decode stages of a
block are one CUDA graph replay (``_CardBlocks``) from the second block on.

The single-frame path (detect/charuco.py) is the reference implementation
the batched path is held against.
"""

from __future__ import annotations

import dataclasses
import functools
import queue as queue_mod
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from openimucameracalibrator_torch.detect import aruco_dict as adict_mod
from openimucameracalibrator_torch.detect import charuco as charuco_mod
from openimucameracalibrator_torch.detect import image as im
from openimucameracalibrator_torch.detect import quad_kernels
from openimucameracalibrator_torch.detect import quads as quads_mod
from openimucameracalibrator_torch.ops import pnp
from openimucameracalibrator_torch.utils import precision


@dataclasses.dataclass
class VideoDetectorOptions:
    batch_frames: int = 32  # frames per block (the JAX package's v5e sweep)
    max_quads: int = 128         # static quad slots per frame
    # Mask resolution divisor for labeling. 1 = full resolution:
    # half-res quad corners start ~2 px off, which costs decoded markers
    # on blurred/compressed video.
    label_downsample: int = 1
    marker: quads_mod.MarkerDetectorOptions = dataclasses.field(
        default_factory=quads_mod.MarkerDetectorOptions)
    min_markers: int = 2
    local_markers: int = 4
    subpix_win: int = 5
    max_residual_px: float = 5.0
    response_check: bool = True
    decode_queue: int = 4        # prefetched frame blocks
    # Board-aware recovery of undecoded markers (refineDetectedMarkers
    # analog; see _stage_decode_interp step 6). err_rate is the accepted
    # bit-error fraction for the fixed-identity verification.
    recover: bool = True
    recover_err_rate: float = 0.25
    # Subpixel-refine marker-quad corners before bit sampling. Off by
    # default: hull corners are within ~1 px at full resolution, which
    # the sampling margin absorbs.
    refine_markers: bool = False
    # CPU route only (the card labels the mask where it lies): bit-pack the
    # dark mask before handing it to the host quad stage (8x fewer bytes;
    # the JAX package's behaviour). False hands over one byte per pixel.
    pack_mask: bool = True


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _stage_pixels(frames_u8: torch.Tensor, radius: int, c: float, down: int,
                  resp_radius: int, want_resp: bool, pack: bool = True):
    """(gray f32 (F,H,W), mask, resp (F,H,W)) on the frames' device.

    mask is the dark mask at 1/down resolution, bit-packed to
    (F, H/down, ceil(W/down/8)) uint8 when ``pack`` (np.unpackbits on the
    host), else (F, H/down, W/down) bool. resp is (F, 1, 1) zeros when
    not ``want_resp``."""
    gray = frames_u8.to(torch.float32)
    mask = im.adaptive_threshold(gray, radius, c)
    if down > 1:
        maskd = torch.nn.functional.max_pool2d(mask[:, None].to(torch.float32), down,
                                               stride=down)[:, 0] > 0
    else:
        maskd = mask
    if pack:
        Fn, h, w = maskd.shape
        w8 = (w + 7) // 8 * 8
        mp = torch.nn.functional.pad(maskd.to(torch.uint8), (0, w8 - w))
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=gray.device)
        maskd = (mp.reshape(Fn, h, w8 // 8, 8) * weights).sum(-1).to(torch.uint8)
    resp = (im.corner_response(gray, resp_radius) if want_resp
            else torch.zeros((gray.shape[0], 1, 1), dtype=torch.float32, device=gray.device))
    return gray, maskd, resp


def _unpack_mask(packed_np: np.ndarray, w: int) -> np.ndarray:
    """(F, h, w) bool from the device-packed bitmap."""
    return np.unpackbits(packed_np, axis=-1)[..., :w].astype(bool)


@functools.lru_cache(maxsize=None)
def _unit_square(device) -> torch.Tensor:
    """Made once per device, so a decode copies nothing from the host."""
    return torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], dtype=torch.float32,
                        device=device)


def _quad_homographies(quads_r: torch.Tensor) -> torch.Tensor:
    """Unit square -> quad least-squares homographies (..., 3, 3), scaled
    to H[2, 2] = 1 where that is not ~0."""
    src = _unit_square(quads_r.device).expand(quads_r.shape)
    Hs = pnp.homography_ls(src, quads_r, torch.ones(quads_r.shape[:-1], dtype=torch.float32,
                                                     device=quads_r.device))
    h22 = Hs[..., 2:3, 2:3]
    return Hs / torch.where(torch.abs(h22) > 1e-12, h22, torch.ones_like(h22))


def _refine_frames(gray, corners, win):
    """refine_corners_subpix of each frame's corners (F, M, 2), with the
    steps that ran farther than win + 1 undone."""
    ref = torch.stack([im.refine_corners_subpix(g, cs, win=win) for g, cs in zip(gray, corners)])
    drift = torch.linalg.vector_norm(ref - corners, dim=-1)
    return torch.where((drift > win + 1.0)[..., None], corners, ref)


def _gather_frames(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[f, idx[f, ...]] for each frame f: x (F, M, ...), idx (F, ...)."""
    f = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return x[f, idx]


def _stage_decode_interp(gray, resp, quads_b, qvalid, codes, board_corners,
                         chess, cells: int, oversample: int, win: int,
                         max_corr: int, n_loc: int, ch_win: int,
                         min_markers: int, max_residual_px: float,
                         response_check: bool, bb: int = 1,
                         cell_margin: float = 0.13,
                         recover_budget: int = 0,
                         refine_markers: bool = False):
    """Quad subpix refine -> homography grid sampling -> dictionary decode
    (matmul Hamming argmax) -> board-slot assignment -> per-corner
    local-homography interpolation + refinement + gates, batched over the
    block's F frames.

    codes: (4K, B) +-1 subset-dictionary rotation codes (row = r*K + k).
    board_corners: (M, 4, 2) board-frame marker corners, M = K markers.
    chess: (N, 2) chessboard corner positions.
    Returns (refined (F,N,2), ok (F,N), n_markers (F,)).
    """
    Fn, Q = quads_b.shape[:2]
    K4, B = codes.shape
    K = K4 // 4
    dev = gray.device

    # 1. (optionally) refine quad corners.
    if refine_markers:
        quads_r = _refine_frames(gray, quads_b.reshape(Fn, Q * 4, 2), win).reshape(Fn, Q, 4, 2)
    else:
        quads_r = quads_b.to(torch.float32)

    # 2. per-quad homography + cell grid sampling
    Hs = _quad_homographies(quads_r)
    grids = im.sample_homography_grid(gray, Hs, cells, cells, oversample,
                                      cell_margin)  # (F, Q, cells, cells)

    # 3. threshold + border/contrast gates
    lo = grids.amin(dim=(2, 3))
    hi = grids.amax(dim=(2, 3))
    bits = grids > ((lo + hi) / 2.0)[..., None, None]
    border = torch.ones((cells, cells), dtype=torch.bool, device=dev)
    border[bb:-bb, bb:-bb] = False
    bw = (bits & border).sum(dim=(2, 3)) / border.sum()
    inner = bits[:, :, bb:-bb, bb:-bb]

    # 4. decode: max correlation against all rotations of the code set
    obs_pm = inner.reshape(Fn, Q, B).to(torch.float32) * 2.0 - 1.0
    scores = torch.einsum("fqb,cb->fqc", obs_pm, codes)  # (F, Q, 4K)
    best = torch.argmax(scores, dim=-1)
    ham = (B - scores.amax(dim=-1).to(torch.int32)) // 2
    rot = best // K
    mid = best % K
    dec_ok = qvalid & (ham <= max_corr) & (bw < 0.2) & ((hi - lo) > 20.0)

    # 5. board-slot assignment: largest decoded quad per marker id
    x, y = quads_r[..., 0], quads_r[..., 1]
    area = 0.5 * torch.abs(torch.sum(x * torch.roll(y, -1, dims=-1)
                                     - y * torch.roll(x, -1, dims=-1), dim=-1))  # (F, Q)
    match = dec_ok[:, :, None] & (mid[:, :, None] == torch.arange(K, device=dev)[None, None, :])
    score = torch.where(match, area[:, :, None], torch.full_like(area[:, :, None], -1.0))
    best_q = torch.argmax(score, dim=1)  # (F, K)
    mk_valid = torch.any(match, dim=1)   # (F, K)
    # canonical corner order: output j = observed corner (j - rot) mod 4
    sel_q = _gather_frames(quads_r, best_q)   # (F, K, 4, 2)
    sel_rot = _gather_frames(rot, best_q)     # (F, K)
    jj = (torch.arange(4, device=dev)[None, None, :] - sel_rot[:, :, None]) % 4
    mk_img = torch.gather(sel_q, 2, jj[..., None].expand(sel_q.shape))

    mk_board = board_corners.expand((Fn,) + board_corners.shape)

    # 6. board-aware marker recovery (cv2.aruco.refineDetectedMarkers
    # analog): fit a global board->image homography from the decoded
    # markers, project every UNDETECTED marker's corners, re-sample its
    # bit grid, and accept when it matches THAT marker's code (identity
    # fixed by board position, orientation by the homography: this is
    # verification, not search).
    if recover_budget > 0:
        bpa = mk_board.reshape(Fn, K * 4, 2)
        ipa = mk_img.reshape(Fn, K * 4, 2)
        wa = torch.repeat_interleave(mk_valid, 4, dim=1).to(torch.float32)
        Hg = pnp.homography_ls(bpa, ipa, wa)  # (F, 3, 3)
        bh = torch.cat([mk_board, torch.ones((Fn, K, 4, 1), dtype=torch.float32, device=dev)],
                       dim=-1)
        pr = torch.einsum("fij,fmcj->fmci", Hg, bh)
        wz = pr[..., 2:3]
        proj = pr[..., :2] / torch.where(torch.abs(wz) > 1e-9, wz, torch.ones_like(wz))
        h_img, w_img = gray.shape[1:]
        proj_inb = ((proj[..., 0] > 1) & (proj[..., 0] < w_img - 2)
                    & (proj[..., 1] > 1) & (proj[..., 1] < h_img - 2))
        # keep refine windows inside the image for the parked slots
        proj = torch.stack([torch.clamp(proj[..., 0], 2.0, w_img - 3.0),
                            torch.clamp(proj[..., 1], 2.0, h_img - 3.0)], dim=-1)
        pf = proj.reshape(Fn, K * 4, 2)
        pref = _refine_frames(gray, pf, win) if refine_markers else pf
        pq = pref.reshape(Fn, K, 4, 2)
        Hm = _quad_homographies(pq)
        grids2 = im.sample_homography_grid(gray, Hm, cells, cells, oversample,
                                           cell_margin)  # (F, K, cells, cells)
        lo2 = grids2.amin(dim=(2, 3))
        hi2 = grids2.amax(dim=(2, 3))
        bits2 = grids2 > ((lo2 + hi2) / 2.0)[..., None, None]
        bw2 = (bits2 & border).sum(dim=(2, 3)) / border.sum()
        pm2 = bits2[:, :, bb:-bb, bb:-bb].reshape(Fn, K, B).to(torch.float32) * 2.0 - 1.0
        # rotation-0 code of marker k = codes row 0*K + k.
        score0 = torch.einsum("fkb,kb->fk", pm2, codes[:K])
        ham0 = (B - score0.to(torch.int32)) // 2
        n_dec = mk_valid.sum(-1)
        rec = (~mk_valid & (ham0 <= recover_budget) & (bw2 < 0.3)
               & ((hi2 - lo2) > 20.0) & proj_inb.all(dim=-1)
               & (n_dec >= 2)[:, None])
        mk_img = torch.where(rec[..., None, None], pq, mk_img)
        mk_valid = mk_valid | rec

    # 7. charuco interpolation (same math as the single-frame path)
    return _charuco_interp(gray, resp, mk_board, mk_img, mk_valid, chess,
                           n_loc, ch_win, min_markers, max_residual_px,
                           response_check) + (mk_valid.sum(-1),)


def _charuco_interp(gray, resp, mk_board, mk_img, mk_valid, chess,
                    n_loc: int, win: int, min_markers: int,
                    max_residual_px: float, response_check: bool):
    """Batched charuco corner interpolation.

    mk_board/mk_img (F,M,4,2) board/image marker corners, mk_valid (F,M).
    chess (N,2) board-frame chessboard corner positions.
    Returns (refined (F,N,2), valid (F,N)).
    """
    Fn, M = mk_valid.shape
    N = chess.shape[0]
    dev = gray.device
    ctr_board = mk_board.mean(dim=2)  # (F, M, 2)
    d = torch.linalg.vector_norm(ctr_board[:, None, :, :] - chess[None, :, None, :],
                                 dim=-1)  # (F, N, M)
    d = torch.where(mk_valid[:, None, :], d, torch.full_like(d, float("inf")))
    # the n_loc nearest markers, ties lower index first (jax.lax.top_k)
    idx = torch.sort(d, dim=-1, stable=True)[1][..., :n_loc]  # (F, N, n_loc)

    bp = _gather_frames(mk_board, idx).reshape(Fn, N, n_loc * 4, 2)
    ip = _gather_frames(mk_img, idx).reshape(Fn, N, n_loc * 4, 2)
    selv = _gather_frames(mk_valid, idx)  # (F, N, n_loc)
    w = torch.repeat_interleave(selv, 4, dim=-1).to(torch.float32)  # (F, N, n_loc*4)

    H = pnp.homography_ls(bp.to(torch.float32), ip.to(torch.float32), w)
    ch = torch.cat([chess.expand(Fn, N, 2),
                    torch.ones((Fn, N, 1), dtype=torch.float32, device=dev)], dim=-1)
    pred_h = torch.einsum("fnij,fnj->fni", H, ch)
    wz = pred_h[..., 2]
    ok = (torch.isfinite(H).all(dim=-1).all(dim=-1) & (torch.abs(wz) > 1e-9)
          & (selv.sum(-1) >= min(n_loc, 1)))
    pred = pred_h[..., :2] / torch.where(torch.abs(wz) > 1e-9, wz, torch.ones_like(wz))[..., None]

    n_mk = mk_valid.sum(-1)  # (F,)
    ok = ok & (n_mk >= min_markers)[:, None]
    h_img, w_img = gray.shape[1:]
    inb = ((pred[..., 0] > 3) & (pred[..., 0] < w_img - 4)
           & (pred[..., 1] > 3) & (pred[..., 1] < h_img - 4))
    ok = ok & inb
    pred = torch.where(ok[..., None], pred, torch.full_like(pred, 8.0))  # park in-bounds

    # Conv-field subpixel refinement: five convolutions per frame + 5
    # bilinear taps per corner-iteration (see im.corner_refine_fields).
    fields = im.corner_refine_fields(gray, win)
    refined = im.refine_corners_from_fields(fields, pred, win)
    drift = torch.linalg.vector_norm(refined - pred, dim=-1)
    ok = ok & (drift < max_residual_px)

    if response_check:
        rx = torch.clamp(torch.round(refined[..., 0]).to(torch.int64), 0, w_img - 1)
        ry = torch.clamp(torch.round(refined[..., 1]).to(torch.int64), 0, h_img - 1)
        f = torch.arange(Fn, device=dev)[:, None]
        rv = resp[f, ry, rx]  # (F, N)
        rmax = resp.amax(dim=(1, 2))  # (F,)
        thr = torch.where(rmax > 0, 0.02 * rmax, torch.zeros_like(rmax))
        ok = ok & (rv > thr[:, None])
    return refined, ok


# ---------------------------------------------------------------------------
# Host stages
# ---------------------------------------------------------------------------

def _host_quads(maskd_np: np.ndarray, opts: VideoDetectorOptions):
    """Per-frame quad candidates from the downsampled mask block.

    Returns (quads_b (F, Q, 4, 2) float32 full-res coords, qvalid (F, Q)).
    """
    down = opts.label_downsample
    Fn = maskd_np.shape[0]
    Q = opts.max_quads
    mopts = dataclasses.replace(
        opts.marker,
        min_area_px=opts.marker.min_area_px / (down * down),
        max_candidates=Q)
    quads_b = np.zeros((Fn, Q, 4, 2), np.float32)
    qvalid = np.zeros((Fn, Q), bool)
    for f in range(Fn):
        qs = quads_mod.find_quad_candidates(maskd_np[f], mopts)
        k = min(qs.shape[0], Q)
        if k:
            # Downsampled grid cell (i, j) covers full-res pixels
            # [j*down, (j+1)*down) x [i*down, ...); cell centers map to
            # down * x + (down - 1) / 2.
            quads_b[f, :k] = qs[:k] * down + (down - 1) / 2.0
            qvalid[f, :k] = True
    return quads_b, qvalid


class _Fetch:
    """Device tensors copied to the host asynchronously (pinned memory and
    an event on the card); ``get`` waits for the copy alone."""

    def __init__(self, *tensors):
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = list(tensors), None

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _stack(frames: list, pinned: bool):
    """The (F, H, W) uint8 block of ``frames``: a numpy array, or with
    ``pinned`` a tensor in pinned host memory, which the card copies from
    without the host waiting."""
    if not pinned:
        return np.stack(frames)
    out = torch.empty((len(frames),) + frames[0].shape, dtype=torch.uint8, pin_memory=True)
    np.stack(frames, out=out.numpy())
    return out


def _block_iter(frames: Iterable[tuple], F: int, prefetch: int,
                pinned: bool = False) -> Iterator:
    """Group (t, gray) into (times (F,), stack (F,H,W) u8, n_real) blocks,
    decoded and stacked (see :func:`_stack`) on a background thread so
    decode overlaps device compute. A short tail block is padded with
    copies of its last frame."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
    _END = object()
    failure = []

    def producer():
        buf_t, buf_f = [], []
        try:
            for t, g in frames:
                buf_t.append(t)
                buf_f.append(np.asarray(g, np.uint8))
                if len(buf_t) == F:
                    q.put((np.asarray(buf_t), _stack(buf_f, pinned), F))
                    buf_t, buf_f = [], []
            if buf_t:
                n = len(buf_t)
                pad = F - n
                buf_f += [buf_f[-1]] * pad
                buf_t += [buf_t[-1]] * pad
                q.put((np.asarray(buf_t), _stack(buf_f, pinned), n))
        except BaseException as e:  # handed to the consumer, which raises it
            failure.append(e)
        finally:
            q.put(_END)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
    th.join()
    if failure:
        raise failure[0]


class _Board:
    """The board's device constants for the decode stage."""

    def __init__(self, spec, opts: VideoDetectorOptions, device):
        board_mids, board_mcorners = spec.marker_board_corners()
        self.sub, _ = adict_mod.subset_dictionary(spec.dictionary, board_mids)
        order = np.argsort(board_mids)
        self.codes = torch.as_tensor(self.sub.flat_codes(), device=device)
        # subset decode index k corresponds to original id sorted(board_mids)[k];
        # the board corner table must be in the same (sorted) order.
        self.corners = torch.as_tensor(board_mcorners[order].astype(np.float32), device=device)
        self.chess = torch.as_tensor(spec.chessboard_corners(), dtype=torch.float32,
                                     device=device)
        self.cells = spec.dictionary.marker_size + 2 * opts.marker.border_bits
        self.n_loc = min(opts.local_markers, len(board_mids))
        self.opts = opts

    def pixels(self, stack_dev, pack):
        o = self.opts
        return _stage_pixels(stack_dev, o.marker.threshold_radius, o.marker.threshold_c,
                             o.label_downsample, 6, o.response_check, pack)

    def quads(self, maskd):
        """K3 on a mask block on the card: (quads_b, qvalid, n_kept)."""
        o = self.opts
        return quad_kernels.quad_candidates_block(maskd, o.label_downsample, o.max_quads,
                                                  o.marker)

    def decode(self, gray, resp, quads_b, qvalid):
        o = self.opts
        dev = gray.device
        return _stage_decode_interp(
            gray, resp, torch.as_tensor(quads_b, device=dev), torch.as_tensor(qvalid, device=dev),
            self.codes, self.corners, self.chess, self.cells, o.marker.cell_oversample,
            o.marker.subpix_win, self.sub.max_correction_bits, self.n_loc, o.subpix_win,
            o.min_markers, o.max_residual_px, o.response_check, bb=o.marker.border_bits,
            cell_margin=o.marker.cell_margin,
            recover_budget=(int(o.recover_err_rate * self.sub.marker_size ** 2)
                            if o.recover else 0),
            refine_markers=o.refine_markers)

    def mask_np(self, fetched, w):
        m = fetched.get()[0]
        return _unpack_mask(m, w) if self.opts.pack_mask else m


class _CardBlocks:
    """K3 and the decode stage of each block on the card, as
    ``(refined, ok, n_kept)``.

    The decode stage is some 1,500 small launches, which eager PyTorch
    issues at tens of ms of host time a 32-frame block against a few ms of
    device time. So the first block of a shape runs eagerly, which also
    loads what a capture needs (the K3 library, the cuBLAS handles, the
    device constants); the second is captured, its tensors becoming the
    graph's inputs, as one CUDA graph that it and every later block of the
    shape replay, one launch each. A replay writes the same output
    tensors: the caller copies a block's out (``_Fetch``, enqueued behind
    the replay on the same stream) before the next replay. The graphs live
    as long as the object, one ``detect_charuco_video`` call.
    """

    def __init__(self, board: _Board):
        self.board = board
        self.graphs = {}  # block shape -> (graph, inputs, outputs), or None once run eagerly

    def stages(self, gray, mask, resp):
        quads_b, qvalid, n_kept = self.board.quads(mask)
        refined, ok, _ = self.board.decode(gray, resp, quads_b, qvalid)
        return refined, ok, n_kept

    def __call__(self, gray, mask, resp):
        key = tuple(gray.shape)
        if key not in self.graphs:
            self.graphs[key] = None
            return self.stages(gray, mask, resp)
        if self.graphs[key] is None:
            # Captured on a side stream without torch.cuda.graph's device
            # sync and emptying of both allocator caches (~0.5 s a capture);
            # thread_local, as the frame producer allocates pinned memory
            # meanwhile.
            graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(gray.device)
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = self.stages(gray, mask, resp)
                finally:
                    graph.capture_end()
            self.graphs[key] = graph, (gray, mask, resp), outputs
        else:
            graph, inputs, outputs = self.graphs[key]
            for dst, src in zip(inputs, (gray, mask, resp)):
                dst.copy_(src)
        graph.replay()
        quad_kernels.count_launch(key[0])
        return outputs


def detect_charuco_video(frames: Iterable[tuple],
                         spec: "charuco_mod.CharucoBoardSpec",
                         opts: VideoDetectorOptions | None = None, device=None):
    """Batched charuco detection over an iterable of (time_s, gray u8) on
    ``device`` (default ``"cuda"``).

    Yields (time_s, ids (K,), corners (K, 2)) per input frame, in order.
    Block i's quad and decode stages are enqueued after block i+1's pixel
    stage, before block i-1's results are read. On the card the quads come
    from kernel K3 on the device-resident mask, each block is uploaded
    from pinned memory without the host waiting, and K3 and the decode
    stage run as one CUDA graph from the second block on (``_CardBlocks``);
    on the CPU the quads come from the host route ``_host_quads``.
    """
    device = precision.resolve_device(device)
    opts = opts or VideoDetectorOptions()
    board = _Board(spec, opts, device)
    on_card = device.type == "cuda"
    pack = opts.pack_mask and not on_card
    card_blocks = _CardBlocks(board) if on_card else None

    def finish(item):
        times, n_real, fetched = item
        refined, ok, *n_kept = fetched.get()
        if n_kept:
            quad_kernels.count_truncated(n_kept[0], opts.max_quads)
        out = []
        for f in range(n_real):
            ids = np.nonzero(ok[f])[0]
            out.append((float(times[f]), ids.astype(np.int64),
                        refined[f, ids].astype(np.float64)))
        return out

    def decode(pending):
        t_p, n_p, (gray_p, mask_p, resp_p) = pending
        if on_card:
            return t_p, n_p, _Fetch(*card_blocks(gray_p, mask_p, resp_p))
        quads_b, qvalid = _host_quads(board.mask_np(mask_p, mask_w), opts)
        refined, ok, _ = board.decode(gray_p, resp_p, quads_b, qvalid)
        return t_p, n_p, _Fetch(refined, ok)

    pending_pix = None   # (times, n_real, (gray, mask or its fetch, resp))
    pending_out = None   # (times, n_real, fetch of (refined, ok))
    mask_w = None
    for times, stack, n_real in _block_iter(frames, opts.batch_frames, opts.decode_queue,
                                            pinned=on_card):
        if mask_w is None:
            mask_w = (stack.shape[2] // opts.label_downsample
                      if opts.label_downsample > 1 else stack.shape[2])
        stack_dev = (stack.to(device, non_blocking=True) if on_card
                     else torch.as_tensor(stack, device=device))
        gray, maskd, resp = board.pixels(stack_dev, pack)
        handles = (gray, maskd if on_card else _Fetch(maskd), resp)
        if pending_pix is not None:
            out = decode(pending_pix)
            if pending_out is not None:
                yield from finish(pending_out)
            pending_out = out
        pending_pix = (times, n_real, handles)
    if pending_pix is not None:
        out = decode(pending_pix)
        if pending_out is not None:
            yield from finish(pending_out)
        pending_out = out
    if pending_out is not None:
        yield from finish(pending_out)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_block(frames_block: np.ndarray, spec, opts=None, n_iters: int = 5, device=None):
    """Per-stage steady-state timings on ONE device-resident frame block.

    Times, in ms for the F-frame block (host clock around work that ends
    in a device synchronisation, mean of ``n_iters``): the pixel stage with
    the mask packed and unpacked, the mask fetch + unpack both ways, the
    host quad stage, on the card kernel K3 on the unpacked mask, and the
    decode + interpolation stage; on the card also K3 and the decode stage
    as the pipeline runs them, one CUDA graph replay (``_CardBlocks``).
    Returns them with the implied device-resident frames/s of the route the
    block's device takes: on the card a block period of pixels (unpacked) +
    that replay, on the CPU max(host quads, pixels + decode), as the
    pipeline overlaps the two.
    """
    device = precision.resolve_device(device)
    opts = opts or VideoDetectorOptions()
    board = _Board(spec, opts, device)
    Fn = frames_block.shape[0]
    mask_w = frames_block.shape[2] // max(opts.label_downsample, 1)
    stack_dev = torch.as_tensor(frames_block, device=device)  # resident upload, once

    def timed(fn):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = fn()
            _sync(device)
        return (time.perf_counter() - t0) / n_iters * 1e3, out

    t_pix, (gray, packed, resp) = timed(lambda: board.pixels(stack_dev, True))
    t_pix_unpacked, (_, mask_u8, _) = timed(lambda: board.pixels(stack_dev, False))
    t_fetch_packed, mask_np = timed(lambda: _unpack_mask(packed.cpu().numpy(), mask_w))
    t_fetch_unpacked, mask_np2 = timed(lambda: mask_u8.cpu().numpy())
    if not np.array_equal(mask_np, mask_np2):
        raise RuntimeError("benchmark_block: the packed and unpacked masks differ")
    t_quads, (quads_b, qvalid) = timed(lambda: _host_quads(mask_np, opts))
    t_dec, _ = timed(lambda: board.decode(gray, resp, quads_b, qvalid))
    out = {
        "frames_per_block": int(Fn),
        "pixels_ms": t_pix,
        "pixels_unpacked_ms": t_pix_unpacked,
        "mask_fetch_packed_ms": t_fetch_packed,
        "mask_fetch_unpacked_ms": t_fetch_unpacked,
        "host_quads_ms": t_quads,
        "decode_interp_ms": t_dec,
    }
    if device.type == "cuda":
        out["k3_quads_ms"], _ = timed(lambda: board.quads(mask_u8))
        card_blocks = _CardBlocks(board)
        card_blocks(gray, mask_u8, resp)  # eager; timed's warm call captures
        out["k3_decode_graph_ms"], _ = timed(lambda: card_blocks(gray, mask_u8, resp))
        block_ms = t_pix_unpacked + out["k3_decode_graph_ms"]
    else:
        block_ms = max(t_quads, t_pix + t_dec)
    out["device_resident_fps"] = Fn / block_ms * 1e3
    return out
