"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no JAX, so it also runs where only the port is installed,
without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.detect import image, kernels, render
from openimucameracalibrator_torch.solver import gram


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py on the GPU)")
    return torch.device("cuda")


def _problem(rng, C, rd=2, ws=9, wr=5, n_fixed=8, n_points=6):
    """Compact J (C, rd, F), r, run indices and kernel-form segments laid
    out like the reprojection family with board points."""
    order = 4
    F = 3 * order + 6 + 3 * order + n_fixed + 3
    col_r, col_f = 3 * order + 6, 3 * order + 6 + 3 * order
    J = rng.normal(size=(C, rd, F)).astype(np.float32)
    r = rng.normal(size=(C * rd,)).astype(np.float32)
    runs = [rng.integers(0, ws - order + 1, size=C), rng.integers(0, wr - order + 1, size=C),
            rng.integers(0, n_points, size=C)]
    L = 3 * ws + 3 * wr + n_fixed
    segs = (("run", 0, order, 3, ws, 0), ("run", col_r, order, 3, wr, 3 * ws),
            ("fixed", col_f, n_fixed, 3 * ws + 3 * wr), ("run", col_f + n_fixed, 1, 3, n_points, L))
    return J, r, runs, segs, L + 3 * n_points


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    """The CUDA kernel against the plain version on the card, float32:
    relative error against max|H| within the float32 rounding of an
    R-term sum (8 sqrt(R) eps)."""
    J, r, runs, segs, L = _problem(np.random.default_rng(42), C=3000)
    C, rd, F = J.shape
    K = 2
    Jt = torch.as_tensor(np.stack([J.reshape(C * rd, F)] * K), device=cuda_device)
    rt = torch.as_tensor(np.stack([r] * K), device=cuda_device)
    idx = torch.as_tensor(np.stack([np.stack([np.repeat(i, rd) for i in runs])] * K, axis=1),
                          dtype=torch.int32, device=cuda_device).contiguous()
    before = gram.fused_gram.launches
    H, g = gram.fused_gram(Jt, rt, idx, segs, L)
    assert gram.fused_gram.launches == before + 1
    Hp, gp = gram.fused_gram_plain(Jt, rt, idx, segs, L)
    tol = 8 * np.sqrt(C * rd) * np.finfo(np.float32).eps
    assert (H - Hp).abs().max().item() <= tol * Hp.abs().max().item()
    assert (g - gp).abs().max().item() <= tol * gp.abs().max().item()
    with pytest.raises(ValueError):
        gram.fused_gram(Jt.double(), rt, idx, segs, L)


@pytest.mark.cuda
def test_cuda_corner_kernel_matches_plain(cuda_device):
    """K2 against its plain version on the card at 960x540, float32, TF32
    off for cuDNN: resp within 2e-5 of max|resp|; keep on >= 0.999 of the
    pixels and exactly where |resp - local max| > 1e-4 of max|resp|; the
    candidate lists hold the same points."""
    torch.backends.cudnn.allow_tf32 = False
    board = render.render_checkerboard(10, 8, 48, 24).astype(np.float32)
    img = np.full((540, 960), 170.0, np.float32)
    img[40:40 + board.shape[0], 100:100 + board.shape[1]] = board
    img += np.random.default_rng(7).normal(0.0, 1.5, img.shape).astype(np.float32)
    x = torch.as_tensor(img, device=cuda_device)
    before = kernels.corner_response_nms.launches
    resp, keep = kernels.corner_response_nms(x)
    assert kernels.corner_response_nms.launches == before + 1
    resp_p, keep_p = kernels.corner_response_nms_plain(x)
    scale = resp_p.abs().max().item()
    assert (resp - resp_p).abs().max().item() <= 2e-5 * scale
    local_max = torch.nn.functional.max_pool2d(resp_p[None, None], 9, 1, 4)[0, 0]
    agree = (keep == keep_p).float().mean().item()
    clear = (resp_p - local_max).abs() > 1e-4 * scale
    assert agree >= 0.999 and torch.equal(keep[clear], keep_p[clear])
    xy, s = image.find_corner_candidates(x)
    xy_p, s_p = kernels.top_candidates(resp_p, keep_p, 512, 0.05)
    n = int((s_p > 0).sum())
    assert n >= 63 and int((s > 0).sum()) == n
    assert {tuple(p) for p in xy[:n].tolist()} == {tuple(p) for p in xy_p[:n].tolist()}
    for bad in (x.double(), x[None], x.t()):
        with pytest.raises(ValueError):
            kernels.corner_response_nms(bad)
