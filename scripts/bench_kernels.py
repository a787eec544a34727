"""K1 and K2 of one source tree against another's, on the same inputs and card.

    python scripts/bench_kernels.py --make-inputs FILE
    python scripts/bench_kernels.py --tree DIR --inputs FILE --label NAME

``--make-inputs`` builds chip_smoke.py's kernel inputs once, with this
checkout's port, and saves them (CPU tensors) to FILE: for each stage-8
family (obs, accel, gyro) of the DS3-scale recording the linearizer's own
(J, r, idx) at the initial point and a random J, r with uniformly random
idx; the first frame of the 960x540 radon sweep and a random frame.

``--tree`` imports ``openimucameracalibrator_torch`` from DIR (this
checkout, or an older commit unpacked with ``git archive``), builds its
kernels from DIR's sources and prints one JSON line: per input, the
kernel's device ms (a CUDA graph of 20 calls, ``chip_smoke.graph_ms``) and
ms per eager call (``chip_smoke.cuda_ms``), each the best of two, and the
card's fp32 rate in the same run (one 8192^3 SGEMM, TF32 off). Only the
wrappers' Python API (``gram.fused_gram``, ``kernels.corner_response_nms``)
is used, which every version of the port keeps. Compare two trees on one
card in one command, in turns: A, B, B, A.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (imports nothing of the package at import time)


def make_inputs(path):
    from openimucameracalibrator_torch.solver import gram
    from openimucameracalibrator_torch.utils import precision, recorded, synthetic
    from openimucameracalibrator_torch.detect import render

    device = precision.resolve_device("cuda")
    st = cs.stage8_setup(torch, device, tempfile.mkdtemp(prefix="oicc_bench_kernels_"))
    captured = cs.capture_linearizer_inputs(gram, st.lin, st.params0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"k1": {}, "k2": {}}
    for name, K, R, rd, F, segs, L in st.shapes:
        J, r, idx = captured[name]
        out["k1"][f"{name}/main"] = (J.cpu(), r.cpu(), idx.cpu(), segs, L)
        Jr = torch.randn((K, R, F), generator=gen, device="cuda")
        rr = torch.randn((K, R), generator=gen, device="cuda")
        out["k1"][f"{name}/random"] = (Jr.cpu(), rr.cpu(),
                                       cs._random_idx(gen, K, R, rd, segs).cpu(), segs, L)
    pose = synthetic.sinusoid_trajectory(np.random.default_rng(3), 60.0, device=device, **cs.TRAJ)
    tex = recorded.BoardTexture(render.render_checkerboard(*cs.SQUARES, 64, 32), 64, 32, 0.04)
    frame = recorded.render_frames(pose, np.zeros(1), "division_undistortion", cs.CAM,
                                   [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0], tex, (960, 540),
                                   supersample=2, noise_std=1.5, seed=3, device=device)[0]
    out["k2"]["rendered"] = torch.as_tensor(np.asarray(frame, np.float32))
    out["k2"]["random"] = 255.0 * torch.rand((540, 960), generator=gen, device="cuda").cpu()
    torch.save(out, path)
    print(json.dumps({"inputs": path, "k1": sorted(out["k1"]), "k2": sorted(out["k2"])}))


def time_tree(tree, path, label):
    sys.path.insert(0, os.path.abspath(tree))
    from openimucameracalibrator_torch.detect import kernels
    from openimucameracalibrator_torch.solver import gram
    from openimucameracalibrator_torch.utils import precision

    assert os.path.abspath(gram.__file__).startswith(os.path.abspath(tree)), gram.__file__
    precision.resolve_device("cuda")
    inputs = torch.load(path, weights_only=False)
    res = {"tree": label, "device": torch.cuda.get_device_name(0), "smi": cs.smi_line(),
           "k1": {}, "k2": {}}

    def best(fn):
        d1, e1 = cs.graph_ms(fn), cs.cuda_ms(fn)
        d2, e2 = cs.graph_ms(fn), cs.cuda_ms(fn)
        return {"device_ms": min(d1, d2), "eager_ms": min(e1, e2)}

    for key, (J, r, idx, segs, L) in inputs["k1"].items():
        J, r, idx = J.cuda(), r.cuda(), idx.cuda()
        res["k1"][key] = best(lambda: gram.fused_gram(J, r, idx, segs, L))
        del J, r, idx
        torch.cuda.empty_cache()
    for key, img in inputs["k2"].items():
        x = img.cuda().contiguous()
        res["k2"][key] = best(lambda: kernels.corner_response_nms(x))
    # The card's own fp32 rate in this run: one 8192^3 cuBLAS SGEMM, TF32 off.
    a = torch.randn((8192, 8192), device="cuda")
    res["sgemm_tflops"] = 2 * 8192 ** 3 / (cs.graph_ms(lambda: a @ a, reps=5) * 1e-3) / 1e12
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--make-inputs", metavar="FILE")
    ap.add_argument("--tree", metavar="DIR")
    ap.add_argument("--inputs", metavar="FILE")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    if args.make_inputs:
        make_inputs(args.make_inputs)
    elif args.tree and args.inputs:
        time_tree(args.tree, args.inputs, args.label)
    else:
        ap.error("give --make-inputs FILE, or --tree DIR --inputs FILE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
