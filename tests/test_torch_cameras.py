"""Port parity: models/cameras.py — all seven camera models.

Projection values, validity masks, unprojection and projection Jacobians
(w.r.t. the camera-frame point and the intrinsics) on the same numpy
inputs, float64 on the CPU. Points include some behind the camera and far
off-axis so the invalid-projection masks are exercised. Tolerance: 1e-9
relative on values and Jacobians (pixel-scale quantities computed by the
same float64 expression sequence), exact equality on masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openimucameracalibrator_torch.models import cameras as t_cam
from openimucameracalibrator_tpu.models import cameras as j_cam

PARAMS = {
    "pinhole": [440.0, 442.0, 480.0, 270.0],
    "pinhole_radtan": [440.0, 442.0, 480.0, 270.0, -0.05, 0.01, -0.002, 0.001, -0.0005],
    "division_undistortion": [437.13, 489.07, 270.87, -1.4386e-06],
    "double_sphere": [342.0, 344.0, 472.0, 273.0, -0.215, 0.513],
    "extended_unified": [438.0, 440.0, 489.0, 272.0, 0.51, 1.06],
    "fov": [440.0, 441.0, 480.0, 270.0, 0.93],
    "fisheye": [435.0, 436.0, 479.0, 274.0, 0.05, 0.07, -0.11, 0.05],
}


def T(x):
    return torch.as_tensor(np.array(x, np.float64))


def points(rng, n=64):
    ang = np.deg2rad(80) * np.sqrt(rng.uniform(size=n))
    az = rng.uniform(0, 2 * np.pi, size=n)
    d = rng.uniform(0.5, 5.0, size=n)
    p = np.stack([np.sin(ang) * np.cos(az), np.sin(ang) * np.sin(az), np.cos(ang)], -1) * d[:, None]
    p[:6, 2] *= -1.0  # behind the camera
    p[6] = [0.0, 0.0, 1.0]  # on the axis
    p[7] = [0.0, 0.0, -2.0]  # straight behind: invalid for the wide-angle models too
    return p


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_project_unproject_and_jacobians(name, rng):
    jm, tm = j_cam.get_model(name), t_cam.get_model(name)
    prm, p = np.asarray(PARAMS[name]), points(rng)

    @jax.jit
    def jax_side(prm_, p_):
        uv, ok = jm.project(prm_, p_)
        bearing = jm.unproject(prm_, uv)
        jp = jax.vmap(jax.jacfwd(lambda q: jm.project(prm_, q)[0]))(p_)
        jk = jax.vmap(lambda q: jax.jacfwd(lambda k: jm.project(k, q)[0])(prm_))(p_)
        return uv, ok, bearing, jp, jk

    uv, ok, bearing, jp, jk = (np.asarray(a) for a in jax_side(jnp.asarray(prm), jnp.asarray(p)))
    tuv, tok = tm.project(T(prm), T(p))
    np.testing.assert_array_equal(tok.numpy(), ok)
    assert (~ok).any() or name in ("fov",), "the point set must exercise the invalid mask"
    np.testing.assert_allclose(tuv.numpy(), uv, rtol=1e-9, atol=1e-9)
    sel = ok & np.all(np.isfinite(uv), -1)
    np.testing.assert_allclose(tm.unproject(T(prm), T(uv)).numpy()[sel], bearing[sel],
                               rtol=1e-9, atol=1e-9)
    tjp = torch.func.vmap(torch.func.jacfwd(lambda q: tm.project(T(prm), q)[0]))(T(p))
    tjk = torch.func.vmap(lambda q: torch.func.jacfwd(lambda k: tm.project(k, q)[0])(T(prm)))(T(p))
    np.testing.assert_allclose(tjp.numpy()[sel], jp[sel], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tjk.numpy()[sel], jk[sel], rtol=1e-9, atol=1e-9)


def test_registry_aliases_and_init():
    assert sorted(t_cam.CAMERA_MODELS) == sorted(j_cam.CAMERA_MODELS)
    assert t_cam.MODEL_ALIASES == j_cam.MODEL_ALIASES
    for alias in list(j_cam.MODEL_ALIASES) + list(j_cam.CAMERA_MODELS):
        jm, tm = j_cam.get_model(alias), t_cam.get_model(alias)
        assert tm.name == jm.name and tuple(tm.param_names) == tuple(jm.param_names)
        assert tm.param_groups == jm.param_groups
        np.testing.assert_array_equal(tm.init_params(440.0, 480.0, 270.0, device="cpu").numpy(),
                                      np.asarray(jm.init_params(440.0, 480.0, 270.0)))
