"""The port's pose covariances (dense and PCG) against the JAX reference's
on the CPU, on the toy problem of `__graft_entry__` solved by the JAX
package's BA: within 1e-2 of each block's largest entry (an inverse of
the reduced system).

Split from tests/test_torch_ba_joint.py so that each file runs on a test
worker of its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.sfm import ba as jba
from alicevision_tpu_torch.sfm import ba as tba
from test_torch_ba import _np, _port

torch.set_num_threads(1)


@pytest.mark.parametrize("which", ["dense", "pcg"])
def test_pose_covariances_match(which):
    import __graft_entry__ as g

    jp = g._toy_problem(n_views=6, n_points=96, max_track=5)
    jres = jba.ba_solve(jp, max_iters=10)
    jp = jp._replace(cam_q=jres.cam_q, cam_c=jres.cam_c, points=jres.points)
    tp = _port(jp)
    if which == "dense":
        ref = np.asarray(jba.pose_covariances(jp, jp.cam_q, jp.cam_c, jp.points))
        out = _np(tba.pose_covariances(tp, tp.cam_q, tp.cam_c, tp.points))
    else:
        idx = [2, 4, 5]
        ref = np.asarray(jba.pose_covariances_pcg(jp, jp.cam_q, jp.cam_c, jp.points,
                                                  cam_indices=jnp.asarray(idx), cg_iters=60))
        out = _np(tba.pose_covariances_pcg(tp, tp.cam_q, tp.cam_c, tp.points, cam_indices=idx, cg_iters=60))
    assert out.shape == ref.shape
    # an inverse of the reduced system: rtol 1e-2 of each block's magnitude
    for o, r_ in zip(out, ref):
        np.testing.assert_allclose(o, r_, atol=1e-2 * np.abs(r_).max())
