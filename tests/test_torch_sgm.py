"""The port's SGM aggregation against the JAX reference, on the CPU.

The same numpy inputs go through `alicevision_tpu` (JAX, and the Pallas
kernel in interpret mode) and through `alicevision_tpu_torch` with CPU
tensors, where the kernel wrapper takes its plain version. On the card the
CUDA kernel is held against the same plain version by chip_smoke.py (the
card machine has no JAX, which tests/conftest.py imports).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.mvs import plane_sweep as jps
from alicevision_tpu.ops.sgm_pallas import sgm_directional_pass as pallas_pass
from alicevision_tpu_torch.mvs import plane_sweep as tps
from alicevision_tpu_torch.ops import sgm_kernel

torch.set_num_threads(1)

# tests/test_pallas_sgm.py's shapes (the second ragged in N and D) plus the
# path's D = 256 and a D past 256 (ragged). Tolerance as there: rtol 1e-5,
# atol 1e-3 on costs of a few hundred — the recurrence is min/add only, so
# the versions agree to float32 rounding of the same operations.
SHAPES = [(12, 16, 128), (7, 13, 100), (5, 9, 256), (4, 6, 301)]
P1 = 10.0


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    S, N, D = shape
    cost = rng.rand(S, N, D).astype(np.float32) * 100
    p2 = rng.rand(S, N).astype(np.float32) * 50 + 10
    return cost, p2


@pytest.mark.parametrize("shape", SHAPES)
def test_directional_pass_matches_scan(shape):
    cost, p2 = _inputs(shape, 0)
    ref = np.asarray(jps._directional_pass(jnp.asarray(cost), jnp.asarray(p2), P1))
    out = tps._directional_pass(torch.from_numpy(cost), torch.from_numpy(p2), P1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_directional_pass_matches_pallas_interpret(shape):
    cost, p2 = _inputs(shape, 1)
    ref = np.asarray(pallas_pass(jnp.asarray(cost), jnp.asarray(p2), P1, interpret=True))
    out = tps._directional_pass(torch.from_numpy(cost), torch.from_numpy(p2), P1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-3)


def _volume(seed=2, D=32, H=24, W=40):
    rng = np.random.RandomState(seed)
    cost = (rng.rand(D, H, W) * 255).astype(np.float32)
    img = rng.rand(H, W).astype(np.float32)
    return cost, img


@pytest.mark.parametrize("n_dirs", [4, 8])
def test_sgm_aggregate_matches(n_dirs):
    cost, img = _volume()
    ref = np.asarray(
        jps.sgm_aggregate(jnp.asarray(cost), jnp.asarray(img), jps.SgmParams(n_dirs=n_dirs))
    )
    out = tps.sgm_aggregate(
        torch.from_numpy(cost), torch.from_numpy(img), tps.SgmParams(n_dirs=n_dirs)
    ).numpy()
    assert out.shape == ref.shape
    # aggregated costs reach ~1e3-1e4; P2 goes through exp(), whose float32
    # results differ by an ulp between XLA and torch, so hold them at rtol 1e-5
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)


def test_retrieve_best_depth_matches():
    cost, img = _volume(seed=3)
    agg = np.asarray(jps.sgm_aggregate(jnp.asarray(cost), jnp.asarray(img), jps.SgmParams()))
    depths = np.asarray(jps.inverse_depth_planes(2.0, 9.0, cost.shape[0]))
    d_ref, s_ref = jps.retrieve_best_depth(jnp.asarray(agg), jnp.asarray(depths))
    d_out, s_out = tps.retrieve_best_depth(torch.from_numpy(agg.copy()), torch.from_numpy(depths.copy()))
    # identical input volume: the argmin is the same (both return the first
    # minimum) and the parabola is float32 rounding apart
    np.testing.assert_allclose(d_out.numpy(), np.asarray(d_ref), rtol=1e-6)
    np.testing.assert_allclose(s_out.numpy(), np.asarray(s_ref), atol=1e-6)
    np.testing.assert_allclose(
        tps.inverse_depth_planes(2.0, 9.0, cost.shape[0]).numpy(), depths, rtol=1e-6
    )


def test_wrapper_takes_plain_version_on_cpu():
    cost, p2 = _inputs((6, 5, 40), 4)
    before = sgm_kernel.launches
    out = sgm_kernel.sgm_directional_pass(torch.from_numpy(cost), torch.from_numpy(p2), P1)
    ref = tps._directional_pass(torch.from_numpy(cost), torch.from_numpy(p2), P1)
    assert torch.equal(out, ref)
    assert sgm_kernel.launches == before == 0


def test_wrapper_rejects_other_devices():
    cost = torch.zeros(3, 4, 8, device="meta")
    with pytest.raises(ValueError):
        sgm_kernel.sgm_directional_pass(cost, torch.zeros(3, 4, device="meta"), P1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py holds the kernel on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_version(cuda_device):
    for shape in SHAPES:
        cost, p2 = _inputs(shape, 5)
        c = torch.from_numpy(cost).to(cuda_device)
        q = torch.from_numpy(p2).to(cuda_device)
        before = sgm_kernel.launches
        out = sgm_kernel.sgm_directional_pass(c, q, P1)
        torch.cuda.synchronize()
        assert sgm_kernel.launches == before + 1
        ref = tps._directional_pass(c, q, P1)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 7, 257), (6, 9, 512), (4, 6, 1500), (5, 7, 1001)])
def test_kernel_matches_plain_version_past_256(cuda_device, shape):
    """Three and four register chunks, then the carry in shared memory."""
    cost, p2 = _inputs(shape, 6)
    c = torch.from_numpy(cost).to(cuda_device)
    q = torch.from_numpy(p2).to(cuda_device)
    out = sgm_kernel.sgm_directional_pass(c, q, P1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tps._directional_pass(c, q, P1), rtol=1e-5, atol=1e-3)
