"""The SGM axis sweeps (`ops/sgm_kernel.sgm_axis_sweeps`) against the JAX
reference, on the CPU.

The same numpy inputs go through `alicevision_tpu` (JAX) and through
`alicevision_tpu_torch` with CPU tensors, where the wrapper takes its plain
version (`mvs/plane_sweep._axis_sweeps`). The kernel's addressing (the
offsets and strides of `axis_sweep_plan`, a negative step stride for the
backward sweep) is held here against explicit flips; on the card
chip_smoke.py holds the kernel against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.mvs import plane_sweep as jps
from alicevision_tpu_torch.mvs import plane_sweep as tps
from alicevision_tpu_torch.ops import sgm_kernel

torch.set_num_threads(1)

# (H, W, D) with H != W: D = 1, D = 3 (ragged, below a warp), the runner's
# D = 96, and D = 131 (ragged, past 128). Tolerance of tests/test_pallas_sgm.py:
# the recurrence is min/add only, so the two agree to float32 rounding.
SHAPES = [(5, 7, 1), (6, 4, 3), (7, 9, 96), (4, 6, 131)]
P1 = 10.0
RTOL, ATOL = 1e-5, 1e-3


def _inputs(shape, seed, batch=()):
    rng = np.random.RandomState(seed)
    vol = (rng.rand(*batch, *shape) * 255).astype(np.float32)
    p2 = (rng.rand(*batch, *shape[:2]) * 90 + 10).astype(np.float32)
    return vol, p2


def _jax_axis_sweeps(vol, p2, axis):
    """The JAX composite: forward and flipped sweeps of one axis stacked on
    the row axis of one `_directional_pass`, as `sgm_aggregate` does."""
    v, p = jnp.asarray(vol), jnp.asarray(p2)
    if axis == 1:
        v, p = jnp.moveaxis(v, 1, 0), p.T
    N = v.shape[1]
    both = jps._directional_pass(jnp.concatenate([v, v[::-1]], 1), jnp.concatenate([p, p[::-1]], 1), P1)
    fwd, bwd = both[:, :N], both[::-1, N:]
    if axis == 1:
        fwd, bwd = jnp.moveaxis(fwd, 0, 1), jnp.moveaxis(bwd, 0, 1)
    return np.asarray(fwd), np.asarray(bwd)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_axis_sweeps_match_jax(shape, axis):
    vol, p2 = _inputs(shape, 0)
    fwd, bwd = _jax_axis_sweeps(vol, p2, axis)
    out = sgm_kernel.sgm_axis_sweeps(torch.from_numpy(vol), torch.from_numpy(p2), P1, axis)
    np.testing.assert_allclose(out.numpy(), fwd + bwd, rtol=RTOL, atol=ATOL)
    # into a running total: (total + fwd) + bwd
    start = (np.random.RandomState(1).rand(*vol.shape) * 1000).astype(np.float32)
    total = torch.from_numpy(start.copy())
    res = sgm_kernel.sgm_axis_sweeps(torch.from_numpy(vol), torch.from_numpy(p2), P1, axis, total)
    assert res is total
    np.testing.assert_allclose(total.numpy(), start + fwd + bwd, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_sgm_aggregate_matches_jax_composite(shape):
    H, W, D = shape
    rng = np.random.RandomState(2)
    cost = (rng.rand(D, H, W) * 255).astype(np.float32)
    img = rng.rand(H, W).astype(np.float32)
    ref = np.asarray(jps.sgm_aggregate(jnp.asarray(cost), jnp.asarray(img), jps.SgmParams(),
                                       use_pallas=False))
    out = tps.sgm_aggregate(torch.from_numpy(cost), torch.from_numpy(img), tps.SgmParams())
    assert out.shape == (D, H, W)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_batch_equals_separate_calls(axis):
    vol, p2 = _inputs((5, 6, 20), 3, batch=(2,))
    v, p = torch.from_numpy(vol), torch.from_numpy(p2)
    out = sgm_kernel.sgm_axis_sweeps(v, p, P1, axis)
    assert out.shape == v.shape
    for b in range(2):
        assert torch.equal(out[b], sgm_kernel.sgm_axis_sweeps(v[b], p[b], P1, axis))
    total = torch.ones_like(v)
    sgm_kernel.sgm_axis_sweeps(v, p, P1, axis, total)
    for b in range(2):
        one = torch.ones_like(v[b])
        assert torch.equal(total[b], sgm_kernel.sgm_axis_sweeps(v[b], p[b], P1, axis, one))


def _plan_index(plan, B, D=None):
    """Flat indices (S, B*N[, D]) of what one launch reads: element
    (b, n, s, d) at offset + b*sb + n*sn + s*ss + d, as the kernel walks it."""
    sb, sn, ss = plan.strides
    s = torch.arange(plan.S).view(-1, 1, 1)
    b = torch.arange(B).view(1, -1, 1)
    n = torch.arange(plan.N).view(1, 1, -1)
    idx = (plan.offset + b * sb + n * sn + s * ss).reshape(plan.S, B * plan.N)
    return idx if D is None else idx[..., None] + torch.arange(D)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_sweep_plan_walks_the_flipped_chains(axis, reverse):
    """The plan's strides address every element once, and a sweep along them
    equals the directional pass over the explicitly transposed and flipped
    volume."""
    B, H, W, D = 2, 5, 7, 6
    vol, p2 = _inputs((H, W, D), 4, batch=(B,))
    v, p = torch.from_numpy(vol), torch.from_numpy(p2)
    plan = sgm_kernel.axis_sweep_plan((B, H, W, D), axis, reverse)
    idx = _plan_index(plan, B, D)
    assert torch.equal(idx.flatten().sort().values, torch.arange(v.numel()))
    p_plan = plan._replace(offset=plan.p2_offset, strides=plan.p2_strides)
    p_idx = _plan_index(p_plan, B)
    assert torch.equal(p_idx.flatten().sort().values, torch.arange(p.numel()))
    swept = tps._directional_pass(v.flatten()[idx], p.flatten()[p_idx], P1)
    by_plan = torch.empty(v.numel())
    by_plan[idx] = swept
    by_plan = by_plan.view(B, H, W, D)

    for bi in range(B):
        c, q = (v[bi].transpose(0, 1), p[bi].T) if axis == 1 else (v[bi], p[bi])
        if reverse:
            ref = tps._directional_pass(c.flip(0), q.flip(0), P1).flip(0)
        else:
            ref = tps._directional_pass(c, q, P1)
        if axis == 1:
            ref = ref.transpose(0, 1)
        assert torch.equal(by_plan[bi], ref)


def test_wrapper_takes_plain_version_on_cpu():
    vol, p2 = _inputs((4, 5, 40), 5)
    v, p = torch.from_numpy(vol), torch.from_numpy(p2)
    before = dict(sgm_kernel.launches)
    for axis in (0, 1):
        assert torch.equal(sgm_kernel.sgm_axis_sweeps(v, p, P1, axis), tps._axis_sweeps(v, p, P1, axis))
    assert sgm_kernel.launches == before


def test_wrapper_rejects_other_devices_and_axes():
    vol = torch.zeros(3, 4, 8, device="meta")
    with pytest.raises(ValueError):
        sgm_kernel.sgm_axis_sweeps(vol, torch.zeros(3, 4, device="meta"), P1, 0)
    with pytest.raises(ValueError):
        sgm_kernel.sgm_axis_sweeps(torch.zeros(3, 4, 8), torch.zeros(3, 4), P1, 2)
    with pytest.raises(ValueError):
        sgm_kernel.axis_sweep_plan((1, 3, 4, 8), 2, False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py holds the kernel on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [(), (2,)])
def test_kernel_axis_sweeps_match_plain_version(cuda_device, batch):
    for shape in SHAPES + [(6, 5, 320), (9, 11, 600)]:
        vol, p2 = _inputs(shape, 6, batch)
        v, p = torch.from_numpy(vol).to(cuda_device), torch.from_numpy(p2).to(cuda_device)
        for axis in (0, 1):
            before = sgm_kernel.launches["sgm_axis_sweeps"]
            out = sgm_kernel.sgm_axis_sweeps(v, p, P1, axis)
            out = sgm_kernel.sgm_axis_sweeps(v, p, P1, 1 - axis, out)
            torch.cuda.synchronize()
            assert sgm_kernel.launches["sgm_axis_sweeps"] == before + 4
            ref = tps._axis_sweeps(v, p, P1, 1 - axis, tps._axis_sweeps(v, p, P1, axis))
            torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_sgm_aggregate_matches_cpu(cuda_device):
    H, W, D = 12, 17, 96
    rng = np.random.RandomState(7)
    cost = torch.from_numpy((rng.rand(D, H, W) * 255).astype(np.float32))
    img = torch.from_numpy(rng.rand(H, W).astype(np.float32))
    out = tps.sgm_aggregate(cost.to(cuda_device), img.to(cuda_device))
    torch.testing.assert_close(out.cpu(), tps.sgm_aggregate(cost, img), rtol=RTOL, atol=ATOL)
