"""Depth maps over ranks and of large images as overlapping tiles.

Port of `alicevision_tpu/mvs/sharded.py` (ref:
depthMap/computeOnMultiGPUs.cpp:15-67 one thread a GPU; mvsUtils/
TileParams.hpp, mvsUtils/mapIO.hpp:28-127 tiled maps with a weighted merge,
depthMap/DepthMapEstimator.cpp:238-270 same-size tiles):

  * `make_sharded_sgm` splits a batch of reference views over the ranks of
    a mesh (`parallel/mesh.py`); each rank runs `batched_sgm` on its
    contiguous block, 4 SGM kernel launches a map on a card;
  * `make_sharded_consistency_filter` is the fusion filter over ranks: each
    rank holds a block of the depth maps in capture order and receives the
    k boundary maps of its ring neighbours (`batch_isend_irecv`), which is
    all a view's ±k consistency set needs; bit-identical to
    `fusion.consistency_filter_ring`;
  * a large image runs as overlapping tiles, each one SGM depth map of a
    crop of the reference view (principal point shifted) against the full
    T-cam images, so it takes the SGM kernel's four launches; tiles merge
    with Hann weights (addTileMapWeighted). Tiles run one after another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..parallel import distributed
from ..parallel.mesh import AXES, Mesh, shard_leading
from .fusion import _counts_against, _keep_map, _ring_offsets
from .plane_sweep import SgmParams, inverse_depth_planes, retrieve_best_depth, sgm_aggregate, sgm_depth_map
from .rectified import rectification_ok, similarity_volume_auto


def batched_sgm(
    ref_imgs: torch.Tensor,  # (B, H, W)
    t_imgs: torch.Tensor,  # (B, T, Ht, Wt)
    K_ref: torch.Tensor,  # (B, 3, 3)
    K_t: torch.Tensor,  # (B, T, 3, 3)
    R_rel: torch.Tensor,  # (B, T, 3, 3)
    t_rel: torch.Tensor,  # (B, T, 3)
    depths: torch.Tensor,  # (B, D) per-view plane lists
    params: SgmParams = SgmParams(),
    tc_depth_ranges: torch.Tensor | None = None,  # (B, T, 2) optional
):
    """The SGM pipeline (similarity volume -> aggregation -> best depth)
    for each view of a batch, one view after another. Returns the (B, H, W)
    depth and similarity maps. Like the JAX package's vmapped version it
    applies no guided cost filtering, and `params.method` picks the
    similarity path for every view ("auto" gates each view's pairs)."""
    out = []
    for b in range(ref_imgs.shape[0]):
        tc = None if tc_depth_ranges is None else tc_depth_ranges[b]
        cost = similarity_volume_auto(
            ref_imgs[b], t_imgs[b], K_ref[b], K_t[b], R_rel[b], t_rel[b], depths[b], params,
            tc_depth_ranges=tc,
        )
        out.append(retrieve_best_depth(sgm_aggregate(cost, ref_imgs[b], params), depths[b]))
    return torch.stack([d for d, _ in out]), torch.stack([s for _, s in out])


def make_sharded_sgm(mesh: Mesh, params: SgmParams = SgmParams(), device="cuda"):
    """Batched SGM with the view batch split over the mesh's ranks.

    The returned function takes `batched_sgm`'s arrays for the whole batch
    (host arrays or tensors; B a multiple of the mesh's ranks), moves this
    rank's contiguous block of views to `device` and returns that block's
    (B/S, H, W) depth and similarity maps. `gather_to_primary` collects the
    blocks on the primary rank for writing."""
    dev = resolve_device(device)

    def block(a):
        return torch.as_tensor(shard_leading(mesh, AXES, a), dtype=torch.float32, device=dev)

    def fn(ref_imgs, t_imgs, K_ref, K_t, R_rel, t_rel, depths, tc_depth_ranges=None):
        args = [block(a) for a in (ref_imgs, t_imgs, K_ref, K_t, R_rel, t_rel, depths)]
        tc = None if tc_depth_ranges is None else block(tc_depth_ranges)
        return batched_sgm(*args, params, tc_depth_ranges=tc)

    return fn


def gather_to_primary(x: torch.Tensor, mesh: Mesh):
    """The blocks of a view-sharded result, concatenated in view order on the
    mesh's first rank (which writes them); None on the other ranks."""
    if mesh.size == 1:
        return x
    out = distributed.gather_to_primary(x, mesh.group, dst=mesh.rank_at(0))
    if out is None:
        return None
    blocks = out.split(x.shape[0])
    return torch.cat([blocks[i] for i in mesh.group_positions()])


def make_sharded_consistency_filter(mesh: Mesh, k: int = 4, min_consistent: int = 3, rel_tol: float = 0.01,
                                    device="cuda"):
    """The cross-view consistency filter with the depth maps split over the
    mesh's ranks, by a ring-halo exchange (the JAX package's shard_map body
    `local`).

    Each rank holds a contiguous block of the (V, H, W) stack in capture
    order; filtering a view needs only its ±k ring neighbours' maps (the
    reference bounds its consistency set the same way:
    src/aliceVision/fuseCut/Fuser.hpp:21-34). So each rank sends its k
    boundary maps forward and back round the ring, 2·k·H·W·4 bytes a rank
    whatever V and the rank count; a rank that holds fewer than k views
    passes whole blocks on, ceil(k / (V/S)) hops. On one rank the halo is a
    wraparound slice of the block.

    The returned function takes `depths`, the whole (V, H, W) stack or this
    rank's block of it (V/S maps), and K, R, c of all V views; it returns
    this rank's block of the filtered maps and counts, bit-identical to the
    same views of `fusion.consistency_filter_ring(depths, K, R, c, k)`."""
    dev = resolve_device(device)
    S = mesh.size
    me = mesh.axis_index(AXES)
    nxt, prv = mesh.rank_at(me + 1), mesh.rank_at(me - 1)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def fn(depths, K, R, c):
        V = K.shape[0]
        if depths.shape[0] == V:
            depths = shard_leading(mesh, AXES, depths)
        elif depths.shape[0] * S != V:
            raise ValueError(f"{depths.shape[0]} depth maps are neither all {V} views nor a block of {S} ranks")
        d_l, K, R, c = t(depths), t(K), t(R), t(c)
        Vs = d_l.shape[0]
        offs = _ring_offsets(V, k)
        k_eff = max(offs) if offs else 0
        if k_eff == 0:
            counts = torch.zeros(d_l.shape, dtype=torch.int32, device=dev)
            return torch.stack([_keep_map(d, cnt, min_consistent) for d, cnt in zip(d_l, counts)]), counts

        if S == 1:  # one rank: the halo is a local wraparound slice
            left, right = d_l[-k_eff:], d_l[:k_eff]
        elif k_eff <= Vs:
            left, right = distributed.ring_exchange(d_l[-k_eff:], d_l[:k_eff], nxt, prv, mesh.group)
        else:  # chain whole blocks round the ring, ceil(k_eff / Vs) hops
            fwd = bwd = d_l
            lparts, rparts = [], []
            for _ in range(-(-k_eff // Vs)):
                fwd, bwd = distributed.ring_exchange(fwd, bwd, nxt, prv, mesh.group)
                lparts.insert(0, fwd)
                rparts.append(bwd)
            left, right = torch.cat(lparts)[-k_eff:], torch.cat(rparts)[:k_eff]
        ext = torch.cat([left, d_l, right])  # (Vs + 2 k_eff, H, W)

        filt, counts = [], []
        for i in range(Vs):
            r = me * Vs + i
            others = ((ext[i + k_eff + off], K[(r + off) % V], R[(r + off) % V], c[(r + off) % V]) for off in offs)
            cnt = _counts_against(d_l[i], K[r], R[r], c[r], others, rel_tol)
            filt.append(_keep_map(d_l[i], cnt, min_consistent))
            counts.append(cnt)
        return torch.stack(filt), torch.stack(counts)

    return fn


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_tiles(H: int, W: int, tile: int = 512, overlap: int = 64, clamp: bool = False):
    """Tile ROIs (y0, y1, x0, x1) covering (H, W) with the given overlap
    (mvsUtils::TileParams contract).

    With `clamp=True` the last tile of each axis is shifted to END at the
    image boundary instead of being cropped, so every tile has the same
    (tile, tile) shape when the image is at least tile-sized."""
    step = tile - overlap
    ys = list(range(0, max(H - overlap, 1), step))
    xs = list(range(0, max(W - overlap, 1), step))
    if clamp:
        ys = sorted({min(y, max(H - tile, 0)) for y in ys})
        xs = sorted({min(x, max(W - tile, 0)) for x in xs})
    return [(y0, min(y0 + tile, H), x0, min(x0 + tile, W)) for y0 in ys for x0 in xs]


def _hann_weight(h: int, w: int) -> np.ndarray:
    wy = np.hanning(h + 2)[1:-1] if h > 1 else np.ones(1)
    wx = np.hanning(w + 2)[1:-1] if w > 1 else np.ones(1)
    return np.outer(wy, wx) + 1e-6


def merge_tiles(tiles: list, H: int, W: int) -> np.ndarray:
    """Hann-weighted tile merge on the host in float64 (mapIO
    addTileMapWeighted semantics). tiles: [(roi, map (h, w))]."""
    acc = np.zeros((H, W), np.float64)
    wacc = np.zeros((H, W), np.float64)
    for (y0, y1, x0, x1), m in tiles:
        wgt = _hann_weight(y1 - y0, x1 - x0)
        valid = m > 0
        acc[y0:y1, x0:x1] += np.where(valid, m * wgt, 0.0)
        wacc[y0:y1, x0:x1] += np.where(valid, wgt, 0.0)
    out = np.where(wacc > 1e-9, acc / np.maximum(wacc, 1e-9), -1.0)
    return out.astype(np.float32)


def _merge_tiles_device(tile_stack: torch.Tensor, rois, hw) -> torch.Tensor:
    """Hann merge of same-shape tiles (S, h, w) on their device, in
    float32 (the JAX package's `_merge_tiles_jit`): the merged map is the
    only one that leaves the tile loop."""
    H, W = hw
    dev = tile_stack.device
    acc = torch.zeros((H, W), dtype=torch.float32, device=dev)
    wacc = torch.zeros((H, W), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for m, (y0, y1, x0, x1) in zip(tile_stack, rois):
        wgt = torch.from_numpy(_hann_weight(y1 - y0, x1 - x0).astype(np.float32)).to(dev)
        valid = m > 0
        acc[y0:y1, x0:x1] += torch.where(valid, m * wgt, zero)
        wacc[y0:y1, x0:x1] += torch.where(valid, wgt, zero)
    return torch.where(wacc > 1e-9, acc / torch.clamp(wacc, min=1e-9), torch.full_like(acc, -1.0))


def sgm_depth_map_tiled(
    ref_img,
    t_imgs,
    K_ref,
    K_t,
    R_rel,
    t_rel,
    d_min: float,
    d_max: float,
    params: SgmParams = SgmParams(),
    tile: int = 512,
    overlap: int = 64,
    device="cuda",
) -> torch.Tensor:
    """Tiled SGM depth map (H, W) of a large reference view, on `device`.

    Host arrays or tensors in. Each tile gets a cropped reference (principal
    point shifted) while the T-cams stay full — the warps index them
    globally. Tiles are CLAMPED to a uniform (tile, tile) shape (the last
    tile of each axis ends at the boundary), so a 1920x1088 view takes 4
    tiles of 1024. With more than one tile every tile takes the gather
    sweep: the rectified sweep keeps a crop's own pixel window and K, and
    misses on a crop off the image's centre (ROADMAP.md §3; the JAX package
    gates its tiles on the poses alone). One ROI (an image no larger than a
    tile) keeps the pose gate. Uniform tiles merge on the device in
    float32, others on the host in float64."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    ref = t(ref_img)
    H, W = ref.shape
    rois = make_tiles(H, W, tile, overlap, clamp=True)
    shapes = {(y1 - y0, x1 - x0) for (y0, y1, x0, x1) in rois}
    R_np, t_np = _host(R_rel), _host(t_rel)
    depths = inverse_depth_planes(d_min, d_max, params.n_depths, device=dev)
    t_j, Kt_j, R_j, tr_j = t(t_imgs), t(K_t), t(R_rel), t(t_rel)
    K_np = _host(K_ref).astype(np.float32)
    ok = len(rois) == 1 and all(rectification_ok(R_np[i], t_np[i]) for i in range(R_np.shape[0]))
    params = params._replace(method="rectified" if ok else "gather")

    tiles = []
    for (y0, y1, x0, x1) in rois:
        K_crop = K_np.copy()
        K_crop[0, 2] -= x0
        K_crop[1, 2] -= y0
        depth, _ = sgm_depth_map(
            ref[y0:y1, x0:x1].contiguous(), t_j, t(K_crop), Kt_j, R_j, tr_j, 1.0, 2.0,
            params, depths=depths,
        )
        tiles.append(depth)
    if len(shapes) == 1 and len(rois) > 1:
        return _merge_tiles_device(torch.stack(tiles), rois, (H, W))
    merged = merge_tiles([(roi, d.cpu().numpy()) for roi, d in zip(rois, tiles)], H, W)
    return torch.from_numpy(merged).to(dev)
