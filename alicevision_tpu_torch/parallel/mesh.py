"""The 2-D rank mesh of the scale-out paths.

Port of `alicevision_tpu/parallel/mesh.py`. The reference scales out with
per-process view chunks plus one thread per GPU
(ref: src/software/pipeline/main_depthMapEstimation.cpp:414-419,
src/aliceVision/depthMap/computeOnMultiGPUs.cpp:15-67). Here the ranks of
the process group are laid out as a grid with two named axes:

  * "view"     — data parallelism over images (depth maps, fusion);
  * "landmark" — BA landmark blocks (the reduced camera system is summed
                 over the ranks that hold them).

A mesh is plain rank arithmetic: `shard_leading` gives the contiguous
block of an array's leading axis that a rank owns, `replicated` the whole
array. The sharded programs (`parallel/ba_sharded.py`, `mvs/sharded.py`)
split their leading axis over both axes at once, row-major, as the JAX
package's `P(("view", "landmark"))` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from .distributed import process_count, process_index

AXES = ("view", "landmark")


@dataclass(frozen=True, eq=False)
class Mesh:
    """Global ranks laid out as (n_view, n_landmark); `rank` is this
    process's global rank, `group` the process group over the mesh's ranks
    (None: the default group, or no group for a one-rank mesh)."""

    ranks: np.ndarray
    rank: int = 0
    group: object = None
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axis=AXES) -> int:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axis=AXES, rank: int | None = None) -> int:
        """Position of `rank` (default: this process) along `axis`, or
        row-major over a tuple of axes."""
        rank = self.rank if rank is None else rank
        pos = np.argwhere(self.ranks == rank)
        if len(pos) != 1:
            raise ValueError(f"rank {rank} is not in the mesh {self.ranks.tolist()}")
        coord = dict(zip(self.axis_names, pos[0]))
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + int(coord[a])
        return idx

    def rank_at(self, index: int) -> int:
        """The global rank at row-major position `index` over both axes
        (modulo the mesh's size: the ring's neighbours)."""
        return int(self.ranks.reshape(-1)[index % self.size])

    def group_positions(self) -> list:
        """For each position of the mesh (row-major over both axes), where
        its rank stands in the list of a collective over `group`."""
        flat = [int(r) for r in self.ranks.reshape(-1)]
        if self.group is None:
            return flat
        return [sorted(flat).index(r) for r in flat]


def make_mesh(n_view: int | None = None, n_landmark: int | None = None, ranks=None) -> Mesh:
    """The (view, landmark) mesh over `ranks` (default: every rank of the
    process group, or rank 0 alone without one), with the JAX package's
    defaulting: neither count given puts every rank on "landmark". With a
    process group, every rank must call this with the same arguments (a
    mesh over part of the world makes its group with `new_group`)."""
    ranks = list(range(process_count())) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if n_view is None and n_landmark is None:
        n_landmark = n
        n_view = 1
    elif n_view is None:
        n_view = n // n_landmark
    elif n_landmark is None:
        n_landmark = n // n_view
    assert n_view * n_landmark == n, (n_view, n_landmark, n)
    group = None
    if dist.is_initialized() and n > 1 and sorted(ranks) != list(range(dist.get_world_size())):
        group = dist.new_group(sorted(ranks))
    return Mesh(np.asarray(ranks).reshape(n_view, n_landmark), rank=process_index(), group=group)


def shard_leading(mesh: Mesh, axis, x, rank: int | None = None):
    """The contiguous block of `x`'s leading axis that `rank` (default: this
    process) owns when that axis is split over mesh axis `axis` (a name or
    a tuple of names). The axis must divide evenly, as a NamedSharding
    requires."""
    n = mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split over {n} shards")
    per = x.shape[0] // n
    i = mesh.axis_index(axis, rank)
    return x[i * per:(i + 1) * per]


def replicated(mesh: Mesh, x):
    """The whole array: what every rank of the mesh holds."""
    return x
