"""The surface mesher's half of `alicevision_tpu/mesh`: graph-cut surface
extraction, mesh operations and IO, per-vertex colour baking. `clean`,
`denoise`, `lscm`, `uv_atlas` and `render` are not ported yet (ROADMAP
item 13)."""

from .delaunay_graphcut import graph_cut_surface, tetrahedralize
from .ops import (
    compact,
    decimate_grid,
    decimate_qem,
    laplacian_smooth,
    largest_component,
    load_obj,
    load_ply_mesh,
    merge_meshes,
    save_obj,
    save_ply_mesh,
    vertex_normals,
)
from .texturing import bake_vertex_colors

__all__ = [
    "bake_vertex_colors",
    "compact",
    "decimate_grid",
    "decimate_qem",
    "graph_cut_surface",
    "laplacian_smooth",
    "largest_component",
    "load_obj",
    "load_ply_mesh",
    "merge_meshes",
    "save_obj",
    "save_ply_mesh",
    "tetrahedralize",
    "vertex_normals",
]
