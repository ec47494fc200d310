"""Port of `alicevision_tpu/mesh`: graph-cut surface extraction, mesh
operations and IO, manifold repair, denoising and resampling, LSCM
unwrapping, UV-atlas texturing (`mesh.uv_atlas`), rasterization
(`mesh.render`) and per-vertex colour baking. It exports the reference
package's names, and the PLY mesh IO beside them."""

from .clean import boundary_loops, clean_mesh, fill_small_holes
from .delaunay_graphcut import graph_cut_surface, tetrahedralize
from .denoise import denoise_sd, mask_faces_by_views, resample
from .lscm import conformal_error, lscm_unwrap
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
    "boundary_loops",
    "clean_mesh",
    "compact",
    "conformal_error",
    "decimate_grid",
    "decimate_qem",
    "denoise_sd",
    "fill_small_holes",
    "graph_cut_surface",
    "laplacian_smooth",
    "largest_component",
    "load_obj",
    "load_ply_mesh",
    "lscm_unwrap",
    "mask_faces_by_views",
    "merge_meshes",
    "resample",
    "save_obj",
    "save_ply_mesh",
    "tetrahedralize",
    "vertex_normals",
]
