"""The part of `alicevision_tpu/panorama` that texturing uses: the
multi-band Laplacian blend. The rest of the panorama pipeline is not ported
yet (ROADMAP item 13)."""

from .compositing import laplacian_blend

__all__ = ["laplacian_blend"]
