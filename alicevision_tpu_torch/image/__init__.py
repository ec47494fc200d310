from . import cache, colorspace, feeds, filtering, io, processing
from .cache import ImageCache

__all__ = [
    "ImageCache", "cache", "colorspace", "feeds", "filtering", "io",
    "processing",
]
