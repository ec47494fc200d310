from .linfinity import (
    translations_from_relative_linf,
    triangulate_linf,
    resection_linf,
)

__all__ = [
    "resection_linf",
    "translations_from_relative_linf",
    "triangulate_linf",
]
