from . import ba, local_ba

__all__ = ["ba", "local_ba"]
