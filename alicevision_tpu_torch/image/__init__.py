from . import filtering, io

__all__ = ["filtering", "io"]
