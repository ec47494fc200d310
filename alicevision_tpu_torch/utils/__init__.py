from . import rendered, synthetic

__all__ = ["rendered", "synthetic"]
