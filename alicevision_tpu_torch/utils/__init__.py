from . import rendered

__all__ = ["rendered"]
