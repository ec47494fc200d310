from . import stages

__all__ = ["stages"]
