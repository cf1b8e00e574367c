from .driver import OptimizeOptions, optimize_tree

__all__ = ["OptimizeOptions", "optimize_tree"]
