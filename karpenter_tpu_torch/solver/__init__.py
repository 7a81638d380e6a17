from .dense import DenseSolver, DenseSolveStats

__all__ = ["DenseSolver", "DenseSolveStats"]
