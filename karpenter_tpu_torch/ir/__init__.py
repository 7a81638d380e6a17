from .encode import DenseProblem, GroupInfo, GroupKind, encode_problem

__all__ = ["DenseProblem", "GroupInfo", "GroupKind", "encode_problem"]
