"""Scheduling errors."""


class IncompatibleError(RuntimeError):
    """A pod cannot be placed on a particular (virtual or existing) node."""


class UnsatisfiableTopologyError(IncompatibleError):
    """No domain choice can satisfy a topology constraint for this placement."""
