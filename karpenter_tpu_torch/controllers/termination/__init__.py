from .controller import TerminationController
from .eviction import EvictionQueue

__all__ = ["TerminationController", "EvictionQueue"]
