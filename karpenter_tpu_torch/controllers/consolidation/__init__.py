from .controller import ConsolidationController, ConsolidationAction

__all__ = ["ConsolidationController", "ConsolidationAction"]
