from .controller import NodeController

__all__ = ["NodeController"]
