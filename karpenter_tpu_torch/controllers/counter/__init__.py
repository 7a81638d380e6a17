from .controller import CounterController

__all__ = ["CounterController"]
