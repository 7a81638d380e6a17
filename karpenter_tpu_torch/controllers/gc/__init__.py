from .controller import GarbageCollectionController

__all__ = ["GarbageCollectionController"]
