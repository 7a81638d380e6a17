from .controller import InterruptionController
from .messages import InterruptionMessage, MessageParseError, parse

__all__ = ["InterruptionController", "InterruptionMessage", "MessageParseError", "parse"]
