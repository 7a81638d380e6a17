from .labels import *  # noqa: F401,F403
from .objects import *  # noqa: F401,F403
from .provisioner import *  # noqa: F401,F403
