from . import batched, contact, system  # noqa: F401
from .system import System, load_mjcf, system_from_numpy  # noqa: F401
