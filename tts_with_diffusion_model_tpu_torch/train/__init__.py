from .engine import Engine, Engines  # noqa: F401
from .train import load_engines, main  # noqa: F401
