from .nodes import *  # noqa: F401,F403
