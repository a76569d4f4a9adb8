"""The serving stack: the continuous-batching engine, the stdlib web app,
the Gradio app's core, the unloop OSC bridge and the token telephone."""
from .engine import MagnetRequest, VampEngine, VampRequest  # noqa: F401
from .webapp import make_server  # noqa: F401
