from .transformer import LMConfig, VampNetLM  # noqa: F401
