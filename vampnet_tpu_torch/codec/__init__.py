from .model import LAC, CodecConfig  # noqa: F401
