from .signal import AudioSignal  # noqa: F401
