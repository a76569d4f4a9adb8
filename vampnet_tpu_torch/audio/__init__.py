from .signal import AudioSignal, signal_concat  # noqa: F401
