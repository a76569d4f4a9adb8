"""Token telephone, the 4-channel standalone art installation (counterpart
of `vampnet_tpu/serve/token_telephone.py`).

A live looper: audio above an RMS trigger threshold is recorded (with 200 ms
lookback to catch attacks, and trigger/release hysteresis), mixed into the
current loop channel, and a background thread vamps each channel into the
next (the "telephone"), with loudness guard rails.

The looper's state machine and block processing are numpy only and run
from any audio callback (tests drive them headless); `run()` wires them to
sounddevice and a terminal UI where those are installed.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..audio import AudioSignal

MAX_LOUDNESS = -20  # the telephone's loudness guard rails (LUFS)
MIN_LOUDNESS = -40


def pow2db(x: float) -> float:
    return 10.0 * math.log10(max(x, 1e-12))


@dataclass
class State:
    """Looper and telephone state."""

    sample_rate: int = 48000
    blocksize: int = 256
    num_channels: int = 4

    feedback: float = 0.25
    duration: float = 5.0
    record_channel: int = 0

    loopbuf: np.ndarray = None
    looper_in: np.ndarray = None
    lookback_buf: np.ndarray = None

    recording: bool = False
    playing: bool = True
    record_ramp_in: bool = False
    record_ramp_out: bool = False
    recording_locked: bool = False

    rec_time: float = 0.0
    cur_hold_time: Optional[float] = None
    pos: int = 0
    rms_db: float = float("-inf")

    trig_threshold_db: float = -25
    hold_seconds: float = 1.0
    rel_threshold_db: float = -40

    input_ready: bool = False
    input_channel: int = 0
    token_telephone_processing: bool = False
    num_telephone_chans: int = 4
    tt_cur_ch: int = 0

    def __post_init__(self):
        n = int(self.duration * self.sample_rate)
        self.loopbuf = np.zeros((self.num_channels, n))
        self.looper_in = np.zeros((1, n))
        num_lookback = max(int(self.sample_rate * 0.2), int(self.blocksize))
        self.lookback_buf = np.zeros((1, num_lookback))


def check_if_record(st: State, ain: np.ndarray, on_release_callback: Optional[Callable] = None):
    """Trigger/release hysteresis with a hold time."""
    rms = pow2db(float(np.sqrt(np.mean(ain**2))))
    st.rms_db = rms

    if not st.recording and rms > st.trig_threshold_db and not st.recording_locked:
        st.recording = True
        st.record_ramp_in = True

    if (st.recording and rms < st.rel_threshold_db) or st.rec_time > (
        st.duration - st.hold_seconds
    ):
        if st.cur_hold_time is None:
            st.cur_hold_time = time.time()
        if (time.time() - st.cur_hold_time) > st.hold_seconds:
            st.record_ramp_out = True
            st.rec_time = 0
            if on_release_callback is not None:
                st.input_ready = True
                on_release_callback(st)
            st.cur_hold_time = None
    else:
        st.cur_hold_time = None


def looper_process_block(st: State, block: np.ndarray) -> np.ndarray:
    """One audio-callback block: the lookback ring buffer, ramped recording
    into looper_in, loop playback."""
    lrc = st.record_channel
    nb = block.shape[1]

    st.lookback_buf = np.roll(st.lookback_buf, nb, axis=1)
    st.lookback_buf[:, -nb:] = block[lrc : lrc + 1, :]

    if st.recording:
        start_i = (st.pos + nb) - st.lookback_buf.shape[1]
        end_i = st.pos + st.lookback_buf.shape[1]
        indices = np.take(
            np.arange(st.loopbuf.shape[1]), np.arange(start_i, end_i), mode="wrap"
        )[: st.lookback_buf.shape[1]]
        audio_in = st.lookback_buf[:, : len(indices)]
        if st.record_ramp_in:
            audio_in = audio_in * np.linspace(0, 1, audio_in.shape[1])
            st.record_ramp_in = False
        if st.record_ramp_out:
            audio_in = audio_in * np.linspace(1, 0, audio_in.shape[1])
            st.record_ramp_out = False
            st.recording = False
        st.looper_in[:, indices] = 0.9 * st.looper_in[:, indices] + audio_in
        st.rec_time += st.lookback_buf.shape[1] / st.sample_rate

    if st.playing:
        play_pos = (st.pos + nb) % st.loopbuf.shape[1]
        indices = np.arange(play_pos, play_pos + nb)
        block = st.loopbuf.take(indices, axis=1, mode="wrap")

    st.pos = (st.pos + nb) % st.loopbuf.shape[1]
    return block


def telephone_step(st: State, vamp_fn: Callable[[AudioSignal], AudioSignal]):
    """One telephone step: mix any pending input into the current channel,
    vamp it, write the result to the next channel."""
    cur_ch = st.tt_cur_ch

    if st.input_ready:
        st.input_ready = False
        st.input_channel = cur_ch
        st.recording_locked = True

        sig_in = AudioSignal(st.looper_in[None].astype(np.float32), st.sample_rate)
        sig_cur = AudioSignal(
            st.loopbuf[cur_ch : cur_ch + 1][None].astype(np.float32), st.sample_rate
        )
        ldns_mid = max(float(sig_cur.loudness()[0]), float(sig_in.loudness()[0]))
        sig_in = sig_in.normalize(ldns_mid)
        st.looper_in = sig_in.samples[0]
        st.loopbuf[cur_ch : cur_ch + 1] = (
            st.looper_in + st.loopbuf[cur_ch : cur_ch + 1] * st.feedback
        )
        for i in range(st.num_telephone_chans):
            if i != cur_ch:
                st.loopbuf[i : i + 1] *= 0.5  # the other channels step down
        st.looper_in = np.zeros_like(st.looper_in)

    loop_input = st.loopbuf[cur_ch : cur_ch + 1]
    sig = AudioSignal(loop_input[None].astype(np.float32), st.sample_rate)
    input_loudness = float(sig.loudness()[0])
    if input_loudness > MAX_LOUDNESS:
        sig = sig.normalize(MAX_LOUDNESS)
    elif input_loudness < MIN_LOUDNESS:
        sig = sig.normalize(MIN_LOUDNESS)

    sig = vamp_fn(sig)
    sig = sig.resample(st.sample_rate)
    sig = sig.normalize(np.clip(input_loudness, MIN_LOUDNESS, MAX_LOUDNESS))

    cur_ch = (cur_ch + 1) % st.num_telephone_chans
    st.tt_cur_ch = cur_ch
    n = st.loopbuf.shape[1]
    out = sig.samples[0, :1, :n]
    if out.shape[-1] < n:
        out = np.pad(out, ((0, 0), (0, n - out.shape[-1])))
    st.loopbuf[cur_ch : cur_ch + 1] = out

    if cur_ch == st.input_channel:
        st.recording_locked = False
    return cur_ch


def ez_variation(interface, sig: AudioSignal, seed: Optional[int] = None,
                 model_choice: Optional[str] = None) -> AudioSignal:
    """The installation's fixed-preset vamp: periodic prompt 3, upper
    codebook mask 3, typical filter 0.15 / 64."""
    if seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))
    if model_choice is not None:
        interface.load_finetuned(model_choice)

    codes = interface.encode(sig)
    mask = interface.build_mask(
        codes, rand_mask_intensity=1.0, prefix_s=0.0, suffix_s=0.0,
        periodic_prompt=3, periodic_prompt_width=1, _dropout=0.0,
        upper_codebook_mask=3, seed=seed,
    )
    interface.set_chunk_size(10.0)
    zv = interface.vamp(
        codes, mask, batch_size=1, feedback_steps=1, time_stretch_factor=1,
        temperature=1.0, typical_filtering=True, typical_mass=0.15,
        typical_min_tokens=64, top_p=None, seed=seed, sample_cutoff=1.0,
    )
    return interface.decode(zv)


def do_token_telephone(st: State, interface, stop_event: Optional[threading.Event] = None):
    """The background vamp loop, until `stop_event` is set."""
    st.token_telephone_processing = True
    vamp_fn = lambda sig: ez_variation(interface, sig)
    while stop_event is None or not stop_event.is_set():
        telephone_step(st, vamp_fn)
    st.token_telephone_processing = False


# ---------------- terminal UI ----------------
# The frame is produced as text rows by `render_frame` (testable headless);
# `draw_looper` paints it through blessed where that package is installed,
# else with plain prints.

RMS_MIN = -50.0  # the RMS bar's scale (dB)
RMS_MAX = -10.0
UI_COLS = 72
UI_ROWS = 18


def _locked_time_remaining(st: State) -> float:
    """Seconds until the visitor's turn."""
    if st.tt_cur_ch < st.input_channel:
        chs_remaining = st.input_channel - st.tt_cur_ch
    else:
        chs_remaining = st.num_telephone_chans - st.tt_cur_ch + st.input_channel
    return (
        chs_remaining * st.duration + st.duration - st.pos / st.sample_rate
    )


def render_frame(st: State, width: int = UI_COLS, height: int = UI_ROWS):
    """The installation screen as `height` rows of `width` chars.

    The RMS bar uses '*' below the trigger threshold and '#' above; the
    active telephone channel's badge is framed with '#', idle ones with
    '.'."""
    grid = [[" "] * width for _ in range(height)]

    def put(x: int, y: int, s: str):
        if not 0 <= y < height:
            return
        for i, ch in enumerate(s):
            if 0 <= x + i < width:
                grid[y][x + i] = ch

    def center(y: int, s: str):
        put(max(0, (width - len(s)) // 2), y, s)

    # title
    center(1, "token telephone")

    # rms bar: a vertical meter at the left edge
    bar_h = height - 3
    rms = max(st.rms_db, RMS_MIN)
    rms_block = int((rms - RMS_MIN) / (RMS_MAX - RMS_MIN) * bar_h)
    threshold_block = (st.trig_threshold_db - RMS_MIN) / (RMS_MAX - RMS_MIN) * bar_h
    for i in range(min(rms_block, bar_h)):
        put(3, height - 3 - i, "*" if i < threshold_block else "#")
    put(0, height - 2, f"{st.rms_db:.1f}dB" if np.isfinite(st.rms_db) else "-inf dB")

    # timeline with playhead
    tl = ["-"] * (width - 12)
    playhead = int((st.pos / st.loopbuf.shape[1]) * (width - 12))
    tl[min(playhead, len(tl) - 1)] = "v"
    put(6, height - 1, "|" + "".join(tl) + "|")

    # center message
    mid = height // 2
    if st.recording:
        center(mid - 1, "recording")
        center(mid, f"{st.duration - st.rec_time:.1f}s left")
    elif st.recording_locked:
        center(mid - 1, "please wait")
        center(mid, f"{_locked_time_remaining(st):.1f}s")
        center(mid + 1, "for your turn :)")
    else:
        center(mid - 1, "make a sound")
        center(mid, "to")
        center(mid + 1, "record")

    # channel badges in the four corners
    mx, my = 10, 3
    locations = {
        1: (width - mx, height - my),
        2: (width - mx, 1 + my),
        3: (mx, 1 + my),
        4: (mx, height - my),
    }
    for i in range(1, 5):
        x, y = locations[i]
        active = st.tt_cur_ch == i - 1 and st.token_telephone_processing
        edge = "#" if active else "."
        put(x, y - 1, edge * 5)
        put(x, y, f"{edge} {i} {edge}")
        put(x, y + 1, edge * 5)

    return ["".join(row) for row in grid]


def draw_looper(st: State, term=None, _state={}):  # pragma: no cover - terminal I/O
    """Paint the frame, at most one full redraw per 0.3 s: in place through
    blessed where available, else clear the screen and print."""
    now = time.time()
    if now - _state.get("last_draw", 0.0) < 0.3:
        return
    _state["last_draw"] = now
    rows = render_frame(st)
    if term is not None:
        for y, row in enumerate(rows):
            print(term.move_xy(0, y) + row)
    else:
        print("\033[2J\033[H" + "\n".join(rows), flush=True)


def make_audio_callback(st: State, on_release_callback: Optional[Callable] = None):
    """The sounddevice stream callback as a numpy closure, so tests drive it
    with synthetic int16 buffers and no audio hardware.

    indata/outdata are (frames, channels) int16, as the stream gives them;
    silence passes through untouched.
    """

    def callback(indata, outdata, frames, tinfo, status):
        if status:
            st.status = str(status)
        ain = indata.T.astype(np.float32) / np.iinfo(np.int16).max
        if ain.shape[0] < st.num_channels:
            ain = np.tile(ain[:1], (st.num_channels, 1))
        if np.all(ain == 0):
            outdata[:] = 0
            return
        check_if_record(st, ain[st.record_channel], on_release_callback)
        out = looper_process_block(st, ain)
        out16 = (np.clip(out, -1.0, 1.0) * np.iinfo(np.int16).max).astype(np.int16)
        outdata[:] = out16.T[: outdata.shape[0], : outdata.shape[1]]

    return callback


def run(interface, duration: float = 5.0, device=None, ui: bool = True):  # pragma: no cover
    """Live entry point: the sounddevice callback, the background telephone
    thread and the terminal UI loop. Needs the sounddevice package and audio
    hardware; blessed is optional (plain frames without it)."""
    import sounddevice as sd

    st = State(duration=duration)
    stop = threading.Event()
    threading.Thread(
        target=do_token_telephone, args=(st, interface, stop), daemon=True
    ).start()
    callback = make_audio_callback(st, on_release_callback=lambda st: None)

    term = None
    if ui:
        try:
            import blessed

            term = blessed.Terminal()
        except ImportError:
            pass

    def _ui_loop():
        while True:
            if ui:
                draw_looper(st, term)
            time.sleep(0.1)

    stream = sd.Stream(
        channels=st.num_channels, samplerate=st.sample_rate,
        blocksize=st.blocksize, dtype=np.int16, callback=callback, device=device,
    )
    try:
        if term is not None:
            with term.fullscreen(), term.hidden_cursor(), stream:
                _ui_loop()
        else:
            with stream:
                _ui_loop()
    except KeyboardInterrupt:
        stop.set()
