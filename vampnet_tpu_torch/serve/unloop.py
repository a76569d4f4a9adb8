"""unloop: the OSC bridge for the Max/MSP live looper (counterpart of
`vampnet_tpu/serve/unloop.py`).

Max sends `/process` with 18 arguments (query id, client type, audio path,
model, mask and sampling knobs, loop length, feedback steps); the bridge
vamps the file and replies `/process-result` with the generated WAV paths.
It also answers `/heartbeat` with "pong", deletes files on `/cleanup`, and
sends `/progress` and `/log` notes.

The bridge calls a local `Interface` (or a `VampEngine`'s) directly, or
forwards to a remote Gradio app (`vampnet_url`, which needs
`gradio_client`). OSC needs no package: `serve/osc.py` implements it.

    python -m vampnet_tpu_torch.serve.unloop
"""
from __future__ import annotations

import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..audio import AudioSignal
from .osc import Dispatcher, OSCClient, OSCServer

from ..profiling import Timer

DOWNLOADS_DIR = ".gradio"


def clear_file(file):
    file = Path(file)
    if file.exists():
        file.unlink()


class OSCManager:
    """The OSC client towards Max and the server for its messages."""

    def __init__(self, ip: str, s_port: int, r_port: int, process_fn: Callable):
        self.ip = ip
        self.s_port = s_port
        self.r_port = r_port
        self.process_fn = process_fn
        self.client = OSCClient(ip, s_port)
        self.server: Optional[OSCServer] = None

    def make_server(self) -> OSCServer:
        dispatcher = Dispatcher()
        dispatcher.map("/process", self.process_fn)
        dispatcher.map(
            "/heartbeat",
            lambda addr, *args: self.client.send_message("/heartbeat", "pong"),
        )
        dispatcher.map("/cleanup", lambda addr, *args: clear_file(args[0]))
        dispatcher.set_default_handler(lambda addr, *args: print(addr, args))
        self.server = OSCServer((self.ip, self.r_port), dispatcher)
        return self.server

    def start_server(self):  # blocking
        self.make_server()
        print(f"Serving on {self.server.address}")
        self.server.serve_forever()

    def error(self, msg: str):
        self.client.send_message("/error", msg)

    def log(self, msg: str):
        self.client.send_message("/log", msg)


class UnloopBridge:
    """The vamp bridge: `/process` requests in, `/process-result` out."""

    def __init__(
        self,
        ip: str = "127.0.0.1",
        s_port: int = 8003,
        r_port: int = 8001,
        interface=None,
        engine=None,
        vampnet_url: Optional[str] = None,
        out_dir: Optional[str] = None,
    ):
        self.osc_manager = OSCManager(ip, s_port, r_port, process_fn=self.process)
        self.interface = interface
        self.engine = engine
        self.batch_size = 2
        self.out_dir = Path(out_dir or tempfile.mkdtemp(prefix="unloop_"))
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.timer = Timer()
        self.gradio_client = None
        if vampnet_url is not None:  # pragma: no cover - needs gradio_client
            from gradio_client import Client

            self.gradio_client = Client(src=vampnet_url, download_files=DOWNLOADS_DIR)
        if self.interface is None and self.engine is None and self.gradio_client is None:
            raise ValueError("need a local interface/engine or a vampnet gradio url")
        self.osc_manager.log("hello from vampnet-tpu unloop bridge!")

    # ---------- OSC entry ----------

    def process(self, address: str, *args):
        client_type = args[1]
        if client_type == "vampnet":
            return self.vampnet_process(address, *args)
        raise ValueError(f"Unknown client type {client_type}")

    def vampnet_process(self, address: str, *args):
        """The 18-argument `/process` request: vamp the file at the loop
        length, write `batch_size` variations at 48 kHz and send their
        paths."""
        (query_id, _client_type, audio_path, model_choice, periodic_p, dropout,
         seed, looplength_ms, typical_filter, typical_mass, typical_min_tokens,
         upper_codebook_mask, onset_mask_width, sampling_steps, temperature,
         top_p, beat_mask_ms, num_feedback_steps) = args[:18]

        audio_path = Path(audio_path)
        if not audio_path.exists():
            self.osc_manager.error(f"File {audio_path} does not exist")
            return

        sig = AudioSignal(audio_path)
        sig.to_mono()
        sig.sample_rate = 48000  # the looper's files are read as 48 kHz

        # crop to the loop length; keep the tail to re-append
        end_sample = int((looplength_ms * sig.sample_rate) / 1000)
        end_sample = min(end_sample, sig.length)
        cut_wav = sig.samples[..., end_sample:]
        sig.samples = sig.samples[..., :end_sample]
        sig.write(audio_path)

        self.timer.tick("predict")
        self.osc_manager.client.send_message("/progress", [str(query_id), "PROCESSING"])

        from .app import vamp_core

        res = vamp_core(
            self.interface if self.interface is not None else self.engine.interface,
            (sig.sample_rate, sig.samples[0, 0]),
            seed=int(seed),
            model_choice=model_choice,
            periodic_p=int(periodic_p),
            n_mask_codebooks=int(upper_codebook_mask),
            onset_mask_width=int(onset_mask_width),
            dropout=float(dropout),
            sampletemp=float(temperature),
            typical_filtering=bool(typical_filter),
            typical_mass=float(typical_mass),
            typical_min_tokens=int(typical_min_tokens),
            top_p=float(top_p) if top_p and top_p > 0 else None,
            sampling_steps=int(sampling_steps),
            beat_mask_ms=int(beat_mask_ms),
            num_feedback_steps=int(num_feedback_steps),
            batch_size=self.batch_size,
        )

        audio_files = []
        for i, (sr, wav) in enumerate(res.variations[: self.batch_size]):
            out = AudioSignal(wav[None, None, :], sr)
            out.resample(48000)
            # re-append the cropped tail
            if cut_wav.shape[-1]:
                out.samples = np.concatenate([out.samples, cut_wav[:1, :1]], axis=-1)
            path = self.out_dir / f"{query_id}_{i}.wav"
            out.write(path)
            audio_files.append(str(path))

        self.timer.tock("predict")
        self.osc_manager.log(f"query {query_id} has been processed")
        self.osc_manager.client.send_message(
            "/process-result", [str(query_id)] + audio_files
        )
        return audio_files


def main(argv=None):
    """Serve the bridge until interrupted, its settings read through
    `config.parse_args` as the JAX package reads them: against the Gradio
    app at `--vampnet_url`, else against the models directory's models on
    `--device` (the card by default); `--ip`, `--s_port`, `--r_port`."""
    from .. import config as cfglib

    args = cfglib.parse_args(argv)
    vampnet_url = args.get("vampnet_url")
    interface = None
    if vampnet_url is None:
        from ..interface import Interface

        interface = Interface.default(device=args.get("device", "cuda"))
    bridge = UnloopBridge(ip=args.get("ip", "127.0.0.1"), s_port=int(args.get("s_port", 8003)),
                          r_port=int(args.get("r_port", 8001)), interface=interface,
                          vampnet_url=vampnet_url)
    bridge.osc_manager.start_server()
    return bridge


if __name__ == "__main__":  # pragma: no cover
    main()
