"""The stdlib web app (counterpart of `vampnet_tpu/serve/webapp.py`): the
app's vamp API (`vamp_core`) behind `http.server.ThreadingHTTPServer`, with
a minimal browser UI. No third-party package; `serve.app.main()` serves it
when Gradio is absent.

Endpoints:
  GET  /            minimal HTML UI (presets, knobs, upload, playback)
  GET  /health      {"status": "ok", "models": [...]}
  GET  /presets     the preset table (JSON)
  POST /api/vamp    run vamp; two request encodings:
                    - body = WAV bytes (Content-Type: audio/wav or
                      application/octet-stream), knobs as query params
                    - body = JSON {"audio_b64": ..., "sample_rate": ...,
                      <vamp_core kwargs>}
                    Response: {"seed", "wall_time_s", "sample_rate",
                    "variations": [base64 WAV, ...]}, or the raw audio/wav
                    of variation 0 with ?format=wav.

With a `VampEngine`, concurrent clients' generates merge into shared
batches on the card (`vamp_core_engine`); the knobs the engine cannot model
take the locked `vamp_core` path.

    python -m vampnet_tpu_torch.serve.app     # the models directory's models
"""
from __future__ import annotations

import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import mask as pmask
from .. import profiling
from ..audio.dsp import pitch_shift
from .app import PRESETS, VampResult, input_signal, to_output, vamp_core
from .engine import VampRequest

# knob name -> coercion, vamp_core's keyword arguments
_KNOBS = {
    "seed": int,
    "model_choice": str,
    "pitch_shift_amt": int,
    "periodic_p": int,
    "n_mask_codebooks": int,
    "onset_mask_width": int,
    "dropout": float,
    "sampletemp": float,
    "typical_filtering": lambda v: str(v).lower() in ("1", "true", "yes", "on"),
    "typical_mass": float,
    "typical_min_tokens": int,
    "top_p": float,
    "sample_cutoff": float,
    "stretch_factor": int,
    "sampling_steps": int,
    "beat_mask_ms": int,
    "num_feedback_steps": int,
    "batch_size": int,
}

# knobs vamp_core takes that vamp_core_engine cannot route to the engine
_ENGINE_UNSUPPORTED = ("stretch_factor", "num_feedback_steps", "model_choice")


def wav_bytes_to_audio(data: bytes) -> Tuple[int, np.ndarray]:
    """WAV bytes -> (sample rate, float32 samples: (t,) mono or (ch, t))."""
    import scipy.io.wavfile as wavfile

    sr, samples = wavfile.read(io.BytesIO(data))
    if np.issubdtype(samples.dtype, np.integer):
        samples = samples.astype(np.float32) / np.iinfo(samples.dtype).max
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 2:  # scipy gives (t, ch)
        samples = samples.T
    return int(sr), samples


def audio_to_wav_bytes(sr: int, samples: np.ndarray) -> bytes:
    """float32 samples in [-1, 1] -> 16-bit PCM WAV bytes."""
    import scipy.io.wavfile as wavfile

    buf = io.BytesIO()
    data = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    wavfile.write(buf, int(sr), (data.T * 32767.0).astype(np.int16))
    return buf.getvalue()


def vamp_core_engine(interface, engine, input_audio, **kwargs) -> VampResult:
    """`vamp_core` with its generate stage routed through a `VampEngine`:
    encode, mask and decode run in the caller's thread, and each variation
    is one engine request, so concurrent clients (and a request's own
    variations) share batches on the card. Variation i takes seed + i.

    While tracing (`profiling.py`), a `webapp.request` span covers the call
    and a `webapp.engine_wait` span its wait on the engine; its engine
    requests carry the request span's id as their `trace_id`."""
    with profiling.span("webapp.request") as request_span:
        request_id = request_span.id
        t0 = time.time()
        seed = int(kwargs.pop("seed", 0))
        _seed = seed if seed > 0 else int(np.random.randint(0, 2**31 - 1))
        batch_size = int(kwargs.pop("batch_size", 2))
        sig = input_signal(input_audio)
        loudness = sig.loudness()
        psa = int(kwargs.pop("pitch_shift_amt", 0))
        if psa:
            sig = pitch_shift(sig, psa)

        n_mask_codebooks = int(kwargs.pop("n_mask_codebooks", 3))
        codes = interface.encode(sig)
        mask = interface.build_mask(
            codes, sig=sig, periodic_prompt=int(kwargs.pop("periodic_p", 7)),
            onset_mask_width=int(kwargs.pop("onset_mask_width", 0)),
            _dropout=float(kwargs.pop("dropout", 0.0)), upper_codebook_mask=n_mask_codebooks,
            seed=_seed,
        )
        beat_mask_ms = int(kwargs.pop("beat_mask_ms", 0))
        if beat_mask_ms > 0 and interface.beat_tracker is not None:
            mask = pmask.mask_and(
                mask, interface.make_beat_mask(sig, after_beat_s=beat_mask_ms / 1000.0))
            mask = pmask.codebook_mask(mask, n_mask_codebooks)

        top_p = kwargs.pop("top_p", None)
        if top_p is not None and top_p <= 0:
            top_p = None
        codes_np, mask_np = codes.cpu().numpy(), mask.cpu().numpy()
        futures = [
            engine.submit(VampRequest(
                codes=codes_np, mask=mask_np, seed=_seed + i,
                temperature=float(kwargs.get("sampletemp", 1.0)), top_p=top_p,
                sample_cutoff=float(kwargs.get("sample_cutoff", 1.0)),
                sampling_steps=int(kwargs.get("sampling_steps", 36)),
                typical_filtering=bool(kwargs.get("typical_filtering", True)),
                typical_mass=float(kwargs.get("typical_mass", 0.15)),
                typical_min_tokens=int(kwargs.get("typical_min_tokens", 64)),
                trace_id=request_id,
            ))
            for i in range(batch_size)
        ]
        with profiling.span("webapp.engine_wait", request=request_id):
            zv = np.concatenate([f.result() for f in futures], axis=0)
        out = interface.decode(zv).normalize(float(loudness[0]))
        return VampResult(
            variations=[to_output(out, i) for i in range(out.batch_size)],
            mask=mask_np, seed=_seed, wall_time_s=time.time() - t0,
        )


_INDEX_HTML = """<!doctype html>
<html><head><title>vampnet</title><style>
body {{ font-family: sans-serif; max-width: 640px; margin: 2em auto; }}
label {{ display: block; margin-top: .5em; }}
</style></head><body>
<h2>vampnet</h2>
<input type="file" id="audio" accept="audio/wav"/>
<label>preset <select id="preset">{presets}</select></label>
<label>sampling steps <input id="sampling_steps" type="number" value="36"/></label>
<label>seed (0 = random) <input id="seed" type="number" value="0"/></label>
<button onclick="vamp()">vamp!</button> <span id="status"></span>
<div id="outs"></div>
<script>
async function vamp() {{
  const f = document.getElementById('audio').files[0];
  if (!f) {{ alert('pick a wav first'); return; }}
  const preset = document.getElementById('preset').value;
  const q = new URLSearchParams({{
    preset: preset,
    sampling_steps: document.getElementById('sampling_steps').value,
    seed: document.getElementById('seed').value,
  }});
  document.getElementById('status').textContent = 'vamping...';
  const r = await fetch('/api/vamp?' + q, {{method: 'POST',
    headers: {{'Content-Type': 'audio/wav'}}, body: await f.arrayBuffer()}});
  const j = await r.json();
  const outs = document.getElementById('outs');
  outs.innerHTML = '';
  for (const b64 of j.variations) {{
    const a = document.createElement('audio');
    a.controls = true; a.src = 'data:audio/wav;base64,' + b64;
    outs.appendChild(a);
  }}
  document.getElementById('status').textContent =
    'seed ' + j.seed + ', ' + j.wall_time_s.toFixed(2) + ' s';
}}
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    # make_server attaches `interface`, `engine` and `lock` to the server
    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        path = urlparse(self.path).path
        iface = self.server.interface  # type: ignore[attr-defined]
        if path in ("/", "/index.html"):
            opts = "".join(f'<option value="{name}">{name}</option>' for name in PRESETS)
            self._send(200, _INDEX_HTML.format(presets=opts).encode(), "text/html")
        elif path == "/health":
            models = []
            if hasattr(iface, "available_models"):
                try:
                    models = list(iface.available_models())
                except Exception:
                    models = []
            self._send_json(200, {"status": "ok", "models": models})
        elif path == "/presets":
            self._send_json(200, PRESETS)
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/api/vamp":
            self._send_json(404, {"error": f"no route {url.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            q = {k: v[-1] for k, v in parse_qs(url.query).items()}
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()

            if ctype == "application/json":
                payload = json.loads(body)
                sr = int(payload.pop("sample_rate"))
                if "audio_b64" in payload:
                    samples = wav_bytes_to_audio(base64.b64decode(payload.pop("audio_b64")))[1]
                else:
                    samples = np.asarray(payload.pop("samples"), np.float32)
                knobs = payload
            else:  # a raw WAV body, the knobs in the query string
                sr, samples = wav_bytes_to_audio(body)
                knobs = dict(q)

            fmt = knobs.pop("format", q.get("format", "json"))
            preset = knobs.pop("preset", None)
            kwargs = {}
            if preset is not None:
                if preset not in PRESETS:
                    self._send_json(400, {"error": f"unknown preset {preset!r}"})
                    return
                kwargs.update(PRESETS[preset])
            for k, v in knobs.items():
                if k not in _KNOBS:
                    self._send_json(400, {"error": f"unknown knob {k!r}"})
                    return
                kwargs[k] = _KNOBS[k](v)
            if kwargs.get("top_p", None) in (0, 0.0):
                kwargs["top_p"] = None

            server = self.server
            engine = getattr(server, "engine", None)
            use_engine = (
                engine is not None
                and int(kwargs.get("stretch_factor", 1)) == 1
                and int(kwargs.get("num_feedback_steps", 1)) == 1
                and kwargs.get("model_choice") in (None, "default")
            )
            with torch.inference_mode():
                if use_engine:
                    # engine requests batch across concurrent clients: no lock
                    res = vamp_core_engine(
                        server.interface, engine, (sr, samples),  # type: ignore[attr-defined]
                        **{k: v for k, v in kwargs.items() if k not in _ENGINE_UNSUPPORTED})
                else:
                    with server.lock:  # type: ignore[attr-defined]
                        res = vamp_core(server.interface, (sr, samples),  # type: ignore[attr-defined]
                                        **kwargs)
            if fmt == "wav":
                out_sr, wav = res.variations[0]
                self._send(200, audio_to_wav_bytes(out_sr, wav), "audio/wav")
                return
            self._send_json(200, {
                "seed": res.seed,
                "wall_time_s": res.wall_time_s,
                "sample_rate": res.variations[0][0],
                "variations": [base64.b64encode(audio_to_wav_bytes(vsr, v)).decode()
                               for vsr, v in res.variations],
            })
        except Exception as e:  # the caller gets the error; the server keeps serving
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(interface, host: str = "127.0.0.1", port: int = 0,
                engine=None) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; port 0 picks a free port.

    Without an engine, requests take turns on a lock (one user at a time).
    With `engine=VampEngine(interface)`, generates are engine requests and
    concurrent clients share batches on the card (`vamp_core_engine`); the
    knobs the engine cannot model (stretch, feedback, model switching) take
    the locked path. A `model_choice` request may swap the weights while
    the engine's dispatcher is generating, as in the JAX package."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.interface = interface  # type: ignore[attr-defined]
    server.engine = engine  # type: ignore[attr-defined]
    server.lock = threading.Lock()  # type: ignore[attr-defined]
    return server


def serve_forever(interface, host: str = "127.0.0.1", port: int = 7860, engine=None,
                  batched: bool = True):  # pragma: no cover - blocking entry point
    """Serve until interrupted (Gradio's default port). By default a
    `VampEngine` batches concurrent clients; `batched=False` serves one at
    a time on the lock."""
    if engine is None and batched:
        from .engine import VampEngine

        engine = VampEngine(interface)
    server = make_server(interface, host, port, engine=engine)
    print(f"vampnet web app at http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if engine is not None:
            engine.close()
