"""The vamp web app's core and its Gradio UI (counterpart of
`vampnet_tpu/serve/app.py`).

`vamp_core` is the app's whole request as a plain function, so the serving
surfaces run without a UI: the stdlib web app (`webapp.py`), the unloop
bridge (`unloop.py`) and tests call it. `build_demo` wraps it in the Gradio
UI with the same named API endpoints (`api_name="vamp"`, and "vamp_1", the
one the unloop client calls). Gradio and matplotlib are imported only where
they are used; `main()` serves the stdlib web app when Gradio is absent.

    python -m vampnet_tpu_torch.serve.app
"""
from __future__ import annotations

import dataclasses
import logging
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import mask as pmask
from ..audio import AudioSignal
from ..audio.dsp import pitch_shift

MAX_DURATION_S = 10

PRESETS = {
    "timbre transfer": dict(periodic_p=2, n_mask_codebooks=1, onset_mask_width=0, dropout=0.0, beat_mask_ms=0),
    "small variation": dict(periodic_p=5, n_mask_codebooks=4, onset_mask_width=0, dropout=0.0, beat_mask_ms=0),
    "small variation (follow beat)": dict(periodic_p=7, n_mask_codebooks=4, onset_mask_width=0, dropout=0.0, beat_mask_ms=50),
    "medium variation": dict(periodic_p=7, n_mask_codebooks=4, onset_mask_width=0, dropout=0.0, beat_mask_ms=0),
    "medium variation (follow beat)": dict(periodic_p=13, n_mask_codebooks=4, onset_mask_width=0, dropout=0.0, beat_mask_ms=50),
    "large variation": dict(periodic_p=13, n_mask_codebooks=4, onset_mask_width=0, dropout=0.2, beat_mask_ms=0),
    "large variation (follow beat)": dict(periodic_p=0, n_mask_codebooks=4, onset_mask_width=0, dropout=0.0, beat_mask_ms=80),
    "unconditional": dict(periodic_p=0, n_mask_codebooks=1, onset_mask_width=0, dropout=0.0, beat_mask_ms=0),
}


def to_output(sig: AudioSignal, row: int = 0) -> Tuple[int, np.ndarray]:
    return sig.sample_rate, sig.samples[row, 0]


@dataclasses.dataclass
class VampResult:
    variations: list  # list of (sample rate, waveform)
    mask: np.ndarray
    seed: int
    wall_time_s: float


def input_signal(input_audio: Tuple[int, np.ndarray]) -> AudioSignal:
    """(sample rate, samples) from a UI or a WAV body -> a mono float32
    AudioSignal; integer PCM is scaled to [-1, 1]."""
    if input_audio is None:
        raise ValueError("no input audio received!")
    sr, samples = input_audio
    samples = np.asarray(samples)
    if np.issubdtype(samples.dtype, np.integer):
        samples = samples / np.iinfo(samples.dtype).max
    return AudioSignal(samples.astype(np.float32), sr).to_mono()


def vamp_core(
    interface,
    input_audio: Tuple[int, np.ndarray],
    seed: int = 0,
    model_choice: Optional[str] = None,
    pitch_shift_amt: int = 0,
    periodic_p: int = 7,
    n_mask_codebooks: int = 3,
    onset_mask_width: int = 0,
    dropout: float = 0.0,
    sampletemp: float = 1.0,
    typical_filtering: bool = True,
    typical_mass: float = 0.15,
    typical_min_tokens: int = 64,
    top_p: Optional[float] = None,
    sample_cutoff: float = 1.0,
    stretch_factor: int = 1,
    sampling_steps: int = 36,
    beat_mask_ms: int = 0,
    num_feedback_steps: int = 1,
    batch_size: int = 2,
) -> VampResult:
    """One app request: encode, build the mask, vamp `batch_size`
    variations, decode, and match the input's loudness. A seed of 0 draws a
    random one, which the result reports."""
    t0 = time.time()
    _seed = int(seed) if seed and seed > 0 else int(np.random.randint(0, 2**31 - 1))
    sig = input_signal(input_audio)
    loudness = sig.loudness()

    if model_choice is not None and hasattr(interface, "load_finetuned"):
        try:
            interface.load_finetuned(model_choice)
        except Exception as e:
            # an unknown or unfetchable model keeps the current weights: a
            # request must not die because the hub is out of reach
            logging.warning(f"could not load model {model_choice!r}: {e}")

    if pitch_shift_amt != 0:
        sig = pitch_shift(sig, pitch_shift_amt)

    codes = interface.encode(sig)
    mask = interface.build_mask(
        codes, sig=sig, periodic_prompt=periodic_p, onset_mask_width=onset_mask_width,
        _dropout=dropout, upper_codebook_mask=n_mask_codebooks, seed=_seed,
    )
    if beat_mask_ms > 0 and interface.beat_tracker is not None:
        mask = pmask.mask_and(
            mask, interface.make_beat_mask(sig, after_beat_s=beat_mask_ms / 1000.0))
        mask = pmask.codebook_mask(mask, n_mask_codebooks)

    interface.set_chunk_size(10.0)
    if top_p is not None and top_p <= 0:
        top_p = None

    zv, mask_z = interface.vamp(
        codes, mask, batch_size=batch_size, feedback_steps=num_feedback_steps,
        _sampling_steps=sampling_steps, time_stretch_factor=stretch_factor,
        return_mask=True, temperature=sampletemp, typical_filtering=typical_filtering,
        typical_mass=typical_mass, typical_min_tokens=typical_min_tokens, top_p=top_p,
        seed=_seed, sample_cutoff=sample_cutoff,
    )
    out = interface.decode(zv).normalize(float(loudness[0]))
    return VampResult(
        variations=[to_output(out, i) for i in range(out.batch_size)],
        mask=np.asarray(mask_z), seed=_seed, wall_time_s=time.time() - t0,
    )


def load_audio_file(path) -> Tuple[int, np.ndarray]:
    return to_output(AudioSignal(path))


def mask_preview_figure(interface, periodic_p, n_mask_codebooks, dropout, out_path):
    """The mask that the knobs give on 80 steps, drawn to `out_path`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lm = interface.c2f if interface.c2f is not None else interface.coarse
    codes = np.zeros((1, lm.config.n_codebooks, 80), dtype=np.int64)
    mask = interface.build_mask(codes, periodic_prompt=periodic_p, _dropout=dropout,
                                upper_codebook_mask=n_mask_codebooks, seed=0)
    plt.clf()
    plt.imshow(mask[0].cpu().numpy(), aspect="auto", origin="lower", interpolation="none")
    plt.title("mask preview")
    plt.savefig(out_path)
    return out_path


def build_demo(interface, engine=None):
    """The Gradio Blocks app: the knobs, the presets, two variations and the
    mask image, with the named API endpoints."""
    import gradio as gr

    def _vamp(input_audio, sampletemp, top_p, periodic_p, dropout, stretch_factor,
              onset_mask_width, typical_filtering, typical_mass, typical_min_tokens,
              seed, model_choice, n_mask_codebooks, pitch_shift_amt, sample_cutoff,
              sampling_steps, beat_mask_ms, num_feedback_steps, api: bool):
        res = vamp_core(
            interface, input_audio, seed=seed, model_choice=model_choice,
            pitch_shift_amt=int(pitch_shift_amt), periodic_p=int(periodic_p),
            n_mask_codebooks=int(n_mask_codebooks),
            onset_mask_width=int(onset_mask_width), dropout=dropout,
            sampletemp=sampletemp, typical_filtering=typical_filtering,
            typical_mass=typical_mass, typical_min_tokens=int(typical_min_tokens),
            top_p=top_p, sample_cutoff=sample_cutoff,
            stretch_factor=int(stretch_factor), sampling_steps=int(sampling_steps),
            beat_mask_ms=int(beat_mask_ms), num_feedback_steps=int(num_feedback_steps),
        )
        if api:
            return res.variations[0], res.variations[1]
        scratch = Path(tempfile.gettempdir()) / "vampnet_scratch"
        scratch.mkdir(exist_ok=True)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.clf()
        plt.imshow(res.mask[0], aspect="auto", origin="lower", interpolation="none")
        plt.title("actual mask")
        mask_png = str(scratch / "mask.png")
        plt.savefig(mask_png)
        return res.variations[0], res.variations[1], mask_png

    with gr.Blocks() as demo:
        with gr.Row():
            with gr.Column():
                manual_audio_upload = gr.File(
                    label="upload some audio (will be randomly trimmed to max of 100s)",
                    file_types=["audio"],
                )
                load_example_audio_button = gr.Button("or load example audio")
                input_audio = gr.Audio(label="input audio", interactive=False, type="numpy")
                load_example_audio_button.click(
                    fn=lambda: load_audio_file("./assets/example.wav"),
                    inputs=[], outputs=[input_audio],
                )
                manual_audio_upload.change(
                    fn=lambda f: load_audio_file(f.name if hasattr(f, "name") else f),
                    inputs=[manual_audio_upload], outputs=[input_audio],
                )
            with gr.Column():
                with gr.Accordion("manual controls", open=True):
                    periodic_p = gr.Slider(label="periodic prompt", minimum=0, maximum=13, step=1, value=7)
                    onset_mask_width = gr.Slider(label="onset mask width", minimum=0, maximum=100, step=1, value=0)
                    beat_mask_ms = gr.Slider(label="beat mask width (ms)", minimum=0, maximum=200, step=1, value=0)
                    n_mask_codebooks = gr.Slider(label="compression prompt", minimum=1, maximum=14, step=1, value=3)
                    dropout = gr.Slider(label="mask dropout", minimum=0.0, maximum=1.0, step=0.01, value=0.0)
                    num_feedback_steps = gr.Slider(label="feedback steps (token telephone)", minimum=1, maximum=8, step=1, value=1)
                    preset_dropdown = gr.Dropdown(label="preset", choices=list(PRESETS), value="medium variation")
                    preset_dropdown.change(
                        fn=lambda p: tuple(PRESETS[p][k] for k in
                                           ("periodic_p", "n_mask_codebooks", "onset_mask_width", "dropout", "beat_mask_ms")),
                        inputs=[preset_dropdown],
                        outputs=[periodic_p, n_mask_codebooks, onset_mask_width, dropout, beat_mask_ms],
                    )
                with gr.Accordion("sampling settings", open=False):
                    sampletemp = gr.Slider(label="sample temperature", minimum=0.1, maximum=10.0, value=1.0, step=0.001)
                    top_p = gr.Slider(label="top p (0.0 = off)", minimum=0.0, maximum=1.0, value=0.0)
                    typical_filtering = gr.Checkbox(label="typical filtering", value=True)
                    typical_mass = gr.Slider(label="typical mass", minimum=0.01, maximum=0.99, value=0.15)
                    typical_min_tokens = gr.Slider(label="typical min tokens", minimum=1, maximum=256, step=1, value=64)
                    sample_cutoff = gr.Slider(label="sample cutoff", minimum=0.0, maximum=1.0, value=1.0)
                    sampling_steps = gr.Slider(label="sampling steps", minimum=1, maximum=128, step=1, value=36)
                stretch_factor = gr.Slider(label="time stretch factor", minimum=1, maximum=8, step=1, value=1)
                pitch_shift_amt = gr.Slider(label="pitch shift (semitones)", minimum=-12, maximum=12, step=1, value=0)
                seed = gr.Number(label="seed (0 for random)", value=0, precision=0)
                model_choice = gr.Dropdown(
                    label="model choice", choices=interface.available_models(), value="default",
                )
                vamp_button = gr.Button("generate (vamp)!!!")
            with gr.Column():
                audio_outs = [gr.Audio(label=f"output audio {i+1}", type="numpy") for i in range(2)]
                mask_image = gr.Image(label="actual mask")

        _inputs = [input_audio, sampletemp, top_p, periodic_p, dropout, stretch_factor,
                   onset_mask_width, typical_filtering, typical_mass, typical_min_tokens,
                   seed, model_choice, n_mask_codebooks, pitch_shift_amt, sample_cutoff,
                   sampling_steps, beat_mask_ms, num_feedback_steps]
        vamp_button.click(
            fn=lambda *a: _vamp(*a, api=False),
            inputs=_inputs, outputs=[*audio_outs, mask_image],
        )
        # the named API endpoints: "vamp", and "vamp_1", the unloop client's
        api_btn = gr.Button(visible=False)
        api_btn.click(fn=lambda *a: _vamp(*a, api=True), inputs=_inputs, outputs=audio_outs,
                      api_name="vamp")
        api_btn2 = gr.Button(visible=False)
        api_btn2.click(fn=lambda *a: _vamp(*a, api=True), inputs=_inputs, outputs=audio_outs,
                       api_name="vamp_1")

        try:  # the pyharp DAW endpoint, where pyharp is installed
            from pyharp import ModelCard, build_endpoint

            card = ModelCard(
                name="vampnet",
                description="vampnet is a masked generative music model",
                author="hugo flores garcia et al.",
                tags=["music generation"],
            )
            build_endpoint(demo, card=card, process_fn=lambda *a: None, inputs=[], outputs=[])
        except Exception:
            pass
    return demo


def main(device="cuda"):  # pragma: no cover - entry point
    from ..interface import Interface

    interface = Interface.default(device=device)
    try:
        import gradio  # noqa: F401
    except ImportError:
        # the stdlib web app: the same vamp API and a minimal UI
        from .webapp import serve_forever

        serve_forever(interface)
        return
    demo = build_demo(interface)
    demo.queue().launch(share=False)


if __name__ == "__main__":  # pragma: no cover
    main()
