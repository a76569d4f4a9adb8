"""Quickstart: vamp a file from Python (counterpart of the repository's
`hello.py`).

    python -m vampnet_tpu_torch.hello [--asset in.wav] [--out out.wav] [--device cpu]

Loads the models directory's checkpoints (`registry.py`: local files first,
then the hub), picks a fine-tune, masks the file's codes with a periodic
prompt, vamps and writes the result. Runs on the card unless `device="cpu"`.
"""
from pathlib import Path


def main(
    asset: str = "assets/example.wav",
    out: str = "scratch/output.wav",
    model: str | None = None,
    periodic_prompt: int = 13,
    upper_codebook_mask: int = 3,
    seed: int = 42,
    interface=None,
    device="cuda",
    **vamp_kwargs,
):
    from .audio import AudioSignal
    from .interface import Interface

    # load the default vampnet model
    if interface is None:
        interface = Interface.default(device=device)

    # list available finetuned models and pick one
    finetuned_model_choices = interface.available_models()
    print(f"available models: {finetuned_model_choices}")
    model_choice = model if model is not None else finetuned_model_choices[0]
    print(f"choosing model: {model_choice}")
    interface.load_finetuned(model_choice)

    # load an example audio file and get the tokens for it
    signal = AudioSignal(asset)
    codes = interface.encode(signal)

    # build a mask for the audio
    mask = interface.build_mask(codes, signal, periodic_prompt=periodic_prompt,
                                upper_codebook_mask=upper_codebook_mask, seed=seed)

    # generate the output tokens
    output_tokens = interface.vamp(codes, mask, return_mask=False, temperature=1.0,
                                   typical_filtering=True, seed=seed, **vamp_kwargs)

    # convert them to a signal and write it to a file
    output_signal = interface.decode(output_tokens)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    output_signal.write(out)
    print(f"wrote {out}")
    return output_signal


if __name__ == "__main__":
    from .config import parse_args

    main(**parse_args())
