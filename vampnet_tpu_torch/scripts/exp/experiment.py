"""Generation conditions for evaluation (counterpart of the repository's
`scripts/exp/experiment.py`): compression sweeps, sampling-step sweeps,
beat-mask and inpainting conditions. Writes one WAV per excerpt and
condition for `scripts.exp.eval`.

    python -m vampnet_tpu_torch.scripts.exp.experiment --args.load configs/interface.yml \
        --sources data/val --exp_type gen-compression --output_dir samples/ [--device cpu]
"""
from __future__ import annotations

import random
import subprocess
import tempfile
from pathlib import Path

import torch

from ... import config as cfglib
from ... import mask as pmask
from ...audio import AudioSignal


def calculate_bitrate(interface, num_codebooks, downsample_factor):
    bit_width = 10
    sr = interface.codec_config.sample_rate
    hop = interface.codec_config.hop_length
    return (sr / hop) * ((bit_width * num_codebooks) / downsample_factor)


def _generator(interface, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=interface.device).manual_seed(seed)


def baseline(sig, interface):
    return interface._preprocess(sig)


def reconstructed(sig, interface):
    return interface.decode(interface.encode(sig))


def coarse2fine(sig, interface):
    z = interface.encode(sig)
    z = z[:, : interface.c2f.config.n_conditioning_codebooks, :]
    return interface.decode(interface.coarse_to_fine(z))


class CoarseCond:
    """Keep `num_conditioning_codebooks` codebooks, downsampled by
    `downsample_factor`, and regenerate the rest."""

    def __init__(self, num_conditioning_codebooks, downsample_factor):
        self.num_conditioning_codebooks = num_conditioning_codebooks
        self.downsample_factor = downsample_factor

    def __call__(self, sig, interface):
        z = interface.encode(sig)
        mask = pmask.full_mask(z)
        mask = pmask.codebook_unmask(mask, self.num_conditioning_codebooks)
        mask = pmask.mask_and(mask, pmask.periodic_mask(z, self.downsample_factor))
        zv = interface.coarse_vamp(z, mask)
        return interface.decode(interface.coarse_to_fine(zv))


def opus(sig, interface, bitrate=128):
    """An ffmpeg opus round trip, the codec baseline."""
    sig = interface._preprocess(sig)
    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        sig.write(f.name)
        opus_name = Path(f.name).with_suffix(".opus")
        subprocess.run(["ffmpeg", "-y", "-i", f.name, "-c:a", "libopus", "-b:a", f"{bitrate}",
                        opus_name], check=True, capture_output=True)
        output_name = Path(f"{f.name}-opus").with_suffix(".wav")
        subprocess.run(["ffmpeg", "-y", "-i", opus_name, output_name], check=True,
                       capture_output=True)
        return AudioSignal(output_name)


def mask_ratio_1_step(ratio=1.0):
    def wrapper(sig, interface):
        z = interface.encode(sig)
        mask = pmask.linear_random(_generator(interface), z, ratio)
        zv = interface.coarse_vamp(z, mask, _sampling_steps=1)
        return interface.decode(zv)

    return wrapper


def num_sampling_steps(num_steps=1):
    def wrapper(sig, interface):
        z = interface.encode(sig)
        mask = pmask.periodic_mask(z, 16)
        zv = interface.coarse_vamp(z, mask, _sampling_steps=num_steps)
        return interface.decode(interface.coarse_to_fine(zv))

    return wrapper


def beat_mask(ctx_time):
    def wrapper(sig, interface):
        bm = interface.make_beat_mask(sig, before_beat_s=ctx_time / 2,
                                      after_beat_s=ctx_time / 2, invert=True)
        z = interface.encode(sig)
        zv = interface.coarse_vamp(z, bm[:, : z.shape[1], : z.shape[-1]])
        return interface.decode(interface.coarse_to_fine(zv))

    return wrapper


def inpaint(ctx_time):
    def wrapper(sig, interface):
        z = interface.encode(sig)
        mask = pmask.inpaint(z, interface.s2t(ctx_time), interface.s2t(ctx_time))
        zv = interface.coarse_vamp(z, mask)
        return interface.decode(interface.coarse_to_fine(zv))

    return wrapper


def token_noise(noise_amt):
    def wrapper(sig, interface):
        z = interface.encode(sig)
        gen = _generator(interface)
        mask = pmask.random(gen, z, noise_amt)
        noise = torch.randint(0, interface.coarse.config.vocab_size, z.shape, generator=gen,
                              device=z.device)
        return interface.decode(torch.where(mask.bool(), noise, z))

    return wrapper


EXP_REGISTRY = {}

EXP_REGISTRY["gen-compression"] = {
    "baseline": baseline,
    "reconstructed": reconstructed,
    "coarse2fine": coarse2fine,
    **{
        f"{n}_codebooks_downsampled_{x}x": CoarseCond(n, x)
        for (n, x) in ((1, 1), (4, 4), (4, 16), (4, 32))
    },
    **{f"token_noise_{x}": mask_ratio_1_step(ratio=x) for x in [0.25, 0.5, 0.75]},
}

EXP_REGISTRY["sampling-steps"] = {
    **{f"steps_{n}": num_sampling_steps(n) for n in [1, 4, 12, 36, 64, 72]},
}

EXP_REGISTRY["musical-sampling"] = {
    **{f"beat_mask_{t}": beat_mask(t) for t in [0.075]},
    **{f"inpaint_{t}": inpaint(t) for t in [0.5, 1.0]},
}


def run_conditions(interface, sources, output_dir, conds, max_excerpts: int = 2000,
                   seed: int = 0):
    """Write `output_dir/<condition>/<i>.wav` for every condition of `conds`
    (name -> fn(sig, interface)) and excerpt i of the sources, skipping
    excerpts already written; excerpts are `coarse.chunk_size_s` long, drawn
    through the training loader in a shuffled order."""
    from ...train.datasets import AudioDataset, AudioLoader

    output_dir = Path(output_dir)
    output_dir.mkdir(exist_ok=True, parents=True)
    loader = AudioLoader(sources=sources)
    dataset = AudioDataset(loader, sample_rate=interface.codec_config.sample_rate,
                           duration=interface.coarse.chunk_size_s, n_examples=max_excerpts,
                           without_replacement=True, loudness_cutoff=-60.0)
    indices = list(range(min(max_excerpts, len(loader))))
    random.Random(seed).shuffle(indices)
    for i in indices:
        if all((output_dir / name / f"{i}.wav").exists() for name in conds):
            continue
        sig = dataset[i]["signal"]
        for name, cond in conds.items():
            o_dir = output_dir / name
            o_dir.mkdir(exist_ok=True, parents=True)
            cond(sig, interface).write(o_dir / f"{i}.wav")
    return output_dir


def main(argv=None, interface=None):
    args = cfglib.parse_args(argv)
    sources = args.get("sources", ["data/val"])
    if isinstance(sources, str):
        sources = [sources]
    exp_type = args.get("exp_type", "gen-compression")
    if exp_type not in EXP_REGISTRY:
        raise ValueError(f"Unknown exp_type {exp_type}")
    if interface is None:
        from ...interface import Interface

        interface = Interface.from_checkpoints(
            coarse_ckpt=args.get("Interface.coarse_ckpt"),
            coarse2fine_ckpt=args.get("Interface.coarse2fine_ckpt"),
            codec_ckpt=args.get("Interface.codec_ckpt"),
            wavebeat_ckpt=args.get("Interface.wavebeat_ckpt"),
            device=args.get("device", "cuda"),
        )
    return run_conditions(interface, sources, Path(args.get("output_dir", "./samples")),
                          EXP_REGISTRY[exp_type], int(args.get("max_excerpts", 2000)),
                          int(args.get("seed", 0)))


if __name__ == "__main__":
    main()
