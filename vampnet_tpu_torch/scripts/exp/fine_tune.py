"""Fine-tune configs (counterpart of the repository's
`scripts/exp/fine_tune.py`): write `configs/generated/<name>/{c2f,coarse,
interface}.yml` for a LoRA fine-tune on the user's audio.

    python -m vampnet_tpu_torch.scripts.exp.fine_tune --audio_folders my/audio --name my-model
"""
from __future__ import annotations

from pathlib import Path
from typing import List

from ... import config as cfglib


def fine_tune(audio_files_or_folders: List[str], name: str, conf_root: str = "configs"):
    conf_dir = Path(conf_root)
    if not conf_dir.exists():
        raise FileNotFoundError(f"configs directory {conf_dir} not found: run this from the "
                                "repository's root or pass conf_root")
    finetune_dir = conf_dir / "generated" / name
    finetune_dir.mkdir(parents=True, exist_ok=True)

    cfglib.generate_conf(
        finetune_dir / "c2f.yml",
        include=["configs/lora/lora.yml"],
        overrides={
            "fine_tune": True,
            "train/AudioLoader.sources": audio_files_or_folders,
            "val/AudioLoader.sources": audio_files_or_folders,
            "VampNet.n_codebooks": 14,
            "VampNet.n_conditioning_codebooks": 4,
            "VampNet.embedding_dim": 1280,
            "VampNet.n_layers": 16,
            "VampNet.n_heads": 20,
            "AudioDataset.duration": 3.0,
            "AudioDataset.loudness_cutoff": -40.0,
            "save_path": f"./runs/{name}/c2f",
            "init_ckpt": "./models/vampnet/c2f.pth",
        },
    )
    cfglib.generate_conf(
        finetune_dir / "coarse.yml",
        include=["configs/lora/lora.yml"],
        overrides={
            "fine_tune": True,
            "train/AudioLoader.sources": audio_files_or_folders,
            "val/AudioLoader.sources": audio_files_or_folders,
            "save_path": f"./runs/{name}/coarse",
            "init_ckpt": "./models/vampnet/coarse.pth",
        },
    )
    cfglib.generate_conf(
        finetune_dir / "interface.yml",
        include=[],
        overrides={
            "Interface.coarse_ckpt": f"./runs/{name}/coarse/latest/model.vtpu",
            "Interface.coarse2fine_ckpt": f"./runs/{name}/c2f/latest/model.vtpu",
            "Interface.wavebeat_ckpt": "./models/wavebeat.pth",
            "Interface.codec_ckpt": "./models/vampnet/codec.pth",
            "AudioLoader.sources": [audio_files_or_folders],
        },
    )

    train = "python -m vampnet_tpu_torch.scripts.exp.train --args.load"
    print(f"generated confs in {finetune_dir}.\n")
    print("you'll need to run two training jobs (they can run in parallel):")
    print(f"run the coarse job with \n\t{train} {finetune_dir}/coarse.yml\n")
    print(f"run the c2f job with \n\t{train} {finetune_dir}/c2f.yml\n")
    return finetune_dir


def main(argv=None):
    args = cfglib.parse_args(argv)
    folders = args.get("audio_folders") or args.get("audio_files_or_folders")
    if isinstance(folders, str):
        folders = [folders]
    return fine_tune(folders, args["name"], conf_root=args.get("conf_root", "configs"))


if __name__ == "__main__":
    main()
