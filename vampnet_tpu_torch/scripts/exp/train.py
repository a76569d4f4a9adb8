"""Training command line (counterpart of the repository's
`scripts/exp/train.py`), a wrapper over `train.loop.main`:

    python -m vampnet_tpu_torch.scripts.exp.train --args.load configs/vampnet.yml \
        --save_path runs/my-run --codec_ckpt models/vampnet/codec.vtpu

Fine-tune (LoRA-only updates):

    python -m vampnet_tpu_torch.scripts.exp.train --args.load configs/lora/lora.yml \
        --init_ckpt models/vampnet/coarse.vtpu --save_path runs/my-finetune

`--device cpu` trains on the CPU; the card is the default.
"""
from ...train.loop import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
