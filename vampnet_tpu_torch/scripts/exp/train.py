"""Training command line (counterpart of the repository's
`scripts/exp/train.py`), a wrapper over `train.loop.main`:

    python -m vampnet_tpu_torch.scripts.exp.train --args.load configs/vampnet.yml \
        --save_path runs/my-run --codec_ckpt models/vampnet/codec.vtpu

Fine-tune (LoRA-only updates):

    python -m vampnet_tpu_torch.scripts.exp.train --args.load configs/lora/lora.yml \
        --init_ckpt models/vampnet/coarse.vtpu --save_path runs/my-finetune

`--device cpu` trains on the CPU; the card is the default.

Distributed: `--mesh.dp` / `--mesh.tp` lay the run over the visible cards
(a null dp takes the largest divisor of the batch), and under `torchrun`
every process joins the job (`loop.main` reads torchrun's `MASTER_ADDR`,
`WORLD_SIZE`, `RANK` and `LOCAL_RANK`), dp extending over the ranks:

    torchrun --nproc_per_node 4 -m vampnet_tpu_torch.scripts.exp.train \
        --args.load configs/vampnet.yml --mesh.tp 2 --save_path runs/coarse
"""
from ...train.loop import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
