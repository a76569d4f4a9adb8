"""What decides `correct` in a data-parallel training cell: the training
cell's gradient checks (`compare/train.py`) on the global batch.

The reference follows the ranks' first `check_steps` steps on one card:
the same weights and global batches (made again from the seed), its own
fp32 encode with the reference codec, and the step's draws as the sharded
step makes them (`train/step.py`): r and the Bernoulli mask for the whole
global batch from a generator seeded with the step's seed, then each dp
group's dropout, over that group's rows, from a generator of its own seeded
from the step's seed and the group's index (`_group_generator`'s stream:
numpy's `SeedSequence([step seed, group])`, its first 64-bit word halved).
The loss is the global batch's: the label-smoothed masked cross-entropy
summed over every group's rows over the global count of masked tokens; the
gradient is its sum over the groups, computed a group's rows at a time;
then the clip at the global norm and AdamW under Noam (`reference/train.py`).

Compared, against the limits of the cell, as in the single-card cell:
`grad_norm_gap` (the first clipped gradient, by leaf) and `change_gap`
(each leaf's change after the steps); `loss_rel_gap` is printed.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from benchmark.compare import train as cmp_train
from benchmark.reference import codec as ref_codec
from benchmark.reference import lm as ref_lm
from benchmark.reference import train as ref_train


def group_seed(step_seed: int, group: int) -> int:
    """The seed of a dp group's dropout generator at a step."""
    word = np.random.SeedSequence([int(step_seed), int(group)]).generate_state(1, np.uint64)
    return int(word[0]) >> 1


def group_grads(params, cfg, z, mask, codebooks, gen, label_smoothing: float, w_total,
                operand=None):
    """One group's rows: its share of the global loss, sum(ce w) over the
    global count, and that share's gradients."""
    import torch

    names = list(params)
    zm = torch.where(mask, cfg.mask_token, z)
    for k in names:
        params[k].requires_grad_(True)
    with torch.enable_grad():
        logits = ref_lm.forward(params, cfg, zm, codebooks, generator=gen, operand=operand)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, z.transpose(1, 2)[..., None])[..., 0]
        ce = lse - (1 - label_smoothing) * tgt - label_smoothing * logits.mean(-1)
        w = mask.transpose(1, 2).to(torch.float32)
        loss = (ce * w).sum() / w_total
        grads = torch.autograd.grad(loss, [params[k] for k in names])
    for k in names:
        params[k].requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def reference_steps(ctx, n: int, precision: Optional[str] = None) -> dict:
    """The reference's n steps over the global batch: losses, the first
    clipped gradient's norm by leaf, and each leaf's change after them."""
    import torch

    from benchmark.harness import weights
    from benchmark.harness.traffic import step_seeds, train_pool

    ref_lm.fp32_mode()
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    ccfg = ref_codec.config_from(cfg["codec"])
    lcfg = ref_lm.config_from(cfg["lm"])
    codec = weights.codec_state(ref_codec.param_shapes(ccfg), gen)
    params = weights.lm_state(ref_lm.param_shapes(lcfg), gen)
    names = list(params)
    p0 = {k: v.clone() for k, v in params.items()}
    codebooks = torch.stack([codec[f"quantizer.quantizers_{i}.codebook"]
                             for i in range(lcfg.n_codebooks)])
    pool = train_pool(tr, ctx.seed, ccfg.sample_rate, ccfg.hop_length)
    groups = int(tr["dp"])
    rows = int(tr["batch"]) // groups
    seeds = step_seeds(ctx.seed, n)
    o = cfg["optimizer"]
    opt = ref_train.AdamW(params, o, lcfg.embedding_dim)
    operand = ref_lm.fp8 if precision == "fp8" else None
    losses, first = [], None
    for i in range(n):
        audio = torch.from_numpy(pool[i % pool.shape[0]]).to(dev).transpose(1, 2)
        with torch.no_grad():
            z = torch.cat([ref_codec.encode(codec, ccfg, a)[:, :lcfg.n_codebooks]
                           for a in audio.split(rows)])
        g = torch.Generator(device=dev)
        g.manual_seed(seeds[i])
        r = torch.rand((z.shape[0],), generator=g, device=dev)
        u = torch.rand(z.shape, generator=g, device=dev)
        mask = u < torch.clamp(torch.cos(r * math.pi / 2), 1e-10, 1.0)[:, None, None]
        w_total = mask.to(torch.float32).sum().clamp(min=1.0)
        loss, grads = 0.0, None
        for grp in range(groups):
            sl = slice(grp * rows, (grp + 1) * rows)
            gg = torch.Generator(device=dev)
            gg.manual_seed(group_seed(seeds[i], grp))
            part, gr = group_grads(params, lcfg, z[sl], mask[sl], codebooks, gg,
                                   o["label_smoothing"], w_total, operand)
            loss += float(part)
            if grads is None:
                grads = gr
            else:
                for k in names:
                    grads[k] += gr[k]
            del gr
        clipped = opt.step(grads)
        losses.append(loss)
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(clipped[k])) for k in names}
        del grads, clipped
    change = {k: float(torch.linalg.vector_norm(params[k] - p0[k])) for k in names}
    return {"losses": losses, "first_grad": first, "change": change}


def check(tr, ctx) -> Dict[str, float]:
    """The run's numbers: rank 0's readings of the ranks' first steps
    against the reference's, once the port's state is freed."""
    port = cmp_train.port_readings(tr)
    tr.release()
    return cmp_train.readings(port, reference_steps(ctx, len(port["losses"])))
