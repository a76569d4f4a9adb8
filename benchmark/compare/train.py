"""What decides `correct` in a training cell.

The reference follows the port's first `check_steps` steps: the same
weights and batches (made again from the seed), its own fp32 encode with
the reference codec, the step's draws from a generator seeded with the
step's seed in the port's order (the ratio r and the Bernoulli mask, then
in each layer the attention output's, the GEGLU hidden units' and the
feed-forward output's dropout), its own fp32 forward, label-smoothed masked
cross-entropy, gradients, the clip at the global norm, and AdamW with the
Noam rate and optax's fp32 bias corrections.

Compared, against the limits of the cell:

  * `loss_rel_gap`: each step's loss against the reference's, the worst of
    the steps, relative;
  * `grad_norm_gap`: the first gradient as the optimizer took it, by leaf:
    |port norm - reference norm| over the reference's norm of that leaf or
    of the median leaf, whichever is larger, the worst leaf;
  * `change_gap`: each leaf's change after the steps, measured the same
    way, over the leaves whose first reference gradient is at least a
    thousandth of the median leaf's (a leaf below it moves under Adam by
    round-off alone).

The control puts the reference in the port's place one precision below the
configuration's bf16 compute: every product's two operands rounded to fp8
(e4m3, one scale per tensor) and computed in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from benchmark.reference import codec as ref_codec
from benchmark.reference import lm as ref_lm
from benchmark.reference import train as ref_train


def reference_steps(ctx, n: int, precision: Optional[str] = None) -> dict:
    """The reference's n steps: losses, the first clipped gradient's norm by
    leaf, and each leaf's change after the n steps."""
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
    seeds = step_seeds(ctx.seed, n)
    o = cfg["optimizer"]
    opt = ref_train.AdamW(params, o, lcfg.embedding_dim)
    losses, first = [], None
    for i in range(n):
        audio = torch.from_numpy(pool[i % pool.shape[0]]).to(dev).transpose(1, 2)
        with torch.no_grad():
            z = ref_codec.encode(codec, ccfg, audio)[:, :lcfg.n_codebooks]
        g = torch.Generator(device=dev)
        g.manual_seed(seeds[i])
        loss, grads = ref_train.loss_and_grads(params, lcfg, z, codebooks, g,
                                               o["label_smoothing"], precision)
        clipped = opt.step(grads)
        losses.append(float(loss))
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(clipped[k])) for k in names}
        del grads, clipped
    change = {k: float(torch.linalg.vector_norm(params[k] - p0[k])) for k in names}
    return {"losses": losses, "first_grad": first, "change": change}


def worst_leaf_gap(got: Dict[str, float], ref: Dict[str, float],
                   leaves: Optional[List[str]] = None) -> float:
    """max over leaves of |got - ref| / max(ref, the median leaf's ref)."""
    leaves = list(ref) if leaves is None else leaves
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def moved_leaves(first_grad: Dict[str, float]) -> List[str]:
    """The leaves whose first reference gradient is at least a thousandth of
    the median leaf's."""
    med = float(np.median(list(first_grad.values())))
    return [k for k, v in first_grad.items() if v >= 1e-3 * med]


def readings(port: dict, ref: dict, failed: int = 0) -> Dict[str, float]:
    """The numbers compared: `port` and `ref` each hold losses, first_grad
    and change."""
    losses = [abs(a - b) / abs(b) for a, b in zip(port["losses"], ref["losses"])]
    return {
        "loss_rel_gap": max(losses) if len(port["losses"]) == len(ref["losses"]) else math.inf,
        "grad_norm_gap": worst_leaf_gap(port["first_grad"], ref["first_grad"]),
        "change_gap": worst_leaf_gap(port["change"], ref["change"],
                                     moved_leaves(ref["first_grad"])),
        "failed": failed,
    }


def port_readings(tr) -> dict:
    """What the driver read of the port's first steps."""
    return {"losses": tr.losses, "first_grad": tr.first_grad, "change": tr.change}


def check(tr, ctx) -> Dict[str, float]:
    """The run's numbers: the port's first steps against the reference's,
    once the port's state is freed."""
    port = port_readings(tr)
    tr.release()
    return readings(port, reference_steps(ctx, len(port["losses"])))
