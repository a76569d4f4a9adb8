"""One LM laid out over a ("dp", "tp") mesh for training: the counterpart of
the shardings the JAX trainer gives its state (`lm_param_specs` over "tp",
the batch over "dp"; `vampnet_tpu/train/loop.py:186-235`).

  * Each row of the mesh is a dp group. It holds a replica of the
    parameters and runs its rows of the batch.
  * Within a group of tp positions, position j holds block j of every
    tensor that `tp_dim` splits: the layers' column and row sites and their
    adapters, and the output features of the classifier and of the codebook
    projection. Position 0 alone holds the tensors every position computes
    with whole: the MASK latents, the biases, the norms, the bucket table,
    the control encoder and the replicated adapters (`REPLICATED_LORA`),
    once per tp group. They reach the other positions as differentiable
    copies (`TensorParallelStack.trainable`).
  * A group of one position (tp = 1) is a plain `VampNetLM`.

No position holds a whole copy of the layers. Parameter names are the whole
LM's, so the positions' tensors gather back into the LM's state dict
(`tp_gather`). The ZeRO-1 split of the moments over dp, the gradient sums
and the update are the training step's (`train/step.py`,
`ShardedTrainState`).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.layers import CodebookEmbedding
from ..modules.transformer import (REPLICATED_LORA, ControlEncoder, LMConfig, RMSNorm,
                                   TensorParallelStack, TransformerLayer, VampNetLM,
                                   position_bias_from_table)
from .mesh import Mesh
from .partition import tp_dim, tp_slice


class _Columns(nn.Module):
    """A Dense's block of output features (`weight`), and on the first
    position its whole `bias`."""

    def __init__(self, n_in: int, n_out: int, bias_features: Optional[int], device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((n_out, n_in), device=device))
        if bias_features is not None:
            self.bias = nn.Parameter(torch.empty((bias_features,), device=device))


class LMShard(nn.Module):
    """Position j of n of a tp group: the LM's modules with position j's
    blocks, under the whole LM's parameter names (module docstring)."""

    def __init__(self, cfg: LMConfig, j: int, n: int, device="meta"):
        super().__init__()
        home = j == 0
        d, n_out = cfg.embedding_dim, cfg.vocab_size * cfg.n_predict_codebooks
        self.embedding = nn.Module()
        if home:
            self.embedding.special_MASK = nn.Parameter(
                torch.empty(cfg.n_codebooks, cfg.latent_dim, device=device))
        self.embedding.out_proj = _Columns(cfg.n_codebooks * cfg.latent_dim, d // n,
                                           d if home else None, device)
        self.transformer = nn.Module()
        for i in range(cfg.n_layers):
            layer = TransformerLayer(cfg, home and i == 0, device=device, tp=n)
            if not home:
                layer.norm_1 = layer.norm_3 = None
                for part, site, leaf in REPLICATED_LORA if cfg.lora_r else ():
                    delattr(getattr(getattr(layer, part), site), leaf)
            self.transformer.add_module(f"layers_{i}", layer)
        if home:
            self.transformer.norm = RMSNorm(d, device=device)
        self.classifier = _Columns(d, n_out // n, n_out if home else None, device)
        if home and cfg.ctrl_dims is not None:
            self.ctrl_encoder = ControlEncoder(cfg.ctrl_dims, d, cfg.cfg_dropout_prob, cfg.dtype,
                                               device=device)


def held_at(name: str, j: int) -> bool:
    """Whether tp position j holds (its block of) the tensor `name`."""
    return j == 0 or tp_dim(name) is not None


def _own(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A fresh contiguous copy of x on `device` (no storage shared with x)."""
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)


class ShardedLM:
    """One dp group's LM over its tp positions `devices`, from `parts[j]`,
    the tensors position j holds: `forward_codes` as `VampNetLM`'s, with x
    and the logits on the first device."""

    def __init__(self, cfg: LMConfig, devices, parts: List[Mapping[str, torch.Tensor]]):
        self.config = cfg
        self.devices = [torch.device(d) for d in devices]
        n = len(self.devices)
        if n == 1:
            self.shards = [VampNetLM(cfg, device="meta")]
            self.stack = None
        else:
            self.shards = [LMShard(cfg, j, n) for j in range(n)]
        for shard, part in zip(self.shards, parts):
            shard.load_state_dict(part, strict=True, assign=True)
        if n > 1:
            self.stack = TensorParallelStack.trainable(
                cfg, self.devices, [s.transformer for s in self.shards])
        self._params = [dict(s.named_parameters()) for s in self.shards]

    def param(self, j: int, name: str) -> nn.Parameter:
        return self._params[j][name]

    def names(self, j: int) -> List[str]:
        return list(self._params[j])

    def _columns(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        """A Dense split by output features: each position's block of the
        product (its bias block added in the product, as the whole Dense
        adds it), gathered on the first device in order."""
        dt, home, n = self.config.dtype, self.devices[0], len(self.devices)
        weights = [self.param(j, f"{prefix}.weight") for j in range(n)]
        biases = self.param(0, f"{prefix}.bias").chunk(n)
        outs = [F.linear(x.to(dev).to(dt), w.to(dt), b.to(dev).to(dt)).to(home)
                for dev, w, b in zip(self.devices, weights, biases)]
        return torch.cat(outs, dim=-1)

    def forward_codes(self, codes: torch.Tensor, codebooks: torch.Tensor,
                      position_bias: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      ctrls: Optional[Dict[str, torch.Tensor]] = None,
                      ctrl_masks: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """codes (b, n_codebooks, t) on the first device -> fp32 logits
        (b, t, n_predict_codebooks, vocab) there; dropout drawn from
        `generator` where one is given."""
        if self.stack is None:
            return self.shards[0].forward_codes(codes, codebooks, position_bias, generator,
                                                ctrls, ctrl_masks)
        cfg, s0 = self.config, self.shards[0]
        x = self._columns("embedding.out_proj",
                          CodebookEmbedding.from_codes(s0.embedding, codes, codebooks))
        if cfg.ctrl_dims is not None:
            x = x + s0.ctrl_encoder(x, ctrls, ctrl_masks, generator)
        elif ctrls is not None:
            raise ValueError("controls given to an LM without ctrl_dims")
        if position_bias is None:
            position_bias = position_bias_from_table(
                s0.transformer.layers_0.self_attn.relative_attention_bias, cfg, x.shape[1])
        logits = self._columns("classifier", self.stack(x, position_bias, generator))
        b, t, _ = logits.shape
        return logits.reshape(b, t, cfg.n_predict_codebooks, cfg.vocab_size).float()


class TrainPlacement:
    """The dp groups of this process's rows of `mesh`, each a `ShardedLM`
    with its own copy of its positions' tensors, cut from `state_dict`, the
    whole LM's (on any device)."""

    def __init__(self, cfg: LMConfig, mesh: Mesh, state_dict: Mapping[str, torch.Tensor]):
        if mesh.axis_names != ("dp", "tp"):
            raise ValueError(f"a training mesh has axes ('dp', 'tp'), not {mesh.axis_names}")
        self.config, self.mesh = cfg, mesh
        n = mesh.shape["tp"]
        self.groups = [
            ShardedLM(cfg, row, [{name: _own(tp_slice(name, x, j, n), dev)
                                  for name, x in state_dict.items() if held_at(name, j)}
                                 for j, dev in enumerate(row)])
            for row in mesh.devices]

    @property
    def tp(self) -> int:
        return self.mesh.shape["tp"]

    @property
    def device(self) -> torch.device:
        """The first position's device (where the step's draws happen)."""
        return self.groups[0].devices[0]
