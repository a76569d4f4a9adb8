"""Dense projection and codebook embedding (counterpart of
`vampnet_tpu/modules/layers.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """`nn.Linear` that computes in a fixed dtype whatever its weights are
    stored in (flax `nn.Dense(dtype=...)` semantics: inputs, kernel and bias
    are cast to the compute dtype)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class CodebookEmbedding(nn.Module):
    """Token ids -> codec latents (the codec's own codebook tables plus one
    learned MASK latent per codebook) -> projection to the model width."""

    def __init__(self, latent_dim: int, n_codebooks: int, emb_dim: int,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.special_MASK = nn.Parameter(
            torch.empty(n_codebooks, latent_dim, device=device)
        )
        self.out_proj = Dense(n_codebooks * latent_dim, emb_dim, bias=True,
                              compute_dtype=compute_dtype, device=device)

    def from_codes(self, codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
        """codes (b, n_cb, t) in [0, vocab] and codebooks (n_cb, vocab,
        latent) -> latents (b, t, n_cb*latent), codebook-major feature blocks.

        A gather; the JAX package contracts a one-hot instead, which selects
        the same rows exactly."""
        n_cb = codes.shape[1]
        table = torch.cat(
            [codebooks, self.special_MASK[:n_cb, None, :].to(codebooks.dtype)], dim=1
        )  # (n_cb, vocab + 1, latent)
        cb_idx = torch.arange(n_cb, device=codes.device)[None, :, None]
        latent = table[cb_idx, codes]  # (b, n_cb, t, latent)
        b, _, t, ld = latent.shape
        return latent.transpose(1, 2).reshape(b, t, n_cb * ld)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        return self.out_proj(latents)
