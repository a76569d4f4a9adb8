"""Token layout helpers and device resolution (counterpart of
`vampnet_tpu/util.py`).

The classifier and the sampler work on a flattened (batch, time*codebook)
layout, time-major and codebook-minor ("b c t -> b (t c)"). Param trees are
nested dicts, flattened to key paths and back by `flatten_tree` and
`unflatten_tree`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def codebook_flatten(tokens: torch.Tensor) -> torch.Tensor:
    """(batch, codebook, time) -> (batch, time*codebook), interleaved t-major."""
    b, c, t = tokens.shape
    return tokens.transpose(1, 2).reshape(b, t * c)


def codebook_unflatten(flat_tokens: torch.Tensor, n_c: int) -> torch.Tensor:
    """(batch, time*codebook) -> (batch, codebook, time)."""
    b, tc = flat_tokens.shape
    return flat_tokens.reshape(b, tc // n_c, n_c).transpose(1, 2)


def scalar_to_batch_array(x, batch_size: int, device=None) -> torch.Tensor:
    """Broadcast a scalar to a (batch,) tensor."""
    return torch.full((batch_size,), x, device=device)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere in
    the port; asking for it on a machine without a card raises instead of
    quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return device


def flatten_tree(tree: Mapping, prefix: tuple = ()) -> Dict[tuple, Any]:
    """A nested dict (a flax-shaped param tree) -> {key path tuple: leaf}."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def unflatten_tree(flat: Mapping[tuple, Any]) -> Dict:
    """The inverse of `flatten_tree`."""
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
