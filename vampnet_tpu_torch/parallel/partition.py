"""Parameter partition specs for the VampNet LM (counterpart of
`vampnet_tpu/parallel/partition.py`), and the tensor-parallel shards that
`Interface.shard` and the training placement (`train_placement.py`) cut
from them (`tp_slice`, `tp_gather`).

Megatron-style tensor parallel over the "tp" axis: the q/k/v projections
and the FFN's w_1 split their output features (heads, hidden units), the
attention output (fc) and the FFN's w_2 their input features, so each head
and each hidden unit lives on one shard and a block ends in one sum. Norms,
biases, the bucket table and the adapters are replicated (a shard computes
with its block of a column site's `lora_b` and a row site's `lora_a`).
ZeRO-1 splits the Adam moments over "dp" on top of a parameter's tp split
(the slices are `train/step.py`'s `ShardedTrainState`'s).

The specs are keyed by the port's state-dict names and written in the
port's layout: a Dense `weight` is (out, in), the transpose of the JAX
kernel (in, out), so JAX's `P(None, "tp")` on a kernel is `P("tp", None)`
on the weight here, and an int8 `w_scale` (JAX `kernel_scale`) of a column
site splits with the weight's rows.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

_COL = {"w_qs", "w_ks", "w_vs", "w_1"}  # split the output features
_ROW = {"fc", "w_2"}  # split the input features


class P(tuple):
    """A partition spec: one entry per dimension, a mesh axis name or None
    (replicated along that dimension); missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _keys(name) -> tuple:
    if isinstance(name, tuple):
        return tuple(k for part in name for k in str(part).split("."))
    return tuple(str(name).split("."))


def _spec_for_path(path: tuple) -> P:
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if leaf == "w_scale":
        return P("tp") if parent in _COL else P()
    if leaf in ("weight", "w_q"):
        if parent in _COL or parent in ("classifier", "out_proj"):
            return P("tp", None)
        if parent in _ROW:
            return P(None, "tp")
    return P()  # norms, biases, the bucket table, the adapters


def lm_param_specs(state_dict: Mapping[str, Any]) -> Dict[str, P]:
    """{state-dict name: P} for an LM's state dict (bf16 or int8)."""
    return {name: _spec_for_path(_keys(name)) for name in state_dict}


def zero1_specs(param_specs: Mapping[str, P], params: Mapping[str, torch.Tensor],
                dp_size: int, dp_axis: str = "dp", min_size: int = 2 ** 14) -> Dict[str, P]:
    """ZeRO-1: each Adam moment's spec is its parameter's, with the first
    dimension that is not split yet and divides by dp split over dp too.
    "First" is in the JAX layout: a Dense weight's dimensions are taken in
    (in, out) order, so the spec is the transpose of the JAX package's.
    Small leaves stay replicated (the collective would cost more than the
    memory saved)."""

    def one(name: str, spec: P, x: torch.Tensor) -> P:
        if x.dim() == 0 or x.numel() < min_size or dp_size <= 1:
            return spec
        entries = list(spec) + [None] * (x.dim() - len(spec))
        order = range(x.dim())
        if x.dim() == 2 and _keys(name)[-1] in ("weight", "w_q"):
            order = reversed(order)  # a Dense weight (out, in): the kernel's in first
        for i in order:
            if entries[i] is None and x.shape[i] % dp_size == 0:
                entries[i] = dp_axis
                return P(*entries)
        return spec

    return {name: one(name, param_specs[name], params[name]) for name in param_specs}


def _rebuild(tree, fn, path=()):
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, fn, path + _keys(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_rebuild(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def opt_state_specs(opt_state, param_specs: Mapping[str, P]):
    """The spec tree of an optimizer state (a nest of mappings and lists):
    a leaf whose key path ends with a parameter's path inherits that
    parameter's (ZeRO-1) spec where the leaf has the dimensions for it;
    counters and the rest are replicated."""
    flat = {_keys(name): spec for name, spec in param_specs.items()}

    def lookup(path, leaf):
        ndim = leaf.dim() if isinstance(leaf, torch.Tensor) else getattr(leaf, "ndim", 0)
        for plen in range(len(path), 0, -1):
            spec = flat.get(path[-plen:])
            if spec is not None and len(spec) <= ndim:
                return spec
        return P()

    return _rebuild(opt_state, lookup)


def _split(x: torch.Tensor, dim: int, j: int, n: int, paired: bool) -> torch.Tensor:
    """Shard j of n of `x` along `dim`: a contiguous block, or with `paired`
    block j of each half (the GEGLU value and gate units of w_1, which
    `chunk(2)` cuts apart), the two blocks side by side."""
    if not paired:
        return x.chunk(n, dim=dim)[j]
    halves = x.chunk(2, dim=dim)
    return torch.cat([h.chunk(n, dim=dim)[j] for h in halves], dim=dim)


def tp_dim(name, row_parallel: bool = True) -> Optional[Tuple[int, bool]]:
    """(dimension, paired) along which a tp shard holds its block of the
    tensor `name`, or None where every shard computes with it whole (the
    tensors kept once per tp group). The dimension `lm_param_specs` splits
    over "tp" (the classifier's and the codebook projection's outputs
    too), with w_1's value and gate halves split alike; a column site's
    `lora_b` splits with its outputs and a row site's `lora_a` with its
    inputs. Without `row_parallel` the row sites (fc, w_2) stay whole."""
    path = _keys(name)
    if path[-1] == "relative_attention_bias":
        return None
    site, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    paired = site == "w_1"
    if site in _COL and leaf == "lora_b":
        return 1, paired
    if site in _ROW and leaf == "lora_a":
        return (0, False) if row_parallel else None
    spec = _spec_for_path(path)
    if "tp" in spec and (site not in _ROW or row_parallel):
        return spec.index("tp"), paired
    return None


def tp_slice(name, x: torch.Tensor, j: int, n: int, row_parallel: bool = True) -> torch.Tensor:
    """Shard j of n of the whole tensor `name` (`tp_dim`), or x itself
    where the shards compute with it whole. A view of x where it can be."""
    where = tp_dim(name, row_parallel)
    return x if where is None or n == 1 else _split(x, where[0], j, n, where[1])


def tp_gather(name, parts, row_parallel: bool = True) -> torch.Tensor:
    """The whole tensor `name` from its n tp shards in order (the inverse of
    `tp_slice`), or the first shard's where they hold it whole."""
    where = tp_dim(name, row_parallel)
    if where is None or len(parts) == 1:
        return parts[0]
    dim, paired = where
    if not paired:
        return torch.cat(list(parts), dim=dim)
    halves = [p.chunk(2, dim=dim) for p in parts]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=dim)


def tp_shard_state_dict(state_dict: Mapping[str, torch.Tensor], j: int, n: int,
                        row_parallel: bool = True) -> Dict[str, torch.Tensor]:
    """Shard j of n of the transformer layers' tensors (the names under
    `transformer.layers_`, keys unchanged, the bucket table left out), as
    the shard's modules compute with them (`tp_slice`). Slices are views
    of `state_dict`'s tensors."""
    out = {}
    for name, x in state_dict.items():
        path = _keys(name)
        if path[0] != "transformer" or not path[1].startswith("layers_") \
                or path[-1] == "relative_attention_bias":
            continue
        out[name] = tp_slice(name, x, j, n, row_parallel)
    return out
