"""One LM laid out over a mesh for inference (`Placement`): the forward
that `Interface.shard` and `Interface.shard_pipeline` give the MaskGIT loop;
and an Interface's whole placement as one value (`InterfacePlacement`).

  * A ("dp", "tp") mesh: each row of the mesh is a dp group. The group's
    first device holds a replica of the LM (the LM itself on its own
    device, a copy elsewhere; groups with the same devices share one) and,
    with tp > 1, the group's `TensorParallelStack`, which stands in for the
    layers: a copy then leaves them out. The LM on its own device stays
    whole (the Interface's unsharded paths, `quantize` and checkpoints read
    it), so that device holds its layers and its shard's. A batch whose rows
    divide by dp is split over the groups, each running its rows; any other
    batch runs whole on the first group, as JAX replicates a batch that
    does not divide over its dp axis.
  * An ("sp",) mesh: one `RingStack` over its devices; the padded sequence
    splits into equal time shards.

The embedding, the classifier and the logits stay on each group's first
device, and the logits meet on the placement's first device
(`Placement.device`), where the MaskGIT loop samples from them as it does
unsharded. One process drives every device; on devices that differ the
card runs each device's launches as they arrive, so the groups overlap.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Mapping, Optional

import torch

from ..modules.transformer import RingStack, TensorParallelStack, VampNetLM
from .mesh import Mesh


def _lm_device(lm: VampNetLM) -> torch.device:
    return lm.classifier.weight.device


def _replica(lm: VampNetLM, device: torch.device, layers: bool = True) -> VampNetLM:
    """`lm` itself on its own device, else a copy on `device`; without
    `layers` the copy has no `transformer` (a stack runs in its place)."""
    if _lm_device(lm) == device:
        return lm
    memo = {} if layers else {id(lm.transformer): None}
    return copy.deepcopy(lm, memo).to(device)


class Placement:
    """`lm` over `mesh`."""

    def __init__(self, lm: VampNetLM, mesh: Mesh):
        self.mesh = mesh
        self.lm = lm
        if mesh.axis_names == ("sp",):
            devices = mesh.device_list()
            rep = _replica(lm, devices[0])
            self.groups = [(rep, RingStack(rep, devices))]
        else:
            built = {}
            self.groups = []
            for row in mesh.devices:
                devices = tuple(row)
                if devices not in built:
                    stack = TensorParallelStack(lm, devices) if len(devices) > 1 else None
                    built[devices] = (_replica(lm, devices[0], layers=stack is None), stack)
                self.groups.append(built[devices])
        self._moved = {}

    @property
    def device(self) -> torch.device:
        """Where the logits meet (the mesh's first device)."""
        return _lm_device(self.groups[0][0])

    @property
    def dp(self) -> int:
        return len(self.groups)

    def _on(self, x: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
        """x on `device`, the copy kept while x is the tensor last given (the
        position bias and the codebooks are the same for every step)."""
        if x is None or x.device == device:
            return x
        key = (device, tuple(x.shape), x.dtype)
        hit = self._moved.get(key)
        if hit is None or hit[0] is not x:
            hit = self._moved[key] = (x, x.to(device))
        return hit[1]

    def forward_codes(self, codes: torch.Tensor, codebooks: torch.Tensor,
                      position_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """codes (b, n_codebooks, t) on `device` -> fp32 logits on `device`."""
        n = self.dp
        parts = codes.chunk(n) if n > 1 and codes.shape[0] % n == 0 else [codes]
        outs = []
        for (rep, stack), part in zip(self.groups, parts):
            dev = _lm_device(rep)
            logits = rep.forward_codes(part.to(dev), self._on(codebooks, dev),
                                       self._on(position_bias, dev), stack=stack)
            outs.append(logits.to(self.device))
        return outs[0] if len(outs) == 1 else torch.cat(outs)


@dataclasses.dataclass(frozen=True)
class InterfacePlacement:
    """Where an Interface's models run (`Interface.placement`). `shard`,
    `shard(sp=)` and `shard_pipeline` each build a whole one; the default is
    unplaced, every model whole on the Interface's device.

    lms: the LMs' placements by name ("coarse", "c2f").
    mesh: the ("dp", "tp") mesh a data-parallel engine rounds its rows by
      (the coarse slice's under a pipeline); None unplaced and under sp.
    sp: the sequence-parallel size (1: none). Under sp only the coarse LM is
      placed, and its placement serves the chunk-free path alone.
    codec_decode: a pipeline's decode codec, on the c2f slice's first device;
      None off a pipeline."""

    lms: Mapping[str, Placement] = dataclasses.field(default_factory=dict)
    mesh: Optional[Mesh] = None
    sp: int = 1
    codec_decode: Optional[torch.nn.Module] = None

    @property
    def pipeline(self) -> bool:
        return self.codec_decode is not None

    def of(self, lm: VampNetLM) -> Optional[Placement]:
        """The placement of `lm`, or None."""
        return next((p for p in self.lms.values() if p.lm is lm), None)
