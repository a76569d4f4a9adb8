"""Per-step dumps of the MaskGIT loop (counterpart of
`vampnet_tpu/sampling/debug.py`; upstream's `generate(debug=True)`).

Pass `debug_callback=save_debug_dumps("vampnet-debug")` to `generate` (or to
a staged `Interface` call, which forwards it): each step's state lands in
`<debug_dir>/step_<i>/state.npz`, and, where matplotlib imports, PNGs of the
first row's masked codes and mask beside it. The loop copies the state to
the host only when a callback is given.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def save_debug_dumps(debug_dir: str = "vampnet-debug", save_png: bool = True):
    """A callback(step, z_masked, sampled, mask, selected_probs,
    num_to_mask) for `generate`."""
    root = Path(debug_dir)
    root.mkdir(parents=True, exist_ok=True)

    def callback(step, z_masked, sampled, mask, selected_probs, num_to_mask):
        step_dir = root / f"step_{int(step)}"
        step_dir.mkdir(exist_ok=True)
        z_masked, mask = np.asarray(z_masked), np.asarray(mask)
        np.savez(step_dir / "state.npz", z_masked=z_masked, sampled=np.asarray(sampled),
                 mask=mask, selected_probs=np.asarray(selected_probs),
                 num_to_mask=np.asarray(num_to_mask))
        if save_png:
            _save_pngs(step_dir, {"z_masked": z_masked[0], "mask": mask[0]})

    return callback


def _save_pngs(step_dir: Path, images) -> None:
    try:
        import matplotlib
    except ImportError:  # the PNGs are optional; the npz holds the state
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for name, arr in images.items():
        plt.clf()
        plt.imshow(arr if arr.ndim == 2 else arr[None, :], aspect="auto", origin="lower",
                   interpolation="none")
        plt.savefig(step_dir / f"{name}.png", dpi=80)
