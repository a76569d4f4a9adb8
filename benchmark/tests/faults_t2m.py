"""Faults planted in the text-to-music cell's timed path, for
`test_portbench_t2m.py`: each takes the driver and the run's context and
returns the system under test with the port broken underneath."""
from __future__ import annotations

import dataclasses

import torch


def _fp8(w: torch.Tensor) -> torch.Tensor:
    s = w.abs().amax().clamp(min=1e-30) / 448.0
    return ((w / s).to(torch.float8_e4m3fn).to(w.dtype) * s).to(w.dtype)


def t2m_lm_fp8(driver, ctx):
    """The LM's weights in a precision below the configuration's: fp8."""
    sv = driver.setup(ctx)
    with torch.no_grad():
        for name, p in sv.iface.lm.named_parameters():
            if p.dim() == 2:
                p.copy_(_fp8(p))
    return sv


def t2m_no_band(driver, ctx):
    """Stages 1-3 attend to every key: the restricted context skipped."""
    sv = driver.setup(ctx)
    lm = sv.iface.lm
    lm.config = dataclasses.replace(lm.config, subcodes_context=10 ** 6)
    return sv


def t2m_no_cross(driver, ctx):
    """The cross-attention skipped: every layer's text keys and values zero."""
    sv = driver.setup(ctx)
    lm = sv.iface.lm
    cross_kv = lm.cross_kv
    lm.cross_kv = lambda c: [(torch.zeros_like(k), torch.zeros_like(v)) for k, v in cross_kv(c)]
    return sv
