"""Port: what the CUDA kernels' wrappers accept before they launch. The
checks run on `meta` tensors, which carry shapes and dtypes but no data, so
they need no card: the fused FFN's argument check (any d a multiple of 128,
as the JAX wrapper asks), and the sampler's per-row parameters (a Python
number is filled on the device, not copied from the host)."""
import pytest
import torch

from vampnet_tpu_torch.ops import sampler_kernel
from vampnet_tpu_torch.ops.ffn_kernel import check_args


def _ffn_args(d, dtype=torch.bfloat16, m=5):
    meta = dict(device="meta")
    return (torch.empty((m, d), dtype=dtype, **meta), torch.empty((d,), **meta),
            torch.empty((4 * d, d), dtype=torch.bfloat16, **meta),
            torch.empty((d, 2 * d), dtype=torch.bfloat16, **meta))


@pytest.mark.parametrize("d", [128, 640, 1280, 1408, 2048])
def test_fused_ffn_takes_any_width_a_multiple_of_128(d):
    check_args(*_ffn_args(d))


@pytest.mark.parametrize("d", [64, 192, 1300])
def test_fused_ffn_refuses_a_width_off_the_128_grid(d):
    with pytest.raises(ValueError, match="multiple of 128"):
        check_args(*_ffn_args(d))


def test_fused_ffn_refuses_fp32_x_and_misshapen_weights():
    with pytest.raises(ValueError, match="bf16"):
        check_args(*_ffn_args(256, dtype=torch.float32))
    x, nw, w1, w2 = _ffn_args(256)
    with pytest.raises(ValueError, match="want norm_weight"):
        check_args(x, nw, w1[: 2 * 256], w2)
    with pytest.raises(ValueError, match="want norm_weight"):
        check_args(x, nw, w1, w2.T)


@pytest.mark.parametrize("value,want", [(None, 1.0), (0.5, 0.5), (1, 1.0), (True, 1.0)])
def test_sampler_fills_scalar_row_params(value, want):
    got = sampler_kernel._row_param(value, 3, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == (3,)
    assert torch.equal(got, torch.full((3,), want))


def test_sampler_keeps_tensor_row_params():
    rows = torch.tensor([0.25, 0.5, 0.75])
    assert torch.equal(sampler_kernel._row_param(rows, 3, torch.device("cpu")), rows)
    scalar = torch.tensor(0.9)
    assert torch.equal(sampler_kernel._row_param(scalar, 2, torch.device("cpu")),
                       torch.full((2,), 0.9))
