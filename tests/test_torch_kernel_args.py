"""Port: what the CUDA kernels' wrappers accept before they launch. The
checks run on `meta` tensors, which carry shapes and dtypes but no data, so
they need no card: the fused FFN's argument check (any d a multiple of 128,
as the JAX wrapper asks), the sampler's per-row parameters (a Python
number is filled on the device, not copied from the host) and its `top_k`
(checked before the wrapper routes by device). Also the kernel library's
first build under concurrent first calls."""
import ctypes

import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
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


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("top_k", [-1, 0, 1025, 2.0, True])
def test_sampler_refuses_a_top_k_out_of_range_on_any_device(device, top_k):
    logits = torch.zeros((2, 3, 1024), device=device)
    keys = torch.zeros((2, 2), dtype=torch.int64, device=device)
    with pytest.raises(ValueError, match="top_k"):
        sampler_kernel.fused_sample_from_logits(keys, 0, logits, 1.0, 0.0, top_k=top_k)


def test_sampler_takes_top_k_none_or_an_int_up_to_the_vocabulary():
    for top_k, want in ((None, 0), (1, 1), (1024, 1024), (np.int64(64), 64)):
        assert sampler_kernel.check_top_k(top_k) == want
    logits = torch.zeros((1, 2, 1024), device="meta")
    with pytest.raises(ValueError, match="CUDA"):  # past the check, not on the card
        sampler_kernel.fused_sample_from_logits(torch.zeros((1, 2), dtype=torch.int64,
                                                            device="meta"), 0, logits, 1.0, 0.0,
                                                top_k=64)


def test_sampler_keeps_tensor_row_params():
    rows = torch.tensor([0.25, 0.5, 0.75])
    assert torch.equal(sampler_kernel._row_param(rows, 3, torch.device("cpu")), rows)
    scalar = torch.tensor(0.9)
    assert torch.equal(sampler_kernel._row_param(scalar, 2, torch.device("cpu")),
                       torch.full((2,), 0.9))


def test_concurrent_first_calls_build_the_library_once(monkeypatch, tmp_path):
    """Eight threads that call `library()` first at the same time build it
    once (the serving engine's threads and the web app's handlers all reach
    it). `build()` is replaced by a slow stand-in that counts its calls and
    returns a loadable library, the C runtime's."""
    import ctypes.util
    import sys
    import threading
    import time

    from vampnet_tpu_torch.ops import build

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.fail("no C runtime library to stand in for the kernels")
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return libc

    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build, "_SIGNATURES", {"abs": (ctypes.c_int,)})
    build._load_library.cache_clear()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(8)
        libs = []

        def first_call():
            barrier.wait(timeout=30)
            libs.append(build.library())

        threads = [threading.Thread(target=first_call) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        build._load_library.cache_clear()
    assert len(calls) == 1 and len(libs) == 8
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].abs(-3) == 3
