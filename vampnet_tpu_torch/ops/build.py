"""Builds the port's CUDA kernels and loads them with `ctypes`.

Every `csrc/*.cu` file (with the `csrc/*.cuh` headers it includes) is
compiled by its own `nvcc` process (all started together) for `sm_90a`, and the objects are linked into one shared library
with a plain C interface. Nothing includes PyTorch's headers, so a cold build
takes seconds. The library's name carries a hash of the sources and flags:
it is rebuilt only when one of them changes. The build directory
(`vampnet_tpu_torch/_build/`) is listed in `.gitignore`.

There is no fallback: a missing `nvcc` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Each returns cudaGetLastError() as int.
_SIGNATURES = {
    # q, k, v, bias, bias_is_bf16, mask (or null), out, b, t, h, d, q_scale,
    # device, stream
    "vampnet_attention_fwd": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, bias, bias_is_bf16, mask, out, lse, b, t, h, d, q_scale, device,
    # stream
    "vampnet_attention_fwd_lse": (_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, bias, bias_is_bf16, mask, rows (lse and delta per query tile),
    # do, dq_acc, dk, dv, dbias, part (scratch), b, t, h, d, q_scale, device,
    # stream
    "vampnet_attention_bwd": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _F, _I, _P),
    # x, x_is_bf16, w_q, w_scale, xq (scratch), a_scale (scratch), out,
    # out_is_bf16, m, n, k, device, stream
    "vampnet_w8a8_matmul": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # m, n, device -> the w8a8 GEMM's tile width there (0: no device)
    "vampnet_w8a8_block_n": (_I, _I, _I),
    # x, norm_weight, nw_is_bf16, w1, w2, y (scratch), g (scratch), out, m,
    # d, eps, device, stream
    "vampnet_geglu_ffn": (_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    # m, d, up, device -> the tile width of the up- (up = 1) or
    # down-projection GEMM there (0: no device)
    "vampnet_geglu_ffn_block_n": (_I, _I, _I, _I),
    # logits, keys, temp, top_p, flag, tokens, probs, b, flat, vocab, step,
    # typical, typical_mass, typical_min_tokens, top_k (0: off), use_top_p,
    # device, stream
    "vampnet_sampler": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _F, _I, _I, _I, _I, _P),
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvampnet_kernels_{_digest()}.so"


def build() -> Path:
    """Compile (if the sources changed) and return the library's path."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    procs = []
    try:
        for src in sources():
            obj = BUILD_DIR / f"{src.stem}_{tag}.o"
            log = open(BUILD_DIR / f"{src.stem}.log", "w")
            procs.append((src, obj, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT,
            )))
        for src, _obj, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (rc {rc}):\n"
                    + (BUILD_DIR / f"{src.stem}.log").read_text()
                )
        tmp = BUILD_DIR / f"tmp_{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
             *[str(obj) for _s, obj, _l, _p in procs]],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
        os.replace(tmp, so)
    finally:
        for _src, obj, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            obj.unlink(missing_ok=True)
    return so


def build_logs() -> str:
    """The compiler's output of the last build (ptxas register and shared
    memory use per kernel)."""
    return "\n".join(
        (BUILD_DIR / f"{src.stem}.log").read_text()
        for src in sources() if (BUILD_DIR / f"{src.stem}.log").exists()
    )


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use. Threads that call it
    first at the same time build it once: the lock keeps a second `nvcc`
    off the same output files."""
    with _LIBRARY_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of `tensors` (others may be None or scalars)
    requires grad."""
    return torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                           for x in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """A kernel launch makes no autograd graph: refuse inputs that want one,
    rather than hand back an output that silently cuts the graph."""
    if needs_grad(*tensors):
        raise RuntimeError(f"the {what} kernel is forward-only and an input requires grad; "
                           "call it under torch.no_grad() or through a differentiable path")


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed to launch: CUDA error {rc}")
