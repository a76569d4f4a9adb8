"""Port parity: int8 serving. The w8a8 kernel's plain version against the JAX
package's XLA path and its Pallas kernel (interpret mode), bit for bit; the
weight quantizer; a quantized LM bridged from a JAX tree; and
`Interface.quantize()` end to end, against the JAX package's `quantize()`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_e2e import DETERMINISTIC, _capture_decoded_codes, _signal
from test_torch_util import codec_params_np, configs, lm_params_np, to_jax
from vampnet_tpu.audio import AudioSignal as JAudioSignal
from vampnet_tpu.interface import Interface as JInterface
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.modules.quantize import quantize_kernel as jquantize_kernel
from vampnet_tpu.modules.quantize import quantize_lm_params
from vampnet_tpu.ops.int8_matmul import w8a8_matmul as jw8a8
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.audio import AudioSignal
from vampnet_tpu_torch.interface import Interface
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.modules.lora import LoRADense
from vampnet_tpu_torch.modules.quantize import (
    QUANT_MODULES,
    quantize_kernel,
    quantize_lm_state_dict,
)
from vampnet_tpu_torch.ops.int8_matmul import w8a8_matmul, w8a8_matmul_plain

K, N = 64, 48


def _matmul_inputs(m, seed):
    """x (m, K) with rows of very different scales, a zero row (the 1e-8
    floor) and a row whose quotients sit exactly on .5 (round half to even:
    amax 127 gives a_scale 1); w_q int8 (K, N) in the JAX layout, w_scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)) * np.exp(rng.uniform(-4, 4, (m, 1)))
    x[1] = 0.0
    x[2] = 0.0
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    w_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    w_scale = rng.uniform(1e-4, 1e-2, N).astype(np.float32)
    return x.astype(np.float32), w_q, w_scale


@pytest.mark.parametrize("m", [37, 300])  # 300: two 256-row Pallas blocks, the last ragged
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_plain_equals_jax_xla_and_pallas_bit_for_bit(m, x_dtype, out_dtype):
    x, w_q, w_scale = _matmul_inputs(m, seed=m)
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    jdt = getattr(jnp, out_dtype)
    want_xla = jw8a8(jx, jnp.asarray(w_q), jnp.asarray(w_scale), out_dtype=jdt, impl="xla")
    want_pallas = jw8a8(jx, jnp.asarray(w_q), jnp.asarray(w_scale), out_dtype=jdt,
                        impl="pallas", interpret=True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    got = w8a8_matmul_plain(tx, torch.from_numpy(w_q.T.copy()), torch.from_numpy(w_scale),
                            out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == (m, N)
    got = got.float().numpy()
    # exact: int32 accumulation and the same IEEE steps in the same order
    np.testing.assert_array_equal(got, np.asarray(want_xla.astype(jnp.float32)))
    np.testing.assert_array_equal(got, np.asarray(want_pallas.astype(jnp.float32)))


def _fma32(a, b, c):
    """RN32(a * b + c) elementwise with one rounding, as the card's FMA: the
    product is exact in float64 and the sum is rounded once there; where
    that could land within a few float64 ulps of a float32 rounding
    midpoint, the sum is redone in exact rationals."""
    from fractions import Fraction

    t = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    out = t.astype(np.float32)
    other = np.nextafter(out, np.where(t >= out, np.float32(np.inf), np.float32(-np.inf)))
    mid = (out.astype(np.float64) + other.astype(np.float64)) / 2
    for i in np.flatnonzero(np.abs(t - mid) <= 4 * np.spacing(np.abs(t))):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = [near, np.nextafter(near, np.float32(np.inf)),
                 np.nextafter(near, np.float32(-np.inf))]
        out[i] = min(cands, key=lambda d: (abs(Fraction(float(d)) - exact),
                                           int(np.float32(d).view(np.int32)) & 1))
    return out


def test_quant_code_arithmetic_equals_the_ieee_division():
    """The card's row quantization (`quant_code` in csrc/int8_matmul.cu),
    emulated with exact fp32 operations: RN(v * r) with r = RN(1/s), two
    Newton corrections by FMA, a clamp to [-127, 127], and the rounding by
    adding 1.5 * 2^23, whose low byte is the code. It must give the codes
    of clip(rint(v / s)) with IEEE division: on rows of scales from 1e-13
    to 2e4, on quotients next to half-integers, on exact half-integers
    (ties to even) and at the row maximum."""
    rng = np.random.default_rng(10)
    f32 = np.float32
    n = 100_000
    got, want = [], []
    for kind in range(4):
        amax = np.exp(rng.uniform(-30, 10, n)).astype(f32)
        s = (np.maximum(amax, f32(1e-8)) * f32(0.007874015718698502)).astype(f32)
        if kind == 0:
            v = (rng.uniform(-1, 1, n) * amax).astype(f32)
        elif kind == 1:
            h = rng.integers(-127, 127, n) + 0.5
            v = (h * s.astype(np.float64) * (1 + rng.uniform(-3e-7, 3e-7, n))).astype(f32)
        elif kind == 2:
            v = ((rng.integers(-127, 127, n) + 0.5).astype(f32) * s).astype(f32)
        else:
            v = (np.where(rng.random(n) < 0.5, amax, -amax)
                 * (1 - rng.integers(0, 4, n) * f32(2.0 ** -24))).astype(f32)
        r = (f32(1) / s).astype(f32)
        y = (v.astype(np.float64) * r.astype(np.float64)).astype(f32)
        for _ in range(2):
            y = _fma32(_fma32(-s, y, v), r, y)
        y = np.minimum(np.maximum(y, f32(-127)), f32(127))
        code = ((y + f32(12582912.0)).astype(f32).view(np.int32) & 0xFF).astype(np.uint8)
        got.append(code.view(np.int8))
        want.append(np.clip(np.rint(v / s), -127, 127).astype(np.int8))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def test_w8a8_wrapper_on_cpu_takes_the_plain_version_and_launches_nothing():
    x, w_q, w_scale = _matmul_inputs(5, seed=1)
    before = w8a8_matmul.launches
    args = (torch.from_numpy(x).reshape(1, 5, K), torch.from_numpy(w_q.T.copy()),
            torch.from_numpy(w_scale))
    got = w8a8_matmul(*args, out_dtype=torch.float32)
    assert tuple(got.shape) == (1, 5, N)
    assert torch.equal(got, w8a8_matmul_plain(*args, out_dtype=torch.float32))
    assert w8a8_matmul.launches == before


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_quantize_kernel_equals_jax_exactly(store):
    rng = np.random.default_rng(3)
    kernel = (rng.standard_normal((96, 40)) * rng.uniform(0.01, 2.0, 40)).astype(np.float32)
    kernel[:, 7] = 0.0  # the 1e-12 floor
    # the Interface quantizes from bf16-stored weights
    kernel = np.asarray(jnp.asarray(kernel).astype(getattr(jnp, store)).astype(jnp.float32))
    jq, js = jquantize_kernel(kernel)
    q, s = quantize_kernel(torch.from_numpy(kernel.T.copy()).to(getattr(torch, store)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _quantized_trees(name, seed):
    """(JAX quantized config, port quantized config, JAX quantized tree)."""
    import dataclasses

    _, _, lms = configs("float32")
    jcfg, tcfg = lms[name]
    qparams = quantize_lm_params(to_jax(lm_params_np(jcfg, seed)))
    qparams = convert._flatten(qparams)  # numpy leaves, flat "a.b.c" keys
    tree = {}
    for path, x in qparams.items():
        node = tree
        *parts, leaf = path.split(".")
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(x)
    return (dataclasses.replace(jcfg, quantization="int8"),
            dataclasses.replace(tcfg, quantization="int8"), tree)


def test_state_dict_quantizer_equals_jax_tree_quantizer():
    _, _, lms = configs("float32")
    jcfg, tcfg = lms["coarse"]
    params = lm_params_np(jcfg, 5)
    _, qtcfg, qtree = _quantized_trees("coarse", 5)
    got = quantize_lm_state_dict(convert.lm_state_dict_from_jax(params, tcfg))
    want = convert.lm_state_dict_from_jax(qtree, qtcfg)
    assert set(got) == set(want) == set(VampNetLM(qtcfg, device="meta").state_dict())
    assert sum(k.endswith(".w_q") for k in got) == len(QUANT_MODULES) * qtcfg.n_layers
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_quantized_bridge_round_trips_to_the_jax_tree():
    _, qtcfg, qtree = _quantized_trees("c2f", 6)
    back = convert.lm_params_to_jax(convert.lm_state_dict_from_jax(qtree, qtcfg))
    flat_back, flat_want = convert._flatten(back), convert._flatten(qtree)
    assert set(flat_back) == set(flat_want)
    for key, want in flat_want.items():
        assert flat_back[key].dtype == want.dtype, key
        np.testing.assert_array_equal(flat_back[key], want, err_msg=key)


@pytest.mark.parametrize("name,t", [("coarse", 37), ("c2f", 25)])
def test_quantized_lm_logits_match_jax_fp32(name, t):
    qjcfg, qtcfg, qtree = _quantized_trees(name, 7)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, qjcfg.vocab_size + 1, (2, qjcfg.n_codebooks, t))
    cbs = rng.standard_normal((qjcfg.n_codebooks, qjcfg.vocab_size,
                               qjcfg.latent_dim)).astype(np.float32)
    want = np.asarray(JVampNetLM(qjcfg).apply(
        {"params": to_jax(qtree)}, jnp.asarray(codes), jnp.asarray(cbs), method="forward_codes"))
    lm = VampNetLM(qtcfg, device="cpu")
    lm.load_state_dict(convert.lm_state_dict_from_jax(qtree, qtcfg), strict=True)
    sites = [m for m in lm.modules() if isinstance(m, LoRADense)]
    assert len(sites) == len(QUANT_MODULES) * qtcfg.n_layers and all(m.quantize for m in sites)
    with torch.no_grad():
        got = lm.forward_codes(torch.from_numpy(codes), torch.from_numpy(cbs)).numpy()
    # fp32 between the int8 products, summed in another order than XLA's:
    # an activation within rounding of a quantization boundary can move its
    # int8 code by one, about 1/127 of that row's scale in one product
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def quantized_interfaces():
    jc, tc, lms = configs("float32")
    codec_np = codec_params_np(jc, 40)
    coarse_np = lm_params_np(lms["coarse"][0], 41)
    c2f_np = lm_params_np(lms["c2f"][0], 42)
    chunks = dict(coarse_chunk_size_s=0.15, coarse2fine_chunk_size_s=0.05)
    jiface = JInterface.from_modules(
        jc, to_jax(codec_np), lms["coarse"][0], to_jax(coarse_np),
        lms["c2f"][0], to_jax(c2f_np), **chunks)
    tiface = Interface.from_modules(
        tc, convert.codec_state_dict_from_jax(codec_np, tc),
        lms["coarse"][1], convert.lm_state_dict_from_jax(coarse_np, lms["coarse"][1]),
        lms["c2f"][1], convert.lm_state_dict_from_jax(c2f_np, lms["c2f"][1]),
        device="cpu", **chunks)
    return jiface.quantize(), tiface.quantize()


def test_interface_quantize_is_idempotent_and_keeps_fp32_scales(quantized_interfaces):
    _, tiface = quantized_interfaces
    coarse, c2f = tiface.coarse, tiface.c2f
    assert tiface.quantize() is tiface and tiface.coarse is coarse and tiface.c2f is c2f
    for lm in (coarse, c2f):
        assert lm.config.quantization == "int8"
        sd = lm.state_dict()
        for key, val in sd.items():
            site = key.split(".")[-2] if "." in key else ""
            assert not (site in QUANT_MODULES and key.endswith(".weight")), key
            if key.endswith(".w_q"):
                assert val.dtype == torch.int8
            elif key.endswith(".w_scale"):
                assert val.dtype == torch.float32
            else:
                assert val.dtype == torch.bfloat16, key  # stored as the Interface stores them


def test_interface_quantize_matches_jax_quantize(quantized_interfaces):
    jiface, tiface = quantized_interfaces
    for name in ("coarse", "c2f"):
        jflat = convert._flatten(getattr(jiface, name).params)
        sd = getattr(tiface, name).state_dict()
        for path, x in jflat.items():
            if path.endswith(".kernel_q"):
                key, val = path[: -len("kernel_q")] + "w_q", np.asarray(x).T
            elif path.endswith(".kernel_scale"):
                key, val = path[: -len("kernel_scale")] + "w_scale", np.asarray(x)
            else:
                continue
            # both quantize the same bf16-stored kernels
            assert sd[key].numpy().dtype == val.dtype, key
            np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)


def test_quantized_vamp_e2e_tokens_match_jax(quantized_interfaces, monkeypatch):
    # fp32 compute between the w8a8 products on both sides, in the same
    # steps; the two packages part only in reduction order (the RMSNorm mean,
    # the fp32 products) and in their math libraries' tanh, exp and rsqrt,
    # 1e-7 to 5e-7 relative. Where an activation sits within that rounding of
    # a quantization boundary the two pick neighbouring int8 codes, and a
    # greedy token can then flip; such flips stay rare. Each stage is held on
    # its own inputs: the c2f LM is conditioned on the coarse codes, so a
    # coarse flip would be counted again in every fine token it conditions.
    jiface, tiface = quantized_interfaces
    seen = _capture_decoded_codes(monkeypatch)
    samples, sr = _signal()
    kw = dict(batch_size=2, seed=0, **DETERMINISTIC)
    want = jiface.vamp_e2e(JAudioSignal(samples, sr), **kw)
    got = tiface.vamp_e2e(AudioSignal(samples, sr), **kw)
    jcodes, tcodes = seen["jax"], seen["torch"]
    assert tcodes.shape == jcodes.shape == (2, 4, 150)
    assert got.samples.shape == want.samples.shape
    differ = float((tcodes[:, :2] != jcodes[:, :2]).mean())  # the coarse codebooks
    assert differ <= 0.02, f"{differ:.4f} of the coarse tokens differ"

    # c2f through the staged API, both sides given the JAX package's coarse
    # codes (the conditioning codebooks are every chunk's prompt)
    c2f_kw = dict(seed=0, mask_temperature=DETERMINISTIC["mask_temperature"],
                  sample_cutoff=DETERMINISTIC["sample_cutoff"])
    jfine = np.asarray(jiface.coarse_to_fine(jcodes[:, :2], **c2f_kw))
    tfine = tiface.coarse_to_fine(torch.from_numpy(jcodes[:, :2].copy()), **c2f_kw).cpu().numpy()
    assert tfine.shape == jfine.shape == (2, 4, 150)
    np.testing.assert_array_equal(tfine[:, :2], jcodes[:, :2])
    np.testing.assert_array_equal(jfine[:, :2], jcodes[:, :2])
    differ = float((tfine[:, 2:] != jfine[:, 2:]).mean())
    assert differ <= 0.02, f"{differ:.4f} of the fine tokens differ"


def test_from_modules_takes_a_quantized_jax_tree():
    import dataclasses

    jc, tc, lms = configs("float32")
    qjcfg, qtcfg, qtree = _quantized_trees("coarse", 9)
    tiface = Interface.from_modules(
        tc, convert.codec_state_dict_from_jax(codec_params_np(jc, 43), tc),
        qtcfg, convert.lm_state_dict_from_jax(qtree, qtcfg), device="cpu")
    sd = tiface.coarse.state_dict()
    key = "transformer.layers_0.self_attn.w_qs"
    scale = qtree["transformer"]["layers_0"]["self_attn"]["w_qs"]["kernel_scale"]
    # the fp32 scales survive the bf16 storage cast bit for bit
    assert sd[key + ".w_scale"].dtype == torch.float32
    np.testing.assert_array_equal(sd[key + ".w_scale"].numpy(), scale)
    assert tiface.quantize().coarse.config == dataclasses.replace(qtcfg)
