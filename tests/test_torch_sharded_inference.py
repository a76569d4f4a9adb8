"""Port parity: multi-device inference (`Interface.shard`, `shard_pipeline`,
`sp_pad_len`, the chunk-free `coarse_vamp`, `VampEngine(data_parallel=True)`)
over repeated-device meshes (`["cpu"] * 8`), the counterparts of the JAX
package's `tests/test_sharded_inference.py`, with their bounds.

A mesh that repeats one device cannot show distribution by a count of
distinct devices; each shard's shape and device show it instead. Each path
is held two ways: against the port's unsharded run at the JAX test's random
settings (its bound: > 0.98 of tokens agree, 0.99 under sp), and against
the JAX package's unsharded run at settings where no random draw decides a
token (greedy, `mask_temperature=0`, a prompt in every chunk; fp32, where
the unsharded port and JAX agree token for token), to the same bound.

The last four tests hold the tensor-parallel layout's traps: w_1's GEGLU
halves split alike, the fused FFN's residual added by one shard, each
shard's heads of the T5 bias, and int8's per-row activation scale (fc and
w_2 stay whole, so the sharded int8 forward is the unsharded one bit for
bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from test_torch_interface_staged import GREEDY, _prompt_mask
from test_torch_util import CODEC_KW, codec_params_np, configs, lm_params_np, to_jax
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.interface import Interface as JInterface
from vampnet_tpu.sampling.generate import generate as jgenerate
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.codec import CodecConfig
from vampnet_tpu_torch.interface import Interface
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.modules.transformer import TensorParallelStack, position_bias_from_params
from vampnet_tpu_torch.ops import ffn_kernel
from vampnet_tpu_torch.parallel import make_mesh
from vampnet_tpu_torch.parallel.placement import Placement
from vampnet_tpu_torch.sampling.generate import generate
from vampnet_tpu_torch.serve import VampEngine, VampRequest

CPU8 = ["cpu"] * 8
CHUNKS = dict(coarse_chunk_size_s=0.15, coarse2fine_chunk_size_s=0.05)  # 75 and 25 tokens
BOUND = 0.98  # the JAX tests' share of tokens that must agree


@pytest.fixture(scope="module")
def params():
    """The numpy param trees and configs of `test_torch_interface_staged`'s
    pair (16 kHz, hop 32; coarse 2 codebooks, c2f 4; 4 heads, d=64; fp32)."""
    _, _, lms = configs("float32")
    jc = JCodecConfig(**CODEC_KW)
    return dict(lms=lms, jcodec=jc, codec=codec_params_np(jc, 60),
                coarse=lm_params_np(lms["coarse"][0], 61), c2f=lm_params_np(lms["c2f"][0], 62))


def _port(p, **cfg_kw) -> Interface:
    """A fresh port Interface on the CPU from the shared trees; `cfg_kw`
    replaces fields of both LM configs."""
    tc = CodecConfig(**CODEC_KW)
    lm = {name: dataclasses.replace(p["lms"][name][1], **cfg_kw) for name in ("coarse", "c2f")}
    return Interface.from_modules(
        tc, convert.codec_state_dict_from_jax(p["codec"], tc),
        lm["coarse"], convert.lm_state_dict_from_jax(p["coarse"], lm["coarse"]),
        lm["c2f"], convert.lm_state_dict_from_jax(p["c2f"], lm["c2f"]), device="cpu", **CHUNKS)


@pytest.fixture(scope="module")
def jiface(params):
    lms = params["lms"]
    return JInterface.from_modules(params["jcodec"], to_jax(params["codec"]), lms["coarse"][0],
                                   to_jax(params["coarse"]), lms["c2f"][0], to_jax(params["c2f"]),
                                   **CHUNKS)


def _codes(t=150, seed=0, b=1):
    return np.random.default_rng(seed).integers(0, 64, (b, 4, t))


def _agree(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


def _two_stage(iface, z, mask, **kw):
    zc = iface.coarse_vamp(z, mask, seed=7, _sampling_steps=3, **kw)
    return np.asarray(iface.coarse_to_fine(zc, mask=mask, seed=11, _sampling_steps=2, **kw))


@pytest.fixture(scope="module")
def greedy_refs(jiface):
    """The JAX package's unsharded coarse vamp and two-stage vamp at greedy
    settings, on codes with a prompt every 7 steps."""
    z = _codes()
    mask = _prompt_mask(z.shape, 7)
    coarse = np.asarray(jiface.coarse_vamp(jnp.asarray(z), jnp.asarray(mask), seed=1,
                                           _sampling_steps=3, **GREEDY))
    two = _two_stage(jiface, jnp.asarray(z), jnp.asarray(mask), **GREEDY)
    return z, mask, coarse, two


@pytest.fixture
def engines():
    made = []
    yield lambda *a, **kw: made.append(VampEngine(*a, **kw)) or made[-1]
    for eng in made:
        eng.close()


# ---------------------------------------------------------------- tp and dp


def test_sharded_vamp_matches_single_device(params, greedy_refs):
    iface = _port(params)
    z = _codes()
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    ref = iface.coarse_vamp(z, mask, seed=3, _sampling_steps=3)
    iface.shard(mesh=make_mesh(tp=2, devices=CPU8))  # 4 dp x 2 tp
    place = iface.placement.of(iface.coarse)
    assert place.dp == 4 and isinstance(place.groups[0][1], TensorParallelStack)
    out = iface.coarse_vamp(z, mask, seed=3, _sampling_steps=3)
    assert _agree(out, ref) > BOUND
    gz, gmask, want, _ = greedy_refs
    got = iface.coarse_vamp(gz, gmask, seed=1, _sampling_steps=3, **GREEDY)
    assert _agree(got, want) > BOUND


def test_sharded_params_actually_distributed(params):
    """Each tp shard holds its part of every projection on its own mesh
    position: block j of the heads, of each GEGLU half, of fc's and w_2's
    inputs."""
    iface = _port(params)
    iface.shard(mesh=make_mesh(tp=2, devices=CPU8))
    stack = iface.placement.of(iface.coarse).groups[0][1]
    assert stack.devices == [torch.device("cpu")] * 2 and len(stack.shards) == 2
    full = iface.coarse.transformer.layers_0
    w1 = full.feed_forward.w_1.weight
    for j, shard in enumerate(stack.shards):
        lay = shard[0]
        assert lay.self_attn.n_head == 2 and lay.self_attn.w_qs.weight.shape == (32, 64)
        assert lay.self_attn.fc.weight.shape == (64, 32)
        assert lay.feed_forward.w_1.weight.shape == (128, 64)
        assert lay.feed_forward.w_2.weight.shape == (64, 64)
        assert torch.equal(lay.feed_forward.w_1.weight,
                           torch.cat([w1[64 * j:64 * (j + 1)], w1[128 + 64 * j:128 + 64 * (j + 1)]]))
        assert all(t.device == stack.devices[j] for t in lay.state_dict().values())


def test_engine_data_parallel_serving(params, engines):
    iface = _port(params)
    solo_iface = _port(params)
    iface.shard(tp=1, devices=CPU8)  # 8-way dp
    rows = []
    place = iface.placement.of(iface.coarse)
    real = place.forward_codes
    place.forward_codes = lambda zm, *a: rows.append(zm.shape[0]) or real(zm, *a)
    eng = engines(iface, max_wait_ms=200.0, max_batch=8, data_parallel=True)
    assert eng.dp == 8
    z = _codes()
    mask = iface.build_mask(z, seed=0).numpy()
    futs = [eng.submit(VampRequest(codes=z, mask=mask, seed=i, sampling_steps=2,
                                   coarse_only=True)) for i in range(3)]
    outs = [f.result(240) for f in futs]
    # 3 requests pad to 8 rows (2 chunk rows each): 16 rows, 2 per dp group
    assert rows and set(rows) == {16}
    for i, o in enumerate(outs):
        assert o.shape == z.shape and (o != iface.coarse.mask_token).all()
        solo = solo_iface.coarse_vamp(z, mask, seed=np.array([i]), _sampling_steps=2)
        assert _agree(o, solo) > BOUND
    assert eng.stats["requests"] == 3


# ---------------------------------------------------------------- pipeline


def test_pipeline_placement_slices_and_parity(params, greedy_refs):
    iface = _port(params)
    z = _codes()
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    ref = _two_stage(iface, z, mask)
    ref_audio = iface.decode(ref).samples
    iface.shard_pipeline(n_coarse_devices=4, devices=CPU8)
    a, b = iface.placement.lms["coarse"], iface.placement.lms["c2f"]
    assert a.lm is iface.coarse and b.lm is iface.c2f
    # slice A is mesh positions 0-3, slice B positions 4-7: dp 4 each
    assert a.mesh.size == 4 and b.mesh.size == 4 and a.dp == b.dp == 4
    assert iface.placement.mesh is a.mesh and iface.placement.pipeline
    out = _two_stage(iface, z, mask)
    assert _agree(out, ref) > BOUND
    np.testing.assert_allclose(iface.decode(out).samples, ref_audio, atol=1e-4)
    gz, gmask, _, want = greedy_refs
    assert _agree(_two_stage(iface, gz, gmask, **GREEDY), want) > BOUND


def test_pipeline_default_split_and_e2e_guard(params):
    iface = _port(params)
    iface.shard_pipeline(devices=CPU8)  # about 3:1 of 8
    assert iface.placement.lms["coarse"].mesh.size == 6
    assert iface.placement.lms["c2f"].mesh.size == 2
    from vampnet_tpu_torch.audio import AudioSignal

    sig = AudioSignal(np.zeros((1, 1, 3200), np.float32), 16000)
    with pytest.raises(AssertionError, match="vamp_e2e"):
        iface.vamp_e2e(sig, batch_size=1)
    with pytest.raises(AssertionError, match=">=2 devices"):
        _port(params).shard_pipeline(devices=["cpu"])


def _engine_outs(make, iface, z, mask, **kw):
    eng = make(iface, max_wait_ms=200.0, max_batch=4, **kw)
    futs = [eng.submit(VampRequest(codes=z, mask=mask, seed=100 + i, sampling_steps=2))
            for i in range(3)]
    outs = [f.result(240) for f in futs]
    eng.close()
    return outs


def test_engine_over_pipeline_matches_unplaced(params, engines):
    iface = _port(params)
    z = _codes()
    mask = iface.build_mask(z, seed=0).numpy()
    ref = _engine_outs(engines, iface, z, mask)
    iface.shard_pipeline(n_coarse_devices=4, devices=CPU8)
    for a, b in zip(ref, _engine_outs(engines, iface, z, mask)):
        assert _agree(a, b) > BOUND


def test_vamp_full_path_under_pipeline(params):
    iface = _port(params)
    z = _codes()
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    kw = dict(batch_size=2, seed=9, _sampling_steps=2, return_mask=True)
    ref, ref_mask = iface.vamp(z, mask, **kw)
    iface.shard_pipeline(n_coarse_devices=4, devices=CPU8)
    out, out_mask = iface.vamp(z, mask, **kw)
    assert out.shape == ref.shape == (2, 4, 150)
    assert _agree(out, ref) > BOUND
    np.testing.assert_array_equal(out_mask, ref_mask)


def test_engine_data_parallel_over_pipeline(params, engines):
    iface = _port(params)
    z = _codes()
    mask = iface.build_mask(z, seed=0).numpy()
    iface.shard_pipeline(n_coarse_devices=4, devices=CPU8)  # dp=4 coarse, dp=4 c2f
    eng = engines(iface, max_wait_ms=200.0, max_batch=4, data_parallel=True)
    assert eng.dp == 4
    futs = [eng.submit(VampRequest(codes=z, mask=mask, seed=50 + i, sampling_steps=2))
            for i in range(3)]  # pads to 4 rows
    for o in (f.result(240) for f in futs):
        assert o.shape == z.shape and (o != iface.c2f.mask_token).all()


def test_quantized_interface_shards(params):
    """quantize() then shard(tp=2): the int8 column sites split their w_q
    rows and w_scale; the tokens are the unsharded int8 Interface's."""
    iface = _port(params)
    ref_iface = _port(params).quantize()
    z = _codes()
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    iface.quantize().shard(mesh=make_mesh(tp=2, devices=CPU8))
    first, lay = iface.placement.of(iface.coarse).groups[0][1].shards[0][0], \
        iface.placement.of(iface.coarse).groups[0][1].shards[1][0]
    assert lay.feed_forward.w_1.w_q.dtype == torch.int8
    assert lay.feed_forward.w_1.w_q.shape == (128, 64) and lay.feed_forward.w_1.w_scale.shape == (128,)
    # the row site stays whole, on the group's first shard only
    assert first.feed_forward.w_2.w_q.shape == (64, 128) and lay.feed_forward.w_2 is None
    out = iface.coarse_vamp(z, mask, seed=3, _sampling_steps=2)
    assert out.shape == z.shape and (out != iface.coarse.mask_token).all()
    np.testing.assert_array_equal(out.numpy(), ref_iface.coarse_vamp(
        z, mask, seed=3, _sampling_steps=2).numpy())


def test_quantize_under_pipeline_unwinds_placement(params):
    iface = _port(params)
    z = _codes()
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    iface.shard_pipeline(n_coarse_devices=4, devices=CPU8)
    _two_stage(iface, z, mask)
    iface.quantize()
    assert iface.placement.pipeline is False and iface.placement.mesh is None
    assert iface.placement.codec_decode is None and iface.placement.lms == {}
    assert iface.placement.of(iface.coarse) is None and iface.placement.of(iface.c2f) is None
    out = _two_stage(iface, z, mask)
    assert iface.decode(out).samples.shape[0] == 1
    with pytest.raises(AssertionError, match="data_parallel"):
        VampEngine(iface, data_parallel=True)


# ---------------------------------------------------------------- sp

DET = dict(temperature=1.0, mask_temperature=0.0, typical_filtering=False, sample_cutoff=-1.0)


def test_sp_chunkfree_vamp_matches_unsharded_whole_seq(params, jiface):
    """shard(sp=8) + the chunk-free coarse_vamp against the same
    whole-sequence generate on one device, the port's and JAX's (XLA
    attention and sampler), in the deterministic regime. The ring's
    accumulation order differs from one softmax, which may flip an argmax at
    a near-tie, so the bound is the JAX test's 0.99 and exact keeps."""
    t = 1024  # 128 tokens a shard
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 64, (1, 2, t))
    mask = (rng.random((1, 2, t)) < 0.8).astype(np.int64)
    iface = _port(params)
    cbs = iface.codebooks[:2]
    jlm = jiface.coarse

    def jforward(zm, c=None, cm=None):
        return jlm.model.apply({"params": jlm.params}, zm, jnp.asarray(cbs.numpy()),
                               method="forward_codes")

    jref = np.asarray(jgenerate(jforward, jax.random.PRNGKey(0), jnp.asarray(codes),
                                jnp.asarray(mask), mask_token=64, sampling_steps=4,
                                sampler_impl="xla", **DET))
    with torch.inference_mode():
        tref = generate(lambda zm: iface.coarse.forward_codes(zm, cbs), torch.from_numpy(codes),
                        torch.from_numpy(mask), 64, torch.Generator().manual_seed(0),
                        sampling_steps=4, **DET).numpy()
    iface.shard(sp=8, devices=CPU8)
    assert iface.sp_pad_len(t) == t
    out = iface.coarse_vamp(codes, mask, seed=0, _sampling_steps=4, **DET).numpy()
    assert out.shape == codes.shape
    for ref in (jref, tref):
        assert _agree(out, ref) > 0.99
    keep = mask == 0
    np.testing.assert_array_equal(out[keep], codes[keep])
    # chunked=True still forces the windowed path on the same interface
    windowed = iface.coarse_vamp(codes, mask, seed=0, _sampling_steps=4, chunked=True,
                                 **DET).numpy()
    assert windowed.shape == out.shape and not np.array_equal(windowed, tref)


def test_sp_pad_len_and_unchunked_refusals(params):
    iface = _port(params)
    z = _codes()
    with pytest.raises(AssertionError, match="shard\\(sp=N\\)"):
        iface.coarse_vamp(z, np.ones_like(z), chunked=False)
    with pytest.raises(AssertionError, match="sp_pad_len"):
        iface.sp_pad_len(100)
    iface.shard(sp=4, devices=CPU8)
    # the grid of the JAX package: sp below 128 tokens a shard, 128 sp above
    assert [iface.sp_pad_len(t) for t in (150, 511, 512, 513, 3445)] == \
        [152, 512, 512, 1024, 3584]
    with pytest.raises(ValueError, match="starts on"):
        _port(params).shard(mesh=make_mesh(devices=["meta"] * 2))


def test_shard_sp_reentry_places_the_coarse_lm_itself(params, monkeypatch):
    """shard(sp=) places the coarse LM itself: a repeated shard(sp=) keeps
    `iface.coarse` the same object on the same storage and builds no
    VampNetLM, and leaving sp unplaces it."""
    iface = _port(params)
    coarse = iface.coarse
    w = "transformer.layers_0.self_attn.w_qs.weight"
    ptr = coarse.state_dict()[w].data_ptr()
    built = []
    real_init = VampNetLM.__init__
    monkeypatch.setattr(VampNetLM, "__init__",
                        lambda self, *a, **kw: built.append(a) or real_init(self, *a, **kw))
    iface.shard(sp=8, devices=CPU8)
    iface.shard(sp=8, devices=CPU8)  # again (a reconfiguration)
    assert built == []
    assert iface.coarse is coarse and iface.coarse.state_dict()[w].data_ptr() == ptr
    assert iface.coarse.config.attention_impl != "ring"
    assert iface.placement.sp == 8 and iface.placement.of(coarse).lm is coarse
    iface.shard(tp=1, devices=CPU8)  # leaving sp: the LM on the dp mesh
    assert iface.coarse is coarse and iface.placement.sp == 1
    iface.to(iface.device)
    assert iface.coarse is coarse and iface.placement.of(coarse) is None


def test_sp_windowed_vamp_matches_unsharded(params):
    """Under shard(sp=8) the windowed coarse_vamp (chunked=True) runs the
    coarse LM unplaced: the unsharded windowed tokens, bit for bit."""
    iface, ref = _port(params), _port(params)
    z = _codes()
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    want = ref.coarse_vamp(z, mask, seed=3, _sampling_steps=3).numpy()
    iface.shard(sp=8, devices=CPU8)
    got = iface.coarse_vamp(z, mask, seed=3, _sampling_steps=3, chunked=True).numpy()
    np.testing.assert_array_equal(got, want)


def test_sp_vamp_public_api_end_to_end(params):
    """vamp() after shard(sp=8): coarse chunk-free, c2f windowed; the kept
    positions survive and the output is in the vocabulary."""
    iface = _port(params)
    iface.shard(sp=8, devices=CPU8)
    z = _codes()
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    out = iface.vamp(z, mask, seed=3, _sampling_steps=3).numpy()
    assert out.shape == z.shape
    keep = mask.numpy() == 0
    np.testing.assert_array_equal(out[keep], z[keep])
    assert (out >= 0).all() and (out < 64).all()


def test_vamp_microbatched_grouping_invariance_and_pipeline(params):
    """vamp_microbatched with a seed array: every grouping gives the
    one-shot tokens (the group lengths are multiples of the c2f chunk), and
    the pipeline placement keeps them within the bound."""
    iface = _port(params)
    z = _codes(t=300)  # 4 coarse chunks of 75
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    kw = dict(_sampling_steps=2, seed=np.array([1234], np.uint32))
    one_shot = iface.vamp_microbatched(z, mask, group_chunks=4, **kw).numpy()
    assert one_shot.shape == (1, 4, 300)
    for g in (1, 2):
        np.testing.assert_array_equal(iface.vamp_microbatched(z, mask, group_chunks=g,
                                                              **kw).numpy(), one_shot)
    iface.shard_pipeline(n_coarse_devices=4, devices=CPU8)
    piped = iface.vamp_microbatched(z, mask, group_chunks=2, **kw).numpy()
    assert _agree(piped, one_shot) > BOUND


def test_sp_rejects_other_samplers_explicitly(params):
    """Under shard(sp=) the port's one sampler (K10) samples the gathered
    logits: an explicit sampler_impl raises instead of being ignored."""
    iface = _port(params)
    iface.shard(sp=8, devices=CPU8)
    z = _codes()
    mask = iface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    for impl in ("fused", "xla"):
        with pytest.raises(NotImplementedError, match="sampler_impl"):
            iface.coarse_vamp(z, mask, seed=0, _sampling_steps=2, sampler_impl=impl)
    out = iface.coarse_vamp(z, mask, seed=0, _sampling_steps=2, sampler_impl="auto")
    assert out.shape == z.shape


def test_sp_engine_serving_matches_solo(params, engines):
    """The engine in its default mode on an sp interface buckets on
    sp_pad_len, so a request's batched tokens are its solo chunk-free
    coarse_vamp's exactly."""
    iface = _port(params)
    iface.shard(sp=8, devices=CPU8)
    z = _codes()
    mask = iface.build_mask(z, seed=0).numpy()
    solo = {s: iface.coarse_vamp(z, mask, seed=np.array([s], np.uint32), _sampling_steps=2,
                                 **DET).numpy() for s in (3, 4)}
    eng = engines(iface, max_wait_ms=200.0, max_batch=4)
    assert eng._bucket_len(150) == 152
    futs = [eng.submit(VampRequest(codes=z, mask=mask, seed=s, coarse_only=True,
                                   sampling_steps=2, **DET)) for s in (3, 4)]
    for s, f in zip((3, 4), futs):
        np.testing.assert_array_equal(f.result(240), solo[s])


def test_sp_engine_rejects_data_parallel(params):
    iface = _port(params)
    iface.shard(tp=1, devices=CPU8)  # leaves a dp mesh behind
    iface.shard(sp=8, devices=CPU8)
    assert iface.placement.mesh is None
    with pytest.raises(AssertionError, match="data_parallel"):
        VampEngine(iface, data_parallel=True)


# ---------------------------------------------------------------- the layout's traps


def _lm(params, **cfg_kw):
    cfg = dataclasses.replace(params["lms"]["coarse"][1], **cfg_kw)
    lm = VampNetLM(cfg, device="cpu")
    lm.load_state_dict(convert.lm_state_dict_from_jax(params["coarse"], cfg), strict=True)
    return lm.requires_grad_(False).eval()


def _logits(lm, stack=None, t=40):
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 65, (2, 2, t)))  # MASK included
    cbs = torch.from_numpy(rng.standard_normal((2, 64, 4)).astype(np.float32))
    with torch.inference_mode():
        return lm.forward_codes(codes, cbs, stack=stack), codes, cbs


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_splits_the_geglu_halves_alike(params, tp):
    """Shard j takes block j of w_1's value half and block j of its gate
    half, so each shard's p1 * gelu(p2) pairs a unit with its own gate (a
    contiguous cut would pair values with values). The tp forward is the
    unsharded one, and JAX's, up to summation order."""
    from vampnet_tpu.modules import VampNetLM as JVampNetLM

    lm = _lm(params)
    want, codes, cbs = _logits(lm)
    got, _, _ = _logits(lm, TensorParallelStack(lm, ["cpu"] * tp))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    jwant = JVampNetLM(params["lms"]["coarse"][0]).apply(
        {"params": to_jax(params["coarse"])}, jnp.asarray(codes.numpy()),
        jnp.asarray(cbs.numpy()), method="forward_codes")
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=2e-4, atol=2e-4)


def test_tp_fused_ffn_adds_the_residual_once(params, monkeypatch):
    """Under ffn_impl="fused" each shard's fused FFN returns a partial sum;
    only shard 0's adds the residual x."""
    lm = _lm(params, ffn_impl="fused")
    flags = []
    real = ffn_kernel.fused_geglu_ffn
    from vampnet_tpu_torch.modules import transformer as tr

    monkeypatch.setattr(tr, "fused_geglu_ffn",
                        lambda *a, residual=True, **kw: flags.append(residual)
                        or real(*a, residual=residual, **kw))
    want, _, _ = _logits(lm)
    flags.clear()
    got, _, _ = _logits(lm, TensorParallelStack(lm, ["cpu"] * 2))
    assert flags == [True, False] * lm.config.n_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_tp_attention_takes_its_heads_of_the_bias(params, monkeypatch):
    """Each shard's attention gets the (h/tp, t, t) block of the T5 bias for
    its own heads."""
    from vampnet_tpu_torch.modules import transformer as tr

    lm = _lm(params)
    seen = []
    real = tr.dot_product_attention
    monkeypatch.setattr(tr, "dot_product_attention",
                        lambda q, k, v, bias=None, **kw: seen.append(bias) or real(
                            q, k, v, bias=bias, **kw))
    want, _, _ = _logits(lm)
    seen.clear()
    got, _, _ = _logits(lm, TensorParallelStack(lm, ["cpu"] * 4))
    full = position_bias_from_params(lm, 40)
    assert len(seen) == 4 * lm.config.n_layers
    for i, bias in enumerate(seen):
        torch.testing.assert_close(bias, full[i % 4:i % 4 + 1], rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_tp_int8_keeps_the_row_scale(params):
    """w8a8 quantizes each activation row by its absmax over all its
    features. A shard of fc's or w_2's inputs would take the max over its
    slice alone (another scale, other tokens), so an int8 LM keeps those two
    sites whole: the tp forward is then the unsharded int8 forward bit for
    bit."""
    iface = _port(params).quantize()
    lm = iface.coarse
    want, _, _ = _logits(lm)
    place = Placement(lm, make_mesh(tp=2, devices=["cpu"] * 2))
    stack = place.groups[0][1]
    got, _, _ = _logits(lm, stack)
    assert torch.equal(got, want)
    assert not stack.row_parallel
    # only shard 0 holds the whole row sites
    for i in range(lm.config.n_layers):
        first, other = stack.shards[0][i], stack.shards[1][i]
        whole = getattr(lm.transformer, f"layers_{i}").self_attn.fc.w_q
        assert torch.equal(first.self_attn.fc.w_q, whole)
        assert other.self_attn.fc is None and other.feed_forward.w_2 is None
    iface.shard(mesh=make_mesh(tp=2, devices=["cpu"] * 2))
    assert not iface.placement.of(lm).groups[0][1].row_parallel


def test_tp_replica_on_another_device_leaves_out_the_layers(params):
    """A tp group whose first device is not the LM's holds a copy of the
    embedding, the classifier and the rest, but not the layers: its stack
    runs in their place. Its forward through the stack is the LM's."""
    from vampnet_tpu_torch.parallel.placement import _replica

    lm = _lm(params)
    shell = _replica(lm, torch.device("meta"), layers=False)
    assert shell.transformer is None and lm.transformer is not None
    assert all(p.is_meta for p in shell.parameters())
    assert _replica(lm, torch.device("cpu"), layers=False) is lm
    shell.to_empty(device="cpu")
    kept = {k: v for k, v in lm.state_dict().items() if not k.startswith("transformer.")}
    shell.load_state_dict(kept, strict=True)
    stack = TensorParallelStack(lm, ["cpu"] * 2)
    want, codes, cbs = _logits(lm, stack)
    with torch.inference_mode():
        got = shell.forward_codes(codes, cbs, position_bias_from_params(lm, codes.shape[-1]),
                                  stack=stack)
    assert torch.equal(got, want)
