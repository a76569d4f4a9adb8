"""Port parity: sketch2sound controls. The control primitives and extractors
(`control.py`), `CFGDropout` and `ControlEncoder`, `VampNetLM` with
`ctrl_dims`, the `ctrl_encoder` weights through the bridge, the upstream
`.pth` converter and `.vtpu` files, `generate` with the controls' CFG, and
the training step with a controller, against the JAX package on the same
numpy inputs and params.

The hard HPSS mask (`harm >= perc`) and the chroma threshold (`< 100`) flip
where two values agree to rounding, and the two packages' FFTs differ in the
last bits; the chroma controls are held to a tolerance and a share of
flipped bins (`CHROMA_*`), the rest of the extractors to fp32 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from test_torch_train import _flat, _rel, _t
from test_torch_util import CODEC_KW, _fill, _lm_leaf, codec_params_np, to_jax
from vampnet_tpu import checkpoints as jckpt
from vampnet_tpu import control as J
from vampnet_tpu import convert as jconvert
from vampnet_tpu import mask as jmask
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.sampling.generate import generate as jgenerate
from vampnet_tpu.train import step as jstep
from vampnet_tpu_torch import checkpoints as tckpt
from vampnet_tpu_torch import control as T
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.codec import LAC, CodecConfig
from vampnet_tpu_torch.interface import _lm_from_file
from vampnet_tpu_torch.modules import LMConfig, VampNetLM
from vampnet_tpu_torch.modules.transformer import CFGDropout, ControlEncoder
from vampnet_tpu_torch.sampling.generate import generate
from vampnet_tpu_torch.train import TrainState, make_optimizer, make_train_step
from vampnet_tpu_torch.util import flatten_tree

SR, HOP = 44100, 512
# chroma: the worst absolute difference of a control value (softmax outputs
# in [0, 1], the raw "hchroma" filterbank sums in the hundreds) and the share
# of bins that may differ by more than CHROMA_ATOL (a flipped HPSS or
# threshold decision); measured 0 flipped bins, 4e-6 and 8e-5 worst
CHROMA_ATOL = {"hchroma-12c-top2": 1e-4, "hchroma-36c-top3": 1e-4, "hchroma": 1e-2}
CHROMA_FLIP_SHARE = 0.01
CTRL_KEYS = ("rmsq16", "hchroma-12c-top2")
LM_KW = dict(n_heads=2, n_layers=2, n_codebooks=2, latent_dim=4, embedding_dim=64,
             vocab_size=64, compute_dtype="float32")


def _wav(b=2, seconds=0.6, sr=SR, seed=0):
    """A noisy A4 and a C4 that starts late: a quiet and a loud row."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    rows = [0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(len(t)),
            0.2 * np.sin(2 * np.pi * 261.6 * t) * (t > 0.2)]
    return np.stack([rows[i % 2] for i in range(b)]).astype(np.float32)


# ---------------------------------------------------------------- primitives


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 51])
def test_median_filter_matches_jax_even_windows_too(size):
    x = np.random.default_rng(size).standard_normal((3, 4, 60)).astype(np.float32)
    want = np.asarray(J.median_filter_1d(jnp.asarray(x), size))
    got = T.median_filter_1d(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, want)


def test_frame_rms_stft_hpss_and_filterbank_match_jax():
    wav = _wav()
    jw, tw = jnp.asarray(wav), torch.from_numpy(wav)
    np.testing.assert_array_equal(T.frame(tw, 2048, HOP).numpy(),
                                  np.asarray(J.frame(jw, 2048, HOP)))
    np.testing.assert_allclose(T.rms(tw).numpy(), np.asarray(J.rms(jw)), rtol=1e-6, atol=1e-7)
    spec_j = np.asarray(J.stft_mag(jw, 4096, HOP))
    spec_t = T.stft_mag(tw, 4096, HOP)
    assert spec_t.shape == spec_j.shape
    # the symmetric window (periodic=False) and two fp32 FFTs
    np.testing.assert_allclose(spec_t.numpy(), spec_j, rtol=1e-4, atol=1e-3 * spec_j.max() * 1e-3)
    for hard in (True, False):
        want = np.asarray(J.hpss_harmonic(jnp.asarray(spec_j), 51, hard))
        got = T.hpss_harmonic(torch.from_numpy(spec_j), 51, hard).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(T.chroma_filterbank(SR, 2049, 36),
                                  J.chroma_filterbank(SR, 2049, 36))


@pytest.mark.parametrize("key", sorted(T.CONTROLLERS))
def test_extractors_match_jax(key):
    wav = _wav()
    want = np.asarray(J.CONTROLLERS[key](hop_length=HOP, sample_rate=SR).extract(jnp.asarray(wav)))
    got = T.CONTROLLERS[key](hop_length=HOP, sample_rate=SR).extract(torch.from_numpy(wav))
    assert got.shape == want.shape and got.dtype == torch.float32
    if key.startswith("hchroma"):
        diff = np.abs(got.numpy() - want)
        assert float((diff > CHROMA_ATOL[key]).mean()) <= CHROMA_FLIP_SHARE
        assert np.median(diff) <= CHROMA_ATOL[key]
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_quantized_rms_depends_on_the_whole_batch():
    """`rmsq16` scales by the batch's min and max, so a row's control
    changes with its batch-mates, in both packages alike."""
    wav = _wav(b=2)
    ctl = T.CONTROLLERS["rmsq16"](hop_length=HOP, sample_rate=SR)
    jctl = J.CONTROLLERS["rmsq16"](hop_length=HOP, sample_rate=SR)
    alone = ctl.extract(torch.from_numpy(wav[1:])).numpy()
    batched = ctl.extract(torch.from_numpy(wav)).numpy()
    assert not np.array_equal(alone[0], batched[1])
    np.testing.assert_array_equal(alone, np.asarray(jctl.extract(jnp.asarray(wav[1:]))))
    np.testing.assert_array_equal(batched, np.asarray(jctl.extract(jnp.asarray(wav))))


def test_controller_masks_and_errors():
    c = T.Sketch2SoundController(list(CTRL_KEYS), hop_length=HOP, sample_rate=SR)
    assert c.ctrl_dims == J.Sketch2SoundController(list(CTRL_KEYS), HOP, SR).ctrl_dims
    ctrls = c.extract(torch.from_numpy(_wav()))
    gen = torch.Generator().manual_seed(0)
    masks = c.random_mask(ctrls, torch.tensor([0.1, 0.9]), gen)
    for k, m in masks.items():
        assert m.shape == ctrls[k].shape[:2] and set(m.unique().tolist()) <= {0, 1}
    # 1 - Bernoulli(gamma(r)): r 0.1 keeps about 2%, r 0.9 about 84% of a row
    assert masks["rmsq16"][0].float().mean() < 0.3 < masks["rmsq16"][1].float().mean()
    assert all(int(m.sum()) == 0 for m in c.empty_mask(ctrls).values())
    with pytest.raises(ValueError, match="unsupported control key"):
        T.Sketch2SoundController(["nope"], HOP, SR)


# ---------------------------------------------------------------- the encoder and the LM


def _cfgs(**kw):
    ctrl_dims = (("rms", 1), ("chroma", 3))
    kw = dict(LM_KW, ctrl_dims=ctrl_dims, **kw)
    return JLMConfig(dropout=0.0, **kw), LMConfig(dropout=0.0, **kw)


def ctrl_lm_params_np(jcfg, seed):
    """A random numpy param tree with the JAX control LM's structure."""
    model = JVampNetLM(jcfg)
    ctrls = {k: jnp.zeros((1, 8, d)) for k, d in jcfg.ctrl_dims}
    masks = {k: jnp.ones((1, 8), jnp.int32) for k, _ in jcfg.ctrl_dims}
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, jcfg.n_codebooks, 8), jnp.int32),
                             jnp.zeros((jcfg.n_codebooks, jcfg.vocab_size, jcfg.latent_dim)),
                             ctrls, masks, method="forward_codes"),
        jax.random.PRNGKey(0))["params"]
    return _fill(shapes, np.random.default_rng(seed), _lm_leaf)


def _ctrl_inputs(jcfg, b=2, t=20, seed=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, jcfg.vocab_size + 1, (b, jcfg.n_codebooks, t))
    cbs = rng.standard_normal((jcfg.n_codebooks, jcfg.vocab_size, jcfg.latent_dim))
    ctrls = {k: rng.uniform(0, 1, (b, t, d)).astype(np.float32) for k, d in jcfg.ctrl_dims}
    masks = {k: rng.integers(0, 2, (b, t)) for k, _ in jcfg.ctrl_dims}
    return codes, cbs.astype(np.float32), ctrls, masks


def _port_lm(tcfg, params):
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(convert.lm_state_dict_from_jax(params, tcfg), strict=True)
    return lm.requires_grad_(False)


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tt(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_control_lm_logits_match_jax_fp32():
    jcfg, tcfg = _cfgs()
    params = ctrl_lm_params_np(jcfg, 1)
    codes, cbs, ctrls, masks = _ctrl_inputs(jcfg)
    jmodel = JVampNetLM(jcfg)
    want = np.asarray(jmodel.apply({"params": to_jax(params)}, jnp.asarray(codes), jnp.asarray(cbs),
                                   _jnp(ctrls), _jnp(masks), method="forward_codes"))
    lm = _port_lm(tcfg, params)
    got = lm.forward_codes(_t(codes), _t(cbs), ctrls=_tt(ctrls), ctrl_masks=_tt(masks))
    # fp32 through 2 layers, as tests/test_torch_lm.py holds the LM
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # the encoder alone, and the controls move the logits
    enc_want = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, _jnp(ctrls), _jnp(masks), method=lambda m, x, c, cm:
        m.ctrl_encoder(x, c, cm)))(to_jax(params), jnp.ones((2, 20, 64))))
    enc_got = lm.ctrl_encoder(torch.ones((2, 20, 64)), _tt(ctrls), _tt(masks))
    np.testing.assert_allclose(enc_got.numpy(), enc_want, rtol=2e-5, atol=2e-6)
    blank = {k: torch.zeros_like(v) for k, v in _tt(masks).items()}
    assert not torch.allclose(got, lm.forward_codes(_t(codes), _t(cbs), ctrls=_tt(ctrls),
                                                    ctrl_masks=blank))
    with pytest.raises(ValueError, match="ctrls"):
        lm.forward_codes(_t(codes), _t(cbs))


def test_cfg_dropout_keeps_rows_without_rescale():
    x = torch.full((4000, 3, 2), 2.0)
    drop = CFGDropout(0.25)
    assert drop(x) is x  # no generator: the identity
    out = drop(x, torch.Generator().manual_seed(0))
    kept = out[:, 0, 0] != 0
    assert ((out == 2.0).all(dim=(1, 2)) == kept).all()  # whole rows, no 1 / (1 - p)
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    enc = ControlEncoder((("a", 1),), 8, cfg_dropout_prob=0.0, compute_dtype=torch.float32)
    assert enc.cfg_all.p == 0.0 and ControlEncoder((("a", 1),), 8, 0.4).cfg_all.p == 0.2


# ---------------------------------------------------------------- weights


def test_ctrl_encoder_leaves_through_the_bridge_and_vtpu(tmp_path):
    jcfg, tcfg = _cfgs()
    params = ctrl_lm_params_np(jcfg, 2)
    sd = convert.lm_state_dict_from_jax(params, tcfg)
    assert {k for k in sd if k.startswith("ctrl_encoder.")} == {
        f"ctrl_encoder.ctrl_{n}.{w}" for n in ("rms", "chroma") for w in ("weight", "bias")}
    back = flatten_tree(convert.lm_params_to_jax(sd))
    for path, x in flatten_tree(params).items():
        np.testing.assert_array_equal(back[path], x, err_msg=str(path))
    # a .vtpu written by the port reads back in both packages, ctrl_dims included
    tckpt.save_lm(tmp_path / "ctrl.vtpu", tcfg, params)
    cfg, tree = tckpt.load_lm(tmp_path / "ctrl.vtpu")
    jcfg2, jtree = jckpt.load_lm(tmp_path / "ctrl.vtpu")
    assert cfg == tcfg and jcfg2.ctrl_dims == jcfg.ctrl_dims == cfg.ctrl_dims
    for path, x in flatten_tree(params).items():
        np.testing.assert_array_equal(flatten_tree(tree)[path].numpy(), x)
        np.testing.assert_array_equal(np.asarray(flatten_tree(jtree)[path]), x)


def test_pth_with_a_control_encoder_converts_as_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, dropout=0.1)
    params = ctrl_lm_params_np(jcfg, 4)
    path = tmp_path / "ctrl.pth"
    chip_smoke.write_reference_lm(path, convert.lm_state_dict_from_jax(params, tcfg), tcfg)
    obj = torch.load(path, weights_only=False)
    assert "ctrl_encoder.ctrl_encoders.chroma.weight" in obj["state_dict"]
    cfg, tree = convert.lm_from_torch_checkpoint(path)
    jcfg_file, jtree = jconvert.lm_from_torch_checkpoint(path)
    got, want = flatten_tree(tree), flatten_tree(jtree)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want[p]), err_msg=str(p))
    # as in JAX, ctrl_dims stays unset and the LM serves without the
    # encoder, ignoring its leaves: the same logits as JAX's, no controls
    assert cfg.ctrl_dims is None and cfg == LMConfig(**dataclasses.asdict(jcfg_file))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    lm = _port_lm(cfg32, tree)
    assert not hasattr(lm, "ctrl_encoder")
    codes, cbs, _, _ = _ctrl_inputs(jcfg)
    want = np.asarray(JVampNetLM(dataclasses.replace(jcfg_file, compute_dtype="float32")).apply(
        {"params": jtree}, jnp.asarray(codes), jnp.asarray(cbs), method="forward_codes"))
    np.testing.assert_allclose(lm.forward_codes(_t(codes), _t(cbs)).numpy(), want,
                               rtol=2e-4, atol=2e-4)
    # the Interface's file loader (bf16 weights) serves it without controls
    served = _lm_from_file(path, None, torch.device("cpu"))
    assert served.config.ctrl_dims is None and not hasattr(served, "ctrl_encoder")
    got = served.forward_codes(_t(codes), _t(cbs)).float().numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    # a caller who sets ctrl_dims gets the control LM, its leaves loaded strictly
    ctrl_lm = _port_lm(dataclasses.replace(cfg32, ctrl_dims=tcfg.ctrl_dims), tree)
    for name in ("rms", "chroma"):
        np.testing.assert_array_equal(ctrl_lm.ctrl_encoder.state_dict()[f"ctrl_{name}.weight"],
                                      obj["state_dict"][f"ctrl_encoder.ctrl_encoders.{name}.weight"])


# ---------------------------------------------------------------- generate


@pytest.mark.parametrize("cfg_scale", [3.0, 0.0])
def test_generate_with_ctrls_cfg_token_identical_to_jax(cfg_scale):
    """The counterpart of `tests/test_control.py::test_generate_with_ctrls_cfg`
    at greedy settings with a prompt (see `test_torch_e2e.py`)."""
    jcfg, tcfg = _cfgs()
    params = ctrl_lm_params_np(jcfg, 5)
    codes, cbs, ctrls, masks = _ctrl_inputs(jcfg, b=2, t=24, seed=6)
    codes = np.minimum(codes, jcfg.vocab_size - 1)
    mask = np.ones_like(codes)
    mask[:, :, ::5] = 0
    kw = dict(sampling_steps=4, mask_temperature=0.0, sample_cutoff=-1.0,
              typical_filtering=True, typical_mass=0.3, typical_min_tokens=2,
              cfg_scale=cfg_scale)
    jmodel, jparams = JVampNetLM(jcfg), to_jax(params)
    want = np.asarray(jgenerate(
        lambda zm, c, cm: jmodel.apply({"params": jparams}, zm, jnp.asarray(cbs), c, cm,
                                       method="forward_codes"),
        jax.random.PRNGKey(0), jnp.asarray(codes), jnp.asarray(mask), jcfg.mask_token,
        ctrls=_jnp(ctrls), ctrl_masks=_jnp(masks), sampler_impl="xla", **kw))
    lm, tcbs = _port_lm(tcfg, params), _t(cbs)
    rows = []

    def forward(zm, c, cm):
        rows.append(zm.shape[0])
        return lm.forward_codes(zm, tcbs, ctrls=c, ctrl_masks=cm)

    with torch.inference_mode():
        got = generate(forward, _t(codes), _t(mask), tcfg.mask_token,
                       torch.Generator().manual_seed(0), ctrls=_tt(ctrls), ctrl_masks=_tt(masks),
                       **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert rows == [4] * 4  # each forward runs the conditioned and blank halves


# ---------------------------------------------------------------- training


def test_controller_train_step_matches_jax_step():
    """Loss, grad norm and every update of one step with a controller
    (rmsq16 and the median-filtered envelope; the chroma extractors are held
    above, and the JAX step's in-graph HPSS takes a minute to trace) at
    cfg_dropout_prob 0 and dropout 0, the port fed the JAX step's r, mask
    and control masks."""
    jcfg, tcfg = (dataclasses.replace(c, ctrl_dims=None) for c in _cfgs())
    keys = ["rmsq16", "rms-median"]
    jctl = J.Sketch2SoundController(keys, hop_length=32, sample_rate=16000)
    tctl = T.Sketch2SoundController(keys, hop_length=32, sample_rate=16000)
    dims = tuple(jctl.ctrl_dims.items())
    jcfg = dataclasses.replace(jcfg, ctrl_dims=dims, cfg_dropout_prob=0.0)
    tcfg = dataclasses.replace(tcfg, ctrl_dims=dims, cfg_dropout_prob=0.0)
    jccfg, tccfg = JCodecConfig(**CODEC_KW), CodecConfig(**CODEC_KW)
    lm_np, codec_np = ctrl_lm_params_np(jcfg, 7), codec_params_np(jccfg, 8)
    jcodec = JLAC(jccfg)
    cbs = np.asarray(jcodec.apply({"params": to_jax(codec_np)},
                                  method="codebook_tables"))[: jcfg.n_codebooks]
    b, t = 2, 80  # the envelope's reflect pad needs more than 1,024 samples
    audio = (0.3 * _wav(b, seconds=t * 32 / 16000, sr=16000, seed=9))[..., None]

    jopt = jstep.make_optimizer(jcfg.embedding_dim, factor=2.0, warmup=10)
    jstate = jstep.TrainState(to_jax(lm_np), jopt.init(to_jax(lm_np)), jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(2)
    # one traced program: eager dispatch of the JAX step takes three times as long
    jnew, jmetrics = jax.jit(jstep.make_train_step(JVampNetLM(jcfg), jcodec, jopt,
                                                   controller=jctl))(
        jstate, to_jax(codec_np), jnp.asarray(cbs), jnp.asarray(audio), key)
    # the JAX step's draws, split as the step splits its key
    k_r, k_mask, _k_drop, k_ctrl = jax.random.split(key, 4)
    jz = jax.jit(lambda p, a: jcodec.apply({"params": p}, a, method="encode")["codes"])(
        to_jax(codec_np), jnp.asarray(audio))[:, : jcfg.n_codebooks]
    r = jax.random.uniform(k_r, (b,))
    mask = jmask.random(k_mask, jz, r)
    jctrls = {k: v[:, :t] for k, v in jctl.extract(jnp.asarray(audio[..., 0])).items()}
    cmasks = {k: np.asarray(v[:, :t]) for k, v in jctl.random_mask(jctrls, r, k_ctrl).items()}

    codec = LAC(tccfg, device="cpu")
    codec.load_state_dict(convert.codec_state_dict_from_jax(codec_np, tccfg))
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(convert.lm_state_dict_from_jax(lm_np, tcfg))
    topt = make_optimizer(jcfg.embedding_dim, factor=2.0, warmup=10)
    state = TrainState.create(lm, topt)
    step = make_train_step(lm, codec, topt, controller=tctl)
    with torch.no_grad():
        z = codec.encode(_t(audio))[:, : jcfg.n_codebooks]
        ctrls = {k: v[:, :t] for k, v in tctl.extract(_t(audio[..., 0])).items()}
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    before = {k: v.clone() for k, v in lm.state_dict().items()}
    state, metrics = step.with_mask(state, _t(cbs), z, _t(r), _t(mask), None, ctrls,
                                    _tt(cmasks))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    delta = convert.lm_params_to_jax({k: v - before[k] for k, v in lm.state_dict().items()})
    jdelta = jax.tree.map(lambda a, b0: np.asarray(a) - np.asarray(b0), jnew.params,
                          to_jax(lm_np))
    jgrad = _flat(jax.tree.map(lambda m: np.asarray(m) / 0.1,
                               optax.tree_utils.tree_get(jnew.opt_state, "mu")))
    want, got = _flat(jdelta), _flat(delta)
    assert set(got) == set(want) and any(k[0] == "ctrl_encoder" for k in want)
    for k in want:
        # as tests/test_torch_train.py: Adam's first update where |g| >= 100 eps
        sel = np.abs(jgrad[k]) >= 1e-6
        assert (~sel).sum() <= max(0.01 * sel.size, 32), (k, int((~sel).sum()))
        assert _rel(got[k][sel], want[k][sel]) <= 1e-4, k

    # the whole step with its own draws: the controls reach the encoder
    state2 = TrainState.create(lm, topt)
    enc0 = lm.ctrl_encoder.state_dict()["ctrl_rmsq16.weight"].clone()
    _, m2 = step(state2, _t(cbs), _t(audio), torch.Generator().manual_seed(0))
    assert np.isfinite(float(m2["loss"]))
    assert not torch.equal(lm.ctrl_encoder.state_dict()["ctrl_rmsq16.weight"], enc0)
