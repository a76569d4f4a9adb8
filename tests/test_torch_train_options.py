"""Port parity: the training step's options (`train/step.py`,
`modules/transformer.py`) against the JAX package's: bf16 Adam moments
(`_scale_by_adam_lowmem`), fp32 `state_dtype`, LoRA-only updates
(`multi_transform` with `set_to_zero`), `LMConfig.remat` with dropout drawn
from an explicit generator, `encode_microbatch`, and a c2f step
(`n_conditioning_codebooks` > 0) with remat and bf16 moments against the JAX
step through `with_mask`.

Inputs come from numpy seeds; each tolerance is stated where it is asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import TRAIN_KW, _flat, _rel, _t
from test_torch_util import CODEC_KW, codec_params_np, lm_params_np, to_jax
from vampnet_tpu import mask as jmask
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.modules.lora import lora_param_filter as jlora_param_filter
from vampnet_tpu.train import step as jstep
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.codec import LAC, CodecConfig
from vampnet_tpu_torch.modules import LMConfig, VampNetLM
from vampnet_tpu_torch.train import (
    TrainState,
    lora_filter,
    loss_and_grads,
    make_optimizer,
    make_train_step,
)

KEYS = ("a", "b", "lora_a", "lora_b")


def _opt_problem(seed, grad_scale, n_steps=3):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((16, 24)), "b": rng.standard_normal((7,)),
              "lora_a": 0.3 * rng.standard_normal((16, 4)),
              "lora_b": 0.3 * rng.standard_normal((4, 24))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = [{k: (rng.standard_normal(v.shape) * 0.05 * grad_scale).astype(np.float32)
              for k, v in params.items()} for _ in range(n_steps)]
    return params, grads


def _run_both(params, grads, jopt, topt):
    """Apply `grads` through the JAX and the port's optimizers; yields, per
    update, (the JAX update tree, the port's params before, after)."""
    jparams = to_jax(params)
    jstate = jopt.init(jparams)
    tparams = [_t(params[k]) for k in KEYS]
    tstate = topt.init(tparams)
    for g in grads:
        jupd, jstate = jopt.update(to_jax(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        before = [p.clone() for p in tparams]
        norm = topt.update([_t(g[k]) for k in KEYS], tstate, tparams)
        # grad_norm is the norm of every gradient, clipped or frozen or not
        np.testing.assert_allclose(float(norm), float(optax.global_norm(to_jax(g))), rtol=1e-6)
        yield jupd, jparams, before, tparams, tstate


@pytest.mark.parametrize("grad_scale", [1.0, 50.0], ids=["no-clip", "clip"])
def test_bf16_moments_match_jax_chain(grad_scale):
    # warmup=1: the first update runs at noam(1), large enough to measure
    jopt = jstep.make_optimizer(128, factor=2.0, warmup=1, state_dtype="bfloat16")
    topt = make_optimizer(128, factor=2.0, warmup=1, state_dtype="bfloat16")
    params, grads = _opt_problem(2, grad_scale, n_steps=4)
    for jupd, jparams, before, tparams, tstate in _run_both(params, grads, jopt, topt):
        for k, p, p0 in zip(KEYS, tparams, before):
            # fp32 moment math in another operation order: the moments agree
            # to an fp32 ulp before their rounding to bf16, which then agrees
            # but where the two straddle a bf16 rounding boundary
            assert _rel((p - p0).numpy(), jupd[k]) <= 1e-3, (k, _rel((p - p0).numpy(), jupd[k]))
    jmu = optax.tree_utils.tree_get(jopt.init(to_jax(params)), "mu")
    assert all(m.dtype == jnp.bfloat16 for m in jax.tree.leaves(jmu))
    assert all(m.dtype == torch.bfloat16 for m in tstate.mu + tstate.nu)
    assert tstate.adamw is None and tstate.count == 4


def test_fp32_state_dtype_is_the_existing_optimizer():
    params, grads = _opt_problem(3, 50.0)
    runs = []
    for state_dtype in (None, "float32", torch.float32):
        opt = make_optimizer(128, factor=2.0, warmup=1, state_dtype=state_dtype)
        ps = [_t(params[k]) for k in KEYS]
        st = opt.init(ps)
        assert st.adamw is not None
        for g in grads:
            opt.update([_t(g[k]) for k in KEYS], st, ps)
        runs.append(ps)
    for ps in runs[1:]:
        for a, b in zip(ps, runs[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1.0, 50.0], ids=["no-clip", "clip"])
def test_lora_only_updates_match_jax_multi_transform(state_dtype, grad_scale):
    params, grads = _opt_problem(4, grad_scale)
    jfilter = jlora_param_filter(to_jax(params))
    jopt = jstep.make_optimizer(128, factor=2.0, warmup=1, lora_filter=jfilter,
                                state_dtype=state_dtype)
    topt = make_optimizer(128, factor=2.0, warmup=1, lora_filter=[k.startswith("lora")
                                                                   for k in KEYS],
                          state_dtype=state_dtype)
    # the clip norm is the adapters' alone: with grad_scale 50 the adapters'
    # norm clips, with 1 it does not (the frozen leaves' would not change that)
    adapter_norm = np.sqrt(sum(float((grads[0][k] ** 2).sum()) for k in ("lora_a", "lora_b")))
    assert (adapter_norm > 5.0) == (grad_scale > 1.0)
    for jupd, jparams, before, tparams, tstate in _run_both(params, grads, jopt, topt):
        for k, p, p0 in zip(KEYS, tparams, before):
            if not k.startswith("lora"):
                assert torch.equal(p, p0), k  # frozen: bitwise unchanged
                np.testing.assert_array_equal(np.asarray(jupd[k]), 0.0)
                continue
            tol = 1e-5 if state_dtype == "float32" else 1e-3  # as the two tests above
            assert _rel((p - p0).numpy(), jupd[k]) <= tol, (k, _rel((p - p0).numpy(), jupd[k]))
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-5, atol=1e-6)
    # moments only for the adapters
    n_moments = len(tstate.mu) if tstate.adamw is None else len(tstate.adamw.state)
    assert n_moments == 2


def test_lora_filter_marks_the_adapters():
    lm = VampNetLM(LMConfig(**dict(TRAIN_KW, lora_r=2)), device="meta")
    names = [n for n, p in lm.named_parameters() if p.requires_grad]
    flags = lora_filter(lm)
    assert len(flags) == len(names) and sum(flags) == 2 * 5 * TRAIN_KW["n_layers"]
    assert all(f == n.endswith(("lora_a", "lora_b")) for f, n in zip(flags, names))
    with pytest.raises(ValueError, match="no parameter to train"):
        make_optimizer(128, lora_filter=[False] * 3).init([torch.zeros(2)] * 3)


def _lm_pair(ncc=0, **kw):
    jcfg = JLMConfig(**dict(TRAIN_KW, n_conditioning_codebooks=ncc, compute_dtype="float32",
                            dropout=0.0))
    tcfg = LMConfig(**dict(TRAIN_KW, n_conditioning_codebooks=ncc, compute_dtype="float32",
                           **kw))
    return jcfg, tcfg


def _port_lm(tcfg, lm_np):
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(convert.lm_state_dict_from_jax(lm_np, tcfg), strict=True)
    return lm


def test_remat_gradients_equal_without_remat_with_dropout_and_a_generator():
    jcfg, tcfg = _lm_pair(dropout=0.1)
    lm_np = lm_params_np(jcfg, 11)
    rng = np.random.default_rng(12)
    b, t = 2, 24
    z = _t(rng.integers(0, 64, (b, 4, t)))
    cbs = _t(rng.standard_normal((4, 64, 4)).astype(np.float32))
    flat_mask = _t(rng.integers(0, 2, (b, t * 4)))
    r = _t(np.array([0.3, 0.8], np.float32))
    runs = {}
    for remat in (False, True):
        lm = _port_lm(dataclasses.replace(tcfg, remat=remat), lm_np)
        gen = torch.Generator().manual_seed(7)
        loss, _, grads = loss_and_grads(lm, z, cbs, z, flat_mask, r, generator=gen)
        after = torch.rand(4, generator=gen)  # the generator's next draws
        runs[remat] = (loss, grads, after)
    (l0, g0, a0), (l1, g1, a1) = runs[False], runs[True]
    # the recompute redraws the forward's dropout masks: the same CPU
    # arithmetic on the same activations, bit for bit
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for x, y in zip(g0, g1):
        assert torch.equal(x, y)
    # and the caller's generator ends where it ends without remat
    assert torch.equal(a0, a1)
    # a recompute from the advanced generator would have drawn other masks
    assert not torch.equal(torch.rand(4, generator=torch.Generator().manual_seed(7)), a0)


def _codec_pair(seed):
    jccfg, tccfg = JCodecConfig(**CODEC_KW), CodecConfig(**CODEC_KW)
    codec_np = codec_params_np(jccfg, seed)
    codec = LAC(tccfg, device="cpu")
    codec.load_state_dict(convert.codec_state_dict_from_jax(codec_np, tccfg), strict=True)
    return JLAC(jccfg), codec_np, codec.requires_grad_(False)


def test_encode_microbatch_codes_and_step_equal_the_full_encode():
    _, tcfg = _lm_pair(dropout=0.1)
    lm_np = lm_params_np(_lm_pair()[0], 13)
    _jcodec, _codec_np, codec = _codec_pair(14)
    audio = _t((np.random.default_rng(15).standard_normal((4, 32 * 16, 1)) * 0.1)
               .astype(np.float32))
    full = codec.encode(audio)
    parts = torch.cat([codec.encode(a) for a in audio.split(2)])
    np.testing.assert_array_equal(parts.numpy(), full.numpy())
    cbs = codec.codebook_tables()[:4].detach()
    results = {}
    for mb in (None, 1, 2, 4):
        lm = _port_lm(tcfg, lm_np)
        opt = make_optimizer(tcfg.embedding_dim, warmup=10)
        state = TrainState.create(lm, opt)
        step = make_train_step(lm, codec, opt, encode_microbatch=mb)
        _, metrics = step(state, cbs, audio, torch.Generator().manual_seed(0))
        results[mb] = (float(metrics["loss"]), [p.clone() for p in state.params])
    for mb in (1, 2, 4):
        assert results[mb][0] == results[None][0]
        assert all(torch.equal(a, b) for a, b in zip(results[mb][1], results[None][1]))
    step = make_train_step(lm, codec, opt, encode_microbatch=3)
    with pytest.raises(ValueError, match="must divide the batch"):
        step(state, cbs, audio, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("state_dtype,remat", [(None, False), ("bfloat16", True)],
                         ids=["fp32", "bf16-moments-remat"])
def test_c2f_step_matches_jax_step(state_dtype, remat):
    ncc = 2
    jcfg, tcfg = _lm_pair(ncc, dropout=0.0, remat=remat)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    lm_np = lm_params_np(jcfg, 16)
    jcodec, codec_np, codec = _codec_pair(17)
    cbs = np.asarray(jcodec.apply({"params": to_jax(codec_np)},
                                  method="codebook_tables"))[: jcfg.n_codebooks]
    b = 2
    audio = (np.random.default_rng(18).standard_normal((b, 32 * 24, 1)) * 0.1).astype(np.float32)
    jopt = jstep.make_optimizer(jcfg.embedding_dim, factor=2.0, warmup=10,
                                state_dtype=state_dtype)
    jstate = jstep.TrainState(to_jax(lm_np), jopt.init(to_jax(lm_np)), jnp.zeros((), jnp.int32))
    # key 2: each row keeps about half its tokens (tests/test_torch_train.py)
    key = jax.random.PRNGKey(2)
    jnew, jmetrics = jstep.make_train_step(JVampNetLM(jcfg), jcodec, jopt)(
        jstate, to_jax(codec_np), jnp.asarray(cbs), jnp.asarray(audio), key)
    k_r, k_mask, _k_drop, _k_ctrl = jax.random.split(key, 4)
    jz = jcodec.apply({"params": to_jax(codec_np)}, jnp.asarray(audio),
                      method="encode")["codes"][:, : jcfg.n_codebooks]
    r = jax.random.uniform(k_r, (b,))
    mask = jmask.random(k_mask, jz, r)

    lm = _port_lm(tcfg, lm_np)
    topt = make_optimizer(tcfg.embedding_dim, factor=2.0, warmup=10, state_dtype=state_dtype)
    state = TrainState.create(lm, topt)
    z = codec.encode(_t(audio))[:, : jcfg.n_codebooks]
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    before = {k: v.clone() for k, v in lm.state_dict().items()}
    state, metrics = make_train_step(lm, codec, topt).with_mask(state, _t(cbs), z, _t(r),
                                                                _t(mask))
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    delta = _flat(convert.lm_params_to_jax({k: v - before[k] for k, v in lm.state_dict().items()}))
    jdelta = _flat(jax.tree.map(lambda a, b0: np.asarray(a) - np.asarray(b0), jnew.params,
                                to_jax(lm_np)))
    jgrad = _flat(jax.tree.map(lambda m: np.asarray(m, np.float32) / 0.1,
                               optax.tree_utils.tree_get(jnew.opt_state, "mu")))
    assert set(delta) == set(jdelta) == set(jgrad)
    for key_ in jdelta:
        # as tests/test_torch_train.py: hold the updates where |g| >= 100 eps
        # (Adam's first step turns rounding near eps into full-size updates);
        # bf16 moments add their rounding of g (2^-9) to the tolerance
        sel = np.abs(jgrad[key_]) >= 1e-6
        assert (~sel).sum() <= max(0.01 * sel.size, 32), (key_, int((~sel).sum()))
        err = _rel(delta[key_][sel], jdelta[key_][sel])
        assert err <= (1e-4 if state_dtype is None else 1e-2), (key_, err)
