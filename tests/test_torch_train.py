"""Port parity: the training step (`vampnet_tpu_torch/train/`, the training
masks, dropout and the reverse weight bridge) against the JAX package's
`make_train_step` and its pieces, on one numpy param tree.

Tiny shapes: 2 layers, d = 128, 2 heads of 64, fp32 compute, dropout 0, the
tiny codec of `test_torch_util`. The JAX step draws r and the mask with
`jax.random`; the test draws them the same way (the keys split as the step
splits them) and hands them to the port's `train_step.with_mask`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_util import CODEC_KW, codec_params_np, lm_params_np, to_jax
from vampnet_tpu import mask as jmask
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.train import step as jstep
from vampnet_tpu.train.scheduler import noam_schedule as jnoam
from vampnet_tpu.util import codebook_flatten as jflatten
from vampnet_tpu_torch import convert
from vampnet_tpu_torch import mask as tmask
from vampnet_tpu_torch.codec import LAC, CodecConfig
from vampnet_tpu_torch.modules import LMConfig, VampNetLM
from vampnet_tpu_torch.modules.transformer import dropout
from vampnet_tpu_torch.train import (
    TrainState,
    loss_and_grads,
    loss_and_metrics,
    make_optimizer,
    make_train_step,
    noam_schedule,
)

TRAIN_KW = dict(n_heads=2, n_layers=2, latent_dim=4, embedding_dim=128, vocab_size=64,
                n_codebooks=4)


def _lm_configs(ncc, lora_r=0):
    kw = dict(TRAIN_KW, n_conditioning_codebooks=ncc, compute_dtype="float32", lora_r=lora_r)
    return JLMConfig(dropout=0.0, **kw), LMConfig(dropout=0.0, **kw)


def _flat(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _rel(a, b):
    """Relative Frobenius error of a against b."""
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("step", [0, 1, 10, 10_000])
def test_noam_schedule_matches_jax(step):
    want = float(jnoam(1280, factor=2.0, warmup=10000)(jnp.asarray(step)))
    # both compute in fp32
    np.testing.assert_allclose(noam_schedule(1280, factor=2.0, warmup=10000)(step), want,
                               rtol=1e-6)


def test_loss_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    b, t, c, v = 2, 6, 3, 40
    logits = (rng.standard_normal((b, t, c, v)) * 3.0).astype(np.float32)
    target = rng.integers(0, v, (b, c, t))
    flat_mask = rng.integers(0, 2, (b, t * c))
    r = np.array([0.2, 0.7], np.float32)
    jl, jm = jstep.loss_and_metrics(jnp.asarray(logits), jnp.asarray(target),
                                    jnp.asarray(flat_mask), jnp.asarray(r))
    tl, tm = loss_and_metrics(_t(logits), _t(target), _t(flat_mask), _t(r))
    assert set(tm) == set(jm)
    # fp32 reductions in different orders
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for name in jm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_apply_mask_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 64, (3, 4, 17))
    m = rng.integers(0, 2, (3, 4, 17))
    jx, jm = jmask.apply_mask(jnp.asarray(x), jnp.asarray(m), 64)
    tx, tm = tmask.apply_mask(_t(x), _t(m), 64)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_random_mask_rate_follows_gamma():
    x = torch.zeros((4, 4, 2000), dtype=torch.int64)
    r = torch.tensor([0.0, 0.3, 0.6, 0.95])
    g = torch.Generator().manual_seed(0)
    share = tmask.random(g, x, r).float().mean(dim=(1, 2))
    p = tmask._gamma(r)
    sigma = torch.sqrt(p * (1 - p) / (4 * 2000))
    # a Bernoulli share over 8000 draws: within 3 standard deviations
    assert bool(((share - p).abs() <= 3 * sigma + 1e-7).all()), (share, p)


def test_dropout_keeps_one_minus_p_and_scales():
    x = torch.ones(200_000)
    p = 0.1
    y = dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / x.numel())
    # Flax semantics: the kept values are x / (1 - p), in x's dtype
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), np.float32(1) / np.float32(0.9)))
    assert torch.equal(dropout(x, p, None), x) and torch.equal(dropout(x, 0.0, torch.Generator()), x)


def test_lm_dropout_needs_a_generator_and_changes_the_output():
    cfg = LMConfig(**dict(TRAIN_KW, compute_dtype="float32"))  # dropout 0.1
    lm = VampNetLM(cfg, device="cpu")
    torch.manual_seed(0)
    for prm in lm.parameters():
        torch.nn.init.normal_(prm, std=0.1)
    codes = torch.randint(0, 64, (1, 4, 12))
    cbs = torch.randn(4, 64, 4)
    # no generator: no dropout, the inference forward
    base = lm.forward_codes(codes, cbs)
    no_drop = dataclasses.replace(cfg, dropout=0.0)
    lm0 = VampNetLM(no_drop, device="cpu")
    lm0.load_state_dict(lm.state_dict())
    assert torch.equal(base, lm0.forward_codes(codes, cbs, generator=torch.Generator()))
    a = lm.forward_codes(codes, cbs, generator=torch.Generator().manual_seed(1))
    b = lm.forward_codes(codes, cbs, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, base)


@pytest.mark.parametrize("grad_scale", [1.0, 50.0])
def test_optimizer_updates_match_optax(grad_scale):
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((16, 24)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 0.05 * grad_scale).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    norm0 = np.sqrt(sum(float((g ** 2).sum()) for g in grads[0].values()))
    assert (norm0 > 5.0) == (grad_scale > 1.0)  # one case clips, one does not

    # warmup=1: the first update runs at noam(1), large enough to measure
    jopt = jstep.make_optimizer(128, factor=2.0, warmup=1)
    topt = make_optimizer(128, factor=2.0, warmup=1)
    jparams = to_jax(params)
    jstate = jopt.init(jparams)
    tparams = [_t(params[k]) for k in ("a", "b")]
    tstate = topt.init(tparams)
    for g in grads:
        jupd, jstate = jopt.update(to_jax(g), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        before = [p.clone() for p in tparams]
        norm = topt.update([_t(g[k]) for k in ("a", "b")], tstate, tparams)
        np.testing.assert_allclose(float(norm), np.sqrt(sum(float((x ** 2).sum())
                                                            for x in g.values())), rtol=1e-6)
        for k, p, p0 in zip(("a", "b"), tparams, before):
            # the same fp32 arithmetic in another operation order
            assert _rel((p - p0).numpy(), jupd[k]) <= 1e-5, k
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- the step


def _setup(ncc, seed=0, lora_r=0):
    jcfg, tcfg = _lm_configs(ncc, lora_r)
    jccfg, tccfg = JCodecConfig(**CODEC_KW), CodecConfig(**CODEC_KW)
    lm_np, codec_np = lm_params_np(jcfg, seed), codec_params_np(jccfg, seed + 1)
    lm = VampNetLM(tcfg, device="cpu")
    lm.load_state_dict(convert.lm_state_dict_from_jax(lm_np, tcfg), strict=True)
    codec = LAC(tccfg, device="cpu")
    codec.load_state_dict(convert.codec_state_dict_from_jax(codec_np, tccfg), strict=True)
    codec.requires_grad_(False)
    jcodec = JLAC(jccfg)
    cbs = np.asarray(jcodec.apply({"params": to_jax(codec_np)},
                                  method="codebook_tables"))[: jcfg.n_codebooks]
    return jcfg, JVampNetLM(jcfg), jcodec, lm, codec, lm_np, codec_np, cbs


def _grads_tree(model, grads):
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return convert.lm_params_to_jax(dict(zip(names, grads)))


def test_reverse_bridge_round_trips():
    jcfg, tcfg = _lm_configs(0)
    lm_np = lm_params_np(jcfg, 3)
    back = convert.lm_params_to_jax(convert.lm_state_dict_from_jax(lm_np, tcfg))
    want, got = _flat(lm_np), _flat(back)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


@pytest.mark.parametrize("ncc,lora_r", [pytest.param(0, 0, id="0"), pytest.param(2, 0, id="2"),
                                         pytest.param(0, 2, id="0-lora_r2")])
def test_loss_and_grads_match_jax_value_and_grad(ncc, lora_r):
    jcfg, jlm, _jcodec, lm, _codec, lm_np, _codec_np, cbs = _setup(ncc, seed=4, lora_r=lora_r)
    rng = np.random.default_rng(5)
    b, t = 2, 24
    z = rng.integers(0, jcfg.vocab_size, (b, jcfg.n_codebooks, t))
    mask = rng.integers(0, 2, z.shape)
    r = rng.uniform(0, 1, (b,)).astype(np.float32)
    mask = np.asarray(jmask.codebook_unmask(jnp.asarray(mask), ncc))
    z_masked, mask = (np.asarray(x) for x in jmask.apply_mask(jnp.asarray(z), jnp.asarray(mask),
                                                              jcfg.mask_token))
    target = z[:, ncc:, :]
    flat_mask = np.asarray(jflatten(jnp.asarray(mask[:, ncc:, :])))

    def jloss(params):
        logits = jlm.apply({"params": params}, jnp.asarray(z_masked), jnp.asarray(cbs), None,
                           None, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
                           method="forward_codes")
        return jstep.loss_and_metrics(logits, jnp.asarray(target), jnp.asarray(flat_mask),
                                      jnp.asarray(r))

    (jl, _jm), jg = jax.value_and_grad(jloss, has_aux=True)(to_jax(lm_np))
    tl, _tm, tg = loss_and_grads(lm, _t(z_masked), _t(cbs), _t(target), _t(flat_mask), _t(r))
    # fp32 forward and backward through 2 layers, different summation orders
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want, got = _flat(jg), _flat(_grads_tree(lm, tg))
    assert set(got) == set(want)
    for key in want:
        assert _rel(got[key], want[key]) <= 1e-4, (key, _rel(got[key], want[key]))


@pytest.mark.parametrize("ncc", [0, 2])
def test_train_step_matches_jax_step(ncc):
    jcfg, jlm, jcodec, lm, codec, lm_np, codec_np, cbs = _setup(ncc, seed=6)
    b = 2
    audio = (np.random.default_rng(7).standard_normal((b, 32 * 24, 1)) * 0.1).astype(np.float32)
    jopt = jstep.make_optimizer(jcfg.embedding_dim, factor=2.0, warmup=10)
    jstate = jstep.TrainState(to_jax(lm_np), jopt.init(to_jax(lm_np)), jnp.zeros((), jnp.int32))
    # key 2 draws r = (0.636, 0.643): each row keeps about half its tokens.
    # A row whose every token is masked feeds attention identical values, so
    # the bias table's gradient is zero up to rounding (~1e-10) in either
    # package, and Adam's first step, g / (|g| + eps), turns that rounding
    # into full-size updates of either sign.
    key = jax.random.PRNGKey(2)
    jnew, jmetrics = jstep.make_train_step(jlm, jcodec, jopt)(
        jstate, to_jax(codec_np), jnp.asarray(cbs), jnp.asarray(audio), key)

    # the JAX step's draws, split as the step splits its key
    k_r, k_mask, _k_drop, _k_ctrl = jax.random.split(key, 4)
    jz = jcodec.apply({"params": to_jax(codec_np)}, jnp.asarray(audio),
                      method="encode")["codes"][:, : jcfg.n_codebooks]
    r = jax.random.uniform(k_r, (b,))
    mask = jmask.random(k_mask, jz, r)

    topt = make_optimizer(jcfg.embedding_dim, factor=2.0, warmup=10)
    state = TrainState.create(lm, topt)
    step = make_train_step(lm, codec, topt)
    with torch.no_grad():
        z = codec.encode(_t(audio))[:, : jcfg.n_codebooks]
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))  # the port's encode
    before = {k: v.clone() for k, v in lm.state_dict().items()}
    state, metrics = step.with_mask(state, _t(cbs), z, _t(r), _t(mask))
    assert state.step == 1 and state.opt_state.count == 1

    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    delta = convert.lm_params_to_jax({k: v - before[k] for k, v in lm.state_dict().items()})
    jdelta = jax.tree.map(lambda a, b0: np.asarray(a) - np.asarray(b0), jnew.params,
                          to_jax(lm_np))
    want, got = _flat(jdelta), _flat(delta)
    # the JAX step's clipped gradient, from its first moment (1 - b1) g
    jgrad = _flat(jax.tree.map(lambda m: np.asarray(m) / 0.1,
                               optax.tree_utils.tree_get(jnew.opt_state, "mu")))
    assert set(got) == set(want) == set(jgrad)
    for key in want:
        # Adam's first update is -lr (g / (|g| + eps) + wd p): where |g| is
        # near eps = 1e-8 it turns the gradients' rounding differences
        # (about 1e-6 relative, see the test above) into update differences
        # of up to lr. Hold the updates where |g| >= 100 eps, and check that
        # those are all but a few of each leaf's elements.
        sel = np.abs(jgrad[key]) >= 1e-6
        assert (~sel).sum() <= max(0.01 * sel.size, 32), (key, int((~sel).sum()))
        err = _rel(got[key][sel], want[key][sel])
        assert err <= 1e-4, (key, err)


def test_train_step_draws_and_runs_with_dropout():
    """The whole step with its own draws and dropout on: finite loss, grad
    norm and params, every parameter moved, reproducible from the seed."""
    _jcfg, tcfg = _lm_configs(0)
    tcfg = dataclasses.replace(tcfg, dropout=0.1)
    _, _, _, _, codec, lm_np, _, cbs = _setup(0, seed=8)
    audio = _t((np.random.default_rng(9).standard_normal((2, 32 * 16, 1)) * 0.1)
               .astype(np.float32))

    def run():
        lm = VampNetLM(tcfg, device="cpu")
        lm.load_state_dict(convert.lm_state_dict_from_jax(lm_np, tcfg))
        opt = make_optimizer(tcfg.embedding_dim, warmup=10)
        state = TrainState.create(lm, opt)
        step = make_train_step(lm, codec, opt)
        g = torch.Generator().manual_seed(0)
        metrics = [step(state, _t(cbs), audio, g)[1] for _ in range(2)]
        return lm, metrics

    lm, metrics = run()
    _, metrics2 = run()
    for m, m2 in zip(metrics, metrics2):
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
        assert float(m["loss"]) == float(m2["loss"])
    init = convert.lm_state_dict_from_jax(lm_np, tcfg)
    for name, p in lm.state_dict().items():
        assert torch.isfinite(p).all() and not torch.equal(p, init[name]), name


class _IndexBias:
    """`RelativePositionBias`'s forward left to autograd: the gather's
    gradient is then the index backward through `table[buckets]`."""

    @staticmethod
    def apply(table, offset_buckets, t_q, t_k):
        from vampnet_tpu_torch.ops.relative_bias import bucket_index

        return table[bucket_index(offset_buckets, t_q, t_k)].permute(2, 0, 1).contiguous()


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_train_step_table_gradient_matches_autograd_index_path(remat, monkeypatch):
    """One coarse step whose bias is `RelativePositionBias` (its backward
    called once) against the same step with the bias left to autograd's
    index backward through `table[buckets]`: the same loss, bit for bit (the
    forward gathers the same values), and the bucket table's gradient, read
    from Adam's first moment (1 - b1) g, within fp32 reorder."""
    from vampnet_tpu_torch.modules import transformer as ttr
    from vampnet_tpu_torch.ops import relative_bias as rb

    _jcfg, tcfg = _lm_configs(0)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    _, _, _, _, codec, lm_np, _, cbs = _setup(0, seed=10)
    rng = np.random.default_rng(11)
    z = _t(rng.integers(0, tcfg.vocab_size, (2, tcfg.n_codebooks, 40)))
    mask = _t(rng.integers(0, 2, z.shape))
    r = torch.tensor([0.3, 0.6])
    calls = []
    grad = rb.relative_bias_grad
    monkeypatch.setattr(rb, "relative_bias_grad",
                        lambda *a, **kw: calls.append(1) or grad(*a, **kw))

    def step():
        lm = VampNetLM(tcfg, device="cpu")
        lm.load_state_dict(convert.lm_state_dict_from_jax(lm_np, tcfg))
        opt = make_optimizer(tcfg.embedding_dim, warmup=10)
        state = TrainState.create(lm, opt)
        state, metrics = make_train_step(lm, codec, opt).with_mask(state, _t(cbs), z, r, mask)
        table = lm.transformer.layers_0.self_attn.relative_attention_bias
        return float(metrics["loss"]), state.opt_state.adamw.state[table]["exp_avg"] / 0.1

    loss, g = step()
    assert len(calls) == 1
    with monkeypatch.context() as m:
        m.setattr(ttr, "RelativePositionBias", _IndexBias)
        loss_index, g_index = step()
    assert len(calls) == 1
    assert loss == loss_index
    # both sum each bucket's fp32 terms, only in another order (read 1.9e-7)
    assert float((g - g_index).norm() / g_index.norm()) <= 1e-5


def test_train_step_records_forward_backward_optimizer_spans():
    """While tracing, a step records `train.forward`, `train.backward` and
    `train.optimizer` once each, in that order, none inside another."""
    from vampnet_tpu_torch import profiling

    _jcfg, tcfg = _lm_configs(0)
    _, _, _, lm, codec, _, _, cbs = _setup(0, seed=3)
    opt = make_optimizer(tcfg.embedding_dim, warmup=10)
    state = TrainState.create(lm, opt)
    step = make_train_step(lm, codec, opt)
    audio = _t((np.random.default_rng(4).standard_normal((2, 32 * 16, 1)) * 0.1)
               .astype(np.float32))
    profiling.clear()
    profiling.enable()
    try:
        step(state, _t(cbs), audio, torch.Generator().manual_seed(0))
    finally:
        profiling.disable()
    recs = profiling.records()
    profiling.clear()
    assert [r.name for r in recs] == ["train.forward", "train.backward", "train.optimizer"]
    assert all(r.parent is None and r.end_ns >= r.start_ns for r in recs)
    assert all(a.end_ns <= b.start_ns for a, b in zip(recs, recs[1:]))
