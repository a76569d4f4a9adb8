"""Port parity: the sharded training step (`train/step.py`
`ShardedTrainState`, `make_sharded_train_step`; `parallel/train_placement.py`)
over meshes that repeat the CPU, against the JAX package's sharded step on
its 8 forced host devices and against the port's unsharded step.

Tiny shapes: `tests/test_torch_train.py`'s LM (2 layers, d = 128, 2 heads of
64, 4 codebooks), fp32 compute, dropout 0 wherever two runs are compared.
Both steps are handed the same r and mask. Tolerances are stated where
they are asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from test_torch_util import CODEC_KW, codec_params_np, lm_params_np, to_jax
from vampnet_tpu import mask as jmask
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu.codec import CodecConfig as JCodecConfig
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.parallel import lm_param_specs as jlm_param_specs
from vampnet_tpu.parallel import make_mesh as jmake_mesh
from vampnet_tpu.parallel import opt_state_specs as jopt_state_specs
from vampnet_tpu.parallel import zero1_specs as jzero1_specs
from vampnet_tpu.train import step as jstep
from vampnet_tpu_torch import convert
from vampnet_tpu_torch import mask as tmask
from vampnet_tpu_torch.codec import LAC, CodecConfig
from vampnet_tpu_torch.modules import LMConfig, VampNetLM
from vampnet_tpu_torch.parallel import lm_param_specs, make_train_mesh, tp_dim, zero1_specs
from vampnet_tpu_torch.parallel.train_placement import ShardedLM, held_at
from vampnet_tpu_torch.train import TrainState, make_optimizer, make_train_step
from vampnet_tpu_torch.train.step import (ShardedTrainState, _group_generator, lora_filter,
                                          make_sharded_train_step)

TRAIN_KW = dict(n_heads=2, n_layers=2, latent_dim=4, embedding_dim=128, vocab_size=64,
                n_codebooks=4, n_conditioning_codebooks=0)
ZERO1_MIN = 2 ** 10  # small enough that the tiny LM's large tensors split over dp


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jcfg = JLMConfig(dropout=0.0, compute_dtype="float32", **TRAIN_KW)
    tcfg = LMConfig(dropout=0.0, compute_dtype="float32", **TRAIN_KW)
    jccfg, tccfg = JCodecConfig(**CODEC_KW), CodecConfig(**CODEC_KW)
    lm_np, codec_np = lm_params_np(jcfg, 11), codec_params_np(jccfg, 12)
    sd = convert.lm_state_dict_from_jax(lm_np, tcfg)
    codec = LAC(tccfg, device="cpu")
    codec.load_state_dict(convert.codec_state_dict_from_jax(codec_np, tccfg), strict=True)
    codec.requires_grad_(False)
    jcodec = JLAC(jccfg)
    cbs = np.asarray(jcodec.apply({"params": to_jax(codec_np)},
                                  method="codebook_tables"))[: jcfg.n_codebooks]
    audio = (np.random.default_rng(13).standard_normal((8, 32 * 24, 1)) * 0.1).astype(np.float32)
    with torch.no_grad():
        z = codec.encode(_t(audio))[:, : tcfg.n_codebooks]
    return dict(jcfg=jcfg, tcfg=tcfg, lm_np=lm_np, codec_np=codec_np, sd=sd, codec=codec,
                jcodec=jcodec, cbs=cbs, audio=audio, z=z)


def _mesh(dp, tp):
    return make_train_mesh(dp, tp, ["cpu"] * (dp * tp), process=(0, 1))


def _unsharded(s, cfg, opt, z, r, mask, **step_kw):
    lm = VampNetLM(cfg, device="cpu")
    lm.load_state_dict(s["sd"], strict=True)
    state = TrainState.create(lm, opt)
    state, metrics = make_train_step(lm, s["codec"], opt, **step_kw).with_mask(
        state, _t(s["cbs"]), z, r, mask)
    adam = state.opt_state
    if adam.adamw is not None:
        mu = [adam.adamw.state[p]["exp_avg"] for p in opt._trained(state.params)]
    else:
        mu = [m.float() for m in adam.mu]
    names = [n for n, p in lm.named_parameters() if p.requires_grad]
    trained = names if opt.lora_filter is None else \
        [n for n, k in zip(names, opt.lora_filter) if k]
    # the clipped gradient, from the first moment (1 - b1) g
    return lm.state_dict(), metrics, dict(zip(trained, [m / 0.1 for m in mu]))


def _draws(s, b, seed=3):
    g = torch.Generator().manual_seed(seed)
    z = s["z"][:b]
    r = torch.rand((b,), generator=g)
    return z, r, tmask.random(g, z, r)


def _assert_updates_match(after, want, grads, label, mu=None, mu_tol=1e-5):
    """Updated parameters equal wherever the parameter's gradient exceeds
    1e-6 (below that, Adam's first step g / (|g| + 1e-8) turns the gradient
    sums' rounding into updates of either sign), to 1e-6 absolute (1.3e-4
    of the first update's size, lr = 7.9e-3: near |g| = 1e-6 the update
    moves by lr eps / |g| times the gradient's relative rounding); and the
    first moments, 0.1 g (a gradient fault that keeps g's sign leaves
    Adam's first update alone), to 1e-5 relative (Frobenius) per tensor
    (`mu_tol`)."""
    for name, w in want.items():
        got = after[name]
        sel = grads[name].abs() > 1e-6 if name in grads else torch.ones_like(w, dtype=torch.bool)
        np.testing.assert_allclose(got[sel].numpy(), w[sel].numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"{label}: {name}")
    for name, m in (mu or {}).items():
        err = _rel(m.float().numpy(), 0.1 * grads[name].numpy())
        assert err <= mu_tol, (label, name, err)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_sharded_step_matches_unsharded(setup, dp, tp):
    s = setup
    cfg = s["tcfg"]
    opt = make_optimizer(cfg.embedding_dim, warmup=10)
    z, r, mask = _draws(s, 8)
    want, m1, grads = _unsharded(s, cfg, opt, z, r, mask)
    state = ShardedTrainState.create(cfg, _mesh(dp, tp), s["sd"], opt, zero1_min_size=ZERO1_MIN)
    state, m2 = make_sharded_train_step(cfg, s["codec"], opt).with_mask(
        state, _t(s["cbs"]), z, r, mask)
    assert state.step == 1
    # fp32 sums of the same terms in another order (the groups' partial sums)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    for k in m1:  # every metric is the global batch's
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    _assert_updates_match(state.params_state_dict(), want, grads, f"dp={dp} tp={tp}",
                          state.gathered_moments()[0])
    # the whole state, gathered, has the single-card layout and loads there
    sd = state.state_dict()
    single = TrainState.create(VampNetLM(cfg, device="cpu"), opt)
    single.load_state_dict(sd)
    assert single.step == 1 and single.opt_state.count == 1


@pytest.mark.parametrize("option", ["bf16_moments", "lora", "remat_microbatch"])
def test_sharded_step_options_match_unsharded(setup, option):
    s = setup
    cfg = s["tcfg"]
    sd = s["sd"]
    step_kw, opt_kw = {}, {}
    if option == "lora":
        cfg = dataclasses.replace(cfg, lora_r=2)
        lm = VampNetLM(cfg, device="cpu")
        with torch.no_grad():
            for name, p in lm.named_parameters():  # the base weights, adapters that move
                p.copy_(sd[name] if name in sd else 0.2 * torch.randn(p.shape))
        sd = lm.state_dict()
        opt_kw = dict(lora_filter=lora_filter(lm))
    if option == "bf16_moments":
        opt_kw = dict(state_dtype="bfloat16")
    if option == "remat_microbatch":
        cfg = dataclasses.replace(cfg, remat=True)
        step_kw = dict(encode_microbatch=2)
    s = dict(s, sd=sd)
    opt = make_optimizer(cfg.embedding_dim, warmup=10, **opt_kw)
    mesh = _mesh(2, 2)
    if option == "remat_microbatch":
        # the whole step from the audio: encode in sub-batches, the draws
        # from the step's generator over the global batch
        lm = VampNetLM(cfg, device="cpu")
        lm.load_state_dict(sd)
        ref = TrainState.create(lm, opt)
        ref, m1 = make_train_step(lm, s["codec"], opt, **step_kw)(
            ref, _t(s["cbs"]), _t(s["audio"]), torch.Generator().manual_seed(4))
        want = lm.state_dict()
        grads = {n: ref.opt_state.adamw.state[p]["exp_avg"] / 0.1
                 for n, p in lm.named_parameters()}
        state = ShardedTrainState.create(cfg, mesh, sd, opt, zero1_min_size=ZERO1_MIN)
        state, m2 = make_sharded_train_step(cfg, s["codec"], opt, **step_kw)(
            state, _t(s["cbs"]), _t(s["audio"]), torch.Generator().manual_seed(4))
    else:
        z, r, mask = _draws(s, 8)
        want, m1, grads = _unsharded(s, cfg, opt, z, r, mask)
        state = ShardedTrainState.create(cfg, mesh, sd, opt, zero1_min_size=ZERO1_MIN)
        state, m2 = make_sharded_train_step(cfg, s["codec"], opt).with_mask(
            state, _t(s["cbs"]), z, r, mask)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    after = state.params_state_dict()
    # bf16 moments: where the two fp32 sums straddle a bf16 rounding, the
    # stored moment moves by one bf16 ulp (2^-8 of it)
    _assert_updates_match(after, want, grads, option, state.gathered_moments()[0],
                          mu_tol=1e-3 if option == "bf16_moments" else 1e-5)
    if option == "lora":
        for name, v in after.items():
            if not name.endswith(("lora_a", "lora_b")):
                assert torch.equal(v, sd[name]), name  # the base weights, bitwise
        assert any(not torch.equal(after[n], sd[n]) for n in after if n.endswith("lora_a"))
    if option == "bf16_moments":
        pos = state.positions[0]
        assert all(m.dtype == torch.bfloat16 for m in pos.opt_state.mu + pos.opt_state.nu)


def test_sharded_state_holds_the_specs_split(setup):
    """Each position's parameters are `lm_param_specs`' tp blocks (the
    adapters as the shards compute with them: a column site's lora_b by
    outputs, a row site's lora_a by inputs, which JAX replicates), the
    tensors every shard uses whole live on position 0 alone, and each
    moment is its parameter's block split over dp as `zero1_specs` says."""
    s = setup
    cfg = dataclasses.replace(s["tcfg"], lora_r=2)
    lm = VampNetLM(cfg, device="cpu")
    whole = {k: torch.randn(v.shape) for k, v in lm.state_dict().items()}
    dp, tp = 2, 2
    opt = make_optimizer(cfg.embedding_dim, warmup=10)
    state = ShardedTrainState.create(cfg, _mesh(dp, tp), whole, opt, zero1_min_size=ZERO1_MIN)
    specs = lm_param_specs(whole)
    zspecs = zero1_specs(specs, whole, dp, min_size=ZERO1_MIN)
    n_dp_split = 0
    for pos, used in zip(state.positions, state.bytes_by_position()):
        group = state.placement.groups[pos.g]
        held = group._params[pos.j]
        assert set(held) == {n for n in whole if held_at(n, pos.j)}
        for name, p in held.items():
            shape = list(whole[name].shape)
            where = tp_dim(name)
            if where is not None:
                shape[where[0]] //= tp
                if not name.endswith(("lora_a", "lora_b")):
                    assert specs[name][where[0]] == "tp", name
            else:
                assert "tp" not in specs[name], name
            assert list(p.shape) == shape, name
        if pos.j > 0:  # no whole layer tensor past the first position
            assert not any(n.endswith(("norm_1.weight", "norm_3.weight", "bias")) for n in held)
        for name, dim, master in zip(pos.names, pos.dims, pos.masters):
            local = list(held[name].shape)
            if "dp" in zspecs[name] and dim is not None:
                assert dim == zspecs[name].index("dp") or tp_dim(name)[0] == dim, name
                local[dim] //= dp
                n_dp_split += 1
            assert list(master.shape) == local, name
        assert used["params"] == sum(p.numel() * 4 for p in held.values())
        assert used["masters"] == sum(m.numel() * 4 for m, d in zip(pos.masters, pos.dims)
                                      if d is not None)
    assert n_dp_split > 0
    # after a step the moments exist, each of its master's shape
    z, r, mask = _draws(s, 4)
    state, _ = make_sharded_train_step(cfg, s["codec"], opt).with_mask(
        state, _t(s["cbs"]), z, r, mask)
    for pos, used in zip(state.positions, state.bytes_by_position()):
        mu, nu = state._moment_lists(pos)
        for m, v, master in zip(mu, nu, pos.masters):
            assert m.shape == master.shape == v.shape
        assert used["moments"] == 2 * sum(m.numel() * 4 for m in pos.masters)
    # gathered back, the parameters are the whole LM's layout
    back = state.params_state_dict()
    assert set(back) == set(whole) and all(back[k].shape == whole[k].shape for k in whole)


def test_dp_groups_draw_different_dropout_masks(setup, monkeypatch):
    """Two dp groups, identical rows and parameters, dropout 0.5: each
    group's forward in the step draws its own masks (correlated dropout
    would repeat them), and the draws repeat from the same seed."""
    s = setup
    cfg = dataclasses.replace(s["tcfg"], dropout=0.5)
    opt = make_optimizer(cfg.embedding_dim, warmup=10)
    z = s["z"][:1].repeat(2, 1, 1)
    r = torch.tensor([0.5, 0.5])
    mask = tmask.random(torch.Generator().manual_seed(0), z[:1], r[:1]).repeat(2, 1, 1)
    seen = []
    real = ShardedLM.forward_codes

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append(out.detach().clone())
        return out

    monkeypatch.setattr(ShardedLM, "forward_codes", spy)
    for _ in range(2):
        state = ShardedTrainState.create(cfg, _mesh(2, 1), s["sd"], opt)
        make_sharded_train_step(cfg, s["codec"], opt).with_mask(
            state, _t(s["cbs"]), z, r, mask, torch.Generator().manual_seed(7))
    assert len(seen) == 4
    assert not torch.equal(seen[0], seen[1])  # group 0 and group 1, identical rows
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])
    g = torch.Generator().manual_seed(7)
    assert _group_generator(g, 0, "cpu").initial_seed() != _group_generator(g, 1, "cpu") \
        .initial_seed()


def test_sharded_step_matches_jax_sharded_step(setup):
    """The port's step on ["cpu"] * 8 at (dp, tp) = (4, 2) against the JAX
    step jitted over its 8-device mesh (`tests/test_train_step.py`'s
    sharded test), given the JAX step's r and mask; held to
    `tests/test_torch_train.py`'s single-step tolerances."""
    s = setup
    jcfg, tcfg, lm_np = s["jcfg"], s["tcfg"], s["lm_np"]
    b = 4
    audio = s["audio"][:b]
    jopt = jstep.make_optimizer(jcfg.embedding_dim, factor=2.0, warmup=10)
    jparams = to_jax(lm_np)
    mesh = jmake_mesh(n_devices=8, tp=2)
    specs = jlm_param_specs(jparams)
    opt_state = jopt.init(jparams)
    opt_specs = jopt_state_specs(opt_state, jzero1_specs(specs, jparams, dp_size=4))
    sh = lambda tree: jax.tree_util.tree_map(lambda x: NamedSharding(mesh, x), tree)  # noqa: E731
    state_sh = jstep.TrainState(sh(specs), sh(opt_specs), NamedSharding(mesh, JP()))
    rep, batch = NamedSharding(mesh, JP()), NamedSharding(mesh, JP("dp", None, None))
    jstate = jstep.TrainState(jax.device_put(jparams, state_sh.params),
                              jax.device_put(opt_state, state_sh.opt_state),
                              jax.device_put(jnp.zeros((), jnp.int32), state_sh.step))
    step = jax.jit(jstep.make_train_step(JVampNetLM(jcfg), s["jcodec"], jopt),
                   in_shardings=(state_sh, rep, rep, batch, rep), out_shardings=(state_sh, rep))
    key = jax.random.PRNGKey(2)  # r keeps about half of each row's tokens
    jnew, jm = step(jstate, jax.device_put(to_jax(s["codec_np"]), rep),
                    jax.device_put(jnp.asarray(s["cbs"]), rep),
                    jax.device_put(jnp.asarray(audio), batch), jax.device_put(key, rep))
    # the JAX step's draws, split as the step splits its key
    k_r, k_mask, _, _ = jax.random.split(key, 4)
    jz = s["jcodec"].apply({"params": to_jax(s["codec_np"])}, jnp.asarray(audio),
                           method="encode")["codes"][:, : jcfg.n_codebooks]
    r = jax.random.uniform(k_r, (b,))
    mask = jmask.random(k_mask, jz, r)

    topt = make_optimizer(tcfg.embedding_dim, factor=2.0, warmup=10)
    state = ShardedTrainState.create(tcfg, _mesh(4, 2), s["sd"], topt)
    z = s["z"][:b]
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    state, m = make_sharded_train_step(tcfg, s["codec"], topt).with_mask(
        state, _t(s["cbs"]), z, _t(r), _t(mask))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    before = s["sd"]
    after = state.params_state_dict()
    delta = convert.lm_params_to_jax({k: after[k] - before[k] for k in before})
    jdelta = jax.tree.map(lambda a, b0: np.asarray(a) - np.asarray(b0), jnew.params, lm_np)
    jgrad = jax.tree.map(lambda mu: np.asarray(mu) / 0.1,
                         optax.tree_utils.tree_get(jnew.opt_state, "mu"))

    def flat(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
        return out

    want, got, grads = flat(jdelta), flat(delta), flat(jgrad)
    assert set(got) == set(want) == set(grads)
    for key_ in want:
        # as the single-device test: updates where |g| >= 100 eps, all but a
        # few of each leaf's elements
        sel = np.abs(grads[key_]) >= 1e-6
        assert (~sel).sum() <= max(0.01 * sel.size, 32), (key_, int((~sel).sum()))
        err = _rel(np.asarray(got[key_])[sel], np.asarray(want[key_])[sel])
        assert err <= 1e-4, (key_, err)
    # and the gathered whole parameters are the port's layout of JAX's tree
    assert set(convert.lm_params_to_jax(after)) == set(jnew.params)
