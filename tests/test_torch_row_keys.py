"""Port: per-row random streams. `fold_in_rows` and the re-masking noise
(`sampling/sample.py`), `Interface._expand_row_keys`, `generate` with
`row_keys`, and `coarse_vamp` / `coarse_to_fine` with seed arrays.

The port defines its own streams (Philox4x32-10, told apart by the counter's
last word), so the random draws are held to the port's own contract: a row's
draws depend only on its key. Against the JAX package the tokens are
compared at the settings of `test_torch_e2e.py` in which no draw decides a
token (greedy sampling, `mask_temperature=0`, every chunk row prompted);
there they must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_e2e import DETERMINISTIC
from test_torch_interface_staged import GREEDY, _codes, _pair, _prompt_mask
from test_torch_util import configs, lm_params_np, to_jax
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.sampling.generate import generate as jgenerate
from vampnet_tpu_torch import convert
from vampnet_tpu_torch.interface import Interface, _expand_row_keys, _keys_from_seeds
from vampnet_tpu_torch.modules import VampNetLM
from vampnet_tpu_torch.ops.sampler_kernel import philox4x32_10, philox_uniform
from vampnet_tpu_torch.sampling import generate as tgenerate_mod
from vampnet_tpu_torch.sampling.generate import generate
from vampnet_tpu_torch.sampling.sample import fold_in_rows, mask_by_random_topk, remask_noise


def _keys(b, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 2 ** 32, (b, 2), dtype=np.int64))


def test_seed_keys_have_the_layout_of_jax_prngkey():
    seeds = np.array([0, 7, 2 ** 31 - 1, 2 ** 32 + 5], dtype=np.int64)
    got = _keys_from_seeds(seeds, "cpu")
    want = np.stack([np.asarray(jax.random.PRNGKey(int(s) % 2 ** 32)) for s in seeds])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_fold_in_rows_is_deterministic_per_row_and_independent_of_batch_mates():
    keys = _keys(5)
    folded = fold_in_rows(keys, 3)
    assert folded.shape == (5, 2) and folded.dtype == torch.int64
    assert int(folded.min()) >= 0 and int(folded.max()) < 2 ** 32
    torch.testing.assert_close(fold_in_rows(keys, 3), folded, rtol=0, atol=0)
    for i in range(5):  # alone, and batched with others in another order
        torch.testing.assert_close(fold_in_rows(keys[i:i + 1], 3)[0], folded[i], rtol=0, atol=0)
    torch.testing.assert_close(fold_in_rows(keys.flip(0), 3).flip(0), folded, rtol=0, atol=0)
    # other data, other keys; a per-row data tensor folds row by row
    assert not (fold_in_rows(keys, 4) == folded).all(dim=1).any()
    per_row = fold_in_rows(keys, torch.arange(5))
    for i in range(5):
        torch.testing.assert_close(per_row[i], fold_in_rows(keys[i:i + 1], i)[0], rtol=0, atol=0)
    assert len({tuple(k) for k in folded.tolist()}) == 5


def test_remask_noise_is_deterministic_per_row_and_independent_of_batch_mates():
    keys, n = _keys(4, 1), 300
    noise = remask_noise(keys, 2, n)
    assert noise.shape == (4, n) and noise.dtype == torch.float32
    assert torch.isfinite(noise).all()
    for i in range(4):
        torch.testing.assert_close(remask_noise(keys[i:i + 1], 2, n)[0], noise[i], rtol=0,
                                   atol=0)
    assert not (remask_noise(keys, 3, n) == noise).all()
    # Gumbel(0, 1): mean 0.5772, variance pi^2 / 6 = 1.645; 1,200 draws put
    # 5 standard errors of the mean at 0.19
    assert abs(float(noise.mean()) - 0.5772) < 0.19
    # re-masking with per-row keys: a row's mask does not depend on the batch
    probs = torch.rand((4, n), generator=torch.Generator().manual_seed(0))
    k = torch.tensor([[5], [50], [100], [299]])
    temp = torch.tensor([0.5, 1.0, 3.0, 10.0])
    batched = mask_by_random_topk(k, probs, temp, row_keys=keys, step=2)
    for i in range(4):
        solo = mask_by_random_topk(k[i:i + 1], probs[i:i + 1], temp[i:i + 1],
                                   row_keys=keys[i:i + 1], step=2)
        torch.testing.assert_close(solo[0], batched[i], rtol=0, atol=0)
        assert int(batched[i].sum()) == int(k[i])


def test_remask_stream_never_meets_the_sampler_stream():
    """For one key and step, the sampler kernel's counters are
    (step, position, j, 0), the re-masking noise's (step, position, 0, 1)
    and fold_in_rows' (data, 0, 0, 2): no shared counter, so no shared
    words."""
    keys, step, n = _keys(3, 2), 4, 64
    shape = (3, n)

    def words(c2, c3):  # (3, n, 4): rows x positions x the 4 output words
        c0 = torch.full(shape, step, dtype=torch.int64)
        c1 = torch.arange(n).expand(shape)
        return torch.stack(philox4x32_10(c0, c1, torch.full(shape, c2), torch.full(shape, c3),
                                         keys[:, :1], keys[:, 1:]), dim=-1)

    sampler = torch.stack([words(j, 0) for j in range(256)], dim=2)  # (3, n, 256, 4)
    # these are the sampler kernel's bits (its plain version's uniforms)
    u_sampler = ((sampler.reshape(3, n, 1024) >> 9).float() + 0.5) * 2.0 ** -23
    torch.testing.assert_close(philox_uniform(keys, step, n), u_sampler, rtol=0, atol=0)
    remask = words(0, 1)
    assert not (sampler == remask[:, :, None, :]).all(dim=-1).any()
    assert not (sampler[..., 0] == remask[:, :, None, 0]).any()
    folded = torch.stack(philox4x32_10(
        torch.full((3,), step), torch.zeros(3, dtype=torch.int64),
        torch.zeros(3, dtype=torch.int64), torch.full((3,), 2), keys[:, 0], keys[:, 1]), dim=-1)
    torch.testing.assert_close(fold_in_rows(keys, step), folded[:, :2], rtol=0, atol=0)
    # the re-masking uniforms are word 0 of its own counters
    u = ((remask[..., 0] >> 9).float() + 0.5) * 2.0 ** -23
    torch.testing.assert_close(remask_noise(keys, step, n), -torch.log(-torch.log(u)),
                               rtol=0, atol=0)


def test_expand_row_keys_with_an_offset_gives_each_chunk_the_ungrouped_stream():
    keys, b, n_chunks = _keys(3, 3), 3, 5
    full = _expand_row_keys(keys, n_chunks)
    assert full.shape == (n_chunks * b, 2)
    for c in range(n_chunks):  # chunk-major rows: row c * b + j
        torch.testing.assert_close(full[c * b:(c + 1) * b], fold_in_rows(keys, c), rtol=0, atol=0)
    # chunks 2..4 streamed as a group of their own, from the global index 2
    part = _expand_row_keys(keys, 3, offset=2)
    torch.testing.assert_close(part, full[2 * b:], rtol=0, atol=0)


def _lm(name):
    _, _, lms = configs("float32")
    jcfg, tcfg = lms[name]
    params = lm_params_np(jcfg, 40)
    model = VampNetLM(tcfg, device="cpu")
    model.load_state_dict(convert.lm_state_dict_from_jax(params, tcfg))
    model.requires_grad_(False)
    return jcfg, tcfg, params, model


def _inputs(cfg, b, t, seed=41):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, cfg.vocab_size, (b, cfg.n_codebooks, t))
    cbs = rng.standard_normal((cfg.n_codebooks, cfg.vocab_size, cfg.latent_dim)).astype(np.float32)
    return z, cbs


def test_generate_with_row_keys_solo_equals_batched():
    """Sampling on (the default cutoff and mask temperature): each row's
    tokens depend only on its key and its own inputs."""
    _, tcfg, _, model = _lm("coarse")
    b, t = 3, 24
    z, cbs = _inputs(tcfg, b, t)
    mask = np.ones((b, t), np.int64)
    mask[:, ::5] = 0
    tcbs = torch.from_numpy(cbs)
    keys = _keys(b, 4)
    temp = torch.tensor([0.8, 1.0, 1.3])
    kw = dict(sampling_steps=5, typical_mass=0.3, typical_min_tokens=2)

    def run(rows):
        with torch.inference_mode():
            return generate(lambda zm: model.forward_codes(zm, tcbs),
                            torch.from_numpy(z[rows]), torch.from_numpy(mask[rows]),
                            tcfg.mask_token, row_keys=keys[rows], temperature=temp[rows], **kw)

    batched = run(list(range(b)))
    assert not (batched == tcfg.mask_token).any()
    for i in range(b):
        torch.testing.assert_close(run([i])[0], batched[i], rtol=0, atol=0)
    # the keys decide: other keys, other tokens
    other = generate(lambda zm: model.forward_codes(zm, tcbs), torch.from_numpy(z),
                     torch.from_numpy(mask), tcfg.mask_token, row_keys=keys + 1,
                     temperature=temp, **kw)
    assert not torch.equal(other, batched)


def test_generate_with_row_keys_uses_no_generator(monkeypatch):
    _, tcfg, _, model = _lm("coarse")
    z, cbs = _inputs(tcfg, 2, 10)

    def no_draws(*a, **kw):
        raise AssertionError("a generator draw with per-row keys")

    monkeypatch.setattr(tgenerate_mod.torch, "randint", no_draws)
    out = generate(lambda zm: model.forward_codes(zm, torch.from_numpy(cbs)),
                   torch.from_numpy(z), None, tcfg.mask_token, row_keys=_keys(2),
                   sampling_steps=2)
    assert out.shape == z.shape
    with pytest.raises(ValueError, match="row_keys must be int64"):
        generate(lambda zm: model.forward_codes(zm, torch.from_numpy(cbs)),
                 torch.from_numpy(z), None, tcfg.mask_token, row_keys=_keys(3),
                 sampling_steps=2)
    with pytest.raises(ValueError, match="generator or per-row keys"):
        generate(lambda zm: model.forward_codes(zm, torch.from_numpy(cbs)),
                 torch.from_numpy(z), None, tcfg.mask_token, sampling_steps=2)


@pytest.mark.parametrize("name", ["coarse", "c2f"])
def test_generate_with_row_keys_and_a_bt_mask_matches_jax(name):
    jcfg, tcfg, params, model = _lm(name)
    b, t = 3, 30
    z, cbs = _inputs(jcfg, b, t, seed=42)
    mask = np.ones((b, t), np.int64)  # coarse: (b, t), every codebook alike
    mask[:, ::6] = 0
    mask[1, 10:14] = 0
    seeds = np.array([3, 11, 12], np.uint32)
    kw = dict(n_conditioning_codebooks=jcfg.n_conditioning_codebooks, sampling_steps=6,
              typical_filtering=True, typical_mass=0.3, typical_min_tokens=2,
              temperature=np.array([1.0, 0.7, 1.4], np.float32),
              sample_cutoff=DETERMINISTIC["sample_cutoff"],
              mask_temperature=DETERMINISTIC["mask_temperature"])
    if jcfg.n_conditioning_codebooks:  # c2f keeps its conditioning codebooks
        mask = np.broadcast_to(mask[:, None], z.shape).copy()
        mask[:, :jcfg.n_conditioning_codebooks] = 0
    jmodel, jparams = JVampNetLM(jcfg), to_jax(params)
    want = jgenerate(
        lambda zm: jmodel.apply({"params": jparams}, zm, jnp.asarray(cbs), method="forward_codes"),
        jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)), jnp.asarray(z), jnp.asarray(mask),
        jcfg.mask_token, sampler_impl="xla", **kw)
    tcbs = torch.from_numpy(cbs)
    got = generate(lambda zm: model.forward_codes(zm, tcbs), torch.from_numpy(z),
                   torch.from_numpy(mask), tcfg.mask_token,
                   row_keys=_keys_from_seeds(seeds, "cpu"),
                   **dict(kw, temperature=torch.from_numpy(kw["temperature"])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got == tcfg.mask_token).any()


@pytest.fixture(scope="module")
def interfaces():
    return _pair()


def test_coarse_vamp_and_coarse_to_fine_with_seed_arrays_match_jax(interfaces):
    """Two requests, 8 coarse chunks each (the keys folded per chunk) and
    c2f over 6 chunks, at the deterministic settings."""
    jiface, tiface = interfaces
    jz, _ = _codes(jiface, tiface)
    z = np.concatenate([jz, np.roll(jz, 7, axis=-1)], axis=0)
    for iface in (jiface, tiface):
        iface.set_chunk_size(0.04)  # 20 tokens: 150 tokens are 8 chunks
    try:
        mask = _prompt_mask(z.shape, 7)
        seeds = np.array([5, 9], np.uint32)
        kw = dict(_sampling_steps=4, temperature=np.array([1.0, 0.9], np.float32), **GREEDY)
        want = jiface.coarse_vamp(jnp.asarray(z), jnp.asarray(mask), seed=seeds, **kw)
        got = tiface.coarse_vamp(z, mask, seed=seeds, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        seeds_c2f = seeds + np.uint32(0x9E3779B9)
        want_f = jiface.coarse_to_fine(want, mask=jnp.asarray(mask), seed=seeds_c2f, **kw)
        got_f = tiface.coarse_to_fine(got, mask=mask, seed=seeds_c2f, **kw)
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        assert not (got_f == tiface.coarse.mask_token).any()
    finally:
        for iface in (jiface, tiface):
            iface.set_chunk_size(0.15)


def test_seed_arrays_fold_chunk_keys_and_take_an_offset(interfaces, monkeypatch):
    """The keys that reach `generate`: as given for one chunk row per
    request, folded with the chunk index for several, and from the global
    chunk index with `row_key_offset`."""
    _, tiface = interfaces
    seen = []
    real = tgenerate_mod.generate

    def spy(*a, row_keys=None, **kw):
        seen.append(row_keys.clone())
        return real(*a, row_keys=row_keys, **kw)

    monkeypatch.setattr("vampnet_tpu_torch.interface.generate", spy)
    z = torch.randint(0, 64, (2, 4, 60), generator=torch.Generator().manual_seed(0))
    mask = torch.from_numpy(_prompt_mask((2, 4, 60), 5))
    keys = _keys_from_seeds([5, 9], "cpu")
    kw = dict(_sampling_steps=1, **GREEDY)
    tiface.coarse_vamp(z, mask, seed=[5, 9], **kw)  # 60 tokens: one 75-token chunk
    tiface.set_chunk_size(0.04)  # 20 tokens: 3 chunks
    try:
        tiface.coarse_vamp(z, mask, seed=[5, 9], **kw)
        tiface.coarse_vamp(z[:, :, :20], mask[:, :, :20], seed=[5, 9], row_key_offset=2, **kw)
    finally:
        tiface.set_chunk_size(0.15)
    torch.testing.assert_close(seen[0], keys, rtol=0, atol=0)
    torch.testing.assert_close(seen[1], _expand_row_keys(keys, 3), rtol=0, atol=0)
    torch.testing.assert_close(seen[2], seen[1][4:], rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not divide"):
        tiface.coarse_vamp(z, mask, seed=[1, 2, 3], **kw)


def test_scalar_seeds_still_take_one_generator(interfaces, monkeypatch):
    _, tiface = interfaces
    seen = []
    real = Interface._run_generate

    def spy(self, lm, start_tokens, mask, rng, **kw):
        seen.append(type(rng))
        return real(self, lm, start_tokens, mask, rng, **kw)

    monkeypatch.setattr(Interface, "_run_generate", spy)
    z = torch.randint(0, 64, (1, 4, 30), generator=torch.Generator().manual_seed(1))
    mask = torch.from_numpy(_prompt_mask((1, 4, 30), 4))
    a = tiface.vamp(z, mask, seed=3, _sampling_steps=2)
    b = tiface.vamp(z, mask, seed=3, _sampling_steps=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert seen == [torch.Generator] * 4
