"""Port parity: `Interface.vamp_microbatched`, `Interface.to`,
`visualize_codes`, and the MaskGIT loop's per-step dumps
(`generate(debug_callback=)`, `sampling/debug.py`) against the JAX package,
on the tiny Interface pair of `test_torch_interface_staged.py` (fp32).

Tokens are compared with JAX at the settings in which no random draw
decides a token (greedy, `mask_temperature=0`, a prompt in every chunk),
where they must be identical. The grouping invariance is the port's own
contract at random settings: with a seed array, every `group_chunks` gives
the one-shot run's tokens where the group length is a multiple of the c2f
chunk (50 coarse tokens a chunk, 25 a c2f chunk, as the JAX package's
`test_vamp_microbatched_grouping_invariance`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_interface_staged import GREEDY, _codes, _pair, _prompt_mask
from test_torch_row_keys import _inputs, _lm
from test_torch_util import to_jax
from vampnet_tpu.modules import VampNetLM as JVampNetLM
from vampnet_tpu.sampling.debug import save_debug_dumps as jsave_debug_dumps
from vampnet_tpu.sampling.generate import generate as jgenerate
from vampnet_tpu_torch.interface import Interface, _keys_from_seeds
from vampnet_tpu_torch.sampling.debug import save_debug_dumps
from vampnet_tpu_torch.sampling.generate import generate


@pytest.fixture(scope="module")
def interfaces():
    # 50 coarse tokens a chunk, 25 a c2f chunk (16 kHz, hop 32)
    jiface, tiface = _pair(coarse_chunk_s=0.1, c2f_chunk_s=0.05)
    assert tiface.s2t(0.1) == 50 and tiface.s2t(0.05) == 25
    return jiface, tiface


def test_vamp_microbatched_matches_jax_at_deterministic_settings(interfaces):
    """Two requests over 4 coarse chunks in groups of 2 and 3 (the last
    group short, its c2f windows offset as JAX offsets them)."""
    jiface, tiface = interfaces
    jz, _ = _codes(jiface, tiface, seconds=0.4)
    z = np.concatenate([jz, np.roll(jz, 9, axis=-1)], axis=0)[..., :190]
    mask = _prompt_mask(z.shape, 7)
    seeds = np.array([5, 9], np.uint32)
    kw = dict(_sampling_steps=3, temperature=np.array([1.0, 0.9], np.float32),
              c2f_steps=2, **GREEDY)
    for group in (2, 3):
        want = jiface.vamp_microbatched(jnp.asarray(z), jnp.asarray(mask), group_chunks=group,
                                        seed=seeds, **kw)
        got = tiface.vamp_microbatched(z, mask, group_chunks=group, seed=seeds, **kw)
        assert got.shape == z.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not (got == tiface.coarse.mask_token).any()


def test_vamp_microbatched_is_invariant_to_grouping(interfaces):
    """Sampling and re-masking draws on: 8 coarse chunks, seed array, the
    same tokens in every codebook for group_chunks 1, 2, 4 and 8."""
    _, tiface = interfaces
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.integers(0, 64, (1, 4, 400)))
    mask = tiface.build_mask(z, periodic_prompt=5, upper_codebook_mask=1, seed=0)
    kw = dict(_sampling_steps=2, seed=np.array([1234], np.uint32))
    one_shot = tiface.vamp_microbatched(z, mask, group_chunks=8, **kw)
    assert one_shot.shape == (1, 4, 400)
    keep = mask == 0
    torch.testing.assert_close(one_shot[keep], z[keep], rtol=0, atol=0)
    for group in (1, 2, 4):
        grouped = tiface.vamp_microbatched(z, mask, group_chunks=group, **kw)
        torch.testing.assert_close(grouped, one_shot, rtol=0, atol=0,
                                   msg=f"group_chunks={group} changed tokens")
    other = tiface.vamp_microbatched(z, mask, group_chunks=2, _sampling_steps=2,
                                     seed=np.array([1235], np.uint32))
    assert not torch.equal(other, one_shot)


def test_vamp_microbatched_scalar_seed_draws_jax_per_row_seeds(interfaces, monkeypatch):
    """A scalar seed: b per-row seeds from np.random.default_rng(seed), the
    fine stage's + 0x9E3779B9 wrapping in uint32, the global chunk and c2f
    window offsets, as the JAX package passes them to its stages."""
    jiface, tiface = interfaces
    seen = {"jax": [], "torch": []}

    def spy(store, iface, name):
        real = getattr(iface, name)

        def call(z, *a, seed=None, row_key_offset=None, **kw):
            store.append((name, np.asarray(seed).tolist(), row_key_offset, z.shape[-1]))
            return real(z, *a, seed=seed, row_key_offset=row_key_offset, **kw)
        monkeypatch.setattr(iface, name, call)

    for key, iface in (("jax", jiface), ("torch", tiface)):
        spy(seen[key], iface, "coarse_vamp")
        spy(seen[key], iface, "coarse_to_fine")
    jz, _ = _codes(jiface, tiface, seconds=0.3)
    z = np.concatenate([jz] * 3, axis=0)
    mask = _prompt_mask(z.shape, 5)
    jiface.vamp_microbatched(jnp.asarray(z), jnp.asarray(mask), group_chunks=2, seed=77,
                             _sampling_steps=1, **GREEDY)
    tiface.vamp_microbatched(z, mask, group_chunks=2, seed=77, _sampling_steps=1, **GREEDY)
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"]) == 4  # 150 tokens: two groups of 100 and 50
    coarse_seeds = seen["torch"][0][1]
    assert coarse_seeds == np.random.default_rng(77).integers(0, 2 ** 31 - 1, 3).tolist()
    assert seen["torch"][1][1] == [(s + 0x9E3779B9) % 2 ** 32 for s in coarse_seeds]


def test_interface_to_moves_every_module(interfaces, monkeypatch):
    _, tiface = interfaces
    assert tiface.to("cpu") is tiface and tiface.device == torch.device("cpu")
    tensors = [*tiface.codec.parameters(), *tiface.coarse.parameters(),
               *tiface.c2f.parameters(), *tiface.coarse.buffers(), tiface.codebooks]
    assert all(t.device.type == "cpu" for t in tensors)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiface.to("cuda")
    assert tiface.device == torch.device("cpu")


def test_interface_to_moves_the_beat_tracker(tmp_path, monkeypatch):
    from test_wavebeat import HP, TDsTCN, _save_ckpt
    from vampnet_tpu_torch.beats import WaveBeat

    torch.manual_seed(3)
    tracker = WaveBeat(str(_save_ckpt(tmp_path, TDsTCN(HP).eval(), HP)), device="cpu")
    moved = []
    monkeypatch.setattr(tracker.model.model, "to",
                        lambda device: moved.append(device) or tracker.model.model)
    assert tracker.to("cpu") is tracker and moved == [torch.device("cpu")]
    assert tracker.model.device == torch.device("cpu")


def test_visualize_codes_draws_the_first_row(interfaces):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, tiface = interfaces
    z = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 4, 30)))
    fig = tiface.visualize_codes(z)
    image = fig.axes[0].get_images()[0].get_array()
    np.testing.assert_array_equal(np.asarray(image), z[0].numpy())
    plt.close(fig)


@pytest.mark.parametrize("name", ["coarse", "c2f"])
def test_debug_dumps_match_jax(tmp_path, name):
    """One state.npz a step with the arrays JAX's callback writes, at the
    settings in which no draw decides a token."""
    jcfg, tcfg, params, model = _lm(name)
    b, t, steps = 2, 20, 4
    z, cbs = _inputs(jcfg, b, t, seed=43)
    mask = np.ones(z.shape, np.int64)
    mask[:, :, ::5] = 0
    mask[:, : jcfg.n_conditioning_codebooks] = 0
    seeds = np.array([3, 4], np.uint32)
    kw = dict(n_conditioning_codebooks=jcfg.n_conditioning_codebooks, sampling_steps=steps,
              typical_filtering=True, typical_mass=0.3, typical_min_tokens=2, **GREEDY)
    jmodel, jparams = JVampNetLM(jcfg), to_jax(params)
    want = jgenerate(
        lambda zm: jmodel.apply({"params": jparams}, zm, jnp.asarray(cbs), method="forward_codes"),
        jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)), jnp.asarray(z), jnp.asarray(mask),
        jcfg.mask_token, sampler_impl="xla",
        debug_callback=jsave_debug_dumps(str(tmp_path / "jax"), save_png=False), **kw)
    jax.effects_barrier()
    tcbs = torch.from_numpy(cbs)
    got = generate(lambda zm: model.forward_codes(zm, tcbs), torch.from_numpy(z),
                   torch.from_numpy(mask), tcfg.mask_token,
                   row_keys=_keys_from_seeds(seeds, "cpu"),
                   debug_callback=save_debug_dumps(str(tmp_path / "torch"), save_png=False), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dirs = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert dirs == [f"step_{i}" for i in range(steps)]
    assert dirs == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for d in dirs:
        j, p = np.load(tmp_path / "jax" / d / "state.npz"), np.load(tmp_path / "torch" / d /
                                                                    "state.npz")
        assert sorted(p.files) == sorted(j.files)
        for k in ("z_masked", "sampled", "mask", "num_to_mask"):
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=f"{d} {k}")
        # fp32 softmax of the same logits in two libraries: a few ulp
        np.testing.assert_allclose(p["selected_probs"], j["selected_probs"], rtol=1e-5,
                                   atol=1e-7, err_msg=d)


def test_debug_callback_reaches_generate_through_the_staged_api(interfaces, tmp_path):
    """coarse_vamp forwards `debug_callback`; the dumps leave the tokens as
    they are, and a PNG is written where matplotlib imports."""
    _, tiface = interfaces
    z = torch.from_numpy(np.random.default_rng(5).integers(0, 64, (1, 4, 50)))
    mask = torch.from_numpy(_prompt_mask((1, 4, 50), 6))
    plain = tiface.coarse_vamp(z, mask, seed=11, _sampling_steps=3)
    dumped = tiface.coarse_vamp(z, mask, seed=11, _sampling_steps=3,
                                debug_callback=save_debug_dumps(str(tmp_path)))
    torch.testing.assert_close(dumped, plain, rtol=0, atol=0)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0", "step_1", "step_2"]
    state = np.load(tmp_path / "step_2" / "state.npz")
    assert state["z_masked"].shape == (1, 2, 50) and state["num_to_mask"].shape == (1,)
    assert (tmp_path / "step_0" / "mask.png").exists()
