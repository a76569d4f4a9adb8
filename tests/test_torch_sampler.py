"""Port parity: token sampling. The filters and the sampler's plain version
against the JAX XLA sampler and the Pallas fused sampler (interpret mode) on
the greedy path, token for token; the port's Philox stream bit for bit
against a numpy Philox4x32-10; and the noise path's draw frequencies."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from vampnet_tpu.ops.sampler_kernel import fused_sample_from_logits as j_fused
from vampnet_tpu.sampling import sample as jsample
from vampnet_tpu_torch.ops import sampler_kernel as tsk
from vampnet_tpu_torch.sampling import sample as tsample

_MASK = np.uint64(0xFFFFFFFF)


def np_philox4x32_10(ctr, key):
    """Reference Philox4x32-10 in numpy uint64 (a 32x32-bit product fits)."""
    c = [np.asarray(x, np.uint64) for x in ctr]
    k0, k1 = (np.asarray(x, np.uint64) for x in key)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & _MASK
            k1 = (k1 + np.uint64(0xBB67AE85)) & _MASK
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & _MASK,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & _MASK]
    return c


def test_numpy_philox_known_answers():
    # the Random123 known-answer vectors for philox4x32-10
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        assert tuple(int(x) for x in np_philox4x32_10(ctr, key)) == want


def test_torch_philox_bit_identical_to_numpy():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (6, 4096), dtype=np.uint64)
    words[:, 0], words[:, 1], words[:, 2] = 0, 0xFFFFFFFF, 0x80000000  # edge words
    got = tsk.philox4x32_10(*(torch.from_numpy(w.astype(np.int64)) for w in words[:4]),
                            torch.from_numpy(words[4].astype(np.int64)),
                            torch.from_numpy(words[5].astype(np.int64)))
    want = np_philox4x32_10(words[:4], words[4:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


def test_philox_uniform_layout_matches_numpy():
    keys = torch.tensor([[12345, 0xDEADBEEF], [7, 0xFFFFFFFF]], dtype=torch.int64)
    step, flat, v = 5, 9, 1024
    u = tsk.philox_uniform(keys, step, flat, v).numpy()
    b_idx, f_idx, q_idx = np.meshgrid(np.arange(2), np.arange(flat), np.arange(v // 4), indexing="ij")
    kn = keys.numpy().astype(np.uint64)
    words = np_philox4x32_10(
        (np.full_like(f_idx, step), f_idx, q_idx, np.zeros_like(f_idx)),
        (kn[b_idx, 0], kn[b_idx, 1]))
    bits = np.stack(words, axis=-1).reshape(2, flat, v)
    want = ((bits >> np.uint64(9)).astype(np.float32) + np.float32(0.5)) * np.float32(2.0 ** -23)
    np.testing.assert_array_equal(u, want)
    assert u.min() > 0.0 and u.max() < 1.0


def _logits(b, flat, v, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((b, flat, v)) * scale).astype(np.float32)


@pytest.mark.parametrize("mass,min_tokens", [(0.15, 64), (0.3, 1), (0.9, 4)])
def test_typical_filter_matches_jax(mass, min_tokens):
    x = _logits(2, 30, 1024, 1)
    want = np.asarray(jsample.typical_filter(jnp.asarray(x), mass, min_tokens))
    got = tsample.typical_filter(torch.from_numpy(x), mass, min_tokens).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_p", [0.5, 0.9, [0.3, 0.95]])
def test_top_p_filter_matches_jax(top_p):
    x = _logits(2, 30, 256, 2)
    tp = np.asarray(top_p, np.float32)
    want = np.asarray(jsample._top_p_filter(jnp.asarray(x), jnp.asarray(tp)))
    got = tsample._top_p_filter(torch.from_numpy(x), torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_top_k_filter_matches_jax():
    x = _logits(2, 10, 64, 3)
    want = np.asarray(jsample._top_k_filter(jnp.asarray(x), 5))
    got = tsample._top_k_filter(torch.from_numpy(x), 5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_top_p", [False, True])
@pytest.mark.parametrize("typical", [True, False])
def test_sampler_greedy_matches_pallas_and_xla(use_top_p, typical):
    b, flat, v = 2, 48, 1024
    x = _logits(b, flat, v, 4)
    temp = np.asarray([1.0, 0.7], np.float32)
    topp = np.asarray([0.9, 0.8], np.float32)
    kw = dict(typical_filtering=typical, typical_mass=0.2, typical_min_tokens=4)
    j_keys = jax.random.split(jax.random.PRNGKey(7), b).astype(jnp.uint32)
    want_tok, want_prob = j_fused(j_keys, 3, jnp.asarray(x), jnp.asarray(temp), 0.0,
                                  top_p=jnp.asarray(topp), use_top_p=use_top_p,
                                  block_f=16, interpret=True, **kw)
    xla_tok, xla_prob = jsample.sample_from_logits(
        jax.random.PRNGKey(0), jnp.asarray(x), sample=False, temperature=jnp.asarray(temp),
        top_p=jnp.asarray(topp) if use_top_p else None, return_probs=True, **kw)
    tok, prob = tsk.fused_sample_from_logits(
        torch.zeros((b, 2), dtype=torch.int64), 3, torch.from_numpy(x),
        torch.from_numpy(temp), 0.0, top_p=torch.from_numpy(topp),
        use_top_p=use_top_p, **kw)
    assert tok.dtype == torch.int64 and prob.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(xla_tok))
    # softmax of the same filtered logits; fp32 summation order only
    np.testing.assert_allclose(prob.numpy(), np.asarray(want_prob), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(prob.numpy(), np.asarray(xla_prob), rtol=1e-5, atol=1e-7)


def test_sampler_noise_path_is_deterministic_per_row():
    x = torch.from_numpy(_logits(3, 20, 1024, 5))
    keys = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int64)
    a = tsk.fused_sample_from_logits(keys, 2, x, 1.0, 1.0, typical_filtering=True)
    b = tsk.fused_sample_from_logits(keys, 2, x, 1.0, 1.0, typical_filtering=True)
    solo = tsk.fused_sample_from_logits(keys[1:2], 2, x[1:2], 1.0, 1.0, typical_filtering=True)
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[0][1:2], solo[0])
    other_step = tsk.fused_sample_from_logits(keys, 3, x, 1.0, 1.0, typical_filtering=True)
    assert not torch.equal(a[0], other_step[0])


def test_sampler_noise_path_frequencies():
    # a fixed 5-token distribution at every position: the Gumbel-max draws
    # over 2 rows x 4000 positions must follow it
    v = 1024
    p = np.asarray([0.4, 0.25, 0.2, 0.1, 0.05])
    row = np.full(v, -np.inf, np.float32)
    row[[3, 100, 517, 800, 1023]] = np.log(p)
    x = torch.from_numpy(np.broadcast_to(row, (2, 4000, v)).copy())
    keys = torch.tensor([[11, 22], [33, 44]], dtype=torch.int64)
    tok, prob = tsk.fused_sample_from_logits(keys, 0, x, 1.0, 1.0, typical_filtering=False)
    counts = np.asarray([(tok.numpy() == i).sum() for i in (3, 100, 517, 800, 1023)])
    assert counts.sum() == 8000
    freq = counts / 8000
    # binomial standard deviation is at most 0.0055 here; 4 of them
    np.testing.assert_allclose(freq, p, atol=0.022)
    chosen = np.asarray([3, 100, 517, 800, 1023])
    np.testing.assert_allclose(prob.numpy(), p[np.searchsorted(chosen, tok.numpy())], rtol=1e-5)


def test_sample_from_logits_greedy_and_mask_topk_match_jax():
    x = _logits(2, 25, 64, 6)
    j_tok, j_prob = jsample.sample_from_logits(
        jax.random.PRNGKey(0), jnp.asarray(x), sample=False, temperature=0.8,
        typical_filtering=True, typical_mass=0.3, typical_min_tokens=2, return_probs=True)
    tok, prob = tsample.sample_from_logits(
        torch.from_numpy(x), None, sample=False, temperature=0.8,
        typical_filtering=True, typical_mass=0.3, typical_min_tokens=2)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(prob.numpy(), np.asarray(j_prob), rtol=1e-5, atol=1e-7)

    # mask temperature 0: the re-mask is decided by the probabilities alone
    probs = np.random.default_rng(7).uniform(0.01, 1.0, (2, 25)).astype(np.float32)
    probs[0, :3] = np.inf
    n = np.asarray([[4], [9]])
    want = np.asarray(jsample.mask_by_random_topk(
        jax.random.PRNGKey(1), jnp.asarray(n), jnp.asarray(probs), jnp.zeros((2,))))
    got = tsample.mask_by_random_topk(torch.from_numpy(n), torch.from_numpy(probs),
                                      torch.zeros(2), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum(dim=1).tolist() == [4, 9]
