"""Faults planted under a whole benchmark run (the timed path broken
underneath the harness), for `test_portbench_faults.py`. Each takes the
driver module and the run's context and returns the system under test, as
`run.run_cell(..., fault=)` asks."""
from __future__ import annotations

import numpy as np


def serve_state_unchanged(driver, ctx):
    """A MaskGIT step returns its state unchanged: at step 1 every position
    still masked stays masked."""
    from vampnet_tpu_torch.sampling import generate

    remask = generate.mask_by_random_topk

    def planted(num_to_mask, probs, temperature, generator=None, row_keys=None, step=0):
        if step == 1:
            return probs != float("inf")
        return remask(num_to_mask, probs, temperature, generator, row_keys=row_keys, step=step)

    generate.mask_by_random_topk = planted
    return driver.setup(ctx)


def serve_half_batch(driver, ctx):
    """An engine group computes half its rows and hands their results to
    the other half."""
    import torch

    sut = driver.setup(ctx)
    coarse_vamp = sut.iface.coarse_vamp

    def planted(z, mask, seed=None, **kw):
        b = z.shape[0]
        h = (b + 1) // 2
        out = coarse_vamp(z[:h], mask[:h], seed=None if seed is None else seed[:h], **kw)
        return torch.cat([out, out[: b - h]]) if b > 1 else out

    sut.iface.coarse_vamp = planted
    return sut


def serve_token_altered(driver, ctx):
    """The sampler's tokens of the first MaskGIT step come out one off."""
    from vampnet_tpu_torch.sampling import generate

    sample = generate.fused_sample_from_logits

    def planted(row_keys, i, logits, *a, **kw):
        tokens, probs = sample(row_keys, i, logits, *a, **kw)
        if i == 0:
            tokens = (tokens + 1) % logits.shape[-1]
        return tokens, probs

    generate.fused_sample_from_logits = planted
    return driver.setup(ctx)


def serve_sampler_temperature(driver, ctx):
    """The sampler draws at twice the requests' temperature."""
    from vampnet_tpu_torch.sampling import generate

    sample = generate.fused_sample_from_logits

    def planted(row_keys, i, logits, temperature, *a, **kw):
        return sample(row_keys, i, logits, temperature * 2.0, *a, **kw)

    generate.fused_sample_from_logits = planted
    return driver.setup(ctx)


def serve_sampler_noise_dropped(driver, ctx):
    """The sampler takes the argmax where the request samples."""
    from vampnet_tpu_torch.sampling import generate

    sample = generate.fused_sample_from_logits

    def planted(row_keys, i, logits, temperature, do_sample, *a, **kw):
        return sample(row_keys, i, logits, temperature, do_sample * 0.0, *a, **kw)

    generate.fused_sample_from_logits = planted
    return driver.setup(ctx)


def serve_remask_noise_shifted(driver, ctx):
    """The re-masking draws the next step's noise."""
    from vampnet_tpu_torch.sampling import generate

    remask = generate.mask_by_random_topk

    def planted(num_to_mask, probs, temperature, generator=None, row_keys=None, step=0):
        return remask(num_to_mask, probs, temperature, generator, row_keys=row_keys,
                      step=step + 1)

    generate.mask_by_random_topk = planted
    return driver.setup(ctx)


def serve_answer_altered(driver, ctx):
    """The decoded audio comes out a sample late."""
    sut = driver.setup(ctx)
    decode = sut.iface.decode

    def planted(z):
        sig = decode(z)
        sig.samples = np.roll(sig.samples, 1, axis=-1)
        return sig

    sut.iface.decode = planted
    return sut


def _train(fault):
    def make(driver, ctx):
        return driver.Training(ctx, fault=fault)

    return make


def _state_unchanged(tr) -> None:
    step = tr.train_step

    def planted(state, codebooks, audio, gen):
        before = [p.detach().clone() for p in state.params]
        state, metrics = step(state, codebooks, audio, gen)
        for p, q in zip(state.params, before):
            p.data.copy_(q)
        return state, metrics

    tr.train_step = planted


def _half_batch(tr) -> None:
    from benchmark.control import half_batch

    half_batch(tr)


def _answer_altered(tr) -> None:
    from benchmark.control import altered_answer

    altered_answer(tr)


train_state_unchanged = _train(_state_unchanged)
train_half_batch = _train(_half_batch)
train_answer_altered = _train(_answer_altered)
