"""The served path's model FLOPs per second as a share of the card's 989
TFLOP/s bf16 peak, in %, over the traced run's window, which runs before
the profiler starts (its host work would slow the rate). Each request
counts at its own token count (padding is no work), and one in flight at
the window's edges by its share inside: per variation the coarse
LM's forward at every MaskGIT step over the request's tokens and the
coarse-to-fine LM's over its chunks of them; the codec's encode of the clip
and decode of each variation."""

import math


def request_flops(rf, cfg, clip_s, variations, steps, c2f_steps=2):
    k = cfg["codec"]
    hop = math.prod(k["encoder_rates"])
    samples = math.ceil(clip_s * k["sample_rate"] / hop) * hop
    frames = samples // hop

    def lm(name, t):
        c = cfg[name]
        return rf.lm_forward_flops(t, c["embedding_dim"], c["n_layers"], c["n_codebooks"],
                                   c["latent_dim"], c["n_codebooks"] - c["n_conditioning_codebooks"],
                                   c["vocab_size"])

    chunk = math.ceil(cfg["c2f_chunk_size_s"] * k["sample_rate"] / hop)
    c2f = sum(lm("c2f", min(chunk, frames - lo)) for lo in range(0, frames, chunk))
    per_var = steps * lm("coarse", frames) + c2f_steps * c2f
    codec = rf.codec_encode_flops(samples, k["encoder_dim"], k["encoder_rates"], k["n_codebooks"],
                                  k["codebook_size"], k["codebook_dim"])
    codec += variations * rf.codec_decode_flops(frames, k["encoder_dim"], k["encoder_rates"],
                                                k["decoder_dim"], k["decoder_rates"],
                                                k["n_codebooks"], k["codebook_dim"])
    return variations * per_var + codec


def read(run):
    sut, rf = run.sut, run.roofline
    t0, t1 = sut.window
    total = sum(share * request_flops(rf, run.config, d.spec.clip_s, sut.mix.variations,
                                      sut.mix.steps)
                for d, share in sut.credited(t0, t1))
    return 100.0 * total / (t1 - t0) / rf.H100_BF16_FLOPS
