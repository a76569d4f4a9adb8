"""The training step's model FLOPs per second as a share of the card's 989
TFLOP/s bf16 peak, in %, over the traced run's window, which runs before
the profiler starts (its host work would slow the steps): per step the
LM's forward and backward (3 forwards) over every row, and the frozen
codec's encode."""


def read(run):
    rf, cfg = run.roofline, run.config
    c, k = cfg["lm"], cfg["codec"]
    b, t = run.sut.batch_shape()
    lm = 3 * b * rf.lm_forward_flops(t, c["embedding_dim"], c["n_layers"], c["n_codebooks"],
                                     c["latent_dim"], c["n_codebooks"] - c["n_conditioning_codebooks"],
                                     c["vocab_size"])
    enc = b * rf.codec_encode_flops(run.sut.batch_samples(), k["encoder_dim"], k["encoder_rates"],
                                    k["n_codebooks"], k["codebook_size"], k["codebook_dim"])
    t0, t1 = run.sut.window
    return 100.0 * run.sut.n_window * (lm + enc) / (t1 - t0) / rf.H100_BF16_FLOPS
