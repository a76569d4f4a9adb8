"""The served path's model FLOPs per second as a share of the card's 989
TFLOP/s bf16 peak, in %, over the traced run's window (which runs before
the profiler starts): each request at its own text length
(`roofline_magnet.request_flops`: T5, the stage loop's forwards on both CFG
rows, the decode), one in flight at the window's edges by its share inside."""

from benchmark import roofline_magnet as rm


def read(run):
    sut = run.sut
    t0, t1 = sut.window
    mix, cfg = sut.mix, run.config
    frames = sut.frames
    steps = mix.t["request"]["decoding_steps"]
    total = sum(share * mix.samples * rm.request_flops(cfg, frames, len(d.spec.text), steps)
                for d, share in sut.credited(t0, t1))
    return 100.0 * total / (t1 - t0) / rm.H100_BF16_FLOPS
