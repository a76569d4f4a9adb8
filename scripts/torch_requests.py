"""Serve bf16 `vamp_e2e` requests at `chip_smoke.py`'s shapes (10 s of
44.1 kHz audio, 2 variations, 12 coarse and 2 coarse-to-fine steps, the
full-width models with random weights from seed 0) with the PyTorch port of
the tree at TREE, on the card, and print each request's wall time and the
median and quartiles after the first:

    python3 scripts/torch_requests.py TREE [N]

To compare two trees on one card, run it for each in alternation (A, B, B,
A, ...) within one session on the machine with the card.
"""
import sys
import time


def main() -> int:
    tree = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_requests: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vampnet_tpu_torch.codec import LAC, CodecConfig
    from vampnet_tpu_torch.interface import Interface
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM
    from vampnet_tpu_torch.ops import build

    build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    cc, co, cf = CodecConfig(), LMConfig.coarse(), LMConfig.c2f()
    iface = Interface.from_modules(
        cc, cs.random_state(LAC(cc, device="meta"), gen),
        co, cs.random_state(VampNetLM(co, device="meta"), gen),
        cf, cs.random_state(VampNetLM(cf, device="meta"), gen), device="cuda")
    sig = cs.bench_signal(cc.sample_rate, 10.0)
    kw = dict(batch_size=2, periodic_prompt=7, upper_codebook_mask=3, _sampling_steps=12,
              c2f_steps=2, transfer_dtype="int16")
    walls = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iface.vamp_e2e(sig, seed=i, **kw)
        walls.append((time.perf_counter() - t0) * 1e3)
    steady = sorted(walls[1:])
    m = len(steady)
    print(f"{tree}: median {steady[m // 2]:.1f} ms, q1 {steady[m // 4]:.1f}, "
          f"q3 {steady[3 * m // 4]:.1f}, all {[round(w, 1) for w in walls]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
