"""Convert an upstream model snapshot to `.vtpu` checkpoints (counterpart of
the repository's `scripts/convert_reference.py`):

    python -m vampnet_tpu_torch.scripts.convert_reference /path/to/snapshot \
        [--out models/vampnet] [--no-parity] [--device cpu]

The snapshot holds what the upstream hub ships:

    codec.pth  coarse.pth  c2f.pth  [wavebeat.pth]  [loras/<name>/{coarse,c2f}.pth]

and `--out` gets the same names as `.vtpu` files, byte for byte what the
JAX package's script writes. The registry prefers a `.vtpu` to the `.pth`
beside it, so with `--out` as the models directory `Interface.default()`
loads the converted files.

Stages:
  1. convert: `.pth` to `.vtpu` for the codec, coarse, c2f, wavebeat and
     every `loras/<name>/` directory (`checkpoints.py`, `convert.py`,
     `codec/convert.py`, `wavebeat.py`);
  2. smoke: the converted codec encodes and decodes a test tone on
     `device` (finite audio, more than 4 distinct codes);
  4. report: `<out>/CONVERSION_REPORT.md` with every stage's lines.

The JAX package's stage 2 also holds each converted LM's logits against
the upstream implementation, and its stage 3 records golden tokens from
upstream's `generate`. Both run the upstream reference code, which this
package does not load: they are not run here, and the report says so.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def _log(report: list, msg: str) -> None:
    print(msg, flush=True)
    report.append(msg)


def _codec_smoke(codec_cfg, codec_tree, report, device="cuda") -> np.ndarray:
    """Encode and decode a two-partial tone of 64 hops with the converted
    codec; returns the codes."""
    from .. import convert
    from ..codec import LAC
    from ..util import resolve_device

    device = resolve_device(device)
    codec = LAC(codec_cfg, device="meta").to_empty(device=device)
    codec.load_state_dict(convert.codec_state_dict_from_jax(codec_tree, codec_cfg))
    codec.requires_grad_(False).eval()
    t = np.arange(codec_cfg.hop_length * 64) / codec_cfg.sample_rate
    x = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 331 * t)
    audio = torch.from_numpy(x.astype(np.float32))[None, :, None].to(device)
    with torch.inference_mode():
        codes = codec.encode(audio)
        decoded = codec.decode_codes(codes)
    if not bool(torch.isfinite(decoded).all()):
        raise AssertionError("codec decode produced NaN or inf")
    codes = codes.cpu().numpy()
    used = len(np.unique(codes))
    _log(report, f"  encode->{codes.shape} codes, {used} distinct tokens, decode finite")
    if used <= 4:
        raise AssertionError("codec collapsed to a near-constant code stream")
    return codes


def convert_reference(snapshot: str, out: str = "models/vampnet", parity: bool = True,
                      device="cuda") -> Path:
    """Run the stages (module docstring); returns the output directory."""
    from ..checkpoints import load_codec, save_codec, save_lm, save_wavebeat
    from ..convert import lm_from_torch_checkpoint

    snap, out_dir = Path(snapshot), Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    report: list = [f"# Conversion report — {snap} -> {out_dir}", ""]
    t0 = time.time()

    # ---- stage 1: convert ----
    _log(report, "## 1. convert")
    if not (snap / "codec.pth").exists():
        raise FileNotFoundError(f"{snap}/codec.pth missing")
    codec_cfg, codec_tree = load_codec(snap / "codec.pth")
    save_codec(out_dir / "codec.vtpu", codec_cfg, codec_tree)
    _log(report, f"- codec.pth -> codec.vtpu ({codec_cfg.sample_rate} Hz, "
                 f"{codec_cfg.n_codebooks} cb x {codec_cfg.codebook_size})")

    for name in ("coarse", "c2f"):
        src = snap / f"{name}.pth"
        if not src.exists():
            raise FileNotFoundError(f"{src} missing")
        cfg, params = lm_from_torch_checkpoint(src)
        save_lm(out_dir / f"{name}.vtpu", cfg, params)
        _log(report, f"- {name}.pth -> {name}.vtpu ({cfg.n_layers}L/{cfg.n_heads}H/"
                     f"{cfg.embedding_dim}d, {cfg.n_codebooks} cb / "
                     f"{cfg.n_conditioning_codebooks} cond)")
        del params

    if (snap / "wavebeat.pth").exists():
        from ..wavebeat import dstcn_from_torch_checkpoint

        wb_cfg, wb_state = dstcn_from_torch_checkpoint(snap / "wavebeat.pth")
        save_wavebeat(out_dir / "wavebeat.vtpu", wb_cfg, wb_state)
        _log(report, f"- wavebeat.pth -> wavebeat.vtpu ({len(wb_cfg.blocks)} blocks @ "
                     f"{wb_cfg.sample_rate} Hz)")
    else:
        _log(report, "- wavebeat.pth absent (beat masks fall back to DP tracker)")

    lora_dirs = sorted((snap / "loras").glob("*")) if (snap / "loras").exists() else []
    for d in lora_dirs:
        for name in ("coarse", "c2f"):
            src = d / f"{name}.pth"
            if not src.exists():
                continue
            cfg, params = lm_from_torch_checkpoint(src)
            save_lm(out_dir / "loras" / d.name / f"{name}.vtpu", cfg, params)
            del params
        _log(report, f"- loras/{d.name} converted")

    # ---- stage 2: the codec's round trip ----
    if parity:
        _log(report, "\n## 2. parity smoke")
        _log(report, "- codec round-trip:")
        _codec_smoke(codec_cfg, codec_tree, report, device)
        _log(report, "- LM logits against the upstream implementation: not run (this "
                     "package does not load the upstream reference code)")
    _log(report, "\n## 3. reference golden tokens: not run (they need the upstream "
                 "reference's generate)")

    # ---- stage 4: the report ----
    _log(report, f"\ndone in {time.time() - t0:.1f}s")
    (out_dir / "CONVERSION_REPORT.md").write_text("\n".join(report) + "\n")
    print(f"report: {out_dir / 'CONVERSION_REPORT.md'}")
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("snapshot", help="snapshot directory holding the upstream .pth files")
    ap.add_argument("--out", default="models/vampnet")
    ap.add_argument("--no-parity", dest="parity", action="store_false",
                    help="skip the codec's round trip")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return convert_reference(args.snapshot, out=args.out, parity=args.parity,
                             device=args.device)


if __name__ == "__main__":
    main()
