"""Port parity: upstream torch checkpoints (`vampnet_tpu_torch/convert.py`,
`codec/convert.py`) against the JAX package's converters.

The LM files are built here from random flax trees in upstream's layout by
`chip_smoke.write_reference_lm` (the writer the card's run uses): the
audiotools wrapper and a raw state dict, `module.` and `_orig_mod.`
prefixes, LoRA rank 0 and 2. Adapter-only files are loralib dicts; the codec
file is the DAC-layout torch model of `tests/test_codec_convert.py`. Both
converters must give the same config and the same arrays bit for bit; the
converted LM must give back the tree it was written from, and the port's
encode must give the JAX codes.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_codec_convert import CFG as DAC_CFG
from test_codec_convert import TCodec
from test_torch_util import configs, lm_params_np, to_jax
from vampnet_tpu import convert as jconvert
from vampnet_tpu.codec import LAC as JLAC
from vampnet_tpu.codec import convert as jcodec_convert
from vampnet_tpu.modules import LMConfig as JLMConfig
from vampnet_tpu_torch import convert as tconvert
from vampnet_tpu_torch.codec import LAC
from vampnet_tpu_torch.codec import convert as tcodec_convert
from vampnet_tpu_torch.modules import LMConfig
from vampnet_tpu_torch.util import flatten_tree

# what the JAX converter takes from the metadata, else defaults (n_heads 20,
# vocab 1024, dropout 0.1): the raw-state-dict cases use a config that
# those defaults describe
RAW_KW = dict(n_heads=20, n_layers=1, n_codebooks=2, latent_dim=4, embedding_dim=40,
              vocab_size=1024, dropout=0.1)
INFERRED = ("n_heads", "n_layers", "n_codebooks", "n_conditioning_codebooks", "latent_dim",
            "embedding_dim", "vocab_size", "dropout", "lora_r")


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for path in want:
        g, w = np.asarray(got[path]), np.asarray(want[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _write(tmp_path, wrapper, prefix, lora_r):
    """An upstream-layout LM file from a random flax tree: (path, tree, cfg)."""
    if wrapper == "raw":
        jcfg = JLMConfig(lora_r=lora_r, **RAW_KW)
    else:
        jcfg = dataclasses.replace(configs()[2]["c2f"][0], lora_r=lora_r)
    tree = lm_params_np(jcfg, 11 + lora_r)
    tcfg = LMConfig(**dataclasses.asdict(jcfg))
    path = tmp_path / "lm.pth"
    chip_smoke.write_reference_lm(path, tconvert.lm_state_dict_from_jax(tree, tcfg), tcfg)
    obj = torch.load(path, weights_only=False)
    sd = {prefix + k: v for k, v in obj["state_dict"].items()}
    torch.save(sd if wrapper == "raw" else dict(obj, state_dict=sd), path)
    return path, tree, jcfg


@pytest.mark.parametrize("wrapper,prefix,lora_r", [
    ("audiotools", "", 0), ("audiotools", "module.", 2), ("raw", "_orig_mod.", 2),
    ("raw", "module._orig_mod.", 0)])
def test_lm_converter_matches_jax(tmp_path, wrapper, prefix, lora_r):
    path, tree, jcfg = _write(tmp_path, wrapper, prefix, lora_r)
    want_cfg, want = jconvert.lm_from_torch_checkpoint(path)
    cfg, got = tconvert.lm_from_torch_checkpoint(path)
    assert isinstance(cfg, LMConfig) and dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    _assert_trees_equal(got, want)
    assert {k: getattr(cfg, k) for k in INFERRED} == {k: getattr(jcfg, k) for k in INFERRED}

    # the file holds the tree it was written from: exact but for the
    # classifier, which weight norm's g v / |v| gives back within fp32 rounding
    flat, src = flatten_tree(got), flatten_tree(tree)
    assert set(flat) == set(src)
    for p, x in src.items():
        if p == ("classifier", "kernel"):
            np.testing.assert_allclose(flat[p].numpy(), x, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(flat[p].numpy(), x, err_msg=str(p))


@pytest.mark.parametrize("wrapped", [False, True])
def test_lora_converter_matches_jax(tmp_path, wrapped):
    rng = np.random.default_rng(3)
    sd = {}
    for i in range(2):
        for site, (d_in, d_out) in (("self_attn.w_qs", (16, 16)), ("feed_forward.w_2", (32, 16))):
            sd[f"module.transformer.layers.{i}.{site}.lora_A"] = torch.from_numpy(
                rng.standard_normal((4, d_in)).astype(np.float32))
            sd[f"module.transformer.layers.{i}.{site}.lora_B"] = torch.from_numpy(
                rng.standard_normal((d_out, 4)).astype(np.float32))
    sd["module.transformer.layers.0.self_attn.w_qs.weight"] = torch.zeros(16, 16)  # skipped
    torch.save({"state_dict": sd, "metadata": {}} if wrapped else sd, tmp_path / "lora.pth")
    want = jconvert.lora_from_torch_checkpoint(tmp_path / "lora.pth")
    got = tconvert.lora_from_torch_checkpoint(tmp_path / "lora.pth")
    _assert_trees_equal(got, want)
    assert len(flatten_tree(got)) == 8
    np.testing.assert_array_equal(
        got["transformer"]["layers_1"]["feed_forward"]["w_2"]["lora_b"].numpy(),
        sd["module.transformer.layers.1.feed_forward.w_2.lora_B"].numpy().T)


@pytest.fixture(scope="module")
def dac_file(tmp_path_factory):
    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("dac") / "codec.pth"
    torch.save({"state_dict": TCodec(DAC_CFG).state_dict(),
                "metadata": {"kwargs": {"sample_rate": 16000}}}, path)
    return path


def test_codec_converter_matches_jax(dac_file):
    want_cfg, want = jcodec_convert.codec_from_torch_checkpoint(dac_file)
    cfg, got = tcodec_convert.codec_from_torch_checkpoint(dac_file)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(DAC_CFG)
    _assert_trees_equal(got, want)


def test_converted_codec_encodes_the_jax_codes(dac_file):
    want_cfg, want = jcodec_convert.codec_from_torch_checkpoint(dac_file)
    cfg, tree = tcodec_convert.codec_from_torch_checkpoint(dac_file)
    codec = LAC(cfg, device="cpu")
    codec.load_state_dict(tconvert.codec_state_dict_from_jax(tree, cfg), strict=True)
    audio = (0.3 * np.random.default_rng(4).standard_normal((2, cfg.hop_length * 16, 1)))
    audio = audio.astype(np.float32)
    want_codes = JLAC(want_cfg).apply({"params": to_jax(want)}, jnp.asarray(audio),
                                      method="encode")["codes"]
    with torch.no_grad():
        got = codec.encode(torch.from_numpy(audio))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_codes))
