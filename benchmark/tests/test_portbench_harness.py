"""The harness at a size the CPU runs in seconds (`tiny.py`'s copy of the
benchmark): the result line's keys, discovery of new files by name, the
check for JAX, the yardstick's counts, and the reference beside the port.

    python -m pytest benchmark/tests -q

The driver's `pytest tests/` does not collect these; the card-only tests
(`test_portbench_control.py`) skip without a card.
"""
from __future__ import annotations

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tiny  # noqa: E402

from benchmark import roofline  # noqa: E402
from benchmark.reference import codec as ref_codec  # noqa: E402
from benchmark.reference import lm as ref_lm  # noqa: E402

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["tiny.closed", "tiny-train.b2"])
def test_result_line_has_the_contracts_keys(copy, workload):
    out = tiny.result(tiny.run(copy, "--workload", workload, "--seed", "2147483711",
                               "--seconds", "2", "--trace", "0"))
    assert list(out) == CONTRACT + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in out["metrics"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_has_breakdown_and_busy(copy):
    out = tiny.result(tiny.run(copy, "--workload", "tiny-train.b2", "--seed", "5",
                               "--seconds", "2", "--trace", "1"))
    assert list(out) == CONTRACT + ["breakdown", "checks"]
    assert set(out["device"]) >= {"busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "mfu.train" in out["metrics"] and "step_ms" not in out["metrics"]


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    """A cell added with its own traffic, limits and metric files runs, and
    no existing file but BENCHMARK.json (one entry more) changes."""
    copy = tiny.make_copy(tmp_path)
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.one", "config": "tiny", "traffic": "tiny-one",
                              "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "steps_seen.one", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "serving engine",
                              "moves": "audio_s_per_s", "workloads": ["tiny.one"]})
    mix = dict(tiny.serve_traffic(), arrival={"process": "closed", "clients": 1},
               clip_seconds=[0.5], top_p=[None])
    reader = ('def read(run):\n'
              '    return float(len(run.sut.recorder.calls))\n')
    for rel, content in {"BENCHMARK.json": spec, "benchmark/traffic/tiny-one.json": mix,
                         "benchmark/limits/tiny.one.json": tiny.SERVE_LIMITS,
                         "benchmark/metrics/steps_seen.one.py": reader}.items():
        (copy / rel).write_text(content if isinstance(content, str) else json.dumps(content))
    out = tiny.result(tiny.run(copy, "--workload", "tiny.one", "--seed", "3", "--seconds", "2",
                               "--trace", "1"))
    assert out["correct"] is True
    assert out["metrics"]["steps_seen.one"]["value"] > 0
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == []


def test_a_run_that_loaded_jax_prints_no_result(copy):
    """A stand-in `jax` module in the process: the run ends non-zero with no line."""
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax'); "
            "sys.path.insert(0, %r); from benchmark import run; "
            "sys.exit(run.main(sys.argv[1:], allow_cpu=True))" % str(copy))
    env = {"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code, "--workload", "tiny.closed", "--seed", "1",
                           "--seconds", "1"], capture_output=True, text=True, env=env,
                          cwd=copy, timeout=600)
    assert proc.returncode != 0
    assert proc.stdout.strip() == "" or not proc.stdout.strip().splitlines()[-1].startswith("{")
    assert "['jax']" in proc.stderr


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port(copy):
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run; "
            "rc = run.main(sys.argv[1:], allow_cpu=True); "
            "print(sorted({m.split('.')[0] for m in sys.modules}), file=sys.stderr); "
            "sys.exit(rc)" % str(copy))
    env = {"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin", "HOME": str(copy),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code, "--workload", "tiny.closed", "--seed", "1",
                           "--seconds", "1"], capture_output=True, text=True, env=env,
                          cwd=copy, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(ast.literal_eval(proc.stderr.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "vampnet_tpu"}
    assert "vampnet_tpu_torch" in loaded
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.lm, benchmark.reference.codec, "
            "benchmark.reference.sampling, benchmark.reference.audio, "
            "benchmark.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(copy))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin"}, timeout=300)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "vampnet_tpu", "vampnet_tpu_torch"}
    for path in (tiny.REPO / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not any(n.split(".")[0].startswith("vampnet") or n.startswith("jax")
                       for n in names), (path, names)


# ---------------------------------------------------------------- yardstick


def test_roofline_counts_by_hand():
    # K1 at b=2, t=4, h=3, d=8, bf16 bias: q, k, v, o 2*4*3*8*2 bytes each,
    # bias 3*4*4*2; QK^T and PV 2*t*t*d each per (b, h)
    flops, nbytes = roofline.k1_attention_fwd(2, 4, 3, 8)
    assert flops == 2 * 3 * (2 * 4 * 4 * 8) * 2
    assert nbytes == 4 * 384 + 96
    # K10 over (2, 5, 16): logits 160 fp32, keys 2x2 int64, tokens and
    # probabilities 10 x (8 + 4), three per-row knobs
    flops, nbytes = roofline.k10_sampler(2, 5, 16)
    assert flops == 160 * 31 and nbytes == 640 + 32 + 120 + 24
    # K4 / K8 at b=1, t=2, h=1, d=4, fp32 bias: act 16 bytes, rows 8
    assert roofline.k4_attention_fwd_lse(1, 2, 1, 4) == (2 * 32, 4 * 16 + 16 + 8)
    assert roofline.k8_attention_bwd(1, 2, 1, 4) == (5 * 32, 7 * 16 + 32 + 16)
    # an LM forward at t=2, d=4, 1 layer, 2 codebooks x latent 3, 2 predicted,
    # vocab 5: embedding 2*2*6*4; the layer's q, k, v, fc (4 d^2), w_1 (d x 4d)
    # and w_2 (2d x d) at 2 flops a product per token, attention 4*t*t*d;
    # the classifier 2*2*4*10
    assert roofline.lm_forward_flops(2, 4, 1, 2, 3, 2, 5) == 96 + 2 * 2 * (64 + 64 + 32) + 64 + 160
    # the least time takes the larger bound
    assert roofline.least_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 3.35e12) == pytest.approx(1.0)


def test_codec_flops_by_hand():
    # encoder dim 1, rates (2,): conv_in 1->1 k7 at 4 samples; a block at
    # dim 2 (res units at 1 channel, 4 samples; strided 1->2 k4 to 2 frames);
    # conv_out 2->2 k3 at 2 frames; 1 stage of 2-dim codes over 3 entries
    f = roofline.codec_encode_flops(4, 1, (2,), 1, 3, 2)
    res = 3 * (2 * 1 * 1 * 7 * 4 + 2 * 1 * 1 * 1 * 4)
    assert f == 2 * 7 * 4 + res + 2 * 1 * 2 * 4 * 2 + 2 * 2 * 2 * 3 * 2 + 2 * (8 + 12 + 8)
    # decoder over 2 frames: out_proj 2->2, conv_in 2->4 k7, a block (4->2,
    # k4, to 4 samples, res units at 2), conv_out 2->1 k7
    g = roofline.codec_decode_flops(2, 1, (2,), 4, (2,), 1, 2)
    assert g == (2 * 2 * 2 * 2 + 2 * 2 * 4 * 7 * 2 + 2 * 4 * 2 * 4 * 2
                 + 3 * (2 * 2 * 2 * 7 * 4 + 2 * 2 * 2 * 1 * 4) + 2 * 2 * 1 * 7 * 4)


# ---------------------------------------------------------------- reference


def test_reference_names_the_ports_tensors():
    from vampnet_tpu_torch.codec import LAC, CodecConfig
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM

    cfg = json.loads((tiny.REPO / "benchmark/configs/vampnet.json").read_text())
    for name, port in (("coarse", LMConfig.coarse()), ("c2f", LMConfig.c2f())):
        ref = ref_lm.param_shapes(ref_lm.config_from(cfg[name]))
        got = {k: tuple(v.shape) for k, v in VampNetLM(port, device="meta").state_dict().items()}
        assert ref == got
    ref = ref_codec.param_shapes(ref_codec.config_from(cfg["codec"]))
    got = {k: tuple(v.shape) for k, v in LAC(CodecConfig(), device="meta").state_dict().items()}
    assert ref == got


def _tiny_models():
    from benchmark.harness import weights
    from vampnet_tpu_torch.codec import LAC, CodecConfig
    from vampnet_tpu_torch.modules import LMConfig, VampNetLM

    gen = torch.Generator().manual_seed(3)
    ccfg = {k: tuple(v) if isinstance(v, list) else v for k, v in tiny.CODEC.items()}
    lcfg = dict(tiny.LM, n_codebooks=4, n_conditioning_codebooks=2, compute_dtype="float32")
    rc, rl = ref_codec.config_from(ccfg), ref_lm.config_from(lcfg)
    cw = weights.codec_state(ref_codec.param_shapes(rc), gen)
    lw = weights.lm_state(ref_lm.param_shapes(rl), gen)
    codec = LAC(CodecConfig(**ccfg), device="meta").to_empty(device="cpu")
    codec.load_state_dict(cw)
    lm = VampNetLM(LMConfig(**lcfg), device="meta").to_empty(device="cpu")
    lm.load_state_dict(lw)
    return codec, lm, cw, lw, rc, rl


def test_reference_codec_and_lm_match_the_ports_fp32_path():
    codec, lm, cw, lw, rc, rl = _tiny_models()
    audio = torch.randn((2, 1, 8 * rc.hop_length), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        codes = ref_codec.encode(cw, rc, audio)
        assert torch.equal(codes, codec.encode(audio.transpose(1, 2)))
        wave = ref_codec.decode(cw, rc, codes)
        torch.testing.assert_close(wave, codec.decode_codes(codes).transpose(1, 2),
                                   rtol=1e-5, atol=1e-6)
        cbs = torch.stack([cw[f"quantizer.quantizers_{i}.codebook"] for i in range(4)])
        z = torch.randint(0, rl.vocab_size + 1, (2, 4, 11), generator=torch.Generator())
        torch.testing.assert_close(ref_lm.forward(lw, rl, z, cbs),
                                   lm.forward_codes(z, cbs), rtol=1e-4, atol=1e-5)


def test_reference_dropout_draws_are_the_ports():
    codec, lm, cw, lw, rc, rl = _tiny_models()
    cbs = torch.stack([cw[f"quantizer.quantizers_{i}.codebook"] for i in range(4)])
    z = torch.randint(0, rl.vocab_size, (2, 4, 9), generator=torch.Generator().manual_seed(4))
    got = lm.train().forward_codes(z, cbs, generator=torch.Generator().manual_seed(8))
    want = ref_lm.forward(lw, rl, z, cbs, generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(want, got.detach(), rtol=1e-4, atol=1e-5)


def test_typical_filter_sort_form_keeps_mass_and_count():
    from benchmark.reference import sampling

    logits = torch.randn((50, 64), generator=torch.Generator().manual_seed(2)) * 2
    keep, dist, thr = sampling.typical_keep(logits, 0.15, 8)
    p = torch.softmax(logits, -1)
    assert bool((keep.sum(-1) >= 8).all())
    assert bool(((p * keep).sum(-1) >= 0.15 - 1e-6).all())
    assert bool((dist[keep] <= thr.expand_as(dist)[keep]).all())


def test_replayed_draws_are_the_ports_streams():
    """The reference's Philox streams give the port's sampler noise,
    re-masking noise and folded keys bit for bit, for keys past 2^31."""
    from benchmark.reference import sampling
    from vampnet_tpu_torch.ops.sampler_kernel import philox_uniform
    from vampnet_tpu_torch.sampling.sample import fold_in_rows, gumbel_from_uniform, remask_noise

    for seed in (1, 2147483711, 2 ** 32 - 5):
        key = sampling.row_key(seed)
        keys = torch.tensor([key])
        assert torch.equal(sampling.sampler_noise(key, 3, 17, 64, "cpu"),
                           gumbel_from_uniform(philox_uniform(keys, 3, 17, 64))[0])
        assert torch.equal(sampling.remask_noise(key, 5, 33, "cpu"), remask_noise(keys, 5, 33)[0])
        assert sampling.row_key(seed, 4) == tuple(fold_in_rows(keys, 4)[0].tolist())


def test_a_step_samples_as_the_ports_sampler():
    """The reference's step picks the port's plain sampler's tokens with the
    same draws (typical filter, top-p, temperature, Gumbel noise), so their
    gaps are 0, and its keep choice is the port's re-masking's; a token
    placed off the pick has a gap."""
    from benchmark.reference import sampling
    from vampnet_tpu_torch.ops.sampler_kernel import fused_sample_plain
    from vampnet_tpu_torch.sampling.sample import mask_by_random_topk

    logits = torch.randn((40, 64), generator=torch.Generator().manual_seed(5)) * 2
    key = sampling.row_key(2147483711)
    for top_p in (None, 0.9):
        knobs = dict(temperature=0.8, top_p=top_p, sample_cutoff=1.0, typical_filtering=True,
                     typical_mass=0.15, typical_min_tokens=8)
        st = sampling.Step(logits, key, 2, 12, knobs)
        tokens, probs = fused_sample_plain(
            torch.tensor([key]), 2, logits[None], torch.tensor([0.8]), torch.tensor([1.0]),
            top_p=torch.tensor([top_p or 1.0]), typical_mass=0.15, typical_min_tokens=8,
            use_top_p=top_p is not None)
        assert torch.equal(st.pick, tokens[0])
        idx = torch.arange(40)
        assert float(st.token_gap(idx, tokens[0]).max()) == 0.0
        assert float(st.token_gap(idx, (tokens[0] + 1) % 64).min()) >= 0.0
        assert float(st.token_gap(idx, (tokens[0] + 1) % 64).max()) > 0.1
        masked = torch.arange(40) % 3 != 0
        conf = st.confidence(key, 2, 12, 10.5, masked)
        want = mask_by_random_topk(torch.tensor([[9]]),
                                   torch.where(masked, probs[0], float("inf"))[None],
                                   torch.tensor([10.5 * (1 - 3 / 12)]),
                                   row_keys=torch.tensor([key]), step=2)[0]
        logp = torch.gather(st.scaled, -1, st.pick[:, None])[:, 0] - st.log_z
        torch.testing.assert_close(logp, torch.log(probs[0]))
        assert torch.equal(sampling.remask(conf, 9), want)
        kept = masked & ~want
        assert float(sampling.keep_gap(conf, kept, want, st.flip_cost)) == 0.0
        assert float(sampling.keep_gap(conf, masked & want, kept, st.flip_cost)) > 0.0


def test_schedule_counts_as_the_port():
    from benchmark.reference import sampling
    from vampnet_tpu_torch.mask import _gamma

    for steps in (2, 12):
        for s in range(steps):
            r = (torch.tensor(float(s)) + 1.0) / steps
            want = int(torch.floor(_gamma(r) * torch.tensor(3448.0)))
            if s != steps - 1:
                want = max(min(3000 - 1, want), 1)
            assert sampling.n_to_mask(s, steps, 3448, 3000) == want
    assert math.isclose(roofline.H100_BF16_FLOPS, 989e12)
