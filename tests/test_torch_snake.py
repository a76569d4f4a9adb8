"""The LAC codec's fused snake route (`ops/snake.py`, `Snake1d.fused`, the
`forward_fused` methods of `codec/model.py`) against the plain composition
the codec's modules run, bit for bit, on the CPU.

On the card PyTorch's convolution adds its bias after cuDNN's product, in
an fp32 add of its own (`output.add_(bias)`); on the CPU oneDNN adds it
inside its product, in another rounding. So the comparisons of the "xla"
schedule run the convolutions as the card does (`card_conv`); the "matmul"
schedule adds its bias after its product on both. The kernel itself is held
against the plain version on the card by `python3 chip_smoke.py --only
snake`.
"""
import dataclasses
import types

import pytest
import torch
import torch.nn.functional as F

import test_torch_util  # noqa: F401  (one torch thread per xdist worker)
from test_torch_util import CODEC_KW
from vampnet_tpu_torch.codec import LAC, CodecConfig
from vampnet_tpu_torch.codec import layers
from vampnet_tpu_torch.codec.layers import Snake1d, WNConv1d, WNConvTranspose1d
from vampnet_tpu_torch.ops.snake import snake_fused, snake_fused_plain

IMPLS = ("xla", "matmul")


@pytest.fixture
def card_conv(monkeypatch):
    """F.conv1d and F.conv_transpose1d with the bias added after the product,
    as PyTorch's CUDA convolution adds it."""
    def bias_after(conv):
        def call(x, w, bias=None, *args, **kw):
            y = conv(x, w, None, *args, **kw)
            return y if bias is None else y.add_(bias[:, None])
        return call

    monkeypatch.setattr(F, "conv1d", bias_after(F.conv1d))
    monkeypatch.setattr(F, "conv_transpose1d", bias_after(F.conv_transpose1d))


def _fill(module, seed):
    """Weights whose activations stay O(1): weight-norm directions normal,
    gains 0.3-0.7, snake alphas 0.5-1.5, biases 0.1 normal, codebooks
    normal."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in module.state_dict().items():
        leaf = k.rsplit(".", 1)[-1]
        u, n = torch.rand(v.shape, generator=gen), torch.randn(v.shape, generator=gen)
        state[k] = {"g": 0.3 + 0.4 * u, "alpha": 0.5 + u, "bias": 0.1 * n}.get(leaf, n)
    module.load_state_dict(state)
    return module.requires_grad_(False)


def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("keep_sum", (False, True))
def test_conv_then_snake(card_conv, impl, keep_sum):
    """snake(conv(x) + bias): the snake of the conv's output without its bias,
    the bias folded into the snake's pass."""
    conv = _fill(WNConv1d(6, 5, 7, padding=9, dilation=3, impl=impl), 1)
    snake = _fill(Snake1d(5), 2)
    x = _randn(2, 6, 203)
    h = conv(x)
    got = snake.fused([conv.forward_nobias(x), conv.bias, None], keep_sum=keep_sum)
    if keep_sum:
        assert torch.equal(got[0], h)
        got = got[1]
    assert torch.equal(got, snake(h))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("keep_sum", (False, True))
def test_residual_add_then_snake(card_conv, impl, keep_sum):
    """x + conv(s), the residual unit's end, followed by the next snake: the
    bias and the residual both folded into the snake's pass."""
    conv = _fill(WNConv1d(5, 5, 1, impl=impl), 3)
    snake = _fill(Snake1d(5), 4)
    x, s = _randn(3, 5, 97, seed=5), _randn(3, 5, 97, seed=6)
    h = x + conv(s)
    got = snake.fused([conv.forward_nobias(s), conv.bias, x], keep_sum=keep_sum)
    if keep_sum:
        assert torch.equal(got[0], h)
        got = got[1]
    assert torch.equal(got, snake(h))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("stride", (2, 8))
def test_strided_convs_then_snake(card_conv, impl, stride):
    """The downsampling conv and the decoder's transposed conv before a snake."""
    snake = _fill(Snake1d(4), 7)
    x = _randn(2, 3, 96, seed=8)
    for conv in (WNConv1d(3, 4, 2 * stride, stride=stride, padding=stride // 2, impl=impl),
                 WNConvTranspose1d(3, 4, 2 * stride, stride=stride, padding=stride // 2,
                                   impl=impl)):
        conv = _fill(conv, 9)
        got = snake.fused([conv.forward_nobias(x), conv.bias, None])
        assert torch.equal(got, snake(conv(x)))


def _count_fused(monkeypatch):
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return snake_fused(*args, **kw)

    monkeypatch.setattr(layers, "snake_fused", counted)
    return calls


def _audio(b, n, seed=0):
    t = torch.arange(n) / 16000
    wav = 0.5 * torch.sin(2 * torch.pi * 220.0 * t) + 0.05 * _randn(b, n, seed=seed)
    return wav[:, :, None]


@pytest.mark.parametrize("impl", IMPLS)
def test_lac_fused_route_matches_plain(card_conv, monkeypatch, impl):
    """A whole encode and decode through the fused route: the same latents,
    codes and waveform bits as the plain composition, one snake pass for
    each of the encoder's and the decoder's snakes."""
    cfg = CodecConfig(**CODEC_KW, conv_impl=impl)
    codec = _fill(LAC(cfg, device="cpu"), 10)
    audio = _audio(2, 4 * cfg.hop_length * 5).transpose(1, 2)
    calls = _count_fused(monkeypatch)
    n_snakes = 7 * len(cfg.encoder_rates) + 1
    with torch.no_grad():
        z = codec.encoder.forward_plain(audio)
        z_fused = codec.encoder.forward_fused(audio)
        assert len(calls) == n_snakes
        assert torch.equal(z_fused, z)
        codes = codec.quantizer(z)[1]
        assert len(torch.unique(codes)) > 8  # the codes are not degenerate
        z_q = codec.quantizer.from_codes(codes)
        wav = codec.decoder.forward_plain(z_q)
        wav_fused = codec.decoder.forward_fused(z_q)
    assert len(calls) == n_snakes + 7 * len(cfg.decoder_rates) + 1
    assert torch.equal(wav_fused, wav)


def test_cpu_codec_takes_the_plain_composition(monkeypatch):
    """CPU tensors keep the plain composition: `encode` and `decode_codes`
    never reach the fused snake."""
    cfg = CodecConfig(**CODEC_KW)
    codec = _fill(LAC(cfg, device="cpu"), 11)
    calls = _count_fused(monkeypatch)
    audio = _audio(1, 4 * cfg.hop_length)
    with torch.no_grad():
        codes = codec.encode(audio)
        codec.decode_codes(codes)
    assert calls == []


def test_snake_fused_on_cpu_is_the_plain_version():
    y, res = _randn(2, 3, 11, seed=12), _randn(2, 3, 11, seed=13)
    bias, alpha = _randn(3, seed=14), _randn(3, seed=15)
    launches = snake_fused.launches
    for r in (None, res):
        x, s = snake_fused(y, bias, alpha, r, keep_sum=True)
        want_x, want_s = snake_fused_plain(y, bias, alpha, r, keep_sum=True)
        assert torch.equal(x, want_x) and torch.equal(s, want_s)
        assert torch.equal(x, (y + bias[:, None]) if r is None else r + (y + bias[:, None]))
        assert torch.equal(snake_fused(y, bias, alpha, r), s)
    assert snake_fused.launches == launches


_Y, _C = (2, 3, 8), 3
_REFUSED = {
    "y_2d": dict(y=torch.zeros(3, 8)),
    "bias_length": dict(bias=torch.zeros(4)),
    "alpha_2d": dict(alpha=torch.zeros(1, _C)),
    "residual_shape": dict(residual=torch.zeros(2, 3, 9)),
    "y_bf16": dict(y=torch.zeros(_Y, dtype=torch.bfloat16)),
    "bias_fp64": dict(bias=torch.zeros(_C, dtype=torch.float64)),
    "residual_fp16": dict(residual=torch.zeros(_Y, dtype=torch.float16)),
    "alpha_other_device": dict(alpha=torch.zeros(_C, device="meta")),
    "not_cpu_or_cuda": dict(y=torch.zeros(_Y, device="meta"), bias=torch.zeros(_C, device="meta"),
                            alpha=torch.zeros(_C, device="meta")),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_snake_fused_refuses(case):
    args = dict(y=torch.zeros(_Y), bias=torch.zeros(_C), alpha=torch.ones(_C), residual=None)
    args.update(_REFUSED[case])
    with pytest.raises(ValueError):
        snake_fused(args["y"], args["bias"], args["alpha"], args["residual"])


def test_route_choice():
    """The fused route for fp32 CUDA tensors that want no gradient; CPU
    tensors, a gradient through the input or the weights, and the bf16 and
    fp16 options (the decoder's alone too) keep the plain composition. A
    stand-in for a CUDA tensor: this machine has none."""
    from vampnet_tpu_torch.codec.model import _fused_route

    cuda = types.SimpleNamespace(is_cuda=True, requires_grad=False)
    codec = LAC(CodecConfig(**CODEC_KW), device="meta")
    enc, dec = codec.encoder, codec.decoder
    assert not _fused_route(enc, torch.zeros(1, 1, 8))
    with torch.no_grad():
        assert _fused_route(enc, cuda) and _fused_route(dec, cuda)
    assert not _fused_route(enc, cuda)  # the parameters want their gradient
    enc.requires_grad_(False)
    assert _fused_route(enc, cuda)
    assert not _fused_route(enc, types.SimpleNamespace(is_cuda=True, requires_grad=True))
    for opts, want in ((dict(compute_dtype="bfloat16"), [False, False]),
                       (dict(compute_dtype="float16"), [False, False]),
                       (dict(decoder_compute_dtype="bfloat16"), [True, False])):
        codec = LAC(dataclasses.replace(CodecConfig(**CODEC_KW), **opts), device="meta")
        with torch.no_grad():
            assert [_fused_route(m, cuda) for m in (codec.encoder, codec.decoder)] == want
