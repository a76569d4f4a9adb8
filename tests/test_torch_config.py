"""Port parity: the config system (`vampnet_tpu_torch/config.py`) against
the JAX package's `vampnet_tpu.config` and PyYAML.

The port carries its own reader and writer for the YAML subset that the
repo's configs and CLI values use; here they are held to `yaml.safe_load`
on every config in `configs/` and on CLI values, and the argbind surface
(`load_config`, `parse_args`, `scope`, `bound`, `bind_kwargs`, `dump_args`,
`generate_conf`) to the JAX module's, mirroring `tests/test_config.py`.
Everything here is exact: parsed values must be equal and of one type.
"""
import math
from pathlib import Path

import pytest
import yaml

from vampnet_tpu import config as jcfg
from vampnet_tpu_torch import config as tcfg

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.relative_to(REPO) for p in (REPO / "configs").rglob("*.yml"))


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=str)
def test_reader_matches_safe_load_on_repo_configs(path):
    text = (REPO / path).read_text()
    assert _same(tcfg.loads(text), yaml.safe_load(text) or {})
    # and the whole include chain, as both packages resolve it
    assert _same(tcfg.load_config(REPO / path), jcfg.load_config(REPO / path))


CLI_VALUES = ["5", "-3", "+7", "0", "1_000", "08", "0.1", "-30.0", "1.", ".5", "1e-4", "1.0e-4",
              "3.0e+5", ".inf", "-.Inf", ".NaN", "true", "False", "yes", "Off", "null", "~", "",
              "runs/x", "./models/vampnet/codec.pth", "a b", "it's", "x #comment", "[]",
              "[1, 2]", "[1,2,]", "[a, 'b c', \"d\"]", "[0.5, null, true]", "'quoted'",
              "\"dq \\\" \\\\ x\"", "bfloat16", "NoamScheduler.warmup", "$include"]


@pytest.mark.parametrize("value", CLI_VALUES)
def test_cli_values_match_safe_load(value):
    assert _same(tcfg._parse_value(value), yaml.safe_load(value))
    assert _same(tcfg._parse_value(value), jcfg._parse_value(value))


@pytest.mark.parametrize("value", ["0x1F", "0b101", "017", "1:30", "190:20:30.15", "2002-12-14",
                                   "{a: 1}", "&anchor x", "*alias", "!!str x", "|", ">",
                                   "[[1, 2]]", "a: b", "- item", "@x", "`x`", "=", "<<"])
def test_reader_refuses_what_is_outside_the_subset(value):
    with pytest.raises(ValueError, match="outside the YAML subset"):
        tcfg._parse_value(value)


@pytest.mark.parametrize("text", ["a:\n  b: 1\n", "a: |\n  text\n", "a: 1\n  continued\n",
                                  "---\na: 1\n", "- 1\n- 2\n", "a: [1, [2]]\n",
                                  "a:\n\t- 1\n", "a: &x 1\n"])
def test_loads_refuses_documents_outside_the_subset(text):
    with pytest.raises(ValueError, match="line [0-9]+: .*outside the YAML subset"):
        tcfg.loads(text)


def test_loads_matches_safe_load_on_layouts():
    text = ("# head comment\n"
            "a: 1   # trailing\n"
            "b:\n"
            "  - x\n"
            "  - 'y # not a comment'\n"
            "c:\n"
            "- 1.5\n"
            "- null\n"
            "d:\n"
            "e: []\n"
            "'quoted key': \"v\"\n"
            "url: http://host:80/x\n"
            "a: 2\n")  # a repeated key: the last wins, as in PyYAML
    assert _same(tcfg.loads(text), yaml.safe_load(text))
    assert tcfg.loads("") == {} and tcfg.loads("# only a comment\n") == {}


def test_include_chain(tmp_path):
    (tmp_path / "base.yml").write_text("a: 1\nb: 2\nX.attr: 10\n")
    (tmp_path / "mid.yml").write_text(f"$include:\n  - {tmp_path}/base.yml\nb: 3\n")
    (tmp_path / "top.yml").write_text(f"$include:\n  - {tmp_path}/mid.yml\na: 9\n")
    cfg = tcfg.load_config(tmp_path / "top.yml")
    assert cfg == {"a": 9, "b": 3, "X.attr": 10}
    assert cfg == jcfg.load_config(tmp_path / "top.yml")


def test_repo_lora_and_s2s_configs_resolve():
    cfg = tcfg.load_config(REPO / "configs" / "lora" / "lora.yml")
    assert cfg["fine_tune"] is True and cfg["batch_size"] == 7
    assert cfg["VampNet.n_layers"] == 20 and cfg["AdamW.lr"] == 0.0001
    s2s = tcfg.load_config(REPO / "configs" / "lora" / "lora-s2s.yml")
    assert s2s["Sketch2SoundController.ctrl_keys"] == ["rmsq16"] and s2s["fine_tune"] is True


@pytest.mark.parametrize("argv", [
    ["--VampNet.n_layers", "5", "--save_path", "runs/x", "--save_iters", "10", "20", "--flag"],
    ["--key=1", "--b", "x", "--c", "[1, 2]", "--d", "0.5", "--e", "null"],
    ["--AdamW.state_dtype", "bfloat16", "--VampNet.remat", "true", "--mesh.dp", "null"],
])
def test_parse_args_matches_jax(tmp_path, argv):
    (tmp_path / "c.yml").write_text("batch_size: 4\nVampNet.n_layers: 2\n")
    full = ["--args.load", str(tmp_path / "c.yml"), *argv]
    assert _same(tcfg.parse_args(full), jcfg.parse_args(full))


def test_parse_args_load_and_overrides(tmp_path):
    (tmp_path / "c.yml").write_text("batch_size: 4\nVampNet.n_layers: 2\n")
    args = tcfg.parse_args(["--args.load", str(tmp_path / "c.yml"), "--VampNet.n_layers", "5",
                            "--save_path", "runs/x", "--save_iters", "10", "20", "--flag"])
    assert args["batch_size"] == 4 and args["VampNet.n_layers"] == 5
    assert args["save_path"] == "runs/x" and args["save_iters"] == [10, 20]
    assert args["flag"] is True


def test_scope_bound_and_bind_kwargs_match_jax():
    args = {"AudioDataset.duration": 10.0, "train/AudioDataset.duration": 3.0,
            "AudioLoader.sources": ["a"], "train/AudioLoader.sources": ["b"],
            "val/AudioLoader.sources": ["c"], "AudioLoader.shuffle": False,
            "AudioLoader.x.y": 1}
    for mod in (tcfg, jcfg):
        assert mod.bound(args, "AudioDataset", "duration") == 10.0
    for name in ("train", "val", ""):
        with tcfg.scope(args, name), jcfg.scope(args, name):
            assert tcfg.bound(args, "AudioDataset", "duration") == \
                jcfg.bound(args, "AudioDataset", "duration")
            kw = dict(sources=[], shuffle=True, relative_path="")
            assert tcfg.bind_kwargs(args, "AudioLoader", **kw) == \
                jcfg.bind_kwargs(args, "AudioLoader", **kw)
    with tcfg.scope(args, "train"):
        assert tcfg.bound(args, "AudioDataset", "duration") == 3.0
        assert tcfg.bind_kwargs(args, "AudioLoader", sources=[])["sources"] == ["b"]
    assert tcfg.bound(args, "AudioDataset", "duration") == 10.0


def test_dump_args_reads_back_in_both_loaders(tmp_path):
    args = {"a": 1, "save_iters": [10000, 50000], "empty": [], "x": None, "flag": True,
            "lr": 1e-05, "big": 1e+16, "neg": -30.0, "inf": float("inf"), "s": "runs/x",
            "t": "true", "n": "1.0", "q": "it's", "sp": "a b", "colon": "a:b", "dash": "-x",
            "train/AudioLoader.sources": ["./data/audio-train"], "$include": ["base.yml"]}
    tcfg.dump_args(args, tmp_path / "args.yml")
    text = (tmp_path / "args.yml").read_text()
    assert _same(yaml.safe_load(text), args)
    assert _same(tcfg.loads(text), args)
    # the JAX writer's output reads back in the port's reader
    jcfg.dump_args(args, tmp_path / "jargs.yml")
    assert _same(tcfg.loads((tmp_path / "jargs.yml").read_text()), args)
    with pytest.raises(ValueError, match="cannot write"):
        tcfg.dump_args({"d": {"nested": 1}}, tmp_path / "bad.yml")


def test_generate_conf_matches_jax(tmp_path):
    tcfg.generate_conf(tmp_path / "g.yml", include=["base.yml"], overrides={"x": 1, "y": [2]})
    jcfg.generate_conf(tmp_path / "j.yml", include=["base.yml"], overrides={"x": 1, "y": [2]})
    text = (tmp_path / "g.yml").read_text()
    assert "$include" in text and "x: 1" in text
    assert text.index("$include") < text.index("x: 1")  # written in order, not sorted
    assert yaml.safe_load(text) == yaml.safe_load((tmp_path / "j.yml").read_text())
    (tmp_path / "base.yml").write_text("z: 3\n")
    assert tcfg.load_config(tmp_path / "g.yml") == jcfg.load_config(tmp_path / "j.yml")
