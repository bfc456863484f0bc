"""The training CLI's config layer against the JAX package's: the port's own
flat-YAML writer and reader held to PyYAML both ways (the chip machine has
no PyYAML), the presets and field help, and train_torch.py's flags against
train.py's."""

import dataclasses
import math
import os

import pytest
import yaml

import train
import train_torch
from gaussian_splatting_torch import config as tconfig
from gaussian_splatting_tpu import config as jconfig
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFSCALE_YAML = os.path.join(ROOT, "runs", "refscale7k", "config.yaml")

# strings that PyYAML writes plain, single-quoted, double-quoted or folded
ODD_STRINGS = [
    "", "garden", "runs/refscale7k", "/tmp/a-b_c.d", "a b", "true", "No", "null",
    "~", "123", "1.5", "1e5", ".5", "0x1f", "1_000", "2024-01-01", "it's", "a: b",
    "#x", "x#y", "-x", "[x]", "*x", " lead", "trail ", "a\nb", "a\n\nb", "tab\there",
    "é", "\x07", "ünï " * 30,
]


def _jax_configs():
    with open(REFSCALE_YAML) as f:
        refscale = jconfig.SplatConfig.from_yaml(f.read())
    return [
        jconfig.SplatConfig(),
        jconfig.preset("30k"),
        refscale,
        refscale.replace(tier_capacities=(4096, 2048, 64, 8), base_lr=1e-8,
                         far_thresh=float("inf"), uv_grad_threshold=1.5e-20),
        jconfig.SplatConfig(tier_capacities=()),
    ] + [jconfig.SplatConfig(dataset_path=s, output_dir=s[::-1]) for s in ODD_STRINGS]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same(a, b):
    """Equal values of equal types (floats by value, NaN equal to NaN)."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        assert type(x) is type(y), (k, x, y)
        if isinstance(x, float) and math.isnan(x):
            assert math.isnan(y), k
        else:
            assert x == y, (k, x, y)


@pytest.mark.parametrize("case", range(len(_jax_configs())))
def test_yaml_both_ways_against_pyyaml(case):
    """The port's text loads with yaml.safe_load to the JAX config's dict,
    and the port reads the JAX package's to_yaml (PyYAML) text back to the
    same fields."""
    jcfg = _jax_configs()[case]
    tcfg = tconfig.SplatConfig(**_fields(jcfg))
    want = dataclasses.asdict(jcfg)
    if want["tier_capacities"] is not None:
        want["tier_capacities"] = list(want["tier_capacities"])
    _same(yaml.safe_load(tcfg.to_yaml()), want)
    _same(_fields(tconfig.SplatConfig.from_yaml(jcfg.to_yaml())), _fields(jcfg))
    assert tconfig.SplatConfig.from_yaml(tcfg.to_yaml()) == tcfg


def test_reads_refscale_config_file():
    with open(REFSCALE_YAML) as f:
        text = f.read()
    got = tconfig.SplatConfig.from_yaml(text)
    _same(_fields(got), yaml.safe_load(text))
    assert (got.synthetic_points, got.synthetic_images, got.synthetic_init_points,
            got.synthetic_width, got.synthetic_height) == (1200000, 96, 200000, 1296, 840)


def test_reader_takes_flow_lists_comments_and_scalar_forms():
    text = ("---\n# a comment\ntier_capacities: [1, 2, 3]  \nseed: 0x1f\n"
            "chunk: 0o17\nuse_split: Off\ncheckpoint_path: ~\nbase_lr: .5e-3\n")
    assert tconfig._parse_flat_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        tconfig._parse_flat_yaml("seed: 1:30\n")
    with pytest.raises(ValueError):
        tconfig._parse_flat_yaml("  indented: 1\n")


def test_presets_and_field_help_equal_jax():
    """The JAX package's presets and help, apart from the help of the TPU
    fields the port does not read, which says so."""
    assert set(tconfig.FIELD_HELP) == set(jconfig.FIELD_HELP) == {
        f.name for f in dataclasses.fields(tconfig.SplatConfig)}
    for name, text in tconfig.FIELD_HELP.items():
        if name in tconfig.NOT_READ:
            assert text.startswith("JAX package only") and "not read" in text, name
            assert "%" not in text and text != jconfig.FIELD_HELP[name], name
        else:
            assert text == jconfig.FIELD_HELP[name], name
    for name in ("7k", "30k"):
        assert _fields(tconfig.preset(name)) == _fields(jconfig.preset(name))
    with pytest.raises(ValueError):
        tconfig.preset("synthetic")


def _options(parser):
    subs = parser._subparsers._group_actions[0].choices
    return {name: {s: a.default for a in p._actions for s in a.option_strings}
            for name, p in subs.items()}


def test_train_torch_accepts_every_flag_of_train():
    """Same presets, flags and defaults as train.py, plus --device (default
    cuda); a flag parses to the same config in both CLIs."""
    jopts, topts = _options(train.build_parser()), _options(train_torch.build_parser())
    assert jopts.keys() == topts.keys() == {"7k", "30k", "synthetic"}
    for name in jopts:
        extra = {k: v for k, v in topts[name].items() if k not in jopts[name]}
        assert extra == {"--device": "cuda"}
        assert {k: topts[name][k] for k in jopts[name]} == jopts[name]
    argv = ["synthetic", "--num_iters", "12", "--use_background", "false",
            "--tier_capacities", "8,4", "--base_lr", "0.001", "--dataset_path", "x"]
    jargs = vars(train.build_parser().parse_args(argv))
    targs = vars(train_torch.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert targs.pop("device") == "cpu"
    assert targs == jargs
