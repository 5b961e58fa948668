"""The port's configuration (speech_enhancement_tpu_torch/config) against the
JAX package's, on the CPU.

* The overlay reader gives what ``yaml.safe_load`` gives on each of the
  port's overlays and on each of the JAX package's (read as data), and on
  values that reach every branch of YAML 1.1's scalar resolution; it
  refuses what is outside its subset, naming the line.
* ``load_config`` and ``get_config`` give the JAX ``load_config``'s fields
  for the defaults, ``BASE`` inheritance, ``--opts`` and each keyword
  override.
* The port's overlays are byte-for-byte copies of the JAX ones.
"""

import argparse
import dataclasses
import math
import os

import pytest
import yaml

import speech_enhancement_tpu.config as jax_config_pkg
import speech_enhancement_tpu_torch.config as port_config_pkg
from speech_enhancement_tpu.config import get_config as jax_get_config
from speech_enhancement_tpu.config import load_config as jax_load_config
from speech_enhancement_tpu_torch.config import (
    OverlayError,
    get_config,
    load_config,
    parse_overlay,
    parse_value,
)

JAX_DIR = os.path.dirname(jax_config_pkg.__file__)
PORT_DIR = os.path.dirname(port_config_pkg.__file__)
PORT_OVERLAYS = ["baseline.yaml", "scp.yaml", "server.yaml"]


def _equal(got, want):
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("path", [os.path.join(PORT_DIR, n) for n in PORT_OVERLAYS]
                         + [os.path.join(JAX_DIR, n) for n in sorted(os.listdir(JAX_DIR))
                            if n.endswith(".yaml")])
def test_overlay_reads_as_yaml_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert parse_overlay(text) == (yaml.safe_load(text) or {})


@pytest.mark.parametrize("name", PORT_OVERLAYS)
def test_port_overlays_are_copies(name):
    with open(os.path.join(PORT_DIR, name), "rb") as port, \
            open(os.path.join(JAX_DIR, name), "rb") as jax_copy:
        assert port.read() == jax_copy.read()


VALUES = [
    "", "~", "null", "NULL", "yes", "No", "ON", "off", "true", "False", "0", "-5", "+7", "010",
    "08", "0x1F", "-0x1f", "0b101", "1_000", "3.", ".5", "-2.5", "1.0e-3", "1.0e+3", "1e-3",
    "1.0e3", "+.5", "-.inf", ".Inf", ".NaN", "abc", "abc def", "a#b", "a # comment",
    "../data/x y/z.wav", "'quoted # kept'", "'it''s'", '"a\\tb\\n\\"c\\""', "''",
    "[0.3, 0.7, 0.2, 0.05]", "[]", "[a, 'b c', 3, yes, ~]", "[a, ]", "[1, 2]  # comment",
]


@pytest.mark.parametrize("text", VALUES)
def test_value_reads_as_yaml_safe_load(text):
    got, want = parse_value(text), yaml.safe_load(text)
    if isinstance(want, list):
        assert len(got) == len(want) and all(_equal(g, w) for g, w in zip(got, want))
    else:
        assert _equal(got, want)


def test_nested_blocks_and_comments():
    text = ("# header\nA: 1  # trailing\nB:\n  C: [1, 2]\n  D:\n    E: 'x'\n\n  F: yes\n"
            "G:\nH: 2\nA: 3\n")
    assert parse_overlay(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text, line", [
    ("A:\n  - 1\n", 2), ("A: {a: 1}\n", 1), ("A: &x 1\n", 1), ("A: *x\n", 1),
    ("A: !!str 1\n", 1), ("A: |\n  x\n", 1), ("A:\n\tB: 1\n", 2), ("A: 1\n  B: 2\n", 2),
    ("A:\n    B: 1\n  C: 2\n", 3), ("A: 2001-01-01\n", 1), ("A: 1:30\n", 1), ("---\nA: 1\n", 1),
    ("A: b: c\n", 1), ("'A': 1\n", 1), ("A: [1, [2]]\n", 1), ("A: 'open\n", 1),
    ('A: "\\x41"\n', 1), ("A 1\n", 1),
])
def test_outside_the_subset_is_refused_with_its_line(text, line):
    with pytest.raises(OverlayError, match=f"line {line}:"):
        parse_overlay(text)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_defaults_equal_jax():
    assert _fields(load_config()) == _fields(jax_load_config())


def test_base_inheritance_opts_and_overrides_equal_jax(tmp_path):
    (tmp_path / "base.yaml").write_text("LOSS_WEIGHTS: [0.1, 0.9, 0.2, 0.05]\nN_FFT: 512\n")
    child = tmp_path / "child.yaml"
    child.write_text("BASE: [base.yaml]\nLOSS_WEIGHTS: [0.3, 0.7, 0.2, 0.05]\n"
                     "TRAIN:\n  SCHEDULER:\n    LR: 0.005\nDATA:\n  TEST_CLEAN_DIR: 'a b'\n")
    opts = ["DATA.BATCH_SIZE", "8", "TRAIN.SCHEDULER.LR", "1e-3", "CROP_LEN", "2",
            "NOISE_SCHEDULE", "20", "INFERENCE_NOISE_SCHEDULE", "[0.1, 0.2]", "TAG", "run 1",
            "TRAIN.OPTIMIZER.NAME", "adamw", "LOSS_WEIGHTS", "[1, 2.5]"]
    overrides = dict(batch_size=4, arch="scp", resume="r", output="out", tag="t",
                     optimizer="lamb", lr=0.02, epochs=12, crop_len=3, rank=1,
                     criterion="l2")
    for kw in [{}] + [{k: v} for k, v in overrides.items()] + [overrides]:
        got = load_config(str(child), opts=opts, **kw)
        want = jax_load_config(str(child), opts=opts, **kw)
        assert _fields(got) == _fields(want), kw
    assert got.N_FFT == 512 and got.TRAIN.SCHEDULER.LR == 0.02 and got.DATA.BATCH_SIZE == 4


def test_packaged_overlays_equal_jax():
    for name in PORT_OVERLAYS:
        got = load_config(os.path.join(PORT_DIR, name))
        assert _fields(got) == _fields(jax_load_config(os.path.join(JAX_DIR, name)))
    assert load_config(os.path.join(PORT_DIR, "scp.yaml")).LOSS_WEIGHTS == [0.3, 0.7, 0.2, 0.05]


def test_get_config_equals_jax():
    ns = argparse.Namespace(cfg=os.path.join(PORT_DIR, "scp.yaml"), opts=["N_FFT", "320"],
                            batch_size=None, arch="cmgan", resume="", output="o", tag=None,
                            optimizer="sgd", lr=0.01, epochs=3, crop_len=1, rank=0,
                            criterion="l1", unrelated=5)
    assert _fields(get_config(ns)) == _fields(jax_get_config(ns))


def test_unknown_keys_raise():
    with pytest.raises(KeyError):
        load_config(colour="red")
    with pytest.raises(ValueError):
        load_config(opts=["DATA.BATCH_SIZE"])
