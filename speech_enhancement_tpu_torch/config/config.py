"""Configuration tree (port of speech_enhancement_tpu/config/config.py).

The same ``Config`` dataclass hierarchy with the same keys and defaults,
YAML overlays with recursive ``BASE`` inheritance, ``--opts KEY VALUE``
dot-path overrides, keyword overrides (the argparse promotion) and the
NOISE_SCHEDULE count -> linspace materialization.

PyYAML is not imported: the overlays are read by :func:`parse_overlay`, a
reader of the subset they use, which gives what ``yaml.safe_load`` gives
on it (YAML 1.1 scalar resolution) and refuses anything else with the
line number:

* block mappings nested by indentation (spaces only), ``key: value``
  with bare keys;
* values: flow lists ``[a, b]`` of scalars, single- and double-quoted
  strings, and bare scalars resolved as null, bool, int, float or str;
* ``#`` comments, on a line of their own or after a value.

Block sequences (``- item``), flow mappings, anchors, tags, multi-line
scalars, several documents, dates and base-60 numbers are outside it.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class DataConfig:
    TRAIN_CLEAN_DIR: str = "data/clean_trainset_28spk_wav"
    TRAIN_NOISY_DIR: str = "data/noisy_trainset_28spk_wav"
    TEST_CLEAN_DIR: str = "data/clean_testset_wav"
    TEST_NOISY_DIR: str = "data/noisy_testset_wav"
    BATCH_SIZE: int = 32


@dataclass
class OptimizerConfig:
    NAME: str = "sgd"


@dataclass
class CriterionConfig:
    NAME: str = "l1"


@dataclass
class SchedulerConfig:
    LR: float = 1e-2
    EPOCHS: int = 100
    CYCLE_LIMIT: int = 4
    WARMUP_EPOCHS: int = 4
    MIN_LR: float = 1e-6


@dataclass
class TrainConfig:
    OPTIMIZER: OptimizerConfig = field(default_factory=OptimizerConfig)
    CRITERION: CriterionConfig = field(default_factory=CriterionConfig)
    SCHEDULER: SchedulerConfig = field(default_factory=SchedulerConfig)


@dataclass
class ModelConfig:
    NAME: str = "diffuse"
    RESUME: str = ""


@dataclass
class Config:
    SAMPLE_RATE: int = 16000
    N_SPECS: int = 201
    N_FFT: int = 400
    HOP_SAMPLES: int = 100
    CROP_FRAMES: int = 160
    RESIDUAL_LAYERS: int = 30
    RESIDUAL_CHANNELS: int = 64
    DILATION_CYCLE_LENGTH: int = 10
    # declared as a step count; materialized to linspace(1e-4, 0.035, N)
    NOISE_SCHEDULE: Any = 50
    INFERENCE_NOISE_SCHEDULE: list = field(
        default_factory=lambda: [0.0001, 0.001, 0.01, 0.05, 0.2, 0.35])
    CROP_LEN: int = 1
    LOSS_WEIGHTS: list = field(default_factory=lambda: [0.1, 0.9, 0.2, 0.05])
    DATA: DataConfig = field(default_factory=DataConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    OUTPUT: str = ""
    TAG: str = "default"
    RANK: int = 0


# ---------------------------------------------------------------------------
# the overlay reader
# ---------------------------------------------------------------------------

class OverlayError(ValueError):
    """An overlay line outside the subset :func:`parse_overlay` reads."""


# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), for the tags
# the subset keeps
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")
_INDICATORS = set("[]{}&*!|>%@`'\"")
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "r": "\r", "/": "/", "0": "\0"}


def _refuse(lineno: int, what: str):
    raise OverlayError(f"line {lineno}: {what} is outside the overlay subset")


def _sign(text: str) -> tuple[int, str]:
    if text[:1] in "+-":
        return (-1 if text[0] == "-" else 1), text[1:]
    return 1, text


def _bare(text: str, lineno: int):
    """A plain scalar, resolved as PyYAML resolves it."""
    if _NULL.match(text):
        return None
    if text.startswith(("- ", "? ")) or text == "-" or text[0] in _INDICATORS:
        _refuse(lineno, f"the value {text!r}")
    if ": " in text or text.endswith(":") or " #" in text or "\t" in text:
        _refuse(lineno, f"the value {text!r}")
    if _BOOL.match(text):
        return text in _TRUE
    if _DATE.match(text) or text == "=" or text == "<<":
        _refuse(lineno, f"the value {text!r}")
    if _INT.match(text):
        if ":" in text:
            _refuse(lineno, f"the base-60 number {text!r}")
        sign, digits = _sign(text.replace("_", ""))
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits.startswith("0"):
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        if ":" in text:
            _refuse(lineno, f"the base-60 number {text!r}")
        sign, digits = _sign(text.replace("_", "").lower())
        if digits == ".inf":
            return sign * math.inf
        if digits == ".nan":
            return math.nan
        return sign * float(digits)
    return text


def _quoted(text: str, lineno: int) -> tuple[str, str]:
    """(the string a quoted scalar at the start of ``text`` holds, the rest
    of ``text`` after its closing quote)."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if quote == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                _refuse(lineno, f"the escape \\{esc}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if quote == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    _refuse(lineno, "a quoted string that does not end on its line")


def _strip_comment(text: str, lineno: int) -> str:
    """``text`` without a trailing ``# comment`` (outside quotes)."""
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " [,"):
            _, rest = _quoted(text[i:], lineno)
            i = len(text) - len(rest)
            continue
        if c == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _scalar(text: str, lineno: int):
    if text and text[0] in "'\"":
        value, rest = _quoted(text, lineno)
        if rest.strip():
            _refuse(lineno, f"text after a quoted string ({rest.strip()!r})")
        return value
    return _bare(text, lineno)


def _flow_list(text: str, lineno: int) -> list:
    """``[a, 'b', 3]`` -> a list of scalars."""
    if not text.endswith("]"):
        _refuse(lineno, f"the flow list {text!r}")
    body, items = text[1:-1].strip(), []
    while body:
        if body[0] in "'\"":
            value, body = _quoted(body, lineno)
            body = body.strip()
        else:
            end = body.find(",")
            token = (body if end < 0 else body[:end]).strip()
            if not token or token[0] in "[{":
                _refuse(lineno, f"the flow list {text!r}")
            value = _bare(token, lineno)
            body = "" if end < 0 else body[end:]
        items.append(value)
        if body and not body.startswith(","):
            _refuse(lineno, f"the flow list {text!r}")
        body = body[1:].strip()
    return items


def parse_value(text: str, lineno: int = 1):
    """One value: a flow list or a scalar, as ``yaml.safe_load`` reads it.
    Raises :class:`OverlayError` outside the subset."""
    text = _strip_comment(text.strip(), lineno)
    if text.startswith("["):
        return _flow_list(text, lineno)
    return _scalar(text, lineno)


def parse_overlay(text: str) -> dict:
    """The mapping an overlay's text holds (``{}`` for an empty one), as
    ``yaml.safe_load`` reads it; a later duplicate key wins, as there."""
    root: dict = {}
    # (indent, mapping) of the open blocks; a key whose value is on the
    # lines below opens a block at a deeper indent
    stack: list[tuple[int, dict]] = [(0, root)]
    pending: tuple[dict, str, int] | None = None  # (parent, key, its indent)
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            _refuse(lineno, "a tab in the indentation")
        line = _strip_comment(raw, lineno)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body in ("---", "...") or body.startswith(("- ", "%")) or body == "-":
            _refuse(lineno, f"{body!r}")
        if pending is not None:
            parent, key, key_indent = pending
            pending = None
            if indent > key_indent:
                parent[key] = {}
                stack.append((indent, parent[key]))
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            _refuse(lineno, "an indentation that matches no enclosing block")
        key, sep, value = body.partition(":")
        if not sep or not _KEY.match(key) or (value and not value.startswith(" ")):
            _refuse(lineno, f"the line {body!r}")
        mapping = stack[-1][1]
        value = value.strip()
        if value:
            mapping[key] = parse_value(value, lineno)
        else:
            mapping[key] = None  # a block below replaces it
            pending = (mapping, key, indent)
    return root


def read_overlay(path: str) -> dict:
    with open(path) as f:
        return parse_overlay(f.read())


# ---------------------------------------------------------------------------
# building a config
# ---------------------------------------------------------------------------

def _apply_dict(cfg: Any, values: dict) -> None:
    for key, val in values.items():
        if key == "BASE":
            continue
        if not hasattr(cfg, key):
            raise KeyError(f"unknown config key: {key}")
        cur = getattr(cfg, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _apply_dict(cur, val)
        else:
            setattr(cfg, key, val)


def _load_overlay_with_base(cfg: Config, path: str) -> None:
    tree = read_overlay(path)
    for base in tree.get("BASE", [""]):
        if base:
            _load_overlay_with_base(cfg, os.path.join(os.path.dirname(path), base))
    _apply_dict(cfg, tree)


def _apply_opts(cfg: Config, opts: list[str] | None) -> None:
    """KEY VALUE pair overrides with dotted paths (e.g. TRAIN.SCHEDULER.LR)."""
    if not opts:
        return
    if len(opts) % 2 != 0:
        raise ValueError("--opts expects KEY VALUE pairs")
    for key, raw in zip(opts[::2], opts[1::2]):
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        cur = getattr(obj, parts[-1])
        val: Any = raw
        try:
            val = parse_value(raw)
        except OverlayError:
            pass  # the string as given
        if isinstance(cur, bool):
            val = bool(val)
        elif isinstance(cur, int) and not isinstance(val, (bool, list)):
            # a list stays a list: NOISE_SCHEDULE takes a count or the betas
            val = int(val)
        elif isinstance(cur, float):
            val = float(val)
        setattr(obj, parts[-1], val)


# keyword override -> its dotted config path (the argparse promotion)
_OVERRIDES = {
    "batch_size": "DATA.BATCH_SIZE", "arch": "MODEL.NAME", "resume": "MODEL.RESUME",
    "output": "OUTPUT", "tag": "TAG", "optimizer": "TRAIN.OPTIMIZER.NAME",
    "lr": "TRAIN.SCHEDULER.LR", "epochs": "TRAIN.SCHEDULER.EPOCHS", "crop_len": "CROP_LEN",
    "rank": "RANK", "criterion": "TRAIN.CRITERION.NAME",
}


def load_config(cfg_file: str | None = None, opts: list[str] | None = None,
                **overrides: Any) -> Config:
    """Build a config: defaults -> overlay (with BASE inheritance) -> --opts
    -> keyword overrides (None values skipped)."""
    cfg = Config()
    if cfg_file:
        _load_overlay_with_base(cfg, cfg_file)
    _apply_opts(cfg, opts)
    for key, val in overrides.items():
        if val is None:
            continue
        if key not in _OVERRIDES:
            raise KeyError(f"unknown override {key!r}")
        *parents, name = _OVERRIDES[key].split(".")
        obj = cfg
        for p in parents:
            obj = getattr(obj, p)
        setattr(obj, name, val)
    if isinstance(cfg.NOISE_SCHEDULE, int):
        cfg.NOISE_SCHEDULE = np.linspace(1e-4, 0.035, cfg.NOISE_SCHEDULE).tolist()
    cfg.OUTPUT = os.path.join(cfg.OUTPUT, cfg.MODEL.NAME, cfg.TAG)
    return cfg


def get_config(args) -> Config:
    """Config from an argparse namespace: each override key that the
    namespace has and sets (truthy) is passed on."""
    kwargs = {key: getattr(args, key) for key in _OVERRIDES if getattr(args, key, None)}
    return load_config(getattr(args, "cfg", None), getattr(args, "opts", None), **kwargs)
