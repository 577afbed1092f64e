"""Config files of the configuru ``.cfg`` syntax, and the views serving and
training need.

A copy of the parts of ``lattice_net_tpu/config.py`` that
``Predictor.from_config`` and the trainer read: the parser (JSON with
``//`` comments, unquoted keys, optional commas, nested ``name: { ... }``
sections), ``apply_overrides``, ``parse_sigmas``, ``LatticeParams``,
``TrainParams`` and ``model_params_from_config``.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any

from lattice_net_tpu_torch.models.lnn import ModelParams


class ConfigError(ValueError):
    pass


class _Parser:
    def __init__(self, text: str):
        # strip // comments (not inside strings)
        self.text = re.sub(r'//[^\n]*', "", text)
        self.pos = 0

    def error(self, msg):
        line = self.text[: self.pos].count("\n") + 1
        raise ConfigError(f"line {line}: {msg}")

    def skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t\r\n,":
            self.pos += 1

    def peek(self):
        self.skip_ws()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def parse_document(self) -> dict:
        # top level is a sequence of key: value pairs (configuru CFG style)
        out = {}
        while True:
            self.skip_ws()
            if self.pos >= len(self.text):
                return out
            key = self.parse_key()
            self.expect(":")
            out[key] = self.parse_value()

    def parse_key(self) -> str:
        self.skip_ws()
        if self.peek() == '"':
            return self.parse_string()
        m = re.match(r"[A-Za-z_][A-Za-z0-9_\-.]*", self.text[self.pos :])
        if not m:
            self.error("expected key")
        self.pos += m.end()
        return m.group(0)

    def expect(self, ch):
        self.skip_ws()
        if self.pos >= len(self.text) or self.text[self.pos] != ch:
            self.error(f"expected '{ch}'")
        self.pos += 1

    def parse_value(self) -> Any:
        c = self.peek()
        if c == "{":
            return self.parse_object()
        if c == "[":
            return self.parse_array()
        if c == '"':
            return self.parse_string()
        m = re.match(r"[^\s,\]\}]+", self.text[self.pos :])
        if not m:
            self.error("expected value")
        tok = m.group(0)
        self.pos += m.end()
        if tok == "true":
            return True
        if tok == "false":
            return False
        if tok in ("null", "nil"):
            return None
        try:
            if re.fullmatch(r"[+-]?\d+", tok):
                return int(tok)
            return float(tok)
        except ValueError:
            return tok  # bare word

    def parse_object(self) -> dict:
        self.expect("{")
        out = {}
        while True:
            if self.peek() == "}":
                self.pos += 1
                return out
            if self.pos >= len(self.text):
                self.error("unterminated object")
            key = self.parse_key()
            self.expect(":")
            out[key] = self.parse_value()

    def parse_array(self) -> list:
        self.expect("[")
        out = []
        while True:
            if self.peek() == "]":
                self.pos += 1
                return out
            if self.pos >= len(self.text):
                self.error("unterminated array")
            out.append(self.parse_value())

    def parse_string(self) -> str:
        self.expect('"')
        start = self.pos
        buf = []
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "\\":
                buf.append(self.text[self.pos + 1])
                self.pos += 2
                continue
            if ch == '"':
                self.pos += 1
                return "".join(buf)
            buf.append(ch)
            self.pos += 1
        self.error("unterminated string")


def load_config(path_or_text) -> dict:
    """Parse a configuru-style .cfg file (or raw text) into nested dicts."""
    p = Path(str(path_or_text))
    text = p.read_text() if p.exists() else str(path_or_text)
    return _Parser(text).parse_document()


def apply_overrides(cfg: dict, overrides) -> dict:
    """Apply ``section.key=value`` overrides (e.g. ``train.lr=0.003``) onto a
    parsed config: dotted paths descend into (and create) nested sections,
    and values are parsed with the file's value grammar (numbers, booleans,
    ``[..]`` arrays, quoted or bare strings).  Returns ``cfg`` mutated."""
    for item in overrides or ():
        if "=" not in item:
            raise ConfigError(f"override {item!r} is not of the form section.key=value")
        path, _, raw = item.partition("=")
        keys = path.strip().split(".")
        if not all(keys):
            raise ConfigError(f"override {item!r} has an empty key segment")
        node = cfg
        for k in keys[:-1]:
            nxt = node.setdefault(k, {})
            if not isinstance(nxt, dict):
                raise ConfigError(f"override {item!r}: {k!r} is not a section")
            node = nxt
        node[keys[-1]] = _Parser(raw.strip()).parse_value() if raw.strip() else ""
    return cfg


def parse_sigmas(lattice_cfg: dict) -> list:
    """'sigma_i: "value extent"' pairs -> flat per-dimension sigma list
    (``src/Lattice.cu:118-129, 134-160``)."""
    out = []
    for i in range(int(lattice_cfg.get("nr_sigmas", 0))):
        spec = lattice_cfg[f"sigma_{i}"]
        val, extent = str(spec).split()
        out.extend([float(val)] * int(float(extent)))
    return out


@dataclasses.dataclass
class LatticeParams:
    hash_table_capacity: int = 65536
    sigmas: tuple = (0.05, 0.05, 0.05)
    # "fixed": per-level capacities halve from hash_table_capacity.  "auto"
    # (capacities measured from occupancy) is a JAX-package option that the
    # port does not serve yet; the Predictor raises on it.
    capacity_mode: str = "fixed"

    @classmethod
    def from_config(cls, cfg: dict) -> "LatticeParams":
        lg = cfg.get("lattice_gpu", {})
        sigmas = tuple(parse_sigmas(lg)) or cls.sigmas
        mode = str(lg.get("capacity_mode", "fixed"))
        if mode not in ("fixed", "auto"):
            raise ValueError(f"lattice_gpu.capacity_mode must be fixed|auto, got {mode!r}")
        return cls(
            hash_table_capacity=int(lg.get("hash_table_capacity", 65536)),
            sigmas=sigmas,
            capacity_mode=mode,
        )


@dataclasses.dataclass
class TrainParams:
    dataset_name: str = "toy"
    with_viewer: bool = False
    with_visdom: bool = False
    with_tensorboard: bool = False
    lr: float = 1e-3
    weight_decay: float = 0.0
    save_checkpoint: bool = False
    checkpoint_path: str = ""
    batch_size: int = 1

    @classmethod
    def from_config(cls, cfg: dict) -> "TrainParams":
        t = cfg.get("train", {})
        return cls(
            dataset_name=t.get("dataset_name", "toy"),
            with_viewer=bool(t.get("with_viewer", False)),
            with_visdom=bool(t.get("with_visdom", False)),
            with_tensorboard=bool(t.get("with_tensorboard", False)),
            lr=float(t.get("lr", 1e-3)),
            weight_decay=float(t.get("weight_decay", 0.0)),
            save_checkpoint=bool(t.get("save_checkpoint", False)),
            checkpoint_path=str(t.get("checkpoint_path", "")),
            batch_size=int(t.get("batch_size", 1)),
        )


@dataclasses.dataclass
class EvalParams:
    dataset_name: str = "toy"
    checkpoint_path: str = ""
    do_write_predictions: bool = False
    output_predictions_path: str = ""

    @classmethod
    def from_config(cls, cfg: dict) -> "EvalParams":
        e = cfg.get("eval", {})
        return cls(
            dataset_name=e.get("dataset_name", "toy"),
            checkpoint_path=str(e.get("checkpoint_path", "")),
            do_write_predictions=bool(e.get("do_write_predictions", False)),
            output_predictions_path=str(e.get("output_predictions_path", "")),
        )


def model_params_from_config(cfg: dict, nr_classes: int) -> ModelParams:
    """Build ``ModelParams`` from the ``model:`` section."""
    m = cfg.get("model", {})
    # the reference uses both spellings across configs
    pointnet_layers = m.get("pointnet_channels_per_layer", m.get("pointnet_layers", [16, 32, 64]))
    return ModelParams(
        nr_classes=nr_classes,
        positions_mode=m.get("positions_mode", "xyz"),
        values_mode=m.get("values_mode", "none"),
        pointnet_channels_per_layer=tuple(int(x) for x in pointnet_layers),
        pointnet_start_nr_channels=int(m.get("pointnet_start_nr_channels", 32)),
        nr_downsamples=int(m.get("nr_downsamples", 3)),
        nr_blocks_down_stage=tuple(int(x) for x in m.get("nr_blocks_down_stage", [4, 4, 4])),
        nr_blocks_bottleneck=int(m.get("nr_blocks_bottleneck", 3)),
        nr_blocks_up_stage=tuple(int(x) for x in m.get("nr_blocks_up_stage", [2, 2, 2])),
        nr_levels_down_with_normal_resnet=int(m.get("nr_levels_down_with_normal_resnet", 3)),
        nr_levels_up_with_normal_resnet=int(m.get("nr_levels_up_with_normal_resnet", 2)),
        compression_factor=float(m.get("compression_factor", 1.0)),
        dropout_last_layer=float(m.get("dropout_last_layer", 0.0)),
        experiment=m.get("experiment", "none"),
    )
