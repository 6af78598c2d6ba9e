"""Python-file config system (parity: mmcv ``Config``).

Reference usage (``tools/train.py:81-83``, ``configs/recognition/vit/
vitclip_base_k400.py:1-3``): python config files whose module-level
variables form the config dict, ``_base_`` composition with deep-merge
overrides (``delete`` markers supported via ``_delete_=True``), and CLI
``--cfg-options`` dot-key overrides. Reference configs port with no changes.
"""

from __future__ import annotations

import ast
import copy
import os
import os.path as osp
import types
from typing import Any, Dict, List, Optional, Union

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


def _exec_py_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    # validate syntax early with a clear filename
    ast.parse(src, filename=path)
    module = types.ModuleType("_cfg_")
    module.__file__ = path
    exec(compile(src, path, "exec"), module.__dict__)
    return {k: v for k, v in module.__dict__.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)}


def _strip_delete(v: Any) -> Any:
    """Deep-copy ``v`` with every nested ``_delete_`` marker removed."""
    if isinstance(v, dict):
        return {k: _strip_delete(x) for k, x in v.items() if k != DELETE_KEY}
    return copy.deepcopy(v)


def _merge_dict(base: Dict, new: Dict) -> Dict:
    """Deep-merge ``new`` over ``base`` (mmcv semantics incl. _delete_)."""
    out = copy.deepcopy(base)
    for k, v in new.items():
        if isinstance(v, dict) and DELETE_KEY in v:
            # the marker never survives the merge, whatever its value
            # (a stray _delete_=False must not leak into built modules)
            stripped = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            if v.get(DELETE_KEY) or not isinstance(out.get(k), dict):
                # replace branches must strip markers RECURSIVELY — a
                # nested _delete_ would otherwise reach module builders
                out[k] = _strip_delete(stripped)
            else:
                out[k] = _merge_dict(out[k], stripped)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge_dict(out[k], v)
        elif isinstance(v, dict):
            out[k] = _strip_delete(v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: Dict, key: str, value: Any):
    parts = key.split(".")
    d = cfg
    for p in parts[:-1]:
        if p not in d or not isinstance(d[p], dict):
            d[p] = {}
        d = d[p]
    d[parts[-1]] = value


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        low = v.lower()
        if low == "true":
            return True
        if low == "false":
            return False
        if low in ("none", "null"):
            return None
        return v


def add_cfg_options_arg(parser):
    """Attach the standard ``--cfg-options k=v ...`` argument."""
    parser.add_argument("--cfg-options", nargs="+", default=[],
                        help="dot-key overrides, e.g. data.videos_per_gpu=4")
    return parser


def apply_cfg_options(cfg: "Config", items) -> "Config":
    overrides = {}
    for item in items or []:
        k, _, v = item.partition("=")
        overrides[k] = v
    cfg.merge_from_dict(overrides)
    return cfg


class Config:
    """Dict-like config with attribute access."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None,
                 filename: Optional[str] = None):
        self._cfg_dict = cfg_dict or {}
        self._filename = filename

    # ------------------------------------------------------------------
    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        filename = osp.abspath(filename)
        cfg = _exec_py_config(filename)
        bases = cfg.pop(BASE_KEY, [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for rel in bases:
            base_path = osp.join(osp.dirname(filename), rel)
            base_cfg = cls.fromfile(base_path)
            merged = _merge_dict(merged, base_cfg._cfg_dict)
        merged = _merge_dict(merged, cfg)
        return cls(merged, filename)

    @classmethod
    def fromdict(cls, d: Dict[str, Any]) -> "Config":
        return cls(copy.deepcopy(d))

    # ------------------------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any]):
        """``--cfg-options`` dot-key overrides (tools/train.py:57-64)."""
        for k, v in options.items():
            if isinstance(v, str):
                v = _parse_value(v)
            _set_dotted(self._cfg_dict, k, v)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._cfg_dict)

    def dump(self, path: str):
        import pprint
        with open(path, "w") as f:
            for k, v in self._cfg_dict.items():
                f.write(f"{k} = {pprint.pformat(v)}\n")

    # ------------------------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            v = self._cfg_dict[name]
        except KeyError as e:
            raise AttributeError(f"config has no key {name!r}") from e
        return v

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = value

    def __contains__(self, name):
        return name in self._cfg_dict

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def setdefault(self, name, default=None):
        return self._cfg_dict.setdefault(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def __repr__(self):
        return f"Config(file={self._filename!r}, keys={sorted(self._cfg_dict)})"
