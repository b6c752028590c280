"""Hierarchical, freezable configuration node.

A clean-room, dependency-free replacement for ``yacs.config.CfgNode`` with the
subset of behaviors the reference stack relies on (see
reference ``train.py:134-299``): attribute access, ``merge_from_file``
(YAML), ``merge_from_list`` (flat KEY VALUE pairs), ``clone``, ``freeze`` and
deterministic pretty-printing.  Type coercion on merge follows yacs semantics:
the incoming value must be coercible to the existing value's type (with
None <-> anything allowed, and int -> float widening).
"""

from __future__ import annotations

import copy
import io
from typing import Any, List

import yaml

_VALID_SCALARS = (int, float, bool, str, list, tuple, type(None))


class CfgNode(dict):
    """A dict subclass with attribute access and yacs-style merging."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict=None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                if isinstance(v, dict) and not isinstance(v, CfgNode):
                    v = CfgNode(v)
                super().__setitem__(k, v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} on a frozen CfgNode")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        super().__setitem__(name, value)

    def __setitem__(self, name: str, value: Any) -> None:
        self.__setattr__(name, value)

    # -- freezing ------------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def freeze(self) -> None:
        self._set_frozen(True)

    def defrost(self) -> None:
        self._set_frozen(False)

    def _set_frozen(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode._FROZEN, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(flag)

    # -- cloning / merging ----------------------------------------------------
    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        # yacs clone() deepcopies, preserving immutability
        if self.is_frozen():
            out._set_frozen(True)
        return out

    def merge_from_file(self, path: str) -> None:
        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded, [])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other, [])

    def merge_from_list(self, opts: List[Any]) -> None:
        if self.is_frozen():
            raise AttributeError("Cannot merge into a frozen CfgNode")
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"Non-existent config key: {key}")
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            old = node[leaf]
            dict.__setitem__(node, leaf, _coerce(_decode(value), old, key))

    def _merge_dict(self, src: dict, trail: List[str]) -> None:
        if self.is_frozen():
            raise AttributeError("Cannot merge into a frozen CfgNode")
        for k, v in src.items():
            full = ".".join(trail + [str(k)])
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            old = self[k]
            if isinstance(old, CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot merge scalar into section {full}")
                old._merge_dict(v, trail + [str(k)])
            else:
                dict.__setitem__(self, k, _coerce(_decode(v), old, full))

    # -- io -------------------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def __str__(self) -> str:
        buf = io.StringIO()
        self._pretty(buf, 0)
        return buf.getvalue().rstrip("\n")

    def _pretty(self, buf, indent: int) -> None:
        pad = "  " * indent
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, CfgNode):
                buf.write(f"{pad}{k}:\n")
                v._pretty(buf, indent + 1)
            else:
                buf.write(f"{pad}{k}: {v}\n")

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _decode(value: Any) -> Any:
    """Interpret a string literal the way yacs does (literal_eval first).

    yacs runs ``ast.literal_eval`` on every string leaf when merging, which is
    how ``SIZE: (224, 224)`` in the reference YAMLs becomes a tuple.
    """
    if not isinstance(value, str):
        return value
    import ast
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        # yacs keeps the string on literal_eval failure — a yaml
        # fallback here would turn string leaves like "no"/"null" into
        # bool/None
        return value


def _coerce(new: Any, old: Any, key: str) -> Any:
    if old is None or new is None:
        # a mapping replacing a None leaf must become a CfgNode, or
        # attribute access and freeze recursion break on the subtree
        if isinstance(new, dict) and not isinstance(new, CfgNode):
            return CfgNode(new)
        return new
    if isinstance(new, _VALID_SCALARS) and type(new) is type(old):
        return new
    # allowed widenings / conversions (yacs-compatible); bool is NOT an
    # int here — a stray "True" must not become LR=1.0
    if isinstance(old, float) and isinstance(new, int) \
            and not isinstance(new, bool):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    raise ValueError(
        f"Type mismatch for key {key}: cannot replace "
        f"{type(old).__name__}({old!r}) with {type(new).__name__}({new!r})")
