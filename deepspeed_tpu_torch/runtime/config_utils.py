"""Typed-config base machinery: the port's own copy of ``deepspeed_tpu/
runtime/config_utils.py``, on dataclasses instead of pydantic (the port
depends on nothing beyond PyTorch and numpy).

A config block is a dataclass deriving from :class:`DeepSpeedConfigModel`
and is built with :meth:`DeepSpeedConfigModel.from_dict`, which keeps the
JAX package's behaviour:

* the string ``"auto"`` drops a key, so its default applies (resolved later
  by batch reconciliation), except for ``replace_method``;
* a field whose type is another block (or an ``Optional`` of one) parses
  its nested dict into that block;
* unknown keys are kept in ``extra`` (pydantic ``extra="allow"``);
* a deprecated field (``metadata={"deprecated": True, "new_param":
  "x.y"}``) moves its value onto the new field with a warning;
* ``metadata={"ge": 0}`` bounds a number from below.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict

from ..utils.logging import logger


def _block_type(hint):
    """The config-block class a field's type names, directly or as an
    ``Optional``; None for any other type."""
    if isinstance(hint, type) and issubclass(hint, DeepSpeedConfigModel):
        return hint
    if typing.get_origin(hint) is typing.Union:
        for arg in typing.get_args(hint):
            if isinstance(arg, type) and issubclass(arg, DeepSpeedConfigModel):
                return arg
    return None


@dataclasses.dataclass
class DeepSpeedConfigModel:
    """Base for all config blocks (see the module docstring)."""

    extra: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                              repr=False)

    @classmethod
    def from_dict(cls, data: Any = None, strict: bool = False):
        if isinstance(data, cls):
            return data
        data = dict(data or {})
        if not strict:
            data = {k: v for k, v in data.items()
                    if not (isinstance(v, str) and v == "auto")
                    or k == "replace_method"}
        fields = {f.name: f for f in dataclasses.fields(cls)
                  if f.name != "extra"}
        _migrate_deprecated(fields, data)
        hints = typing.get_type_hints(cls)
        known, extra = {}, {}
        for key, val in data.items():
            if key not in fields:
                extra[key] = val
                continue
            block = _block_type(hints[key])
            if block is not None and val is not None:
                val = block.from_dict(val)
            lower = fields[key].metadata.get("ge")
            if lower is not None and val is not None and val < lower:
                raise ValueError(f"{cls.__name__}.{key} must be >= {lower}, "
                                 f"got {val}")
            known[key] = val
        return cls(extra=extra, **known)

    def get(self, key, default=None):
        return getattr(self, key, self.extra.get(key, default))

    def __getitem__(self, key):
        return getattr(self, key)


def _migrate_deprecated(fields, values: Dict[str, Any]) -> None:
    for name, field in fields.items():
        meta = field.metadata
        if not meta.get("deprecated") or name not in values:
            continue
        if values[name] == field.default:
            continue
        new_param = meta.get("new_param", "")
        logger.warning(f"Config parameter {name} is deprecated" +
                       (f", use {new_param} instead" if new_param else ""))
        if new_param:
            parts = new_param.split(".")
            tgt = values
            for p in parts[:-1]:
                tgt = tgt.setdefault(p, {})
            tgt.setdefault(parts[-1], values[name])


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """json.load hook rejecting duplicate keys."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter: Dict[str, int] = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d


def pp_int(x: int, comment: str = "") -> str:
    """Large ints with thousands separators."""
    return f"{x:,}" + (f" ({comment})" if comment else "")
