"""Config round-trip compatible with the reference's ConfigMixin.

The reference serializes every model/scheduler's constructor arguments to a
`config.json` per subfolder (reference: src/diffusers/configuration_utils.py:86,
:608).  Here the constructor arguments *are* the config: each model stores
them as attributes of the same names, `to_config()` dumps them, and
`from_config()` filters a (possibly foreign, diffusers-written) JSON dict down
to known arguments and instantiates.  This gives bidirectional `config.json`
compatibility with diffusers checkpoints (and with the JAX package's
`save_pretrained` folders) without replicating its registry machinery.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")

CONFIG_NAME = "config.json"

# Fields in diffusers configs that are bookkeeping, not constructor args.
_PRIVATE_KEYS = ("_class_name", "_diffusers_version", "_name_or_path", "_use_default_values")


def _jsonable(value: Any) -> Any:
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if hasattr(value, "item") and getattr(value, "ndim", 1) == 0:  # numpy/torch scalar
        return value.item()
    return value


class ConfigMixin:
    """Mixin for modules / dataclasses providing config.json round-trip."""

    # Subclasses may override to exclude runtime-only arguments.
    config_ignored_fields = ("self", "parent", "name", "dtype", "param_dtype", "device")

    @classmethod
    def _config_field_names(cls):
        if dataclasses.is_dataclass(cls):
            names = [f.name for f in dataclasses.fields(cls)]
        else:
            names = [
                p.name for p in inspect.signature(cls.__init__).parameters.values()
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
            ]
        return [n for n in names if n not in cls.config_ignored_fields]

    def to_config(self) -> Dict[str, Any]:
        out = {"_class_name": type(self).__name__}
        for name in self._config_field_names():
            out[name] = _jsonable(getattr(self, name))
        return out

    @classmethod
    def from_config(cls: Type[T], config: Dict[str, Any], **overrides) -> T:
        known = set(cls._config_field_names())
        kwargs = {k: v for k, v in config.items() if k in known and k not in _PRIVATE_KEYS}
        kwargs.update(overrides)
        # JSON turns tuples into lists; dataclass defaults often expect tuples.
        for k, v in list(kwargs.items()):
            if isinstance(v, list):
                kwargs[k] = tuple(v)
        return cls(**kwargs)

    def save_config(self, save_directory: str) -> str:
        os.makedirs(save_directory, exist_ok=True)
        path = os.path.join(save_directory, CONFIG_NAME)
        with open(path, "w") as f:
            json.dump(self.to_config(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load_config(cls, pretrained_path: str, subfolder: str | None = None) -> Dict[str, Any]:
        path = pretrained_path
        if subfolder:
            path = os.path.join(path, subfolder)
        if os.path.isdir(path):
            path = os.path.join(path, CONFIG_NAME)
        with open(path) as f:
            return json.load(f)
