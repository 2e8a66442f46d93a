"""Weight I/O for the port: diffusers-layout folders and JAX parameter trees.

Counterpart of `reflecting_reality_tpu/core/io.py`.  The on-disk format is
the same (config.json + torch-layout safetensors), so a folder written by the
JAX package's `save_pretrained` loads here unchanged.  Loads are strict: any
missing, unexpected or mis-shaped key raises :class:`WeightMappingError`.

`state_dict_from_jax_params` carries a JAX parameter tree (nested dicts of
numpy arrays) across to the port's `state_dict` layout without importing JAX:

  * conv   `kernel` (4D)  HWIO -> OIHW, named ``weight``
  * dense  `kernel` (2D)  (in, out) -> (out, in), named ``weight``
  * norm   `scale`                    named ``weight``
  * embed  `embedding`                named ``weight``
  * ``resnets_0`` -> ``resnets.0`` for the container stems below
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

WEIGHTS_NAME = "diffusion_pytorch_model.safetensors"

# Container (ModuleList) stems used across the model zoo.  linear_1/linear_2,
# norm1... are real leaf module names and must NOT be split.
_CONTAINER_STEMS = {
    "down_blocks", "up_blocks", "resnets", "attentions", "transformer_blocks",
    "downsamplers", "upsamplers", "brushnet_down_blocks", "brushnet_up_blocks",
    "layers", "net", "to_out", "blocks",
}


class WeightMappingError(ValueError):
    """A checkpoint's keys don't line up with the module's parameters."""


def _jax_path_to_key(path: Iterable[str]) -> str:
    out = []
    for p in path:
        m = re.fullmatch(r"(.*?)_(\d+)", p)
        if m and m.group(1) in _CONTAINER_STEMS:
            out += [m.group(1), m.group(2)]
        else:
            out.append(p)
    return ".".join(out)


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy arrays, with or without the
    top-level "params" key) -> the port's state_dict (fp32 CPU tensors)."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _walk(tree):
        leaf = path[-1]
        arr = np.asarray(value)
        if leaf == "kernel":
            leaf = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        key = _jax_path_to_key(list(path[:-1]) + [leaf])
        out[key] = torch.tensor(np.ascontiguousarray(arr))
    return out


def convert_deprecated_attention_keys(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Remap old-vintage VAE attention keys (``query/key/value/proj_attn``)
    to ``to_q/to_k/to_v/to_out.0`` in place and return the dict; (C, C, 1, 1)
    conv kernels are squeezed to 2D linears (reference modeling_utils.py:
    929-971, _convert_deprecated_attention_blocks)."""
    renames = {"query": "to_q", "key": "to_k", "value": "to_v",
               "proj_attn": "to_out.0"}
    for key in list(state_dict):
        parts = key.rsplit(".", 2)
        if len(parts) == 3 and parts[1] in renames and parts[2] in ("weight", "bias"):
            arr = state_dict.pop(key)
            if parts[2] == "weight" and arr.ndim == 4 and tuple(arr.shape[2:]) == (1, 1):
                arr = arr[:, :, 0, 0]
            state_dict[f"{parts[0]}.{renames[parts[1]]}.{parts[2]}"] = arr
    return state_dict


def validate_state_dict(module: nn.Module, state: Mapping[str, Any],
                        where: str = "checkpoint") -> None:
    """Raise :class:`WeightMappingError` listing every missing key,
    unexpected key and shape mismatch between `state` and `module`."""
    exp = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing = sorted(set(exp) - set(got))
    unexpected = sorted(set(got) - set(exp))
    mismatched = sorted(
        f"{k}: checkpoint {got[k]} vs model {exp[k]}"
        for k in set(exp) & set(got) if exp[k] != got[k]
    )
    if missing or unexpected or mismatched:
        def _fmt(name, items):
            if not items:
                return ""
            shown = "\n    ".join(items[:12])
            more = f"\n    ... and {len(items) - 12} more" if len(items) > 12 else ""
            return f"\n  {name} ({len(items)}):\n    {shown}{more}"

        raise WeightMappingError(
            f"{type(module).__name__} <- {where}: weight mapping mismatch"
            + _fmt("missing from checkpoint", missing)
            + _fmt("unexpected in checkpoint", unexpected)
            + _fmt("shape mismatch", mismatched)
        )


def load_into(module: nn.Module, state: Mapping[str, Any], where: str = "checkpoint") -> nn.Module:
    """Strict load: validate keys and shapes, then `load_state_dict(strict=True)`."""
    state = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
             for k, v in state.items()}
    validate_state_dict(module, state, where)
    module.load_state_dict(state, strict=True)
    return module


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return dict(load_file(path))


def load_pretrained(cls, pretrained_path: str, subfolder: Optional[str] = None,
                    **overrides) -> nn.Module:
    """Build `cls` from a reference-layout folder's config.json and load its
    safetensors strictly (on the CPU, in fp32; the caller moves it)."""
    root = os.path.join(pretrained_path, subfolder) if subfolder else pretrained_path
    module = cls.from_config(cls.load_config(root), **overrides)
    for name in (WEIGHTS_NAME, "diffusion_pytorch_model.fp16.safetensors"):
        p = os.path.join(root, name)
        if os.path.exists(p):
            weights = load_safetensors(p)
            break
    else:
        raise FileNotFoundError(f"no safetensors weights under {root}")
    weights = {k: v.float() for k, v in convert_deprecated_attention_keys(weights).items()}
    return load_into(module, weights, where=root)
