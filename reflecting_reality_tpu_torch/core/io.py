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
  * ``resnets_0`` -> ``resnets.0`` for the container stems below (and
    ``proj_0`` -> ``proj.0``, `NormalProjModel`'s Linear); the IP-Adapter
    leaves ``to_k_ip`` / ``to_v_ip`` keep their names

The safetensors format is read and written here, without the `safetensors`
package: an 8-byte little-endian header length, a JSON header (`dtype`,
`shape`, `data_offsets` per tensor, optional `__metadata__`), then the raw
little-endian bytes.  `save_pretrained` writes the folder layout of the JAX
package's `save_pretrained` (config.json + diffusion_pytorch_model.safetensors).
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

WEIGHTS_NAME = "diffusion_pytorch_model.safetensors"

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}

# Container (ModuleList) stems used across the model zoo.  linear_1/linear_2,
# norm1... are real leaf module names and must NOT be split.
_CONTAINER_STEMS = {
    "down_blocks", "up_blocks", "resnets", "attentions", "transformer_blocks",
    "downsamplers", "upsamplers", "brushnet_down_blocks", "brushnet_up_blocks",
    "layers", "net", "to_out", "blocks", "proj",
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


def _allowed(key: str, allow_missing: Iterable[str]) -> bool:
    return any(part in allow_missing for part in key.split("."))


def validate_state_dict(module: nn.Module, state: Mapping[str, Any],
                        where: str = "checkpoint", allow_missing: Iterable[str] = ()) -> None:
    """Raise :class:`WeightMappingError` listing every missing key,
    unexpected key and shape mismatch between `state` and `module`.  Keys
    with a part named in `allow_missing` (e.g. "to_k_ip") may be missing."""
    exp = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing = sorted(k for k in set(exp) - set(got) if not _allowed(k, allow_missing))
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


def load_into(module: nn.Module, state: Mapping[str, Any], where: str = "checkpoint",
              allow_missing: Iterable[str] = ()) -> nn.Module:
    """Strict load: validate keys and shapes, then `load_state_dict`
    (strict unless `allow_missing` names leaves the caller fills itself)."""
    state = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
             for k, v in state.items()}
    validate_state_dict(module, state, where, allow_missing)
    module.load_state_dict(state, strict=not allow_missing)
    return module


def _readinto(f, buf: memoryview) -> None:
    """Fill `buf` from `f` (one read can return less than asked: Linux caps a
    read at 2 GiB)."""
    done = 0
    while done < len(buf):
        n = f.readinto(buf[done:])
        if not n:
            raise ValueError(f"{f.name}: file ends {len(buf) - done} bytes early")
        done += n


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors file -> {name: CPU tensor} in the file's dtypes.  The
    data section is read in one pass into one preallocated buffer and every
    tensor is a view of it (a copy only where a foreign file leaves a tensor
    misaligned for its dtype)."""
    with open(path, "rb", buffering=0) as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        data = torch.empty(os.fstat(f.fileno()).st_size - 8 - n, dtype=torch.uint8)
        _readinto(f, memoryview(data.numpy()))
    out = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != itemsize * int(np.prod(info["shape"], dtype=np.int64)) \
                or end > data.numel():
            raise ValueError(f"{path}: {name} offsets {start}:{end} do not fit "
                             f"{info['dtype']} {info['shape']}")
        raw = data[start:end]
        if start % itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def save_safetensors(state: Mapping[str, Any], path: str) -> None:
    """Write {name: tensor or array} as a safetensors file: the tensors in
    the order (larger item size first, then name), contiguous offsets, the
    header padded with spaces to 8 bytes, so every tensor is aligned for
    its dtype."""
    tensors = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
               .detach().cpu().contiguous() for k, v in state.items()}
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, Any] = {}
    offset = 0
    for k in order:
        t = tensors[k]
        size = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            f.write(memoryview(tensors[k].reshape(-1).view(torch.uint8).numpy()))


def cast_floating(state: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Floating-point tensors cast to `dtype`; integer and bool ones kept."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}


def save_pretrained(module: nn.Module, save_directory: str,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """config.json + diffusion_pytorch_model.safetensors, the layout of the
    JAX package's `save_pretrained`.  `state_dict` (default: the module's)
    lets a caller write a host snapshot or a cast copy."""
    os.makedirs(save_directory, exist_ok=True)
    module.save_config(save_directory)
    save_safetensors(module.state_dict() if state_dict is None else state_dict,
                     os.path.join(save_directory, WEIGHTS_NAME))


def empty_module(cls, config: Mapping[str, Any], **overrides) -> nn.Module:
    """`cls.from_config(config)` with uninitialised CPU parameters: built on
    the meta device (no random init of every weight), then given storage.
    Only for modules whose every tensor is about to be loaded."""
    with torch.device("meta"):
        module = cls.from_config(dict(config), **overrides)
    return module.to_empty(device="cpu")


def load_pretrained(cls, pretrained_path: str, subfolder: Optional[str] = None,
                    allow_missing: Iterable[str] = (), **overrides) -> nn.Module:
    """Build `cls` from a reference-layout folder's config.json and load its
    safetensors strictly (on the CPU, in fp32; the caller moves it).  Leaves
    named in `allow_missing` may be absent from the file: they are left
    uninitialised for the caller to fill (the IP-Adapter's to_k_ip/to_v_ip,
    copied from to_k/to_v by `models.ip_adapter.init_ip_params_from_unet`)."""
    root = os.path.join(pretrained_path, subfolder) if subfolder else pretrained_path
    module = empty_module(cls, cls.load_config(root), **overrides)
    for name in (WEIGHTS_NAME, "diffusion_pytorch_model.fp16.safetensors"):
        p = os.path.join(root, name)
        if os.path.exists(p):
            weights = load_safetensors(p)
            break
    else:
        raise FileNotFoundError(f"no safetensors weights under {root}")
    weights = {k: v.float() for k, v in convert_deprecated_attention_keys(weights).items()}
    return load_into(module, weights, where=root, allow_missing=allow_missing)
