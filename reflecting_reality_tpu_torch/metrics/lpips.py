"""LPIPS (squeeze variant) as a torch module, the port's counterpart of
`reflecting_reality_tpu/metrics/lpips.py` (the reference reaches it through
torchmetrics.functional.image.lpips with net_type='squeeze',
metrics/metrics.py:201-204).

SqueezeNet-1.1's feature trunk read at the 7 LPIPS taps; each tap unit-
normalised over channels, the squared difference through a 1x1 `lin{i}`
head, its spatial mean, summed over the taps.  Inputs are NCHW in [-1, 1],
shift/scale-normalised with the LPIPS constants first.  `conv0` has no
padding (torchvision's squeezenet1_1, JAX :65-69) and the max pools are
MaxPool2d(3, 2, ceil_mode=True), which JAX emulates by padding (:47-54).

Weights: `load_torch_lpips_state` maps the torchmetrics and richzhang
checkpoint layouts to this module's state dict; `load_lpips_npz` and
`save_lpips_npz` read and write the JAX package's `.npz` (flax parameter
paths joined by "/", kernels HWIO), so a file from JAX's
`tools/convert_lpips.py` loads here and one written here loads there.
Without a checkpoint the module can still be built (random weights for
tests), but its scores are then not LPIPS.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# LPIPS input normalization constants (richzhang/PerceptualSimilarity).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# out channels of the 7 taps
_TAP_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
# (name, squeeze, expand, in channels) of the Fire modules, in order
_FIRES = (("fire3", 16, 64, 64), ("fire4", 16, 64, 128), ("fire6", 32, 128, 128),
          ("fire7", 32, 128, 256), ("fire9", 48, 192, 256), ("fire10", 48, 192, 384),
          ("fire11", 64, 256, 384), ("fire12", 64, 256, 512))


class _Fire(nn.Module):
    def __init__(self, c_in: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(c_in, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return F.relu(torch.cat([self.expand1x1(s), self.expand3x3(s)], dim=1))


def _maxpool(x):
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


class SqueezeFeatures(nn.Module):
    """SqueezeNet-1.1 features with the 7 LPIPS tap outputs."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 3, stride=2)
        for name, sq, ex, c_in in _FIRES:
            setattr(self, name, _Fire(c_in, sq, ex))

    def forward(self, x):
        taps = [F.relu(self.conv0(x))]                                # slice1
        x = self.fire4(self.fire3(_maxpool(taps[-1])))
        taps.append(x)                                                # slice2
        x = self.fire7(self.fire6(_maxpool(x)))
        taps.append(x)                                                # slice3
        x = self.fire9(_maxpool(x))
        taps.append(x)                                                # slice4
        for name in ("fire10", "fire11", "fire12"):                   # slices 5-7
            x = getattr(self, name)(x)
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = SqueezeFeatures()
        for i, c in enumerate(_TAP_CHANNELS):
            setattr(self, f"lin{i}", nn.Conv2d(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """pred/target: (B, 3, H, W) in [-1, 1] -> scalar LPIPS mean."""
        fa = self.net((pred - self.shift) / self.scale)
        fb = self.net((target - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fa, fb)):
            a = a / torch.sqrt((a ** 2).sum(dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b ** 2).sum(dim=1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean(dim=(1, 2, 3))
        return total.mean()


# SqueezeNet-1.1 torch layer indices of the trunk convs (features.N).
_TORCH_LAYERS = {"conv0": 0, "fire3": 3, "fire4": 4, "fire6": 6, "fire7": 7,
                 "fire9": 9, "fire10": 10, "fire11": 11, "fire12": 12}


def load_torch_lpips_state(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """torch LPIPS(squeeze) state dict -> this module's state dict.

    Accepts the torchmetrics (`net.slice*.*`, `lin*.model.1.weight`) and
    richzhang (`net.features.*`, `lin*.model.1.weight`) layouts, with the
    JAX module's key rules (:122-164)."""
    feats: Dict[str, np.ndarray] = {}
    for k, v in state.items():
        feats[k.replace("net.features.", "").replace("net.", "")] = np.asarray(v)

    def get(n, sub):
        for pattern in (f"{n}.{sub}", f"slice{n}.{sub}"):
            if pattern in feats:
                return feats[pattern]
        raise KeyError(f"missing {n}.{sub}")

    out: Dict[str, np.ndarray] = {}
    for name, idx in _TORCH_LAYERS.items():
        subs = ("",) if name == "conv0" else ("squeeze.", "expand1x1.", "expand3x3.")
        for sub in subs:
            for leaf in ("weight", "bias"):
                out[f"net.{name}.{sub}{leaf}"] = get(idx, f"{sub}{leaf}")
    for i in range(7):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if k in feats:
                out[f"lin{i}.weight"] = feats[k]
                break
        else:
            raise KeyError(f"missing lin{i} weight")
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}


# ---------------------------------------------------------------------- npz
# The JAX package's torch-free weights file: one .npz whose keys are the
# "/"-joined flax parameter paths ("params/net/fire3/squeeze/kernel").


def _flax_path(key: str) -> str:
    """'net.fire3.squeeze.weight' -> 'params/net/fire3/squeeze/kernel'."""
    parts = key.split(".")
    parts[-1] = "kernel" if parts[-1] == "weight" else parts[-1]
    return "/".join(["params"] + parts)


def save_lpips_npz(state: Dict[str, torch.Tensor], path: str) -> None:
    """This module's state dict -> the JAX package's .npz (OIHW -> HWIO)."""
    flat = {_flax_path(k): np.asarray(v.detach().cpu().float().numpy()
                                      if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}
    flat = {k: np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v for k, v in flat.items()}
    np.savez_compressed(path, **flat)


def load_lpips_npz(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's .npz -> this module's state dict (HWIO -> OIHW)."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            parts = k.split("/")
            if parts[0] == "params":
                parts = parts[1:]
            v = z[k]
            if parts[-1] == "kernel":
                parts[-1] = "weight"
                v = np.transpose(v, (3, 2, 0, 1))
            out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return out
