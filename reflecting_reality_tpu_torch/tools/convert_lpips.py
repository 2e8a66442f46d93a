"""LPIPS(squeeze) weights converter: a torch checkpoint -> the JAX package's
torch-free `.npz` (the port's copy of
`reflecting_reality_tpu/tools/convert_lpips.py`).

The reference computes LPIPS through torchmetrics (metrics/metrics.py:
196-209), which torch-loads the richzhang/PerceptualSimilarity squeeze
weights.  The JAX package reads them from one `.npz` ("/"-joined flax
parameter paths); the port reads either file
(`metrics.lpips.load_torch_lpips_state`, `load_lpips_npz`).  This tool
writes the `.npz` from a local state dict through the port's
`metrics.lpips.save_lpips_npz`.

Sources:
  --torch_ckpt PATH      an lpips/torchmetrics squeeze state_dict (.pt/.pth)
  --from_torchmetrics    torchmetrics' LPIPS(net_type="squeeze") state dict
                         (needs torchmetrics, which downloads the weights)

Usage:
    python -m reflecting_reality_tpu_torch.tools.convert_lpips \\
        --torch_ckpt lpips_squeeze.pth --out lpips_squeeze.npz
"""

from __future__ import annotations

import argparse


def state_from_torch_ckpt(path: str) -> dict:
    import torch

    state = torch.load(path, map_location="cpu")
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return {k: v.numpy() for k, v in state.items()}


def state_from_torchmetrics() -> dict:
    try:
        from torchmetrics.image.lpip import LearnedPerceptualImagePatchSimilarity
    except ImportError:
        raise RuntimeError("--from_torchmetrics needs the torchmetrics package, which is not "
                           "installed; pass --torch_ckpt with a local state dict") from None

    metric = LearnedPerceptualImagePatchSimilarity(net_type="squeeze")
    return {k: v.numpy() for k, v in metric.net.state_dict().items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--from_torchmetrics", action="store_true")
    p.add_argument("--out", type=str, required=True, help=".npz output path")
    args = p.parse_args(argv)

    from reflecting_reality_tpu_torch.metrics.lpips import load_torch_lpips_state, save_lpips_npz

    if args.torch_ckpt:
        state = state_from_torch_ckpt(args.torch_ckpt)
    elif args.from_torchmetrics:
        state = state_from_torchmetrics()
    else:
        raise SystemExit("need --torch_ckpt or --from_torchmetrics")

    save_lpips_npz(load_torch_lpips_state(state), args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
