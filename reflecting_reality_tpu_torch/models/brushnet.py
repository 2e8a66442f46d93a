"""BrushNetModel — the MirrorFusion conditioning branch, NCHW (counterpart of
`reflecting_reality_tpu/models/brushnet.py`; reference:
src/diffusers/models/brushnet.py:61).

A conv-only twin of the SD-1.5 UNet whose input is
concat(noisy latents [4ch], conditioning latents) through
`conv_in_condition`.  It emits 28 zero-initialized 1x1-conv residuals for
the SD-1.5 shape: 12 "down" (conv_in output + every down resnet/downsampler
state), 1 "mid", 15 "up" (every up resnet/upsampler state, captured before
injection).  `conditioning_scale` multiplies all residuals; `guess_mode`
applies the logspace(-1, 0) ramp; `global_pool_conditions` mean-pools them.

An SDXL branch (`addition_embed_type="text_time"`, JAX :64-66,
:122-133) adds its own `add_embedding` term to the time embedding, as the
UNet does.

`config_from_unet` / `from_unet` build the branch from a UNet the way
training does (`cli/train.py:125-142`), and `init_from_unet` is the weight
surgery of `init_params_from_unet` (`reflecting_reality_tpu/models/
brushnet.py:302-336`; reference brushnet.py:513-528).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from reflecting_reality_tpu_torch.core.config import ConfigMixin
from reflecting_reality_tpu_torch.models.unet_blocks import DOWN_BLOCKS, MID_BLOCKS, UP_BLOCKS
from reflecting_reality_tpu_torch.ops.embeddings import (
    TimestepEmbedding, add_embedding_for, added_time_embedding, time_embedding,
)


def _zero_conv(channels: int) -> nn.Conv2d:
    conv = nn.Conv2d(channels, channels, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class BrushNetModel(nn.Module, ConfigMixin):
    def __init__(
        self,
        in_channels: int = 4,
        conditioning_channels: int = 5,
        down_block_types: Tuple[str, ...] = ("DownBlock2D",) * 4,
        mid_block_type: str = "MidBlock2D",
        up_block_types: Tuple[str, ...] = ("UpBlock2D",) * 4,
        block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        transformer_layers_per_block: int = 1,
        downsample_padding: int = 1,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-5,
        cross_attention_dim: int = 768,
        attention_head_dim: Union[int, Tuple[int, ...]] = 8,
        use_linear_projection: bool = False,
        flip_sin_to_cos: bool = True,
        freq_shift: int = 0,
        global_pool_conditions: bool = False,
        addition_embed_type: Optional[str] = None,
        addition_time_embed_dim: int = 256,
        projection_class_embeddings_input_dim: Optional[int] = None,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.conditioning_channels = conditioning_channels
        self.down_block_types = tuple(down_block_types)
        self.mid_block_type = mid_block_type
        self.up_block_types = tuple(up_block_types)
        self.block_out_channels = bocs = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.transformer_layers_per_block = transformer_layers_per_block
        self.downsample_padding = downsample_padding
        self.norm_num_groups = norm_num_groups
        self.norm_eps = norm_eps
        self.cross_attention_dim = cross_attention_dim
        self.attention_head_dim = attention_head_dim
        self.use_linear_projection = use_linear_projection
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.global_pool_conditions = global_pool_conditions
        self.addition_embed_type = addition_embed_type
        self.addition_time_embed_dim = addition_time_embed_dim
        self.projection_class_embeddings_input_dim = projection_class_embeddings_input_dim

        n = len(bocs)
        heads = (tuple(attention_head_dim) if isinstance(attention_head_dim, (tuple, list))
                 else (attention_head_dim,) * n)
        temb_ch = bocs[0] * 4
        cross = dict(transformer_layers_per_block=transformer_layers_per_block,
                     cross_attention_dim=cross_attention_dim,
                     use_linear_projection=use_linear_projection)

        self.conv_in_condition = nn.Conv2d(in_channels + conditioning_channels, bocs[0], 3,
                                           padding=1)
        self.time_embedding = TimestepEmbedding(bocs[0], temb_ch)
        self.add_embedding = add_embedding_for(self, temb_ch)

        self.down_blocks = nn.ModuleList()
        down_channels = [bocs[0]]
        for i, bt in enumerate(self.down_block_types):
            cls = DOWN_BLOCKS[bt]
            kw = dict(in_channels=bocs[i - 1] if i > 0 else bocs[0], out_channels=bocs[i],
                      temb_channels=temb_ch, num_layers=layers_per_block,
                      add_downsample=i < n - 1, resnet_eps=norm_eps,
                      resnet_groups=norm_num_groups, downsample_padding=downsample_padding)
            if cls.has_cross_attention:
                kw.update(num_attention_heads=heads[i], **cross)
            self.down_blocks.append(cls(**kw))
            down_channels += [bocs[i]] * (layers_per_block + (1 if i < n - 1 else 0))
        self.brushnet_down_blocks = nn.ModuleList([_zero_conv(c) for c in down_channels])

        mid_cls = MID_BLOCKS[mid_block_type]
        mid_kw = dict(in_channels=bocs[-1], temb_channels=temb_ch, resnet_eps=norm_eps,
                      resnet_groups=norm_num_groups)
        if mid_cls.has_cross_attention:
            mid_kw.update(num_attention_heads=heads[-1], **cross)
        self.mid_block = mid_cls(**mid_kw)
        self.brushnet_mid_block = _zero_conv(bocs[-1])

        self.up_blocks = nn.ModuleList()
        up_channels = []
        rb, rh = list(reversed(bocs)), list(reversed(heads))
        out_ch = rb[0]
        for i, bt in enumerate(self.up_block_types):
            prev, out_ch = out_ch, rb[i]
            cls = UP_BLOCKS[bt]
            kw = dict(in_channels=rb[min(i + 1, n - 1)], prev_output_channel=prev,
                      out_channels=out_ch, temb_channels=temb_ch,
                      num_layers=layers_per_block + 1, add_upsample=i < n - 1,
                      resnet_eps=norm_eps, resnet_groups=norm_num_groups)
            if cls.has_cross_attention:
                kw.update(num_attention_heads=rh[i], **cross)
            self.up_blocks.append(cls(**kw))
            up_channels += [out_ch] * (layers_per_block + 1 + (1 if i < n - 1 else 0))
        self.brushnet_up_blocks = nn.ModuleList([_zero_conv(c) for c in up_channels])

    @classmethod
    def config_from_unet(cls, unet, conditioning_channels: int = 5) -> dict:
        """BrushNet config cloned from a UNet (or its config dict), every block
        turned into its conv-only variant (reference :479-511)."""
        cfg = unet.to_config() if hasattr(unet, "to_config") else dict(unet)
        return dict(
            in_channels=cfg["in_channels"],
            conditioning_channels=conditioning_channels,
            down_block_types=tuple("DownBlock2D" for _ in cfg["down_block_types"]),
            mid_block_type="MidBlock2D",
            up_block_types=tuple("UpBlock2D" for _ in cfg["down_block_types"]),
            block_out_channels=tuple(cfg["block_out_channels"]),
            layers_per_block=cfg["layers_per_block"],
            transformer_layers_per_block=cfg.get("transformer_layers_per_block", 1),
            downsample_padding=cfg.get("downsample_padding", 1),
            norm_num_groups=cfg["norm_num_groups"],
            norm_eps=cfg["norm_eps"],
            cross_attention_dim=cfg["cross_attention_dim"],
            attention_head_dim=cfg["attention_head_dim"],
            use_linear_projection=cfg.get("use_linear_projection", False),
            flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
            freq_shift=cfg.get("freq_shift", 0),
            addition_embed_type=cfg.get("addition_embed_type"),
            addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
            projection_class_embeddings_input_dim=cfg.get("projection_class_embeddings_input_dim"),
        )

    @classmethod
    def from_unet(cls, unet: nn.Module, conditioning_channels: int = 5) -> "BrushNetModel":
        """A BrushNet on the UNet's device and dtype, initialized from its
        weights (`init_from_unet`); the 28 zero convs stay zero."""
        p = next(unet.parameters())
        with torch.device(p.device):
            model = cls(**cls.config_from_unet(unet, conditioning_channels))
        return model.to(p.dtype).init_from_unet(unet)

    @torch.no_grad()
    def init_from_unet(self, unet: nn.Module) -> "BrushNetModel":
        """Copy the UNet's weights in, in place:
        - `conv_in` into input channels 0:4 and 4:8 of `conv_in_condition`,
          zeros in the remaining conditioning channels, the bias copied;
        - `time_embedding`;
        - every down/mid/up leaf whose name and shape match (the attention
          weights have no counterpart in the conv-only twin).
        """
        src = unet.state_dict()
        w = self.conv_in_condition.weight          # (C, in + cond, 3, 3)
        w.zero_()
        w[:, 0:4] = src["conv_in.weight"]
        w[:, 4:8] = src["conv_in.weight"]
        self.conv_in_condition.bias.copy_(src["conv_in.bias"])
        for name, t in self.state_dict().items():
            if (name.startswith(("time_embedding.", "down_blocks.", "mid_block.", "up_blocks."))
                    and name in src and src[name].shape == t.shape):
                t.copy_(src[name])
        return self

    @property
    def has_cross_attention(self) -> bool:
        return (any(b.has_cross_attention for b in self.down_blocks)
                or self.mid_block.has_cross_attention
                or any(b.has_cross_attention for b in self.up_blocks))

    def forward(
        self,
        sample: torch.Tensor,                 # (B, in_channels, H, W) noisy latents
        timesteps: torch.Tensor,              # (B,) or scalar
        encoder_hidden_states: torch.Tensor,
        brushnet_cond: torch.Tensor,          # (B, conditioning_channels, H, W)
        conditioning_scale: float = 1.0,
        guess_mode: bool = False,
        temb: Optional[torch.Tensor] = None,  # precomputed time embedding
        added_cond_kwargs: Optional[dict] = None,   # text_time: text_embeds, time_ids
    ) -> Tuple[List[torch.Tensor], torch.Tensor, List[torch.Tensor]]:
        """A `text_time` branch takes `added_cond_kwargs` or a `temb` with
        their term already added, as `UNet2DConditionModel.forward`."""
        b = sample.shape[0]
        if temb is not None:
            emb = temb.to(sample.dtype).expand(b, temb.shape[-1])
        else:
            t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
            emb = time_embedding(self, t)
        emb = added_time_embedding(self, emb, temb, added_cond_kwargs, sample.dtype)

        x = self.conv_in_condition(torch.cat([sample, brushnet_cond], dim=1))
        down_states = (x,)
        for block in self.down_blocks:
            x, states = block(x, emb, encoder_hidden_states=encoder_hidden_states)
            down_states += states
        down_res = [conv(s) for conv, s in zip(self.brushnet_down_blocks, down_states)]

        x = self.mid_block(x, emb, encoder_hidden_states=encoder_hidden_states)
        mid_res = self.brushnet_mid_block(x)

        skips = list(down_states)
        num_layers = self.layers_per_block + 1
        up_states = ()
        for block in self.up_blocks:
            res = tuple(skips[-num_layers:])
            skips = skips[:-num_layers]
            upsample_size = tuple(skips[-1].shape[2:]) if skips else None
            x, captured = block(x, res, emb, encoder_hidden_states=encoder_hidden_states,
                                capture_res=True, upsample_size=upsample_size)
            up_states += captured
        up_res = [conv(s) for conv, s in zip(self.brushnet_up_blocks, up_states)]

        if guess_mode and not self.global_pool_conditions:
            n = len(down_res) + 1 + len(up_res)
            scales = (torch.logspace(-1, 0, n) * conditioning_scale).tolist()
            down_res = [s * scales[i] for i, s in enumerate(down_res)]
            mid_res = mid_res * scales[len(down_res)]
            up_res = [s * scales[len(down_res) + 1 + i] for i, s in enumerate(up_res)]
        else:
            down_res = [s * conditioning_scale for s in down_res]
            mid_res = mid_res * conditioning_scale
            up_res = [s * conditioning_scale for s in up_res]

        if self.global_pool_conditions:
            def pool(s):
                return s.mean(dim=(2, 3), keepdim=True)

            down_res = [pool(s) for s in down_res]
            mid_res = pool(mid_res)
            up_res = [pool(s) for s in up_res]
        return down_res, mid_res, up_res
