"""Minimal CLIP text encoder (counterpart of
`reflecting_reality_tpu/models/clip_text.py`): token + position embeddings,
pre-LN transformer layers with causal masking and quick_gelu MLPs, final
LayerNorm; SD-1.5 uses only `last_hidden_state`, SDXL the penultimate of
the per-layer states (`output_hidden_states`).  Parameter names follow
the transformers checkpoint layout (`text_model.encoder.layers.N.self_attn.
q_proj`).  `CLIPTextModelWithProjection` (JAX :105-137) adds the projected
EOS-token state, the text half of CLIP_Similarity; FLUX.1 conditions on
`CLIPTextModel.pooled_output`, that state unprojected.  The T=77 attention stays
plain, as in JAX.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from reflecting_reality_tpu_torch.core.config import ConfigMixin


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.num_heads

        def heads(y):
            return y.reshape(b, t, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / hd ** 0.5 + causal_mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, c)
        return self.out_proj(out)


class _CLIPMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class _CLIPLayer(nn.Module):
    def __init__(self, hidden_size, num_heads, intermediate_size):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.self_attn = _CLIPAttention(hidden_size, num_heads)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.mlp = _CLIPMLP(hidden_size, intermediate_size)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, hidden_size)
        self.position_embedding = nn.Embedding(max_position_embeddings, hidden_size)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        return self.token_embedding(input_ids) + self.position_embedding(pos)


class _Encoder(nn.Module):
    def __init__(self, hidden_size, num_layers, num_heads, intermediate_size):
        super().__init__()
        self.layers = nn.ModuleList([_CLIPLayer(hidden_size, num_heads, intermediate_size)
                                     for _ in range(num_layers)])

    def forward(self, x, causal_mask):
        """-> (x, [the embeddings, then each layer's output])."""
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x, causal_mask)
            hidden_states.append(x)
        return x, hidden_states


class _TextModel(nn.Module):
    def __init__(self, vocab_size, hidden_size, num_hidden_layers, num_attention_heads,
                 intermediate_size, max_position_embeddings):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden_size, max_position_embeddings)
        self.encoder = _Encoder(hidden_size, num_hidden_layers, num_attention_heads,
                                intermediate_size)
        self.final_layer_norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, input_ids):
        """-> (last hidden state, the encoder's per-layer states)."""
        t = input_ids.shape[1]
        x = self.embeddings(input_ids)
        mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)[None, None]
        x, hidden_states = self.encoder(x, mask)
        return self.final_layer_norm(x), hidden_states


class CLIPTextModel(nn.Module, ConfigMixin):
    def __init__(self, vocab_size: int = 49408, hidden_size: int = 768,
                 num_hidden_layers: int = 12, num_attention_heads: int = 12,
                 intermediate_size: int = 3072, max_position_embeddings: int = 77):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.text_model = _TextModel(vocab_size, hidden_size, num_hidden_layers,
                                     num_attention_heads, intermediate_size,
                                     max_position_embeddings)

    def forward(self, input_ids: torch.Tensor, output_hidden_states: bool = False):
        """(B, T) int token ids -> (B, T, hidden) last hidden state; with
        `output_hidden_states`, (last, [num_hidden_layers + 1 states])."""
        last, hidden_states = self.text_model(input_ids)
        return (last, hidden_states) if output_hidden_states else last

    def pooled_output(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids -> (B, hidden): the last hidden state at each
        row's largest id, CLIP's EOS (transformers' `pooler_output` of a
        config whose `eos_token_id` is 2, as FLUX.1's CLIP-L's is)."""
        last, _ = self.text_model(input_ids)
        eos = input_ids.int().argmax(dim=-1)
        return last[torch.arange(last.shape[0], device=last.device), eos]


class CLIPTextModelWithProjection(nn.Module, ConfigMixin):
    """CLIP text tower + `text_projection` (transformers names): the pooled
    output is the final hidden state at the first EOS token, projected."""

    def __init__(self, vocab_size: int = 49408, hidden_size: int = 1280,
                 num_hidden_layers: int = 32, num_attention_heads: int = 20,
                 intermediate_size: int = 5120, max_position_embeddings: int = 77,
                 projection_dim: int = 1280, eos_token_id: int = 49407):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.projection_dim = projection_dim
        self.eos_token_id = eos_token_id
        self.text_model = _TextModel(vocab_size, hidden_size, num_hidden_layers,
                                     num_attention_heads, intermediate_size,
                                     max_position_embeddings)
        self.text_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor, output_hidden_states: bool = False):
        """(B, T) int token ids -> (last hidden (B, T, hidden), text embeds
        (B, projection_dim)), and the per-layer states third with
        `output_hidden_states`."""
        last, hidden_states = self.text_model(input_ids)
        eos = (input_ids == self.eos_token_id).int().argmax(dim=1)
        pooled = self.text_projection(last[torch.arange(last.shape[0], device=last.device), eos])
        return (last, pooled, hidden_states) if output_hidden_states else (last, pooled)


def load_text_encoder(base_path: str, subfolder: str = "text_encoder",
                      with_projection: bool = False) -> nn.Module:
    """A strict load from a transformers-layout folder (config.json +
    model.safetensors), the layout SD checkpoints ship; CPU, fp32.
    `with_projection` builds `CLIPTextModelWithProjection` from a whole CLIP
    checkpoint (openai/clip-vit-large-patch14 layout: `text_config` in the
    config, the vision tower's tensors beside the text tower's, which are
    left out of the load)."""
    from reflecting_reality_tpu_torch.core.io import empty_module, load_into, load_safetensors

    root = os.path.join(base_path, subfolder)
    cfg = {}
    cfg_path = os.path.join(root, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
    if with_projection:
        cfg = cfg.get("text_config", cfg)
    module = empty_module(CLIPTextModelWithProjection if with_projection else CLIPTextModel, cfg)
    for name in ("model.safetensors", "pytorch_model.safetensors"):
        path = os.path.join(root, name)
        if os.path.exists(path):
            weights = load_safetensors(path)
            break
    else:
        raise FileNotFoundError(f"no text encoder weights under {root}")
    # position_ids is a persistent buffer in older transformers exports
    weights = {k: v.float() for k, v in weights.items() if not k.endswith("position_ids")
               and (not with_projection or k.startswith(("text_model.", "text_projection.")))}
    return load_into(module, weights, where=root)
