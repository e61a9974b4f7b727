"""CLIP text encoder (openai/clip-vit-large-patch14) in PyTorch.

Counterpart of `geodiffuser_tpu/models/clip_text.py`: pre-LN causal
transformer, quick_gelu MLP (SD-1.x) or exact gelu (SD-2.x's OpenCLIP
tower), learned positions, final LayerNorm, final-layer hidden states.
Parameter names follow HF CLIPTextModel (`text_model.…`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from geodiffuser_tpu_torch.config import ModelConfig


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        d = c // self.heads
        q = (self.q_proj(x) * (d ** -0.5)).reshape(b, l, self.heads, d).transpose(1, 2)
        k = self.k_proj(x).reshape(b, l, self.heads, d).transpose(1, 2)
        v = self.v_proj(x).reshape(b, l, self.heads, d).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, c)
        return self.out_proj(out)


ACTIVATIONS = {"quick_gelu": quick_gelu,
               "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none")}


class _MLP(nn.Module):
    def __init__(self, hidden: int, hidden_act: str = "quick_gelu"):
        super().__init__()
        self.fc1 = nn.Linear(hidden, hidden * 4)
        self.fc2 = nn.Linear(hidden * 4, hidden)
        self.act = ACTIVATIONS[hidden_act]

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, hidden_act: str = "quick_gelu"):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.mlp = _MLP(hidden, hidden_act)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.text_vocab_size, config.text_hidden_size)
        self.position_embedding = nn.Embedding(config.text_max_length, config.text_hidden_size)


class _Encoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(config.text_hidden_size, config.text_heads,
                                                      config.text_hidden_act)
                                     for _ in range(config.text_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        self.final_layer_norm = nn.LayerNorm(config.text_hidden_size, eps=1e-5)


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, 77) int token ids -> (B, 77, hidden) float32 final hidden states."""
        tm = self.text_model
        l = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[None, :l]
        causal = torch.triu(torch.full((l, l), float("-inf"), device=input_ids.device), diagonal=1)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x).float()
