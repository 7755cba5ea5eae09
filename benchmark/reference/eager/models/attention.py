# Frozen copy of gpnerf_tpu_torch/models/attention.py at commit ffa1347, the benchmark's plain
# reference: the port's hand-written kernels, registries and the paths no
# configuration of the benchmark runs are removed; nothing here is imported
# from the program.
"""Multi-head attention for SMPL vertex-code / image-feature fusion
(gpnerf_tpu/models/attention.py; reference MultiHeadAttention.py:20-98):
bias-free projections and a separate kv_dim. GP-NeRF runs it without the
residual + LayerNorm branch (sum=False); the LayerNorm parameters exist only
for checkpoint-key parity."""

from __future__ import annotations

import torch
from torch import nn


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head, d_model, d_k, d_v, kv_dim):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(kv_dim, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(kv_dim, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, q, k, v):
        """q: (B, Lq, d_model); k, v: (B, Lk, kv_dim). Returns
        ((B, Lq, d_model), attn (B, n_head, Lq, Lk))."""
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        h, d_k, d_v = self.n_head, self.d_k, self.d_v
        qh = self.w_qs(q).reshape(B, Lq, h, d_k)
        kh = self.w_ks(k).reshape(B, Lk, h, d_k)
        vh = self.w_vs(v).reshape(B, Lk, h, d_v)
        attn = torch.einsum("bqhd,bkhd->bhqk", qh / d_k**0.5, kh)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, Lq, h * d_v)
        return self.fc(out), attn
