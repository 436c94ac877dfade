"""Minimal MLP: the counterpart of gloo_tpu/models/mlp.py (dense layers
stored (fan_in, fan_out), ReLU between them, mean-squared-error loss)."""

from __future__ import annotations

import math

import torch
from torch import nn

from gloo_tpu_torch.device import resolve_device


class _Dense(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(fan_in, fan_out, device=device))
        self.b = nn.Parameter(torch.zeros(fan_out, device=device))


class MLP(nn.Module):
    def __init__(self, sizes, device="cuda"):
        super().__init__()
        self.sizes = tuple(sizes)
        dev = resolve_device(device)
        self.layers = nn.ModuleList(
            _Dense(i, o, dev) for i, o in zip(self.sizes, self.sizes[1:]))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MLP":
        """He-normal weights (normal * sqrt(2 / fan_in)), zero biases."""
        for layer in self.layers:
            x = torch.randn(layer.w.shape, generator=generator,
                            device=generator.device)
            layer.w.copy_(x * math.sqrt(2.0 / layer.w.shape[0]))
            layer.b.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = x @ layer.w + layer.b
            if i + 1 < len(self.layers):
                x = torch.relu(x)
        return x

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return ((self(x) - y) ** 2).mean()
