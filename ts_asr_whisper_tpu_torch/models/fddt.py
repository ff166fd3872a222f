"""FDDT (frame-level diarization-dependent transformations) of the port.

Counterpart of ts_asr_whisper_tpu/models/fddt.py. Per STNO class c in
(silence, target, non-target, overlap): ``h' = sum_c m_c * (W_c h + b_c)``
(full), ``h' = sum_c m_c * (w_c * h + b_c)`` (diagonal) or
``h' = h + sum_c m_c * b_c`` (bias-only). A disabled class has no
parameters and contributes the identity. Parameter names follow the DiCoW
checkpoints: ``{cls}_linear.weight`` / ``.bias``, and a bare ``{cls}_linear``
vector in the bias-only variant. The full weight is kept in torch (out, in)
layout, as the JAX package keeps it too (fddt.py:120-123).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

STNO_CLASSES = ("silence", "target", "non_target", "overlap")


class DiagonalLinear(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class FDDT(nn.Module):
    def __init__(self, d_model: int, is_diagonal: bool = True,
                 bias_only: bool = False, use_silence: bool = True,
                 use_target: bool = True, use_overlap: bool = True,
                 use_non_target: bool = True):
        super().__init__()
        self.is_diagonal = is_diagonal
        self.bias_only = bias_only
        use = {"silence": use_silence, "target": use_target,
               "non_target": use_non_target, "overlap": use_overlap}
        for cls in STNO_CLASSES:
            if not use[cls]:
                continue
            if bias_only:
                self.register_parameter(f"{cls}_linear",
                                        nn.Parameter(torch.zeros(d_model)))
            elif is_diagonal:
                setattr(self, f"{cls}_linear", DiagonalLinear(d_model))
            else:
                setattr(self, f"{cls}_linear", nn.Linear(d_model, d_model))

    def part(self, cls: str):
        return getattr(self, f"{cls}_linear", None)

    @torch.no_grad()
    def init_(self, generator: torch.Generator, non_target_rate: float,
              fddt_init: Optional[str]) -> None:
        """Distributions of init_fddt (fddt.py:28-76): biases zero;
        'suppressive' sets the (diagonal of the) weight to 1.0 for target
        and overlap and ``non_target_rate`` for silence and non-target,
        'non-disturbing' to 1.0 / identity, anything else keeps the uniform
        fan-in (diagonal) or xavier-uniform (full) draw."""
        eye_vals = {"silence": non_target_rate, "target": 1.0,
                    "non_target": non_target_rate, "overlap": 1.0}
        for cls in STNO_CLASSES:
            p = self.part(cls)
            if p is None:
                continue
            if self.bias_only:
                p.zero_()
                continue
            w = p.weight
            d = w.shape[-1]
            bound = (3.0 / d) ** 0.5 if self.is_diagonal \
                else (6.0 / (2 * d)) ** 0.5
            w.uniform_(-bound, bound, generator=generator)
            if fddt_init in ("suppressive", "non-disturbing"):
                val = eye_vals[cls] if fddt_init == "suppressive" else 1.0
                if self.is_diagonal:
                    w.fill_(val)
                else:
                    w.copy_(val * torch.eye(d, dtype=w.dtype,
                                            device=w.device))
            p.bias.zero_()

    def forward(self, hidden: torch.Tensor,
                stno_mask: torch.Tensor) -> torch.Tensor:
        """hidden (..., T, D), stno_mask (..., 4, T) -> (..., T, D)."""
        dt = hidden.dtype
        d = hidden.shape[-1]
        m = stno_mask.transpose(-1, -2).to(dt)            # (..., T, 4)

        def stack_rows(field: str, default: float) -> torch.Tensor:
            rows = []
            for cls in STNO_CLASSES:
                p = self.part(cls)
                if p is None:
                    rows.append(torch.full((d,), default, dtype=dt,
                                           device=hidden.device))
                elif isinstance(p, nn.Parameter):
                    rows.append(p.to(dt))
                else:
                    rows.append(getattr(p, field).to(dt))
            return torch.stack(rows, dim=-2)              # (4, D)

        if self.bias_only:
            return hidden + m @ stack_rows("bias", 0.0)
        if self.is_diagonal:
            scale = m @ stack_rows("weight", 1.0)
            shift = m @ stack_rows("bias", 0.0)
            return hidden * scale + shift
        out = torch.zeros_like(hidden)
        for ci, cls in enumerate(STNO_CLASSES):
            p = self.part(cls)
            y = hidden if p is None else F.linear(hidden, p.weight.to(dt),
                                                  p.bias.to(dt))
            out = out + m[..., ci: ci + 1] * y
        return out
