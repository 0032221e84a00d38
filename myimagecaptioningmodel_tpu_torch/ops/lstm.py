"""LSTM cell nonlinearities; port of ``myimagecaptioningmodel_tpu/ops/lstm.py``."""

from __future__ import annotations

from typing import Tuple

import torch


def lstm_from_gates(
    gates: torch.Tensor, c_prev: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate pre-activations [.., 4H] in i, f, g, o order -> (h, c).

    c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
    """
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c
