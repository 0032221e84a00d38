"""The end of a beam search, shared by both decoder families: follow the
back-pointers and pick each row's best beam."""

from __future__ import annotations

from typing import Tuple

import torch


def beam_backtrack(words_tm, srcs_tm, scores, lengths,
                   length_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Follow the back-pointers from the last step ([T, B, W] words and
    source beams), GNMT-normalize the final scores by ``max(len, 1) **
    length_norm`` (0 = off) and pick each row's best beam (ties to the
    lowest) -> (ids int32 [B, T], scores float32 [B])."""
    T, B, W = words_tm.shape
    ptr = torch.arange(W, device=words_tm.device).expand(B, W)
    seq = []
    for t in range(T - 1, -1, -1):
        seq.append(words_tm[t].gather(1, ptr))
        ptr = srcs_tm[t].long().gather(1, ptr)
    sequences = torch.stack(seq[::-1], dim=2)  # [B, W, T]
    final = scores.float()
    if length_norm > 0:
        final = final / lengths.clamp(min=1).float() ** length_norm
    best = torch.argmax(final, dim=1)
    rows = torch.arange(B, device=words_tm.device)
    return sequences[rows, best].to(torch.int32), final[rows, best]
