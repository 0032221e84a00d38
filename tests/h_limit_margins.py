"""Print what phase 29 (a)'s limits (``chip_smoke.h_scores``) score for
kernel H's plain versions at (7, 3, 16, 200): with z moved by a relative
error before its rounding (bf16: ``chip_smoke.H_TANH_EPS``; float32: one
and two float32 ulps), all in one direction, and with each plant of
``chip_fault_check.H_FAULTS``. A CPU run:

    python tests/h_limit_margins.py
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_fault_check as F  # noqa: E402
import chip_smoke as S  # noqa: E402
from myimagecaptioningmodel_tpu_torch.ops.kernels import attention as KH  # noqa: E402

SHAPE = (7, 3, 16, 200)


def moved_scores(ops, dt, eps):
    saved = KH._z

    def moved(img_k, h_emb, d):
        x = img_k[None].to(d) + h_emb.to(d)[:, :, None, :]
        return (torch.tanh(x.double()) * (1 + eps)).to(d)

    KH._z = moved
    try:
        got = S.h_run(KH.attn_scores_reference, KH.attn_scores_bwd_reference, ops, dt)
    finally:
        KH._z = saved
    return S.h_scores(got, ops, dt)[0]


def main():
    torch.set_num_threads(4)
    for dt in (torch.float32, torch.bfloat16):
        ops = S.h_operands(torch.Generator().manual_seed(sum(SHAPE)), "cpu", *SHAPE, dt)
        moves = ({"1 ulp": 2.0 ** -23, "2 ulps": 2.0 ** -22} if dt == torch.float32
                 else {"H_TANH_EPS": S.H_TANH_EPS})
        for name, eps in moves.items():
            for sign in (1, -1):
                sc = moved_scores(ops, dt, sign * eps)
                print(dt, f"z moved {'+' if sign > 0 else '-'}{name}:",
                      {k: round(v, 3) for k, v in sc.items()})
        for plant in F.H_FAULTS:
            fwd, bwd = plant(KH.attn_scores_reference, KH.attn_scores_bwd_reference)
            sc = S.h_scores(S.h_run(fwd, bwd, ops, dt), ops, dt)[0]
            print(dt, plant.__name__.strip("_") + ":", {k: round(v, 3) for k, v in sc.items()})


if __name__ == "__main__":
    main()
