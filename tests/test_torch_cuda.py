"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: h', c', proj to atol 1e-4 in float32 (TF32 off) and 3e-2 in
bfloat16; ids equal wherever the plain version's top-2 logit gap exceeds
1e-3 x max|logit| (float32) or 2e-2 (bfloat16).
"""

import pytest
import torch

from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import decoder as TD
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as TFS
from myimagecaptioningmodel_tpu_torch.ops.kernels import vocab_head as TVH


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _near_tie_ok(ids, logits, dt):
    """ids agree with the plain argmax wherever its top-2 gap is clear."""
    top2 = torch.topk(logits, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    if dt == torch.float32:
        clear = gap > 1e-3 * logits.abs().amax(dim=-1)
    else:
        clear = gap > 2e-2
    ref = logits.argmax(dim=-1).to(torch.int32)
    return bool(((ids == ref) | ~clear).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 37, 128])
def test_cuda_vocab_argmax_matches_plain(cuda, dt, B):
    g = torch.Generator(device="cpu").manual_seed(B)
    V, E = 12416, 256
    proj = torch.randn(B, E, generator=g).to(cuda)
    table = (torch.randn(V, E, generator=g) / 16).to(cuda, dt)
    bias = torch.randn(V, generator=g).to(cuda)
    out = TVH.greedy_vocab_argmax(proj, table, bias)
    logits = torch.matmul(proj.to(dt).float(), table.float().T) + bias
    assert _near_tie_ok(out, logits, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 128])
def test_cuda_fused_step_matches_plain(cuda, dt, B):
    g = torch.Generator(device="cpu").manual_seed(0)
    dims = TD.DecoderDims(vocab_size=12295, embedding_size=256, hidden_dim=1024,
                          vocab_pad_multiple=128)
    params = tree_to_torch(TD.init(g, dims), cuda)
    img = torch.rand(B, 49, 1024, generator=g).to(cuda)
    gf = torch.rand(B, 1024, generator=g).to(cuda)
    pre = TD.precompute(params, img, gf, dt)
    fp = TFS.prepare(params, pre, 0, dt)
    word = torch.randint(0, 12295, (B,), generator=g).to(cuda)
    h = (torch.randn(B, 1024, generator=g) * 0.1).to(cuda)
    c = (torch.randn(B, 1024, generator=g) * 0.1).to(cuda)
    args = (fp, fp.emb_table[word], h, c, pre.img_k, pre.img_v)
    out = TFS.fused_decode_step(*args, with_head=True, compute_dtype=dt)
    ref = TFS.reference_step(*args, with_head=True, compute_dtype=dt)
    tol = 1e-4 if dt == torch.float32 else 3e-2
    for t, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(t, r, rtol=0, atol=tol)
    logits = torch.matmul(ref[2].to(dt).float(), fp.head_table.float().T) + fp.head_bias
    assert _near_tie_ok(out[3], logits, dt)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_operands(cuda):
    proj = torch.randn(4, 256, device=cuda)
    table = torch.randn(512, 256, device=cuda)
    bias = torch.randn(512, device=cuda)
    with pytest.raises(ValueError):
        TVH.greedy_vocab_argmax(proj, table[:, :128], bias)
    with pytest.raises(TypeError):
        TVH.greedy_vocab_argmax(proj, table.half(), bias)
    with pytest.raises(ValueError):
        TVH.greedy_vocab_argmax(proj, table.T.contiguous().T, bias)


@pytest.mark.cuda
def test_cuda_launch_counters(cuda):
    proj = torch.randn(3, 256, device=cuda)
    table = torch.randn(640, 256, device=cuda)
    bias = torch.randn(640, device=cuda)
    before = TVH.greedy_vocab_argmax.launches
    TVH.greedy_vocab_argmax(proj, table, bias)
    TVH.greedy_vocab_argmax(proj.cpu(), table.cpu(), bias.cpu())  # plain version
    assert TVH.greedy_vocab_argmax.launches == before + 1
