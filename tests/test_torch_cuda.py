"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: h', c', proj to atol 1e-4 in float32 (TF32 off) and 3e-2 in
bfloat16, with the head (greedy rows) and without it (beam rows); ids equal
wherever the plain version's top-2 logit gap exceeds 1e-3 x max|logit|
(float32) or 2e-2 (bfloat16 and int8 tables). The top-k head: lse and the
picked ids' logits (re-read from the plain float32 logits) to 1e-4 for every
table dtype, since the plain version rounds as the kernel does (on an H100
the errors read 9.5e-7 for lse and 2.1e-6 for the values); ids equal at
every rank whose plain sorted value is clear of both neighbours by the
near-tie gap. Kernel F: y to 1e-4 x max|y| in float32; in bfloat16 to one
bf16 ulp of the larger magnitude plus the float32 accumulation-order bound
2 K 2^-24 sum_k |x w| (the two sums add in other orders, so a value may
round to the neighbouring bf16 number, or further where y cancels to near
zero); sum and sumsq to 5e-5 of sum|y| and of sumsq against float64 sums of
the kernel's own y (float32 adds up to ~800 terms in order per thread), the
same bits from run to run; the fused 1x1 conv + BN against the unfused conv
and BN in float32 to 1e-4 of each output's largest magnitude.
"""

import pytest
import torch

from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import decoder as TD
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as TFS
from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as TMB
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


def _ranks_clear(logits, k, dt):
    """[B, k] bool: the plain sorted value at rank i is clear of its
    neighbours at ranks i-1 and i+1 by the near-tie gap (a near tie may swap
    two ranks, and then only)."""
    v = torch.sort(logits, dim=-1, descending=True).values[:, : k + 1]
    if dt == torch.float32:
        gap = 1e-3 * logits.abs().amax(dim=-1, keepdim=True)
    else:
        gap = 2e-2
    after = (v[:, :-1] - v[:, 1:]) > gap  # rank i vs i+1
    before = torch.cat([torch.ones_like(after[:, :1]), after[:, :-1]], dim=1)
    return after & before


def _table(g, V, E, dt, cuda):
    """-> (table, scale or None): a float table, or an int8 one with its
    per-row scale."""
    t = torch.randn(V, E, generator=g) / 16
    if dt != torch.int8:
        return t.to(cuda, dt), None
    s = t.abs().amax(dim=1) / 127
    return torch.round(t / s[:, None]).clamp(-127, 127).to(cuda, torch.int8), s.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 37, 128])
def test_cuda_vocab_argmax_int8_matches_plain(cuda, B):
    g = torch.Generator(device="cpu").manual_seed(B)
    V, E = 12416, 256
    proj = torch.randn(B, E, generator=g).to(cuda)
    table, scale = _table(g, V, E, torch.int8, cuda)
    bias = torch.randn(V, generator=g).to(cuda)
    out = TVH.greedy_vocab_argmax(proj, table, bias, scale)
    logits = TVH.head_logits_reference(proj, table, bias, scale)
    assert _near_tie_ok(out, logits, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("M,k", [(1, 1), (32, 4), (37, 8), (512, 4), (128, 32)])
def test_cuda_topk_head_matches_plain(cuda, dt, M, k):
    g = torch.Generator(device="cpu").manual_seed(M + k)
    V, E = 12416, 256
    proj = torch.randn(M, E, generator=g).to(cuda)
    table, scale = _table(g, V, E, dt, cuda)
    bias = torch.randn(V, generator=g).to(cuda)
    bias[12295:] = -1e9
    vals, ids, lse = TVH.topk_vocab_head(proj, table, bias, k, scale)
    rv, ri, rlse = TVH.topk_vocab_head_reference(proj, table, bias, k, scale)
    logits = TVH.head_logits_reference(proj, table, bias, scale)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    torch.testing.assert_close(vals, logits.gather(1, ids.long()), rtol=0, atol=1e-4)
    assert bool(((ids == ri) | ~_ranks_clear(logits, k, dt)).all())
    assert int(ids.max()) < 12295


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_heads_break_ties_by_index(cuda, dt):
    """Equal logits in different vocab blocks: lowest index first."""
    g = torch.Generator(device="cpu").manual_seed(3)
    V, E = 12416, 256
    proj = torch.rand(8, E, generator=g).to(cuda)
    t = torch.rand(V, E, generator=g) / 64
    winners = [12000, 9000, 4097, 4096, 65, 64, 63, 10]
    t[winners] = 0.25
    if dt == torch.int8:
        s = t.abs().amax(dim=1) / 127
        table, scale = torch.round(t / s[:, None]).to(cuda, torch.int8), s.to(cuda)
    else:
        table, scale = t.to(cuda, dt), None
    bias = torch.full((V,), -5.0, device=cuda)
    bias[winners] = 0.0
    _v, ids, _l = TVH.topk_vocab_head(proj, table, bias, 8, scale)
    assert ids.tolist() == [sorted(winners)] * 8
    assert TVH.greedy_vocab_argmax(proj, table, bias, scale).tolist() == [10] * 8


def _step_args(cuda, B, dt):
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
    return fp, fp.emb_table[word], h, c, pre.img_k, pre.img_v


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,head", [(1, True), (8, True), (128, True),
                                    (32, False), (512, False)])  # beam: 8, 128 x beam 4
def test_cuda_fused_step_matches_plain(cuda, dt, B, head):
    args = _step_args(cuda, B, dt)
    fp = args[0]
    out = TFS.fused_decode_step(*args, with_head=head, compute_dtype=dt)
    ref = TFS.reference_step(*args, with_head=head, compute_dtype=dt)
    tol = 1e-4 if dt == torch.float32 else 3e-2
    for t, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(t, r, rtol=0, atol=tol)
    if head:
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
    with pytest.raises(ValueError, match="32"):
        TVH.topk_vocab_head(proj, table, bias, 33)
    with pytest.raises(ValueError):
        TVH.topk_vocab_head(proj, table[:, :128], bias, 4)
    with pytest.raises(TypeError):
        TVH.topk_vocab_head(proj, table.half(), bias, 4)
    q = table.to(torch.int8)
    with pytest.raises(ValueError):  # an int8 table needs its scale
        TVH.topk_vocab_head(proj, q, bias, 4)
    with pytest.raises(ValueError):  # and a float table takes none
        TVH.greedy_vocab_argmax(proj, table, bias, torch.ones(512, device=cuda))
    with pytest.raises(ValueError):
        TVH.topk_vocab_head(proj, q, bias, 4, torch.ones(100, device=cuda))


@pytest.mark.cuda
def test_cuda_launch_counters(cuda):
    proj = torch.randn(3, 256, device=cuda)
    table = torch.randn(640, 256, device=cuda)
    bias = torch.randn(640, device=cuda)
    before = TVH.greedy_vocab_argmax.launches
    TVH.greedy_vocab_argmax(proj, table, bias)
    TVH.greedy_vocab_argmax(proj.cpu(), table.cpu(), bias.cpu())  # plain version
    assert TVH.greedy_vocab_argmax.launches == before + 1
    before = TVH.topk_vocab_head.launches
    TVH.topk_vocab_head(proj, table, bias, 4)
    TVH.topk_vocab_head(proj.cpu(), table.cpu(), bias.cpu(), 4)  # plain version
    assert TVH.topk_vocab_head.launches == before + 1


# kernel F's (M, K, N) on the training path at B=128, 224 px, a ragged M, and
# rows that are not whole 16-byte vectors
F_SHAPES = [(1605632, 32, 32), (1605632, 16, 96), (401408, 24, 144), (25088, 576, 96),
            (6272, 320, 1280), (1000, 24, 144), (1000, 11, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", F_SHAPES)
def test_cuda_matmul_stats_matches_plain(cuda, dt, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, device=cuda, generator=g).to(dt)
    w = (torch.randn(K, N, device=cuda, generator=g) / K ** 0.5).to(dt)
    y, s, q = TMB.matmul_stats(x, w)
    ry, _rs, _rq = TMB._matmul_stats_reference(x, w)
    yf, ryf = y.float(), ry.float()
    if dt == torch.float32:
        assert (yf - ryf).abs().max() <= 1e-4 * ryf.abs().max()
    else:
        mag = torch.maximum(yf.abs(), ryf.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        acc = 2 * K * 2.0 ** -24 * torch.matmul(x.float().abs(), w.float().abs())
        assert ((yf - ryf).abs() <= ulp + acc).all()
    y64 = y.double()
    assert ((s.double() - y64.sum(0)).abs() <= 5e-5 * y64.abs().sum(0)).all()
    q64 = (y64 * y64).sum(0)
    assert ((q.double() - q64).abs() <= 5e-5 * q64).all()
    _y2, s2, q2 = TMB.matmul_stats(x, w)
    assert torch.equal(s, s2) and torch.equal(q, q2)


@pytest.mark.cuda
def test_cuda_conv1x1_bn_train_matches_unfused(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = (torch.randn(4, 14, 14, 96, device=cuda, generator=g) + 0.5).requires_grad_()
    w = (torch.randn(576, 96, 1, 1, device=cuda, generator=g) / 96 ** 0.5).requires_grad_()
    bn = {"scale": (1 + 0.1 * torch.randn(576, device=cuda, generator=g)).requires_grad_(),
          "offset": (0.1 * torch.randn(576, device=cuda, generator=g)).requires_grad_()}
    dy = torch.randn(4, 14, 14, 576, device=cuda, generator=g)
    y, mean, var = TMB.conv1x1_bn_train(w, bn, x, torch.float32)
    before = TMB.matmul_stats.launches
    grads = torch.autograd.grad(y, (w, bn["scale"], bn["offset"], x), dy)
    assert TMB.matmul_stats.launches == before  # the backward is plain PyTorch
    conv = TL.conv2d(w, x.permute(0, 3, 1, 2), compute_dtype=torch.float32).permute(0, 2, 3, 1)
    ry, new = TL.batch_norm_train(bn, {"mean": torch.zeros(576, device=cuda),
                                       "var": torch.ones(576, device=cuda)}, conv)
    rgrads = torch.autograd.grad(ry, (w, bn["scale"], bn["offset"], x), dy)
    for got, want in ((y, ry), (mean, new["mean"] / 0.1), (var, (new["var"] - 0.9) / 0.1),
                      *zip(grads, rgrads)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
