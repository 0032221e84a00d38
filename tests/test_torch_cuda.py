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
near-tie gap; the same at the edges of C's tiling (512 rows, k up to 32,
vocabularies that are not whole 128-row tiles) and ties inside one vocab
tile and across tile edges in ascending index order. Kernel F: y to 1e-4 x
max|y| in float32; in bfloat16 to one bf16 ulp of the larger magnitude plus
the float32 accumulation-order bound 2 K 2^-24 sum_k |x w| (the two sums
add in other orders, so a value may round to the neighbouring bf16 number,
or further where y cancels to near zero); sum and sumsq to 5e-5 of sum|y|
and of sumsq against float64 sums of the kernel's own y (float32 sums of up
to ~16 rows a tile, then ~100 tile sums per thread, in a fixed order), the
same bits from run to run; at the training path's shapes and at the edges
of the tiling (K one 16-deep chunk, odd, over one chunk; N in one column
tile and over it; M one row, one past a tile); the fused 1x1 conv + BN
against the unfused conv and BN in float32 to 1e-4 of each output's largest
magnitude. Kernels D and E
(whole transformer decodes, small dims: D=256, E=128, 2 layers, 2 heads,
V=2050, M=6, T=5) at B and n_img in {1, 8}, fixed length and early stop: in
float32 ids (words, back-pointers, lengths) equal to the plain versions' and
beam scores to 1e-4; in bfloat16 each greedy id the plain teacher-forced
argmax on the kernel's own ids under the near-tie rule (<pad> after <stop>),
and each best beam's teacher-forced score its returned score within 2e-2
per step (the two round their bf16 activations after sums in other orders).
The same for D and E on int8 weights (``quantize_transformer_decoder``) and
for D on int8 weights and int8 memory (``quantize_kv``), the teacher forcing
on the packed tensors seen as the model (the kernels' own dequantized head
and embedding). Kernel G (the fused inverted-residual block, both entries):
to 1e-5 x max|out| in float32 (float sums in other orders) and 1e-2 x
max|out| in bfloat16 (a sum that lands on the other side of a bf16 rounding
moves the expanded or depthwise value by one bf16 ulp, 2^-8 relative); the
chain's zero rows, W tail and channel pad exactly 0.
"""

import pytest
import torch

from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import decoder as TD
from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from myimagecaptioningmodel_tpu_torch.ops.backtrack import beam_backtrack
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_irb as TFI
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_step as TFS
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as TFT
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


def _check_topk_head(cuda, dt, M, V, k, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    E, real = 256, min(V, 12295)
    proj = torch.randn(M, E, generator=g).to(cuda)
    table, scale = _table(g, V, E, dt, cuda)
    bias = torch.randn(V, generator=g).to(cuda)
    bias[real:] = -1e9
    vals, ids, lse = TVH.topk_vocab_head(proj, table, bias, k, scale)
    rv, ri, rlse = TVH.topk_vocab_head_reference(proj, table, bias, k, scale)
    logits = TVH.head_logits_reference(proj, table, bias, scale)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    torch.testing.assert_close(vals, logits.gather(1, ids.long()), rtol=0, atol=1e-4)
    assert bool(((ids == ri) | ~_ranks_clear(logits, k, dt)).all())
    assert int(ids.max()) < real


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("M,k", [(1, 1), (32, 4), (37, 8), (512, 4), (128, 32)])
def test_cuda_topk_head_matches_plain(cuda, dt, M, k):
    _check_topk_head(cuda, dt, M, 12416, k, M + k)


# kernel C's tiling edges: 512 rows (four 128-row batch chunks) at k = 1, 8
# and 32; batch rows past a chunk and a 64-row sub-tile; vocabularies that are
# not whole 128-row tiles, down to one partial tile
@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("M,V,k", [(512, 12416, 1), (512, 12416, 8), (512, 12416, 32),
                                   (130, 12300, 16), (300, 1000, 4), (65, 100, 32)])
def test_cuda_topk_head_tile_edges(cuda, dt, M, V, k):
    _check_topk_head(cuda, dt, M, V, k, M + V + k)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_topk_head_ties_across_tiles(cuda, dt):
    """Equal logits inside one 128-row vocab tile and on both sides of tile
    edges, for 130 rows (two batch chunks): ascending index order."""
    g = torch.Generator(device="cpu").manual_seed(5)
    V, E, M = 12416, 256, 130
    proj = torch.rand(M, E, generator=g).to(cuda)
    t = torch.rand(V, E, generator=g) / 64
    winners = [12415, 256, 255, 129, 128, 127, 6, 5]
    t[winners] = 0.25
    if dt == torch.int8:
        s = t.abs().amax(dim=1) / 127
        table, scale = torch.round(t / s[:, None]).to(cuda, torch.int8), s.to(cuda)
    else:
        table, scale = t.to(cuda, dt), None
    bias = torch.full((V,), -5.0, device=cuda)
    bias[winners] = 0.0
    vals, ids, _l = TVH.topk_vocab_head(proj, table, bias, 8, scale)
    assert ids.tolist() == [sorted(winners)] * M
    assert bool((vals == vals[:, :1]).all())


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
    x, w = torch.randn(300, 16, device=cuda), torch.randn(16, 96, device=cuda)
    before = TMB.matmul_stats.launches
    TMB.matmul_stats(x, w)
    TMB.matmul_stats(x.cpu(), w.cpu())  # plain version
    assert TMB.matmul_stats.launches == before + 1


# kernel F's (M, K, N) on the training path at B=128, 224 px, a ragged M, and
# rows that are not whole 16-byte vectors
F_SHAPES = [(1605632, 32, 32), (1605632, 16, 96), (401408, 24, 144), (25088, 576, 96),
            (6272, 320, 1280), (1000, 24, 144), (1000, 11, 37)]


def _check_matmul_stats(cuda, dt, M, K, N):
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
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", F_SHAPES)
def test_cuda_matmul_stats_matches_plain(cuda, dt, M, K, N):
    _check_matmul_stats(cuda, dt, M, K, N)


# kernel F's tiling edges: K one 16-deep chunk, an odd K, K over one 32-deep
# chunk and ragged in it; N = 96 and 144 in one column tile, N over it (bf16
# tiles up to 256 columns, float32 up to 128) and a ragged last tile; M one
# row, one past a 128-row tile, and under one wave of tiles
F_EDGES = [(1, 16, 96), (129, 16, 96), (4097, 13, 144), (3000, 48, 600), (1000, 100, 1280),
           (257, 7, 3), (640, 40, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", F_EDGES)
def test_cuda_matmul_stats_tile_edges(cuda, dt, M, K, N):
    _check_matmul_stats(cuda, dt, M, K, N)


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


# ---- kernels D and E: whole transformer decodes -----------------------------------

TF_DIMS = TTF.TransformerDims(vocab_size=2050, embedding_size=128, model_dim=256, num_layers=2,
                              num_heads=2, mlp_ratio=2, max_positions=6, vocab_pad_multiple=2)


def _tf_case(dev, n_img, dt, stop_bias, seed=0):
    """Random small transformer params (a bias on <stop> so that rows stop at
    different steps) and its memory for n_img images."""
    gen = torch.Generator().manual_seed(seed)
    params = tree_to_torch(TTF.init(gen, TF_DIMS), dev)
    params["out_bias"][3] += stop_bias
    img = torch.rand(n_img, 5, 256, generator=gen).to(dev)
    gf = torch.rand(n_img, 256, generator=gen).to(dev)
    return params, TTF.precompute(params, img, gf, 2, dt)


def _tf_logits(params, pre, ids, dt):
    """Teacher-forced logits on ``ids`` and the positions up to each row's
    first <stop>."""
    ids = ids.long()
    src = torch.cat([torch.full_like(ids[:, :1], 2), ids[:, :-1]], dim=1)
    logits = TTF.teacher_forcing_logits(params, pre, src, TF_DIMS, 0, dt)
    after = torch.cumsum((ids == 3).int(), dim=1) - (ids == 3).int() > 0
    return logits, ~after


@pytest.mark.cuda
@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 256])  # 256 rows: the tensor-core product (bf16)
def test_cuda_kernel_d_matches_plain(cuda, B, dt, early):
    params, pre = _tf_case(cuda, B, dt, 2.5 if early else 0.0)
    ftp = TFT.prepare(params, pre, 2, dt)
    n = TFT.fused_greedy_decode.launches
    ids = TFT.fused_greedy_decode(ftp, 5, 2, compute_dtype=dt, early_stop=early)
    torch.cuda.synchronize()
    assert TFT.fused_greedy_decode.launches == n + 1 and ids.dtype == torch.int32
    ref = TFT.fused_greedy_decode_reference(ftp, 5, 2, compute_dtype=dt, early_stop=early)
    if dt == torch.float32:
        assert torch.equal(ids, ref)
    logits, live = _tf_logits(params, pre, ids, dt)
    if not early:
        live = torch.ones_like(live)
    assert _near_tie_ok(ids[live], logits[live], dt)
    assert (ids[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_img", [1, 8, 32])  # 32: each warp of beam_select takes 4 images
def test_cuda_kernel_e_matches_plain(cuda, n_img, dt, early):
    params, pre = _tf_case(cuda, n_img, dt, 2.5, seed=1)
    ftp = TFT.prepare(params, pre, 2, dt)
    n = TFT.fused_beam_decode.launches
    quad = TFT.fused_beam_decode(ftp, 5, 2, 4, compute_dtype=dt, early_stop=early)
    torch.cuda.synchronize()
    assert TFT.fused_beam_decode.launches == n + 1
    ref = TFT.fused_beam_decode_reference(ftp, 5, 2, 4, compute_dtype=dt, early_stop=early)
    if dt == torch.float32:
        for i, (got, want) in enumerate(zip(quad, ref)):
            if i == 2:
                assert (got - want).abs().max() <= 1e-4
            else:
                assert torch.equal(got, want), i
    ids, score = beam_backtrack(*quad, 0.0)
    logits, live = _tf_logits(params, pre, ids, dt)
    tok = torch.log_softmax(logits, dim=-1).gather(-1, ids.long()[..., None])[..., 0]
    rescore, steps = (tok * live).sum(dim=1), live.sum(dim=1)
    tol = (1e-4 if dt == torch.float32 else 2.5e-2) * steps.float().sqrt()
    assert ((rescore - score).abs() <= tol).all()


@pytest.mark.cuda
def test_cuda_kernels_d_e_refuse_what_they_cannot_take(cuda):
    params, pre = _tf_case(cuda, 2, torch.float32, 0.0)
    ftp = TFT.prepare(params, pre, 2, torch.float32)
    with pytest.raises(ValueError, match="max_length"):
        TFT.fused_greedy_decode(ftp, 7, 2, compute_dtype=torch.float32)  # 6 positions
    with pytest.raises(ValueError, match="heads"):
        TFT.fused_beam_decode(ftp, 5, 3, 2, compute_dtype=torch.float32)  # 256 % 3
    with pytest.raises(TypeError):
        TFT.fused_greedy_decode(ftp._replace(table=ftp.table.half()), 5, 2,
                                compute_dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 256])  # 256 rows: the tensor-core product (bf16)
def test_cuda_kernel_d_int8_matches_plain(cuda, B, dt, quantize_kv):
    params, _ = _tf_case(cuda, B, dt, 2.5)
    q = TTF.quantize_transformer_decoder(params)
    gen = torch.Generator().manual_seed(5)
    img = torch.rand(B, 5, 256, generator=gen).to(cuda)
    pre = TTF.precompute(q, img, torch.rand(B, 256, generator=gen).to(cuda), 2, dt)
    ftp = TFT.prepare(q, pre, 2, dt, quantize_kv=quantize_kv)
    assert ftp.w_fc2.dtype == torch.int8 and (ftp.mem_kv.dtype == torch.int8) == quantize_kv
    ids = TFT.fused_greedy_decode(ftp, 5, 2, compute_dtype=dt, early_stop=True)
    torch.cuda.synchronize()
    ref = TFT.fused_greedy_decode_reference(ftp, 5, 2, compute_dtype=dt, early_stop=True)
    if dt == torch.float32:
        assert torch.equal(ids, ref)
    mp, _dims, mpre = TFT._as_model(ftp, 2, torch.arange(B, device=cuda))
    logits, live = _tf_logits(mp, mpre, ids, dt)
    assert _near_tie_ok(ids[live], logits[live], dt)
    assert (ids[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_img", [1, 8, 32])
def test_cuda_kernel_e_int8_matches_plain(cuda, n_img, dt):
    params, _ = _tf_case(cuda, n_img, dt, 2.5, seed=1)
    q = TTF.quantize_transformer_decoder(params)
    gen = torch.Generator().manual_seed(6)
    img = torch.rand(n_img, 5, 256, generator=gen).to(cuda)
    pre = TTF.precompute(q, img, torch.rand(n_img, 256, generator=gen).to(cuda), 2, dt)
    ftp = TFT.prepare(q, pre, 2, dt)
    quad = TFT.fused_beam_decode(ftp, 5, 2, 4, compute_dtype=dt, early_stop=True)
    torch.cuda.synchronize()
    ref = TFT.fused_beam_decode_reference(ftp, 5, 2, 4, compute_dtype=dt, early_stop=True)
    if dt == torch.float32:
        for i, (got, want) in enumerate(zip(quad, ref)):
            if i == 2:
                assert (got - want).abs().max() <= 1e-4
            else:
                assert torch.equal(got, want), i
    ids, score = beam_backtrack(*quad, 0.0)
    mp, _dims, mpre = TFT._as_model(ftp, 2, torch.arange(n_img, device=cuda))
    logits, live = _tf_logits(mp, mpre, ids, dt)
    tok = torch.log_softmax(logits, dim=-1).gather(-1, ids.long()[..., None])[..., 0]
    rescore, steps = (tok * live).sum(dim=1), live.sum(dim=1)
    tol = (1e-4 if dt == torch.float32 else 2.5e-2) * steps.float().sqrt()
    assert ((rescore - score).abs() <= tol).all()


# ---- kernel G: the fused inverted-residual block ------------------------------------

G_SHAPES = [  # (B, H, W, Cin, Cexp, Cout, stride, shortcut)
    (2, 112, 112, 32, 32, 16, 1, False),  # conv2_1: row tiles of 112-wide rows
    (2, 112, 112, 16, 96, 24, 2, False),  # conv3_1
    (3, 14, 14, 96, 576, 96, 1, True),
    (8, 7, 7, 160, 960, 320, 1, False),  # few tiles: the Cexp split and its reduce
    (2, 9, 13, 24, 144, 24, 1, True),  # odd H and W, a ragged Cexp chunk
    (2, 9, 13, 24, 40, 32, 2, False),  # odd H and W at stride 2
    (1, 5, 300, 8, 48, 8, 1, True),  # wider than a tile: column tiles
]


def _g_case(cuda, B, H, W, cin, cexp, cout, dt, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, H, W, cin, generator=g) * 0.5).to(cuda, dt)
    fold = TFI.FoldedIRB(*(t.to(cuda) for t in (
        torch.randn(cin, cexp, generator=g) / cin ** 0.5, torch.randn(1, cexp, generator=g) * 0.1,
        torch.randn(9, cexp, generator=g) * 0.3, torch.randn(1, cexp, generator=g) * 0.1,
        torch.randn(cexp, cout, generator=g) / cexp ** 0.5, torch.randn(1, cout, generator=g) * 0.1)))
    return x, fold


def _g_close(got, want, dt):
    tol = 1e-5 if dt == torch.float32 else 1e-2
    err = (got.float() - want.float()).abs().max()
    assert err <= tol * want.float().abs().max(), (float(err), float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cexp,cout,stride,shortcut", G_SHAPES)
def test_cuda_fused_irb_matches_plain(cuda, dt, B, H, W, cin, cexp, cout, stride, shortcut):
    x, fold = _g_case(cuda, B, H, W, cin, cexp, cout, dt, H * W + cexp)
    for round_e in (False, True):
        n = TFI.fused_inverted_residual.launches
        got = TFI.fused_inverted_residual(x, fold, stride, shortcut, round_expanded=round_e)
        torch.cuda.synchronize()
        assert TFI.fused_inverted_residual.launches == n + 1 and got.dtype == dt
        want = TFI.fused_inverted_residual_reference(x, fold, stride, shortcut, round_e)
        assert got.shape == want.shape
        _g_close(got, want, dt)
    xc = TFI.pad_activation(x)
    got = TFI.fused_irb_chain(xc, fold, stride, shortcut, real_w=W)
    torch.cuda.synchronize()
    want = TFI.fused_irb_chain_reference(xc, fold, stride, shortcut, real_w=W)
    assert got.shape == want.shape
    ho, wo = TFI.out_size(H, stride), TFI.out_size(W, stride)
    real = torch.zeros(got.shape, dtype=torch.bool, device=cuda)
    real[:, 1:ho + 1, :wo, :cout] = True
    assert (got[~real] == 0).all()
    _g_close(got[real], want[real], dt)


@pytest.mark.cuda
def test_cuda_fused_irb_refuses_what_it_cannot_take(cuda):
    x, fold = _g_case(cuda, 1, 8, 8, 16, 32, 16, torch.float32, 0)
    with pytest.raises(ValueError, match="stride"):
        TFI.fused_inverted_residual(x, fold, 3, False)
    with pytest.raises(ValueError, match="residual"):
        TFI.fused_inverted_residual(x, fold, 2, True)
    with pytest.raises(TypeError):
        TFI.fused_inverted_residual(x.half(), fold, 1, True)
    x12, fold12 = _g_case(cuda, 1, 8, 8, 12, 32, 16, torch.float32, 0)
    with pytest.raises(ValueError, match="multiples of 8"):
        TFI.fused_inverted_residual(x12, fold12, 1, False)
    with pytest.raises(ValueError, match="contiguous"):
        TFI.fused_inverted_residual(x.transpose(1, 2), fold, 1, True)
    n = TFI.fused_inverted_residual.launches
    TFI.fused_inverted_residual(x.cpu(), TFI.FoldedIRB(*(t.cpu() for t in fold)), 1, True)
    assert TFI.fused_inverted_residual.launches == n  # the plain version
