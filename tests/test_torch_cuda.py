"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: h', c', proj to atol 1e-4 in float32 (TF32 off) and 3e-2 in
bfloat16, their mean errors to 1e-5 and 3e-4, with the head (greedy rows)
and without it (beam rows), at 1-512 rows; ids equal
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
chain's zero rows, W tail and channel pad exactly 0; the same at the edges
of the tensor-core tiling (several 7x7 or 14x14 images a block with B not a
multiple of them, Cexp 40 and 72, odd H and W at stride 2, the Cexp split
at B=1), and prepared weights with a shared split scratch give the same
bits as a FoldedIRB. Kernel A at the edges of its tiling (B across the
8-, 16- and 128-row batch tiles, vocabularies that are not whole tiles, E
8, 24 and 256, every table dtype) under the near-tie rule, and ties inside
one mma fragment, across lanes, warps and tiles to the lowest index. D's
and E's bf16 product (``stream_product``) at every (N, K) of a full-width
decode step with the A operand and epilogue it has there, rows 1-512
across its row tiles, bf16 and int8 weights, against a float32 ``torch.mm``
of the same rounded operands (``stream_product_reference``), to one bf16 ulp
at each element's magnitude plus 1e-3 of the largest (sums in other
orders); and D and E at small dims replayed through one CUDA graph on two
batches of other images, each held against its own plain decode as above.
Kernel B's bf16 products (``step_product``) against a float32 product of
the same rounded operands to 2^-16 of sum |A w| plus 1e-5; its gathered
word rows and shared image memory give the same bits as the rows and the
memory repeated; the LSTM greedy decode (one CUDA graph, small dims: H=128,
E=64, V=2050, k=49, T=5) equal to its plain version in float32 and under
the near-tie rule against the plain step teacher-forced in bfloat16, a
graph replayed on two batches and, without the copy of its inputs, giving
the previous batch's ids; the beam graph equal to the same search's plain
versions in float32 and its best beams re-scored within 2.5e-2 a sqrt
step in bfloat16. Kernel H (the attention scores and their one-pass
backward) against its plain version at ragged shapes (k across the
backward's 128-, 64- and 32-column blocks and past 48 KB of shared sums),
float32 and bfloat16, by ``chip_smoke.h_checks``'s limits (a bf16 ulp of
each bf16 output, two for e, plus the float32 sums' accumulation bound; dw
and db against a float64 sum by the bound of the kernel's own order), each
rerun bit-equal, and without a score bias. The training workflow at small dims
(``chip_smoke.trainer_corpus``: 64 train images at 64 px, H=128, E=64,
V=2050): the feeder's host buffers pinned and its batches on the card
equal to the rows; ``loop.train``'s dev decode through kernel B with head A
(35 launches each a dev batch) and kernel F 35 a step; ``evaluate()`` beam
3 through B and C (35 each), A not at all. The quality corpus's shapes
(``chip_smoke.py`` phase 30): kernel B's step, its bf16 products and its
greedy and beam decodes at H=128, E=32 (the bf16 projection in 32-column
blocks), a vocabulary of 19 words padded to 128 rows and 4 image slots, by
the limits above, the near-tie rule over the real words; kernel F at every
(M, K, N) of MobileNetV2 x0.35 at 48 px and B=16; kernel G at that
encoder's 17 blocks, whose channel counts (5, 11, 22, 30, 33, ...) are not
multiples of 8, in float32 and bfloat16 by G's limits (at B=1 the Cexp
split's partials with an odd Cout).
"""

import pytest
import torch

from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import decoder as TD
from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from myimagecaptioningmodel_tpu_torch.ops.backtrack import beam_backtrack
from myimagecaptioningmodel_tpu_torch.ops.kernels import attention as TKH
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


# kernel A's tilings: 32-row vocab tiles for B <= 16 (8- and 16-row batch
# tiles), 96-row tiles with 128-row batch chunks beyond; B across each edge,
# vocabularies that are not whole tiles, E one 16-deep step, not a whole step,
# and the served 256
A_EDGES = ([(B, 12300, 256) for B in (1, 7, 8, 9, 16, 17, 128, 129, 300)]
           + [(B, V, E) for B in (8, 17, 129) for V, E in ((1000, 8), (100, 24))])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("B,V,E", A_EDGES)
def test_cuda_vocab_argmax_tile_edges(cuda, dt, B, V, E):
    g = torch.Generator(device="cpu").manual_seed(B + V + E)
    proj = torch.randn(B, E, generator=g).to(cuda)
    table, scale = _table(g, V, E, dt, cuda)
    bias = torch.randn(V, generator=g).to(cuda)
    n = TVH.greedy_vocab_argmax.launches
    out = TVH.greedy_vocab_argmax(proj, table, bias, scale)
    assert TVH.greedy_vocab_argmax.launches == n + 1
    logits = TVH.head_logits_reference(proj, table, bias, scale)
    assert out.shape == (B,) and int(out.max()) < V
    assert _near_tie_ok(out, logits, dt)


# equal best rows: two rows of one thread's mma fragment (g and g + 8), rows of
# other lanes, of both warp rows of a tile, and of other tiles
A_TIES = {"fragment": [11, 3], "lanes": [14, 9, 6], "warps": [60, 50, 30, 20],
          "tiles": [12000, 9000, 4097, 4096, 96, 95, 33, 32]}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("B", [8, 16, 128])
@pytest.mark.parametrize("where", list(A_TIES))
def test_cuda_vocab_argmax_ties_lowest_index(cuda, dt, B, where):
    winners = A_TIES[where]
    g = torch.Generator(device="cpu").manual_seed(7)
    V, E = 12416, 256
    proj = torch.rand(B, E, generator=g).to(cuda)
    t = torch.rand(V, E, generator=g) / 64
    t[winners] = 0.25
    if dt == torch.int8:
        s = t.abs().amax(dim=1) / 127
        table, scale = torch.round(t / s[:, None]).to(cuda, torch.int8), s.to(cuda)
    else:
        table, scale = t.to(cuda, dt), None
    bias = torch.full((V,), -5.0, device=cuda)
    bias[winners] = 0.0
    out = TVH.greedy_vocab_argmax(proj, table, bias, scale)
    assert out.tolist() == [min(winners)] * B


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
@pytest.mark.parametrize("head", [True, False])  # greedy rows; beam rows (8, 128 x beam 4)
@pytest.mark.parametrize("B", [1, 8, 16, 17, 32, 128, 512])  # the products' row tiles
def test_cuda_fused_step_matches_plain(cuda, dt, B, head):
    _check_fused_step(_step_args(cuda, B, dt), dt, head)


# the quality corpus's LSTM (chip_smoke.py phase 30): H=128, E=32, a vocabulary
# of 19 words padded to 128 rows, 4 image slots (48 px, MobileNetV2 x0.35)
QUALITY_DIMS = TD.DecoderDims(vocab_size=19, embedding_size=32, hidden_dim=128,
                              vocab_pad_multiple=128)


def _quality_step_args(cuda, B, dt):
    g = torch.Generator(device="cpu").manual_seed(B)
    params = tree_to_torch(TD.init(g, QUALITY_DIMS), cuda)
    img = torch.rand(B, 4, 128, generator=g).to(cuda)
    pre = TD.precompute(params, img, torch.rand(B, 128, generator=g).to(cuda), dt)
    fp = TFS.prepare(params, pre, 0, dt)
    word = torch.randint(0, 19, (B,), generator=g).to(cuda)
    h = (torch.randn(B, 128, generator=g) * 0.1).to(cuda)
    c = (torch.randn(B, 128, generator=g) * 0.1).to(cuda)
    return fp, fp.emb_table[word], h, c, pre.img_k, pre.img_v


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("B", [1, 16, 48])  # the eval batch; 16 images x beam 3
def test_cuda_fused_step_at_the_quality_dims(cuda, dt, B, head):
    """E = 32 (the bf16 projection in 32-column blocks), H = 128, 4 slots."""
    _check_fused_step(_quality_step_args(cuda, B, dt), dt, head, v_real=19)


def _check_fused_step(args, dt, head, v_real=None):
    fp = args[0]
    n = TFS.fused_decode_step.launches
    out = TFS.fused_decode_step(*args, with_head=head, compute_dtype=dt)
    torch.cuda.synchronize()
    assert TFS.fused_decode_step.launches == n + 1
    ref = TFS.reference_step(*args, with_head=head, compute_dtype=dt)
    tol = 1e-4 if dt == torch.float32 else 3e-2
    # and the mean error, as chip_smoke.py's B_MEAN_TOL: a bf16 rounding on
    # the other side of the plain step's moves a few outputs, a dataflow
    # fault every row's
    mean_tol = 1e-5 if dt == torch.float32 else 3e-4
    for t, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(t, r, rtol=0, atol=tol)
        assert (t - r).abs().mean() <= mean_tol
    if head:
        logits = torch.matmul(ref[2].to(dt).float(), fp.head_table.float().T) + fp.head_bias
        assert _near_tie_ok(out[3], logits[:, :v_real], dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 32])
def test_cuda_fused_step_gathers_words_and_shares_images(cuda, dt, B):
    """The gate product's gathered word rows (the padding id's zeroed) and
    rows sharing their image's memory (beam rows) give the same bits as the
    word rows and the memory repeated per row."""
    fp, _emb, h, c, img_k, img_v = _step_args(cuda, B, dt)
    pk = TFS.pack_step(fp)
    word = torch.randint(0, 12295, (B,), generator=torch.Generator().manual_seed(1))
    word[::3] = 0  # <pad>
    word = word.to(cuda, torch.int32)
    rows = TFS.fused_decode_step(pk, TFS.gather_words(pk.table, word, 0), h, c, img_k, img_v,
                                 with_head=False, compute_dtype=dt)
    gathered = TFS.fused_decode_step(pk, None, h, c, img_k, img_v, with_head=False,
                                     compute_dtype=dt, word=word, padding_idx=0)
    shared_k = img_k[::4].contiguous()  # 4 rows an image
    shared = TFS.fused_decode_step(pk, None, h, c, shared_k.repeat_interleave(4, 0),
                                   img_v[::4].repeat_interleave(4, 0).contiguous(),
                                   with_head=False, compute_dtype=dt, word=word)
    once = TFS.fused_decode_step(pk, None, h, c, shared_k, img_v[::4].contiguous(),
                                 with_head=False, compute_dtype=dt, word=word)
    torch.cuda.synchronize()
    for a, b, x, y in zip(rows[:3], gathered[:3], shared[:3], once[:3]):
        assert torch.equal(a, b) and torch.equal(x, y)


# (name, problems, N, K, k_split, mode, gather) of each product of a bf16 step
B_PRODUCTS = [("gate", 1, 5120, 1280, 256, "lstm", True), ("gate_rows", 1, 5120, 1280, 256,
               "lstm", False), ("p_hid", 1, 1024, 1024, 0, "tanh", False),
              ("he_se", 2, 1024, 1024, 0, "f32", False), ("proj", 1, 256, 1024, 0, "f32", False),
              # the quality corpus's LSTM (H=128, E=32): the projection's 32-column blocks
              ("gate_e32", 1, 640, 160, 32, "lstm", True), ("proj_e32", 1, 32, 128, 0, "f32", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 9, 16, 17, 33, 128, 257, 512])
@pytest.mark.parametrize("name,P,N,K,k_split,mode,gather", B_PRODUCTS)
def test_cuda_step_product_matches_plain(cuda, name, P, N, K, k_split, mode, gather, rows):
    """Each of kernel B's bf16 products against a float32 product of the
    same rounded operands: to 2^-16 of sum |A w| plus 1e-5 (float32 sums in
    other orders; the epilogue's tanh, sigmoid and cell move that by at most
    as much)."""
    g = torch.Generator().manual_seed(N + K + rows)
    bf = torch.bfloat16
    w = (torch.randn(P, K, N, generator=g) / K ** 0.5).to(cuda, bf)
    bias = (0.1 * torch.randn(P, N, generator=g)).to(cuda)
    a2 = torch.randn(P, rows, K - k_split, generator=g).to(cuda)
    kw = {}
    if mode == "lstm":
        table = torch.randn(300, k_split, generator=g).to(cuda, bf)
        word = torch.randint(0, 300, (rows,), generator=g, dtype=torch.int32)
        word[::3] = 0  # <pad>: zeros
        kw = dict(a=table, word=word.to(cuda), pad=0) if gather else dict(a=table[:rows])
        kw.update(k_split=k_split, gxb=torch.randn(rows, N, generator=g).to(cuda),
                  c=torch.randn(rows, N // 5, generator=g).to(cuda))
        if not gather and rows > 300:
            pytest.skip("the word rows come from a 300-row table")
    if P == 1:
        w, bias, a2 = w[0], bias[0], a2[0]
    if mode == "lstm":
        bias = None
    n = TFS.step_product.launches
    got = TFS.step_product(a2, w, bias, mode, **kw)
    torch.cuda.synchronize()
    assert TFS.step_product.launches == n + 1
    want = TFS.step_product_reference(a2, w, bias, mode, **kw)
    A = TFS._product_rows(a2, kw.get("a"), kw.get("word"), k_split, 0).to(bf).float()
    W = TFS.deinterleave_gates(w) if mode == "lstm" else w
    mag = (A.abs().reshape(P, rows, K) @ W.float().abs().reshape(P, K, -1)).reshape(
        *(() if P == 1 else (P,)), rows, -1)
    tol = 2.0 ** -16 * mag + 1e-5
    if mode == "lstm":  # h', c', sentinel: each moves by at most the gates' errors
        tol = 4 * tol.reshape(rows, 5, -1).amax(dim=1)
    for a, b in zip(got if mode == "lstm" else [got], want if mode == "lstm" else [want]):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert ((a - b).abs() <= tol).all(), float(((a - b).abs() / tol).max())


# ---- kernel B's whole decodes: greedy (one C call) and beam, each one CUDA graph ----

LSTM_DIMS = TD.DecoderDims(vocab_size=2050, embedding_size=64, hidden_dim=128)


def _lstm_case(dev, n_img, dt, stop_bias, seed=0, dims=LSTM_DIMS, slots=49):
    """Small random LSTM params (the embedding table and the output
    projection scaled up, so that rows and steps emit distinct words; a bias
    on <stop> so that rows stop at different steps) and one batch's
    ``Precomputed``."""
    gen = torch.Generator().manual_seed(seed)
    params = tree_to_torch(TD.init(gen, dims), dev)
    params["out_proj"]["w"] *= 4.0
    params["embedding"]["table"] *= 4.0
    params["out_bias"][3] += stop_bias
    return params, _lstm_pre(params, n_img, dt, seed + 100, slots)


def _lstm_pre(params, n_img, dt, seed, slots=49):
    gen = torch.Generator().manual_seed(seed)
    dev = params["out_bias"].device
    img = torch.randn(n_img, slots, 128, generator=gen).to(dev)
    return TD.precompute(params, img, torch.randn(n_img, 128, generator=gen).to(dev), dt)


def _lstm_forced(params, pre, ids, dt, padding_idx=0):
    """The plain step teacher-forced on ``ids`` -> (float32 logits [B, T, V],
    positions up to each row's first <stop>)."""
    fp = TFS.prepare(params, pre, padding_idx, dt)
    B, T = ids.shape
    h = torch.zeros(B, 128, device=ids.device)
    c = torch.zeros_like(h)
    word = torch.full((B,), 2, dtype=torch.long, device=ids.device)
    logits = []
    for t in range(T):
        h, c, proj, _w = TFS.reference_step(fp, fp.emb_table[word], h, c, pre.img_k.to(dt),
                                            pre.img_v.to(dt), False, dt)
        logits.append(TVH.head_logits_reference(proj, fp.head_table, fp.head_bias))
        word = ids[:, t].long()
    after = torch.cumsum((ids == 3).int(), dim=1) - (ids == 3).int() > 0
    return torch.stack(logits, dim=1), ~after


def _lstm_greedy(params, pre, dt, early, packed=None):
    pk = TFS.with_batch(TFS.packed_for(params, dt, packed), params, pre)
    return pk, TFS.lstm_greedy_decode(pk, pre.img_k.to(dt).contiguous(),
                                      pre.img_v.to(dt).contiguous(), 5, compute_dtype=dt,
                                      early_stop=early)


def _lstm_greedy_ok(params, pre, ids, dt, early, v_real=None):
    logits, live = _lstm_forced(params, pre, ids, dt)
    if not early:
        live = torch.ones_like(live)
    return (_near_tie_ok(ids[live], logits[live][:, :v_real], dt)
            and bool((ids[~live] == 0).all()))


@pytest.mark.cuda
@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 17, 128])
def test_cuda_lstm_greedy_decode_matches_plain(cuda, B, dt, early):
    params, pre = _lstm_case(cuda, B, dt, 4.0 if early else 0.0)
    n = (TFS.fused_decode_step.launches, TVH.greedy_vocab_argmax.launches)
    pk, ids = _lstm_greedy(params, pre, dt, early)
    torch.cuda.synchronize()
    # every step counts, captured or replayed
    assert (TFS.fused_decode_step.launches, TVH.greedy_vocab_argmax.launches) == (n[0] + 5,
                                                                                  n[1] + 5)
    assert ids.dtype == torch.int32 and TFS.lstm_greedy_decode.kernel_launches == 45
    ref = TFS.lstm_greedy_decode_reference(pk, pre.img_k.to(dt), pre.img_v.to(dt), 5,
                                           compute_dtype=dt, early_stop=early)
    if dt == torch.float32:
        assert torch.equal(ids, ref)
    assert _lstm_greedy_ok(params, pre, ids, dt, early)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_lstm_greedy_replays_one_graph_on_two_batches(cuda, dt):
    params, _ = _lstm_case(cuda, 8, dt, 4.0, seed=3)
    packed = TFS.pack_weights(params, dt)
    TFS.GRAPHS.entries.clear()  # no graph of an earlier test at these addresses
    captures = TFS.GRAPHS.captures
    pres = [_lstm_pre(params, 8, dt, seed) for seed in (11, 12)]
    outs = []
    for pre in pres:
        _pk, ids = _lstm_greedy(params, pre, dt, True, packed)
        torch.cuda.synchronize()
        assert _lstm_greedy_ok(params, pre, ids, dt, True)
        outs.append(ids)
    assert TFS.GRAPHS.captures == captures + 1, "the second batch replays the first's graph"
    assert not torch.equal(outs[0], outs[1])
    load = TFS.GRAPHS.load
    TFS.GRAPHS.load = lambda work, inputs: None  # the first batch, its inputs not copied in
    try:
        _pk, stale = _lstm_greedy(params, pres[0], dt, True, packed)
    finally:
        TFS.GRAPHS.load = load
    torch.cuda.synchronize()
    assert torch.equal(stale, outs[1])  # the graph decoded the second batch again


def _beam_rescore(params, pre, ids, dt):
    logits, live = _lstm_forced(params, pre, ids, dt)
    tok = torch.log_softmax(logits, dim=-1).gather(-1, ids.long()[..., None])[..., 0]
    return (tok * live).sum(dim=1), live.sum(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_img", [1, 8, 32])
def test_cuda_lstm_beam_graph_matches_plain(cuda, n_img, dt, early):
    from myimagecaptioningmodel_tpu_torch.inference import beam as TB

    params, pre = _lstm_case(cuda, n_img, dt, 4.0, seed=1)
    packed = TFS.pack_weights(params, dt)
    TFS.GRAPHS.entries.clear()
    captures = TFS.GRAPHS.captures
    for i, seed in enumerate((21, 22)):
        pre = _lstm_pre(params, n_img, dt, seed)
        n = (TFS.fused_decode_step.launches, TVH.topk_vocab_head.launches)
        ids, score = TB.beam_search_ids(params, pre, 5, 4, compute_dtype=dt, use_kernels=True,
                                        early_stop=early, packed=packed)
        torch.cuda.synchronize()
        assert (TFS.fused_decode_step.launches, TVH.topk_vocab_head.launches) == (n[0] + 5,
                                                                                  n[1] + 5)
        assert TFS.GRAPHS.captures == captures + 1
        if dt == torch.float32:  # the same branch on the CPU: the kernels' plain versions
            cpu = lambda t: t.cpu()  # noqa: E731
            ref_ids, ref_score = TB.beam_search_ids(
                {k: _tree_map(v, cpu) for k, v in params.items()},
                TD.Precomputed(*(cpu(t) for t in pre)), 5, 4, compute_dtype=dt,
                use_kernels=True, early_stop=early)
            assert torch.equal(ids.cpu(), ref_ids)
            assert (score.cpu() - ref_score).abs().max() <= 1e-4
        rescore, steps = _beam_rescore(params, pre, ids, dt)
        tol = (1e-4 if dt == torch.float32 else 2.5e-2) * steps.float().sqrt()
        assert ((rescore - score).abs() <= tol).all()


def _tree_map(tree, fn):
    return {k: _tree_map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


@pytest.mark.cuda
@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_lstm_decodes_at_the_quality_dims(cuda, dt, early):
    """Greedy (B with A's head, one C call) and beam 3 (B with C) at the
    quality corpus's dims, 16 images of 4 slots, against the plain decodes."""
    from myimagecaptioningmodel_tpu_torch.inference import beam as TB

    params, pre = _lstm_case(cuda, 16, dt, 4.0 if early else 0.0, seed=4, dims=QUALITY_DIMS,
                             slots=4)
    pk, ids = _lstm_greedy(params, pre, dt, early)
    ref = TFS.lstm_greedy_decode_reference(pk, pre.img_k.to(dt), pre.img_v.to(dt), 5,
                                           compute_dtype=dt, early_stop=early)
    torch.cuda.synchronize()
    if dt == torch.float32:
        assert torch.equal(ids, ref)
    assert _lstm_greedy_ok(params, pre, ids, dt, early, v_real=19)
    assert int(ids.max()) < 19  # no padded row of the vocabulary wins
    n = (TFS.fused_decode_step.launches, TVH.topk_vocab_head.launches)
    ids, score = TB.beam_search_ids(params, pre, 5, 3, compute_dtype=dt, use_kernels=True,
                                    early_stop=early)
    torch.cuda.synchronize()
    assert (TFS.fused_decode_step.launches, TVH.topk_vocab_head.launches) == (n[0] + 5, n[1] + 5)
    rescore, steps = _beam_rescore(params, pre, ids, dt)
    tol = (1e-4 if dt == torch.float32 else 2.5e-2) * steps.float().sqrt()
    assert ((rescore - score).abs() <= tol).all()


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


# kernel F's (M, K, N) at the quality corpus's shapes (chip_smoke.py phase 30:
# MobileNetV2 x0.35 at 48 px, B=16): K and N down to 5 and 8, not multiples of
# 16-byte vectors
F_QUALITY = [(64, 56, 336), (64, 112, 1280), (64, 198, 56), (64, 336, 56), (64, 336, 112),
             (144, 22, 132), (144, 33, 198), (144, 66, 22), (144, 132, 22), (144, 132, 33),
             (144, 198, 33), (576, 11, 66), (576, 48, 11), (576, 66, 11), (2304, 8, 48),
             (2304, 30, 8), (2304, 48, 8), (9216, 5, 30), (9216, 11, 5), (9216, 11, 11)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", F_QUALITY)
def test_cuda_matmul_stats_at_the_quality_shapes(cuda, dt, M, K, N):
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


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 15])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_subset_bn_matches_float64(cuda, dt, rows):
    """The subset-statistics BN (``model.bn_stat_rows``) on the card against
    the same function in float64 on the CPU, on the same (rounded) inputs:
    y, mean, var and the backward's dscale, doffset and dx to 1e-5 of each
    one's largest magnitude in float32 and 1e-2 (bf16 y and dx, 2^-8
    relative) in bfloat16."""
    g = torch.Generator().manual_seed(rows)
    x = (torch.randn(16, 14, 14, 64, generator=g) * 2 + 0.5).to(dt)
    scale, offset = 1 + 0.2 * torch.randn(64, generator=g), 0.1 * torch.randn(64, generator=g)
    dy = torch.randn(16, 14, 14, 64, generator=g).to(dt)
    outs = []
    for dev, xdt in ((cuda, dt), ("cpu", torch.float64)):
        s, o, xx = (t.to(dev).requires_grad_() for t in (scale, offset, x.to(xdt)))
        y, mean, var = TL._BNTrainSubset.apply(s, o, xx, rows)
        outs.append([y, mean, var, *torch.autograd.grad(y, (s, o, xx), dy.to(dev, xdt))])
    tol = 1e-5 if dt == torch.float32 else 1e-2
    for name, got, want in zip(("y", "mean", "var", "dscale", "doffset", "dx"), *outs):
        err = (got.detach().cpu().double() - want.detach()).abs().max()
        assert err <= tol * want.abs().max(), (name, float(err))


@pytest.mark.cuda
def test_cuda_transformer_train_step_fused_matches_unfused(cuda):
    """A small transformer captioner (MobileNetV2 x0.35 at 64 px, B=8, D=64,
    2 layers, 4 heads, vocab 200) trained one float32 step on the card with
    kernel F (35 launches a forward) and without: loss to 1e-5 relative,
    the decoder's and projections' gradients to 5e-4 of their group's
    largest (float32 sums in other orders), the encoder's to a relative L2
    error of 0.05 (float32 BN noise at B=8), and every leaf of every layer
    updated by Adam."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import train_tree
    from myimagecaptioningmodel_tpu_torch.models import captioner as TC
    from myimagecaptioningmodel_tpu_torch.models.decoder import DecoderDims
    from myimagecaptioningmodel_tpu_torch.parallel import train_step as TS

    tdims = TTF.TransformerDims(vocab_size=200, embedding_size=32, model_dim=64, num_layers=2,
                                num_heads=4, mlp_ratio=2, max_positions=10)
    opts = TC.ModelOptions(dims=DecoderDims(vocab_size=200, hidden_dim=64), arch="transformer",
                           tdims=tdims, encoder_scale=0.35, compute_dtype="float32",
                           sentence_length=10, label_smoothing=0.1)
    ref = TC.init(torch.Generator().manual_seed(0), opts)
    g = torch.Generator().manual_seed(1)
    images = torch.rand(8, 64, 64, 3, generator=g).to(cuda)
    caps = torch.randint(4, 200, (8, 10), generator=g)
    caps[:, 0], caps[:, 7], caps[:, 8:] = 2, 3, 0
    runs = {}
    for fuse in (False, True):
        o = opts._replace(fuse_bn_stats=fuse)
        params, state = train_tree(*ref, device=cuda)
        n = TMB.matmul_stats.launches
        loss, _ = TC.loss_fn(params, state, images, caps.to(cuda), o)
        assert TMB.matmul_stats.launches - n == (35 if fuse else 0)
        leaves = TS.tree_leaves(params)
        runs[fuse] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    groups = [k for k in sorted(ref[0]) for _ in TS.tree_leaves(ref[0][k])]
    (l0, g0), (l1, g1) = runs[False], runs[True]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for grp in ("decoder", "img_embed", "img_global"):
        pairs = [(a, b) for a, b, k in zip(g1, g0, groups) if k == grp]
        top = max(float(b.abs().max()) for _a, b in pairs)
        assert all(float((a - b).abs().max()) <= 5e-4 * top for a, b in pairs), grp
    enc = [(a, b) for a, b, k in zip(g1, g0, groups) if k == "encoder"]
    diff = sum(float(((a - b) ** 2).sum()) for a, b in enc) ** 0.5
    assert diff <= 0.05 * sum(float((b ** 2).sum()) for _a, b in enc) ** 0.5

    schedule = lambda step: 1e-3  # noqa: E731
    optimizer = TS.Optimizer(schedule)
    steps = TS.build_steps(opts._replace(fuse_bn_stats=True), optimizer, schedule)
    params, state = train_tree(*ref, device=cuda)
    before = [p.detach().clone() for p in TS.tree_leaves(params["decoder"]["layers"])]
    params, _o, _s, _n, loss, _lr = steps.train_step(params, optimizer.init(params), state, 0,
                                                     images, caps.to(cuda))
    after = TS.tree_leaves(params["decoder"]["layers"])
    assert torch.isfinite(loss) and len(after) == 48
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


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


def _tf_logits(params, pre, ids, dt, dims=TF_DIMS):
    """Teacher-forced logits on ``ids`` and the positions up to each row's
    first <stop>."""
    ids = ids.long()
    src = torch.cat([torch.full_like(ids[:, :1], 2), ids[:, :-1]], dim=1)
    logits = TTF.teacher_forcing_logits(params, pre, src, dims, 0, dt)
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


# the quality corpus's transformer (chip_smoke.py phase 30): E=32, D=128, 4
# heads, F=256, 19 words padded to 128 rows
QUALITY_TF_DIMS = TTF.TransformerDims(vocab_size=19, embedding_size=32, model_dim=128,
                                      num_layers=2, num_heads=4, mlp_ratio=2, max_positions=6,
                                      vocab_pad_multiple=128)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_kernels_d_e_at_the_quality_dims(cuda, dt, int8):
    """D greedy (int8 weights and int8 memory with ``int8``) and E beam 4 at
    the quality corpus's dims, 16 images of 4 slots: in bf16 the head's
    product takes 32-column blocks over rows tf_layernorm normalized. The
    limits of the tests above, the near-tie rule over the real words."""
    gen = torch.Generator().manual_seed(7)
    params = tree_to_torch(TTF.init(gen, QUALITY_TF_DIMS), cuda)
    params["out_bias"][3] += 2.5
    if int8:
        params = TTF.quantize_transformer_decoder(params)
    img = torch.rand(16, 4, 128, generator=gen).to(cuda)
    pre = TTF.precompute(params, img, torch.rand(16, 128, generator=gen).to(cuda), 4, dt)
    rows = torch.arange(16, device=cuda)
    ftp = TFT.prepare(params, pre, 4, dt, quantize_kv=int8)
    ids = TFT.fused_greedy_decode(ftp, 5, 4, compute_dtype=dt, early_stop=True)
    torch.cuda.synchronize()
    ref = TFT.fused_greedy_decode_reference(ftp, 5, 4, compute_dtype=dt, early_stop=True)
    if dt == torch.float32:
        assert torch.equal(ids, ref)
    mp, _dims, mpre = TFT._as_model(ftp, 4, rows)
    logits, live = _tf_logits(mp, mpre, ids, dt, QUALITY_TF_DIMS)
    assert _near_tie_ok(ids[live], logits[live][:, :19], dt) and (ids[~live] == 0).all()
    ftp = TFT.prepare(params, pre, 4, dt)  # float memory: beam takes no int8 memory
    quad = TFT.fused_beam_decode(ftp, 5, 4, 4, compute_dtype=dt, early_stop=True)
    torch.cuda.synchronize()
    ids, score = beam_backtrack(*quad, 0.0)
    mp, _dims, mpre = TFT._as_model(ftp, 4, rows)
    logits, live = _tf_logits(mp, mpre, ids, dt, QUALITY_TF_DIMS)
    tok = torch.log_softmax(logits, dim=-1).gather(-1, ids.long()[..., None])[..., 0]
    rescore, steps = (tok * live).sum(dim=1), live.sum(dim=1)
    tol = (1e-4 if dt == torch.float32 else 2.5e-2) * steps.float().sqrt()
    assert ((rescore - score).abs() <= tol).all() and int(ids.max()) < 19


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


# ---- kernels D and E: the weight-streaming product and the decode graphs -------------

# (N, K, A operand, epilogue) of each product of a bf16 decode step
STREAM_SHAPES = [(3072, 1024, "layernorm", "qkv"), (1024, 1024, "rows", "residual"),
                 (1024, 1024, "layernorm", "store"), (4096, 1024, "layernorm", "gelu"),
                 (1024, 4096, "rows", "residual"), (256, 1024, "layernorm", "store_f32"),
                 (1024, 256, "gather", "embed"),
                 # the quality corpus's head (E=32: 32-column blocks over
                 # normalized rows) and embedding (K=32)
                 (32, 128, "rows", "store_f32"), (128, 32, "gather", "embed")]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 31, 33, 255, 257, 512])
@pytest.mark.parametrize("N,K,a_mode,mode", STREAM_SHAPES)
def test_cuda_stream_product_matches_mm(cuda, N, K, a_mode, mode, rows, int8):
    g = torch.Generator().manual_seed(N + K + rows)
    bf = torch.bfloat16
    w = torch.randn(K, N, generator=g) / K ** 0.5
    scale = None
    if int8:
        scale = (w.abs().amax(dim=0) / 127).to(cuda)
        w = torch.round(w / scale.cpu()).to(torch.int8).to(cuda)
    else:
        w = w.to(cuda, bf)
    bias = (0.1 * torch.randn(N, generator=g)).to(cuda)
    kw = dict(w_scale=scale)
    if a_mode == "gather":
        a = torch.randn(300, K, generator=g).to(cuda, bf)
        word = torch.randint(0, 300, (rows,), generator=g, dtype=torch.int32)
        word[::3] = 0  # <pad>: zeros
        kw.update(word=word.to(cuda), pad=0)
    elif a_mode == "layernorm":
        a = (3 * torch.randn(rows, K, generator=g) + 0.5).to(cuda)
        kw.update(ln_g=(1 + 0.1 * torch.randn(K, generator=g)).to(cuda),
                  ln_b=(0.1 * torch.randn(K, generator=g)).to(cuda))
    else:
        a = torch.randn(rows, K, generator=g).to(cuda, bf)
    outs = {}
    for name, fn in (("kernel", TFT.stream_product), ("plain", TFT.stream_product_reference)):
        o = dict(kw)
        if mode == "residual":
            o["out"] = torch.ones(rows, N, device=cuda)
        elif mode == "embed":
            o["pos"] = torch.linspace(-1, 1, N, device=cuda)
        elif mode == "qkv":
            o.update(out=torch.zeros(rows, N // 3, dtype=bf, device=cuda), t=2,
                     kc=torch.zeros(rows, 4, N // 3, dtype=bf, device=cuda),
                     vc=torch.zeros(rows, 4, N // 3, dtype=bf, device=cuda))
        n = TFT.stream_product.launches
        out = fn(a, w, bias, mode, a_mode, **o)
        torch.cuda.synchronize()
        assert TFT.stream_product.launches == n + (name == "kernel")
        outs[name] = [out] + ([o["kc"], o["vc"]] if mode == "qkv" else [])
    # the float32 product (times the int8 scale): the two sums, taken in other
    # orders, may round to neighbouring bf16 numbers, and that ulp carries
    # through the scale, the bias and the mode's own rounding
    A = a.float()
    if a_mode == "gather":
        A = torch.where((kw["word"] == 0)[:, None], 0.0, A[kw["word"].long()])
    if a_mode == "layernorm":
        A = TTF._layer_norm({"g": kw["ln_g"], "b": kw["ln_b"]}, A)
    s = 1 if scale is None else scale
    prod = (A @ w.float()).abs() * s
    if a_mode == "layernorm":
        # the kernel's row statistics and the plain two-pass ones differ in
        # the last float32 bits, and an A element may round to the
        # neighbouring bf16 number: at most one bf16 ulp (2^-8 of |A|) of
        # each term of the sum
        prod = prod + 2.0 ** -8 * (A.abs() @ w.float().abs()) * s
    # the product's ulp carries through the scale's and the bias's roundings
    # (and GELU's slope, at most 1.13): 2^-6 of the product and of the
    # value before the mode
    prod = prod + (A @ w.float() * s + bias).abs()
    prods = [prod[:, :N // 3], prod[:, N // 3:2 * N // 3], prod[:, 2 * N // 3:]]
    for i, (got, want) in enumerate(zip(outs["kernel"], outs["plain"])):
        assert got.shape == want.shape and got.dtype == want.dtype
        got, want = got.float(), want.float()
        if mode == "residual":  # x + y: y held
            got, want = got - 1, want - 1
        if mode == "embed":  # y + pos: y held
            got, want = got - o["pos"], want - o["pos"]
        p = prods[i] if mode == "qkv" else prod
        if mode == "qkv" and i:
            got, want = got[:, 2], want[:, 2]  # position t
            assert not (outs["kernel"][i].float()[:, [0, 1, 3]]).any()
        # and one bf16 ulp (at most 2^-7 of the magnitude) of the output
        tol = 2.0 ** -6 * p + 2.0 ** -7 * want.abs() + 1e-6
        assert ((got - want).abs() <= tol).all(), float(((got - want).abs() / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_kernels_d_e_replay_one_graph_on_two_batches(cuda, dt, beam):
    params, _ = _tf_case(cuda, 8, dt, 2.5, seed=3)
    pk = TFT.pack_weights(params, dt)
    TFT.GRAPHS.entries.clear()  # no graph of an earlier test at these addresses
    captures = TFT.GRAPHS.captures
    for i, seed in enumerate((11, 12)):
        gen = torch.Generator().manual_seed(seed)
        img = torch.rand(8, 5, 256, generator=gen).to(cuda)
        pre = TTF.precompute(params, img, torch.rand(8, 256, generator=gen).to(cuda), 2, dt)
        ftp = TFT.prepare(params, pre, 2, dt, packed=pk)
        if beam:
            got = TFT.fused_beam_decode(ftp, 5, 2, 4, compute_dtype=dt, early_stop=True)
            ref = TFT.fused_beam_decode_reference(ftp, 5, 2, 4, compute_dtype=dt,
                                                  early_stop=True)
            ids, score = beam_backtrack(*got, 0.0)
            logits, live = _tf_logits(params, pre, ids, dt)
            tok = torch.log_softmax(logits, dim=-1).gather(-1, ids.long()[..., None])[..., 0]
            tol = (1e-4 if dt == torch.float32 else 2.5e-2) * live.sum(dim=1).float().sqrt()
            assert (((tok * live).sum(dim=1) - score).abs() <= tol).all()
            if dt == torch.float32:
                assert all(torch.equal(a, b) for j, (a, b) in enumerate(zip(got, ref)) if j != 2)
        else:
            got = TFT.fused_greedy_decode(ftp, 5, 2, compute_dtype=dt, early_stop=True)
            ref = TFT.fused_greedy_decode_reference(ftp, 5, 2, compute_dtype=dt, early_stop=True)
            logits, live = _tf_logits(params, pre, got, dt)
            assert _near_tie_ok(got[live], logits[live], dt) and (got[~live] == 0).all()
            if dt == torch.float32:
                assert torch.equal(got, ref)
        torch.cuda.synchronize()
        assert TFT.GRAPHS.captures == captures + 1, "the second batch replays the first's graph"


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


def _check_fused_irb(cuda, dt, B, H, W, cin, cexp, cout, stride, shortcut):
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
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cexp,cout,stride,shortcut", G_SHAPES)
def test_cuda_fused_irb_matches_plain(cuda, dt, B, H, W, cin, cexp, cout, stride, shortcut):
    _check_fused_irb(cuda, dt, B, H, W, cin, cexp, cout, stride, shortcut)


G_TILINGS = [  # (B, H, W, Cin, Cexp, Cout, stride, shortcut): the tensor-core tiles' edges
    (3, 7, 7, 160, 960, 160, 1, True),  # two 7x7 images a block, B not a multiple of two
    (5, 7, 7, 160, 960, 160, 1, True),
    (5, 14, 14, 16, 48, 16, 1, True),  # three 14x14 images a block, B = 3 + 2
    (3, 14, 14, 32, 72, 32, 2, False),  # Cexp 72: a chunk of 8 channels last
    (2, 28, 28, 32, 40, 32, 1, True),  # Cexp 40, row tiles
    (2, 15, 17, 24, 72, 24, 2, False),  # odd H and W at stride 2
    (1, 7, 7, 160, 960, 320, 1, False),  # B = 1: Cexp split over 30 blocks, the reduce
    (1, 112, 112, 32, 32, 16, 1, False),  # conv2_1 at B = 1: Cexp split in two
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cexp,cout,stride,shortcut", G_TILINGS)
def test_cuda_fused_irb_tilings(cuda, dt, B, H, W, cin, cexp, cout, stride, shortcut):
    _check_fused_irb(cuda, dt, B, H, W, cin, cexp, cout, stride, shortcut)


# kernel G at channel counts that are not multiples of 8, or under 8: the 17
# blocks of MobileNetV2 x0.35 at 48 px, B=16 (chip_smoke.py phase 30), and
# two of them at sizes with several row and column tiles (bf16: element
# copies and stores, odd Cout in the Cexp split's partials)
G_ANY_CHANNELS = [(16, 24, 24, 11, 11, 5, 1, False), (16, 24, 24, 5, 30, 8, 2, False),
                  (16, 12, 12, 8, 48, 8, 1, True), (16, 12, 12, 8, 48, 11, 2, False),
                  (16, 6, 6, 11, 66, 11, 1, True), (16, 6, 6, 11, 66, 22, 2, False),
                  (16, 3, 3, 22, 132, 22, 1, True), (16, 3, 3, 22, 132, 33, 1, False),
                  (16, 3, 3, 33, 198, 33, 1, True), (16, 3, 3, 33, 198, 56, 2, False),
                  (16, 2, 2, 56, 336, 56, 1, True), (16, 2, 2, 56, 336, 112, 1, False),
                  (2, 30, 37, 11, 66, 11, 1, True), (3, 25, 25, 5, 30, 8, 2, False),
                  (1, 7, 7, 33, 198, 33, 1, True), (1, 3, 3, 22, 132, 33, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,cin,cexp,cout,stride,shortcut", G_ANY_CHANNELS)
def test_cuda_fused_irb_any_channels(cuda, dt, B, H, W, cin, cexp, cout, stride, shortcut):
    _check_fused_irb(cuda, dt, B, H, W, cin, cexp, cout, stride, shortcut)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_fused_irb_prepared_equals_folded(cuda, dt):
    """prepare_irb's weights and a shared split scratch give the kernel's
    output bit for bit as the FoldedIRB does."""
    x, fold = _g_case(cuda, 1, 7, 7, 160, 960, 320, dt, 11)
    want = TFI.fused_inverted_residual(x, fold, 1, False, round_expanded=True)
    scratch = TFI.SplitScratch()
    prep = TFI.prepare_irb(fold, dt, scratch)
    got = TFI.fused_inverted_residual(x, prep, 1, False, round_expanded=True)
    assert torch.equal(got, want) and scratch.buf is not None
    with pytest.raises(TypeError):  # prepared for another dtype
        TFI.fused_inverted_residual(x.float() if dt == torch.bfloat16 else x.bfloat16(), prep, 1,
                                    False)


@pytest.mark.cuda
def test_cuda_fused_irb_refuses_what_it_cannot_take(cuda):
    x, fold = _g_case(cuda, 1, 8, 8, 16, 32, 16, torch.float32, 0)
    with pytest.raises(ValueError, match="stride"):
        TFI.fused_inverted_residual(x, fold, 3, False)
    with pytest.raises(ValueError, match="residual"):
        TFI.fused_inverted_residual(x, fold, 2, True)
    with pytest.raises(TypeError):
        TFI.fused_inverted_residual(x.half(), fold, 1, True)
    with pytest.raises(ValueError, match="contiguous"):
        TFI.fused_inverted_residual(x.transpose(1, 2), fold, 1, True)
    n = TFI.fused_inverted_residual.launches
    TFI.fused_inverted_residual(x.cpu(), TFI.FoldedIRB(*(t.cpu() for t in fold)), 1, True)
    assert TFI.fused_inverted_residual.launches == n  # the plain version


# ---- the training workflow on the card: feeder, loop, evaluate ---------------


def _workflow_cfg(root, corpus_cfg, vocab):
    """A small LSTM (MobileNetV2 x0.35 at 64 px, H=128, E=64, B=8, bf16,
    kernel F on) over ``chip_smoke.trainer_corpus``'s corpus."""
    from myimagecaptioningmodel_tpu_torch.config import replace_nested

    cfg = corpus_cfg
    for path, value in (("model.decoder.vocab_size", vocab), ("model.decoder.hidden_dim", 128),
                        ("model.decoder.embedding_size", 64), ("model.encoder.encoder_scale", 0.35),
                        ("model.fuse_bn_stats", True), ("train.batch_size", 8),
                        ("train.max_epoch", 1), ("train.learning_rate", 1e-3),
                        ("train.checkpoint_path", str(root / "save")),
                        ("log.log_path", str(root / "log"))):
        cfg = replace_nested(cfg, path, value)
    return cfg


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from chip_smoke import trainer_corpus

    root = tmp_path_factory.mktemp("workflow")
    cfg, summary, _rows = trainer_corpus(str(root), 0, splits=(64, 8, 8), words=2046, size=64)
    return root, _workflow_cfg(root, cfg, summary["vocab_size"])


@pytest.mark.cuda
def test_cuda_feeder_pins_and_copies_ahead(cuda):
    from myimagecaptioningmodel_tpu_torch.data.feeder import PrefetchingFeeder

    rng = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 256, (12, 3, 16, 16), generator=rng, dtype=torch.uint8).numpy()
    caps = torch.randint(0, 50, (12, 7), generator=rng).numpy()

    def reader():
        for i in range(0, 12, 4):
            yield rows[i:i + 4], caps[i:i + 4]

    feeder = PrefetchingFeeder(reader, capacity=2, device=cuda, device_convert=True)
    host = feeder._host_item((rows[:4], caps[:4]))
    assert all(t.is_pinned() for t in host)
    got = list(feeder)
    assert len(got) == 3
    for i, (imgs, c) in enumerate(got):
        assert imgs.device.type == "cuda" and imgs.dtype == torch.uint8
        assert torch.equal(imgs.cpu(), torch.from_numpy(rows[4 * i:4 * i + 4]))
        assert torch.equal(c.cpu(), torch.from_numpy(caps[4 * i:4 * i + 4]))


@pytest.mark.cuda
def test_cuda_loop_dev_decode_runs_kernel_b(cuda, workflow):
    from myimagecaptioningmodel_tpu_torch.training import loop

    root, cfg = workflow
    for fn in (TFS.fused_decode_step, TVH.greedy_vocab_argmax, TMB.matmul_stats):
        fn.launches = 0
    result = loop.train(cfg, device=cuda, max_steps_per_epoch=2)
    torch.cuda.synchronize()
    T = cfg.model.decoder.infer_max_length
    assert result["final_step"] == 2
    assert TMB.matmul_stats.launches == 2 * 35  # the fused 1x1 convs of two steps
    # one dev batch of 8: one greedy decode through kernel B with head A
    assert TFS.fused_decode_step.launches == TVH.greedy_vocab_argmax.launches == T


@pytest.mark.cuda
def test_cuda_evaluate_beam_runs_kernel_c(cuda, workflow):
    from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import evaluate
    from myimagecaptioningmodel_tpu_torch.training import loop

    root, cfg = workflow
    if not (root / "save" / "infer").exists():
        loop.train(cfg, device=cuda, max_steps_per_epoch=2)
    for fn in (TFS.fused_decode_step, TVH.greedy_vocab_argmax, TVH.topk_vocab_head):
        fn.launches = 0
    res = evaluate(cfg, beam_size=3, device=cuda)
    torch.cuda.synchronize()
    T = cfg.model.decoder.infer_max_length
    assert res["captions"] == 8 and len(res["bleu"]) == 5
    assert TFS.fused_decode_step.launches == TVH.topk_vocab_head.launches == T
    assert TVH.greedy_vocab_argmax.launches == 0


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms (its default wgrad may add with
    atomics): a step must give the same bits twice for a bitwise
    comparison."""
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    yield
    cudnn.deterministic, cudnn.benchmark = was


@pytest.mark.cuda
def test_cuda_world1_nccl_step_equals_plain(cuda, workflow, deterministic):
    """One fused train step (kernel F) in a world-1 NCCL group: the same bits
    as without a group, with the reductions issued through the group."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import train_tree
    from myimagecaptioningmodel_tpu_torch.models import captioner
    from myimagecaptioningmodel_tpu_torch.parallel import distributed
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import (
        build_steps, make_optimizer, tree_leaves)
    from myimagecaptioningmodel_tpu_torch.training import lr_schedules

    _root, cfg = workflow
    opts = captioner.ModelOptions.from_config(cfg)
    gen = torch.Generator().manual_seed(1)
    images = torch.rand(8, 64, 64, 3, generator=gen)
    caps = torch.randint(4, 100, (8, cfg.model.decoder.sentence_length), generator=gen)
    caps[:, 0] = 2
    caps[4:, 5:] = 0  # rows of different lengths

    def step():
        schedule = lr_schedules.from_config(cfg)
        opt = make_optimizer(cfg, schedule)
        p, s = train_tree(*captioner.init(torch.Generator().manual_seed(0), opts), cuda,
                          torch.float32)
        p, _o, s, _, loss, _ = build_steps(opts, opt, schedule).train_step(
            p, opt.init(p), s, 0, images.to(cuda), caps.to(cuda))
        torch.cuda.synchronize()
        return loss, tree_leaves(p), tree_leaves(s)

    plain = step()
    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0, backend="nccl")
    try:
        calls = distributed.collective_calls()
        grouped = step()
        calls = distributed.collective_calls() - calls
    finally:
        distributed.shutdown()
    assert calls > 2  # the token count, the gradient bucket, BN's sums
    assert torch.equal(plain[0], grouped[0])
    for a, b in zip(plain[1] + plain[2], grouped[1] + grouped[2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_caption_arrays_equals_load_bundle(cuda, workflow):
    """Batch captioning's device half on the card: each record's ids are
    ``load_bundle``'s decode of the same rows, in the same padded batch."""
    import numpy as np

    from myimagecaptioningmodel_tpu_torch.data.reader import DataReader
    from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
    from myimagecaptioningmodel_tpu_torch.inference.batch_caption import caption_arrays
    from myimagecaptioningmodel_tpu_torch.training import loop

    root, cfg = workflow
    if not (root / "save" / "infer").exists():
        loop.train(cfg, device=cuda, max_steps_per_epoch=2)
    model, _bc, _opts, decode = load_bundle(cfg, device=cuda, early_stop=True)
    arrays = np.random.RandomState(0).rand(10, 3, 64, 64).astype(np.float32)
    records = caption_arrays(cfg, [(i, f"{i}.jpg", a) for i, a in enumerate(arrays)], model,
                             decode, DataReader(cfg).index_word, batch_size=4)
    assert [r["image"] for r in records] == [f"{i}.jpg" for i in range(10)]
    for lo in range(0, 10, 4):
        batch = np.zeros((4, 64, 64, 3), np.float32)
        rows = arrays[lo:lo + 4].transpose(0, 2, 3, 1)
        batch[:len(rows)] = rows
        want = decode(model, torch.from_numpy(batch).to(cuda)).cpu().numpy()[:len(rows)]
        np.testing.assert_array_equal([r["ids"] for r in records[lo:lo + 4]], want)


# ---- vocab tensor parallelism: kernel A's winning logit and vocab slices -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("B", [8, 128])
def test_cuda_vocab_argmax_winning_logit(cuda, dt, B):
    """``with_value``: the ids of the plain call and each row's winning
    logit, within 1e-4 of the plain logit of that id (sums in other
    orders)."""
    g = torch.Generator(device="cpu").manual_seed(B)
    V, E = 12416, 256
    proj = torch.randn(B, E, generator=g).to(cuda)
    table, scale = _table(g, V, E, dt, cuda)
    bias = torch.randn(V, generator=g).to(cuda)
    ids, val = TVH.greedy_vocab_argmax(proj, table, bias, scale, with_value=True)
    assert torch.equal(ids, TVH.greedy_vocab_argmax(proj, table, bias, scale))
    logits = TVH.head_logits_reference(proj, table, bias, scale)
    assert _near_tie_ok(ids, logits, dt)
    assert float((val - logits.gather(1, ids.long()[:, None])[:, 0]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [6208, 3104])  # a rank's rows at model_parallel 2 and 4
@pytest.mark.parametrize("B", [8, 128])
def test_cuda_vocab_argmax_slices_merge_to_the_full_vocab(cuda, rows, B):
    """A on each rank's slice of a 12,416-row bf16 table (ragged tiles at
    B=128), merged by value and then the lowest global index, equals A on
    the full vocab, ids and values bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(rows + B)
    V, E = 12416, 256
    proj = torch.randn(B, E, generator=g).to(cuda)
    table = (torch.randn(V, E, generator=g) / 16).to(cuda, torch.bfloat16)
    bias = torch.randn(V, generator=g).to(cuda)
    bias[12295:] = -1e9
    full_ids, full_val = TVH.greedy_vocab_argmax(proj, table, bias, with_value=True)
    vals, idx = [], []
    for lo in range(0, V, rows):
        i, v = TVH.greedy_vocab_argmax(proj, table[lo:lo + rows], bias[lo:lo + rows],
                                       with_value=True)
        vals.append(v)
        idx.append(i.long() + lo)
    vals, idx = torch.stack(vals), torch.stack(idx)
    best = vals.max(dim=0).values
    merged = torch.where(vals == best, idx, torch.full_like(idx, 1 << 40)).min(dim=0).values
    assert torch.equal(merged.to(torch.int32), full_ids) and torch.equal(best, full_val)


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [0, 3])
def test_cuda_exported_artifact_equals_plain_decode(cuda, tmp_path, beam):
    """``export_program`` on the card: the reloaded ``.pt2`` gives the plain
    decode's ids on the card, id for id (small dims, 6 steps)."""
    import numpy as np

    from myimagecaptioningmodel_tpu_torch.compat.from_jax import to_numpy
    from myimagecaptioningmodel_tpu_torch.config import Config, replace_nested
    from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
    from myimagecaptioningmodel_tpu_torch.inference import export_program as EP
    from myimagecaptioningmodel_tpu_torch.inference.beam import beam_decode
    from myimagecaptioningmodel_tpu_torch.models import captioner as C
    from myimagecaptioningmodel_tpu_torch.training import checkpoint as ckpt

    cfg = Config()
    for path, value in (("model.decoder.vocab_size", 64), ("model.decoder.embedding_size", 64),
                        ("model.decoder.hidden_dim", 128), ("model.encoder.encoder_scale", 0.35),
                        ("model.decoder.infer_max_length", 6), ("data.image_shape", (64, 64)),
                        ("train.checkpoint_path", str(tmp_path))):
        cfg = replace_nested(cfg, path, value)
    params, state = C.init(torch.Generator().manual_seed(0), C.ModelOptions.from_config(cfg))
    ckpt.export_inference_bundle(str(tmp_path / "infer"), to_numpy(params), to_numpy(state), cfg)
    EP.export_to_file(str(tmp_path / "x.pt2"), EP.export_decode(cfg, "infer", 4, beam, cuda))
    images = torch.from_numpy(np.random.RandomState(0).rand(4, 64, 64, 3).astype(np.float32))
    got = torch.export.load(str(tmp_path / "x.pt2")).module()(images.to(cuda))
    model, _b, opts, _d = load_bundle(cfg, beam_size=beam, device=cuda)
    opts = opts._replace(use_kernels=False)
    want = (beam_decode(model, images, opts, beam, stop_idx=opts.stop_idx)[0] if beam
            else C.greedy_decode(model, images, opts))
    assert torch.equal(got, want)


# kernel H's (T, B, k, H): ragged; k = 100 and 250 take the backward's 64- and
# 32-column blocks, k = 500 its shared sums past 48 KB; H = 300 and 1,030 give
# dw's reduce 2 and 5 blocks (the last one partial) before db's
H_CUDA_SHAPES = [(7, 3, 16, 200), (9, 2, 5, 64), (1, 1, 1, 1), (3, 2, 100, 40),
                 (2, 3, 250, 33), (2, 2, 500, 40), (5, 9, 12, 300), (4, 5, 49, 1030)]


@pytest.fixture
def exact_bf16_products(cuda):
    """cuBLAS's bf16 products with float32 sums, as the limits assume."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield cuda
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", H_CUDA_SHAPES)
def test_cuda_kernel_h_matches_plain(exact_bf16_products, dt, shape):
    from chip_smoke import h_checks, h_failures

    scores, _err = h_checks(TKH.attn_scores, TKH.attn_scores_bwd, exact_bf16_products, 0,
                            shapes=(shape,), dts=(dt,))  # asserts the rerun's bits
    assert not h_failures(scores)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_kernel_h_without_bias(exact_bf16_products, dt):
    from chip_smoke import h_operands, h_scores

    ik, he, w, _b, de = h_operands(torch.Generator().manual_seed(3), exact_bf16_products,
                                   7, 3, 16, 200, dt)
    before = (TKH.attn_scores.launches, TKH.attn_scores_bwd.launches)
    e = TKH.attn_scores(ik, he, w, None, dt)
    dw, db, dk, dh = TKH.attn_scores_bwd(ik, he, w, None, de, dt)
    torch.cuda.synchronize()
    assert db is None and dw.shape == w.shape and dw.dtype == w.dtype
    assert dk.dtype == ik.dtype and dh.dtype == he.dtype
    assert (TKH.attn_scores.launches, TKH.attn_scores_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    scores, _err = h_scores((e, dw, db, dk, dh), (ik, he, w, None, de), dt)
    assert set(scores) == {"e", "dw", "dimg_k", "dh_emb"} and max(scores.values()) <= 1.0
