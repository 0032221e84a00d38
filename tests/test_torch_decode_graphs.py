"""Kernels D and E's CUDA-graph cache and the plain version of their bf16
product (``ops/kernels/fused_transformer.py``), on the CPU.

The wrappers capture a decode's C call once per ``decode_key`` and replay
it. The capture and the replay need a card; here they are stubbed, and the
tests hold the Python logic around them:

- ``decode_key`` differs in every int the C call takes and in every packed
  weight's address (a clone of one weight gives another key), and not in the
  batch's memory, which each replay copies in;
- ``DecodeGraphs.run`` captures a key once, copies each new batch of the
  same shape into the graph's own input tensors before every replay, and
  hands the outputs of that batch back; it keeps at most ``max_graphs``
  graphs and ``max_bytes`` of their tensors, dropping the least recently
  used first (a single larger graph is kept alone);
- ``_reset`` writes a decode's start state (greedy and beam);
- ``stream_product_reference`` in every epilogue mode against the model's
  own ``layers.dense`` in bfloat16 (to one bf16 ulp: the two take their
  float32 sums in other orders), and ``stream_product`` taking it for CPU
  tensors.

Dims: V=2050, E=128, D=256, 2 layers, 2 heads, MLP ratio 2, M=6, T=5.
"""

import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu_torch.compat.from_jax import tree_to_torch
from myimagecaptioningmodel_tpu_torch.models import transformer as TTF
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from myimagecaptioningmodel_tpu_torch.ops.kernels import fused_transformer as FT

DIMS = TTF.TransformerDims(vocab_size=2050, embedding_size=128, model_dim=256, num_layers=2,
                           num_heads=2, mlp_ratio=2, max_positions=6, vocab_pad_multiple=2)
INTS = ["dtype", "layers", "dim", "ffn", "slots", "images", "beam", "vocab", "emb", "steps",
        "heads", "start", "pad", "stop", "early", "w_int8", "mem_int8"]  # csrc TfArg order
BF = torch.bfloat16


def _params(seed=0, quantize=False):
    gen = torch.Generator().manual_seed(seed)
    params = tree_to_torch(TTF.init(gen, DIMS), "cpu")
    return TTF.quantize_transformer_decoder(params) if quantize else params


def _pre(params, seed, n_img=3):
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.rand(n_img, 5, 256).astype(np.float32))
    gf = torch.from_numpy(rng.rand(n_img, 256).astype(np.float32))
    return TTF.precompute(params, img, gf, 2, BF)


def _ints(ftp):
    L, D, F_, M, n_img, V, E = ftp.dims
    return [1, L, D, F_, M, n_img, 0, V, E, 5, 2, 2, 0, 3, 1, int(ftp.int8_stream), 0]


@pytest.fixture(scope="module")
def packed():
    params = _params()
    return params, FT.pack_weights(params, BF)


@pytest.mark.parametrize("field", range(len(INTS)), ids=INTS)
def test_decode_key_differs_in_every_int(packed, field):
    params, pk = packed
    ftp = FT.prepare(params, _pre(params, 1), 2, BF, packed=pk)
    ints = _ints(ftp)
    changed = list(ints)
    changed[field] += 1
    assert FT.decode_key("e", ftp, ints) != FT.decode_key("e", ftp, changed)
    assert FT.decode_key("e", ftp, ints) == FT.decode_key("e", ftp, list(ints))
    assert FT.decode_key("a", ftp, ints) != FT.decode_key("b", ftp, ints)


WEIGHTS = [f for f in FT._PTR_FIELDS if f not in FT._INPUT_FIELDS]


@pytest.mark.parametrize("field", WEIGHTS)
def test_decode_key_differs_with_each_weight(field):
    quantize = field.startswith("s_")  # the int8 streams' scales
    params = _params(quantize=quantize)
    ftp = FT.prepare(params, _pre(params, 2), 2, BF)
    other = ftp._replace(**{field: getattr(ftp, field).clone()})
    assert FT.decode_key("e", ftp, _ints(ftp)) != FT.decode_key("e", other, _ints(other))


def test_decode_key_ignores_the_batch_memory(packed):
    params, pk = packed
    a = FT.prepare(params, _pre(params, 3), 2, BF, packed=pk)
    b = FT.prepare(params, _pre(params, 4), 2, BF, packed=pk)
    assert not torch.equal(a.mem_kv, b.mem_kv)
    assert FT.decode_key("e", a, _ints(a)) == FT.decode_key("e", b, _ints(b))


class _Stubbed(FT.DecodeGraphs):
    """Capture runs the decode function once (as the card's capture records
    its kernels) and keeps it; replay runs it again on the graph's own
    tensors, as the card's graph would."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.replayed = 0

    def capture(self, record, device):
        return record, record()

    def replay(self, graph):
        self.replayed += 1
        graph()


def _decode(work):  # a stand-in decode: reads the graph's input copy
    work["out"].copy_(work["mem_kv"].sum(dim=-1))


def _make(shape=(2, 3, 4)):
    return lambda: {"mem_kv": torch.zeros(shape), "mem_scale": None, "out": torch.zeros(shape[:-1])}


def test_graphs_capture_once_and_copy_each_batch():
    g = _Stubbed()
    outs = []
    for seed in (0, 1, 2):
        mem = torch.from_numpy(np.random.RandomState(seed).rand(2, 3, 4).astype(np.float32))
        out, entry, captured = g.run("k", _make(), _decode, {"mem_kv": mem, "mem_scale": None},
                                     lambda w: w["out"].clone(), "cpu")
        assert captured == (seed == 0)
        assert torch.equal(entry.work["mem_kv"], mem) and entry.work["mem_kv"] is not mem
        assert torch.equal(out, mem.sum(dim=-1))
        outs.append(out)
    assert g.captures == 1 and g.replays == 3 and g.replayed == 3
    assert not torch.equal(outs[0], outs[1])


def test_graphs_keep_the_captured_launch_count():
    g = _Stubbed()
    for i in range(3):
        _out, entry, captured = g.run("k", _make(), lambda w: 37, {}, lambda w: None, "cpu")
        assert captured == (i == 0)
    assert g.captures == 1 and entry.kernel_launches == 37 and entry.capture_ms >= 0


def _run_key(g, key, n):
    return g.run(key, lambda: {"mem_kv": torch.zeros(n)}, lambda w: 0, {}, lambda w: None,
                 "cpu")


def test_graphs_bound_count_and_bytes():
    g = _Stubbed(max_graphs=3, max_bytes=10 * 4 * 100)
    for i in range(12):
        _run_key(g, i, 100 * (1 + i % 4))  # 400-1600 bytes each
        assert len(g.entries) <= 3
        assert g.nbytes <= g.max_bytes
    assert g.captures == 12


def test_graphs_drop_least_recently_used():
    g = _Stubbed(max_graphs=2, max_bytes=1 << 20)
    _run_key(g, "a", 10)
    _run_key(g, "b", 10)
    _run_key(g, "a", 10)  # a replayed: b is now the oldest
    _run_key(g, "c", 10)
    assert list(g.entries) == ["a", "c"] and g.captures == 3


def test_graphs_keep_one_larger_than_the_bound():
    g = _Stubbed(max_graphs=4, max_bytes=100)
    _run_key(g, "small", 5)
    _run_key(g, "big", 1000)
    assert list(g.entries) == ["big"]
    _run_key(g, "small", 5)
    assert list(g.entries) == ["small"]


@pytest.mark.parametrize("beam", [False, True])
def test_reset_writes_the_start_state(beam):
    T, rows, n_img = 5, 6, 3
    work = {"word": torch.full((rows,), 9, dtype=torch.int32),
            "words_tm": torch.full((T, rows), 9, dtype=torch.int32),
            "done": torch.ones(rows, dtype=torch.int32), "flag": torch.ones(1, dtype=torch.int32)}
    if beam:
        r = torch.arange(rows)
        work.update(scores=torch.full((rows,), 5.0), scores0=torch.where(r < n_img, 0.0, -1e9),
                    srcs_tm=torch.full((T, rows), 9, dtype=torch.int32),
                    srcs0=(r // n_img).int().expand(T, rows).contiguous(),
                    lens=torch.ones(rows, dtype=torch.int32))
    FT._reset(work, 2, 0)
    assert (work["word"] == 2).all() and (work["words_tm"] == 0).all()
    assert not work["done"].any() and not work["flag"].any()
    if beam:
        assert torch.equal(work["scores"], work["scores0"]) and not work["lens"].any()
        assert torch.equal(work["srcs_tm"], work["srcs0"])


# ---- the plain version of the bf16 product ---------------------------------------


def _operands(seed, M, K, N, int8):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g)
    w = torch.randn(K, N, generator=g) / K ** 0.5
    bias = 0.1 * torch.randn(N, generator=g)
    p = {"w": w.to(BF), "b": bias}
    if int8:
        scale = w.abs().amax(dim=0) / 127
        p = {"w_q": torch.round(w / scale).to(torch.int8), "scale": scale, "b": bias}
    return a, p


def _ulp_close(got, want):
    got, want = got.float(), want.float()
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode", ["store", "store_f32", "gelu", "residual", "embed", "qkv"])
def test_stream_product_reference_matches_dense(mode, int8):
    M, K = 7, 128
    N = 192 if mode == "qkv" else 64
    a, p = _operands(0, M, K, N, int8)
    w = p["w_q"] if int8 else p["w"]
    y = TL.dense(p, a.to(BF), BF).float()
    kw = dict(w_scale=p.get("scale"))
    x0 = torch.randn(M, N)
    if mode == "residual":
        got = FT.stream_product(a.to(BF), w, p["b"], mode, out=x0.clone(), **kw)
        _ulp_close(got - x0, y)
        return
    if mode == "qkv":
        D = N // 3
        q, kc, vc = torch.zeros(M, D, dtype=BF), torch.zeros(M, 5, D, dtype=BF), torch.zeros(
            M, 5, D, dtype=BF)
        FT.stream_product(a.to(BF), w, p["b"], mode, out=q, kc=kc, vc=vc, t=3, **kw)
        _ulp_close(q, y[:, :D])
        _ulp_close(kc[:, 3], y[:, D:2 * D])
        _ulp_close(vc[:, 3], y[:, 2 * D:])
        assert not kc[:, :3].any() and not vc[:, 4].any()
        return
    pos = torch.randn(N) if mode == "embed" else None
    got = FT.stream_product(a.to(BF), w, p["b"], mode, pos=pos, **kw)
    assert got.dtype == (torch.float32 if mode in ("store_f32", "embed") else BF)
    want = {"store": y, "store_f32": y, "embed": y + (0 if pos is None else pos),
            "gelu": torch.nn.functional.gelu(y, approximate="tanh")}[mode]
    _ulp_close(got, want)


def test_stream_product_reference_layernorm_and_gather():
    M, K, N = 5, 128, 64
    a, p = _operands(1, M, K, N, False)
    g = torch.Generator().manual_seed(2)
    ln_g, ln_b = 1 + 0.1 * torch.randn(K, generator=g), 0.1 * torch.randn(K, generator=g)
    got = FT.stream_product(a, p["w"], p["b"], "store", a_mode="layernorm", ln_g=ln_g, ln_b=ln_b)
    h = TTF._layer_norm({"g": ln_g, "b": ln_b}, a)
    _ulp_close(got, TL.dense(p, h.to(BF), BF))
    table = torch.randn(40, K, generator=g).to(BF)
    word = torch.tensor([3, 0, 39, 3, 7], dtype=torch.int32)
    got = FT.stream_product(table, p["w"], p["b"], "store", a_mode="gather", word=word, pad=0)
    emb = TL.embed({"table": table}, word.long(), 0)
    _ulp_close(got, TL.dense(p, emb, BF))
    assert FT.stream_product.launches == 0  # CPU tensors launch nothing
