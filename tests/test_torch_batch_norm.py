"""Train-mode BN's passes (``ops/kernels/batch_norm.py``, kernel I's entries,
which run their plain versions on the CPU) through ``layers._BNTrain`` and
``layers._BNTrainSubset`` against the JAX package's hand-written VJPs, on
the same numpy inputs (NHWC, B=6, 3x5 spatial, an offset and a spread per
channel, C in {1, 11, 96}):

- the exact BN against ``jax.vjp`` of ``layers._bn_train``; the subset BN
  (R = 1, 3, B-1) against ``layers._bn_train_subset``; ``act`` (the layer's
  ReLU6 inside the BN's passes) against ``relu6(_bn_train(...))``;
- y, mean, var, dscale, doffset and dx, in float32 to 2e-5 x each one's
  largest magnitude (the sums add in other orders: x's statistics and the
  backward's two sums move y and dx by a few float32 roundings of the
  largest term; measured at most 4.3e-6) and in float64 to 1e-10 x it
  (measured 5.5e-15);
- channels that are constant (0.5, exactly summed), whose BN output is
  their offset: with offsets 0 and 6 the ReLU6 sits on its ends, where the
  gradient must be 1/2, jnp.clip's (doffset is half of Σdy there);
- the entries raise on a device that is neither the CPU nor CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.ops import layers as JL
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from myimagecaptioningmodel_tpu_torch.ops.kernels import batch_norm as KBN

B, H, W = 6, 3, 5
NAMES = ("y", "mean", "var", "dscale", "doffset", "dx")
TOLS = {"float32": 2e-5, "float64": 1e-10}
NP = {"float32": np.float32, "float64": np.float64}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bn_inputs(C, dtype, constant=None):
    """x [B, H, W, C], scale, offset, dy; ``constant`` {channel: offset}
    makes those channels 0.5 everywhere with that offset."""
    rng = np.random.RandomState(C)
    x = rng.randn(B, H, W, C) * (rng.rand(C) * 3 + 0.1) + rng.randn(C)
    scale, offset = 1 + 0.3 * rng.randn(C), 0.2 * rng.randn(C)
    for c, off in (constant or {}).items():
        x[..., c], offset[c] = 0.5, off
    dy = rng.randn(B, H, W, C)
    return [a.astype(NP[dtype]) for a in (x, scale, offset, dy)]


def jax_bn(x, scale, offset, dy, rows=0, act=False):
    """(y, mean, var, dscale, doffset, dx) from the JAX package's VJP."""
    def f(s, o, xx):
        y, mean, var = (JL._bn_train_subset(s, o, xx, rows) if rows
                        else JL._bn_train(s, o, xx))
        return (JL.relu6(y) if act else y), mean, var

    with jax.enable_x64(x.dtype == np.float64):
        (y, mean, var), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (scale, offset, x)))
        zero = jnp.zeros(x.shape[-1], mean.dtype)
        ds, do, dx = vjp((jnp.asarray(dy), zero, zero))
        return [np.asarray(a) for a in (y, mean, var, ds, do, dx)]


def port_bn(x, scale, offset, dy, rows=0, act=False):
    ts, to, tx = (torch.tensor(a, requires_grad=True) for a in (scale, offset, x))
    if rows:
        y, mean, var = TL._BNTrainSubset.apply(ts, to, tx, rows, act)
    else:
        y, mean, var = TL._BNTrain.apply(ts, to, tx, act)
    grads = torch.autograd.grad(y, (ts, to, tx), torch.from_numpy(dy))
    return [t.detach().numpy() for t in (y, mean, var, *grads)]


def assert_matches(got, want, dtype):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype == NP[dtype], name
        err = np.abs(g.astype(np.float64) - w).max()
        assert err <= TOLS[dtype] * max(np.abs(w).max(), 1e-30), (name, float(err))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("C", [1, 11, 96])
@pytest.mark.parametrize("act", [False, True], ids=["bn", "bn_relu6"])
def test_exact_bn_and_vjp_match_jax(C, dtype, act):
    x, scale, offset, dy = bn_inputs(C, dtype)
    assert_matches(port_bn(x, scale, offset, dy, act=act),
                   jax_bn(x, scale, offset, dy, act=act), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rows", [1, 3, B - 1])
@pytest.mark.parametrize("act", [False, True], ids=["bn", "bn_relu6"])
def test_subset_bn_and_vjp_match_jax(rows, dtype, act):
    x, scale, offset, dy = bn_inputs(11, dtype)
    got = port_bn(x, scale, offset, dy, rows, act)
    assert_matches(got, jax_bn(x, scale, offset, dy, rows, act), dtype)
    np.testing.assert_allclose(got[1], x[:rows].mean(axis=(0, 1, 2)),
                               rtol=0, atol=10 * TOLS[dtype] * np.abs(x).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rows", [0, 2])
def test_relu6_ties_take_half_the_gradient(dtype, rows):
    """Channel 1 is constant with offset 0 (y == 0), channel 4 with offset 6
    (y == 6): their doffset is Σdy / 2 over the rows that feed it, as JAX's."""
    x, scale, offset, dy = bn_inputs(11, dtype, {1: 0.0, 4: 6.0})
    got = port_bn(x, scale, offset, dy, rows, act=True)
    want = jax_bn(x, scale, offset, dy, rows, act=True)
    assert_matches(got, want, dtype)
    y, doffset = got[0], got[4]
    ratio = B / rows if rows else 1.0
    for c, end in ((1, 0.0), (4, 6.0)):
        assert (y[..., c] == end).all()
        half = 0.5 * dy[: rows or B, ..., c].astype(np.float64).sum() * ratio
        assert doffset[c] == pytest.approx(half, rel=TOLS[dtype], abs=TOLS[dtype])
        assert want[4][c] == pytest.approx(half, rel=TOLS[dtype], abs=TOLS[dtype])
    slope = KBN.relu6_slope(torch.tensor([-1.0, 0.0, -0.0, 3.0, 6.0, 6.5]), torch.float32)
    assert slope.tolist() == [0.0, 0.5, 0.5, 1.0, 0.5, 0.0]


def test_entries_take_no_other_device():
    x = torch.empty(8, 3, device="meta")
    v = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        KBN.bn_stats(x, 8)
    with pytest.raises(ValueError, match="no kernel"):
        KBN.bn_apply(x, v, v, 8, v, v, True)
    with pytest.raises(ValueError, match="no kernel"):
        KBN.bn_grad_sums(x, x, v, v, v, v, 8, False)
    with pytest.raises(ValueError, match="no kernel"):
        KBN.bn_dx(x, x, v, v, v, v, v, v, 8, False, True)


@pytest.mark.parametrize("every_dtype", [False, True], ids=["float64", "every_dtype"])
def test_smoke_reference_steps_take_the_plain_versions(every_dtype):
    """``chip_smoke.plain_in_float64`` sends float64 operands (with
    ``i_every_dtype`` every operand) to the plain versions and the rest to
    the entries, and puts the entries back: on the meta device an entry
    raises and a plain version runs."""
    import chip_smoke as S

    x64 = torch.empty(8, 3, dtype=torch.float64, device="meta")
    x32 = torch.empty(8, 3, device="meta")
    with S.plain_in_float64(i_every_dtype=every_dtype):
        assert KBN.bn_stats(x64, 8)[0].shape == (3,)
        if every_dtype:
            assert KBN.bn_stats(x32, 8)[0].shape == (3,)
        else:
            with pytest.raises(ValueError, match="no kernel"):
                KBN.bn_stats(x32, 8)
    assert [getattr(KBN, fn.__name__) for fn in KBN.ENTRIES] == list(KBN.ENTRIES)
    with pytest.raises(ValueError, match="no kernel"):
        KBN.bn_stats(x64, 8)


def test_smoke_relu_kink_drops_the_units_a_rounding_flipped():
    """``chip_smoke.relu_kink``: a pre-activation that the float32 step puts
    on the other side of zero takes its unit out of the comparison, and is
    read in units of the float32 error's RMS."""
    import chip_smoke as S

    rng = np.random.RandomState(0)
    ref = torch.as_tensor(rng.randn(32, 64))
    ref[5, 9] = 1e-7
    pre = ref + 1e-6 * torch.as_tensor(rng.randn(32, 64))
    pre[5, 9] = -1e-7
    keep, read = S.relu_kink(pre, ref)
    assert (~keep).nonzero().flatten().tolist() == [9]
    assert read["relu_flips"] == 1 and read["flip_err_in_rms"] < 1.0
    assert read["flip_pre_in_std"] == [pytest.approx(1e-7 / float(ref.std()))]
    keep, read = S.relu_kink(ref.clone(), ref)
    assert bool(keep.all()) and read["relu_flips"] == 0 and read["flip_err_in_rms"] == 0.0
