"""The port's ``PrefetchingFeeder`` and native batch converter against the
JAX package's, on the CPU: the same batches (JAX with ``device_put`` off,
the port with no device, and as CPU tensors), ``drop_remainder``, a worker
error reaching the consumer, no live thread after a mid-epoch close, the
native converter equal to its numpy version, and a failed build raising.
"""

import threading

import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import native as jnative
from myimagecaptioningmodel_tpu.data.feeder import PrefetchingFeeder as JFeeder
from myimagecaptioningmodel_tpu_torch import native as tnative
from myimagecaptioningmodel_tpu_torch.data.feeder import PrefetchingFeeder as TFeeder

NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def sample_reader(dtype, n=11, batch=4, stacked=False, fail_at=None):
    """Batches of (row [3,6,5], caption [7]) samples; the last one partial."""
    rng = np.random.RandomState(3)
    if dtype == "uint8":
        rows = rng.randint(0, 256, (n, 3, 6, 5)).astype(np.uint8)
    else:
        rows = rng.randn(n, 3, 6, 5).astype(dtype)
    caps = rng.randint(0, 50, (n, 7)).astype(np.int64)

    def gen():
        for i in range(0, n, batch):
            if fail_at is not None and i >= fail_at:
                raise ValueError("reader broke")
            if stacked:
                yield rows[i:i + batch], caps[i:i + batch]
            else:
                yield [(rows[j], caps[j]) for j in range(i, min(n, i + batch))]

    return gen


def feeder_threads():
    return [t for t in threading.enumerate() if t.name == "feeder" and t.is_alive()]


@pytest.mark.parametrize("dtype", ["uint8", "float16", "float32"])
@pytest.mark.parametrize("device_convert", [False, True])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("stacked", [False, True])
def test_batches_match_the_jax_feeder(dtype, device_convert, drop, stacked):
    kw = dict(capacity=2, drop_remainder=drop, image_norm=NORM, device_convert=device_convert)
    want = list(JFeeder(sample_reader(dtype, stacked=stacked), device_put=False, **kw))
    got = list(TFeeder(sample_reader(dtype, stacked=stacked), **kw))
    on_cpu = list(TFeeder(sample_reader(dtype, stacked=stacked), device=torch.device("cpu"),
                          **kw))
    assert len(got) == len(want) == len(on_cpu) == (2 if drop else 3)
    for (gi, gc), (wi, wc), (ci, cc) in zip(got, want, on_cpu):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)
        assert isinstance(ci, torch.Tensor) and ci.device.type == "cpu"
        np.testing.assert_array_equal(ci.numpy(), wi)
        np.testing.assert_array_equal(cc.numpy(), wc)
    assert not feeder_threads()


def test_worker_error_reaches_the_consumer():
    feeder = TFeeder(sample_reader("float32", fail_at=8), capacity=2)
    seen = []
    with pytest.raises(ValueError, match="reader broke"):
        for batch in feeder:
            seen.append(batch)
    assert len(seen) == 1  # the second batch is held back one step, then the error
    assert not feeder_threads()


def test_close_mid_epoch_leaves_no_thread():
    rows = sample_reader("float32", n=400, batch=4)
    feeder = TFeeder(rows, capacity=2)
    it = iter(feeder)
    next(it)
    assert feeder_threads()
    feeder.close()
    assert not feeder_threads()
    # a consumer that breaks out: the generator's own finally stops the worker
    for _batch in TFeeder(rows, capacity=2):
        break
    assert not feeder_threads()
    assert TFeeder(rows).wait_seconds == 0.0


@pytest.mark.parametrize("dtype", ["float16", "float32", "uint8"])
def test_native_converter_equals_numpy(dtype):
    rng = np.random.RandomState(0)
    shape = (5, 3, 17, 13)
    if dtype == "uint8":
        batch = rng.randint(0, 256, shape).astype(np.uint8)
        got = tnative.convert_u8chw_to_f32nhwc(batch, *NORM, nthreads=3)
        plain = tnative.convert_u8chw_to_f32nhwc_plain(batch, *NORM)
        jax_native = jnative.convert_u8chw_to_f32nhwc(batch, *NORM, nthreads=3)
        # the table folds /255, -mean and /std into one multiply-add: within
        # float32 rounding of the three-step numpy version
        np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    else:
        batch = rng.randn(*shape).astype(dtype)
        got = tnative.convert_chw_to_nhwc_f32(batch, nthreads=3)
        plain = tnative.convert_chw_to_nhwc_f32_plain(batch)
        jax_native = jnative.convert_chw_to_nhwc_f32(batch, nthreads=3)
        np.testing.assert_array_equal(got, plain)
    assert got.dtype == np.float32 and got.shape == (5, 17, 13, 3)
    np.testing.assert_array_equal(got, jax_native)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ["-DFORCE_A_NEW_NAME",
                                                                   "--no-such-flag"])
    batch = np.zeros((1, 3, 2, 2), np.float32)
    with pytest.raises(RuntimeError, match="building the native converter failed"):
        tnative.convert_chw_to_nhwc_f32(batch)
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="building the native converter failed"):
        tnative.get_lib()
    # the feeder's host conversion surfaces it to the consumer
    with pytest.raises(RuntimeError, match="native converter"):
        list(TFeeder(sample_reader("float32"), capacity=2))
    assert not feeder_threads()
