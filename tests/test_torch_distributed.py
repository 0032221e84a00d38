"""The port's data parallelism (``parallel/distributed.py``, ``parallel/mesh.py``,
the global-batch BN of ``ops/layers.py`` and ``ops/kernels/matmul_bn.py``,
the data-parallel train step) against the JAX package, on the CPU.

Two processes (``distributed.spawn_local``: a gloo group on localhost, one
torch thread each) run everything a rank runs, once, in one module fixture;
the parent holds each rank's results against the JAX package's
single-process results on the global batch, made from the same numpy
inputs (float64, JAX under x64):

- the helpers: ``process_slice_batches`` equals JAX's, ``host_local_slice``
  JAX's arithmetic (``jax.process_count`` / ``process_index`` patched), and
  each rank's ``local_rows`` / ``shard_batch`` and reductions;
- train-mode BN over 2 ranks x 3 rows, against JAX's ``_bn_train`` (through
  ``batch_norm``), ``_bn_train_subset`` at R=2 (rank 0's rows only) and R=4
  (across the rank boundary) and ``conv1x1_bn_train`` (the port's kernel F
  plain version, its sums all-reduced) on the 6 rows: y and dx row for row,
  dscale, doffset and dw summed over the ranks (as the gradient bucket sums
  them), the moving statistics on each rank, all to 1e-10 of each output's
  largest magnitude (the sums add in another order); BN per rank, without
  the reduction, misses by far more;
- one data-parallel train step (8 captions, 4 a rank, ``grad_accum_steps=2``,
  clip, EMA; rank 0's captions shorter than rank 1's, so the ranks hold
  different token counts) against JAX's ``train_step`` on the global batch,
  to ``test_torch_train_step``'s tolerances; both ranks end bit-equal; the
  step issues one all-reduce for the token count, one gradient bucket and
  one per BN forward and backward. With the planted fault of a mean of
  per-rank means (each rank divides by its own token count times the
  world), the loss misses JAX's by over 1e-3 relative.

``spawn_local`` itself fails at once, not at its timeout, when a rank dies
before it reports, and its ranks take the parent's TF32 switches.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu.data import reader as jreader
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu.ops import layers as JL
from myimagecaptioningmodel_tpu.ops.pallas import matmul_bn as JMB
from myimagecaptioningmodel_tpu.parallel import distributed as jdist
from myimagecaptioningmodel_tpu.parallel import train_step as jts
from myimagecaptioningmodel_tpu.training import lr_schedules as jlr
from myimagecaptioningmodel_tpu_torch.compat.from_jax import reference_tree, train_tree
from myimagecaptioningmodel_tpu_torch.data import reader as treader
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from myimagecaptioningmodel_tpu_torch.ops import layers as TL
from myimagecaptioningmodel_tpu_torch.ops.kernels import matmul_bn as TMB
from myimagecaptioningmodel_tpu_torch.parallel import distributed as tdist
from myimagecaptioningmodel_tpu_torch.parallel import mesh as tmesh
from myimagecaptioningmodel_tpu_torch.parallel import train_step as tts
from myimagecaptioningmodel_tpu_torch.training import lr_schedules as tlr
from test_torch_train import f64_zero_state, flat, jax_tree, tiny_batch, tiny_cfg
from test_torch_train_step import LR, STEP_OPTIONS, _adam_state, _as_tree, _Float64Zeros

WORLD, ROWS = 2, 3  # BN: 2 ranks x 3 rows
BN_TOL = 1e-10
BN_CASES = {"exact": 0, "subset_r2": 2, "subset_r4": 4, "conv1x1_f": None}
GLOBAL, ACCUM = 8, 2  # the train step's global batch and microbatches


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bn_inputs():
    rng = np.random.RandomState(7)
    C, Cin = 8, 5
    return {
        "x": rng.randn(WORLD * ROWS, 4, 4, C) * 2.0 + 0.5,
        "xc": rng.randn(WORLD * ROWS, 4, 4, Cin),
        "w": rng.randn(1, 1, Cin, C) / np.sqrt(Cin),  # HWIO
        "scale": rng.rand(C) + 0.5, "offset": rng.randn(C),
        "dy": rng.randn(WORLD * ROWS, 4, 4, C),
        "mean": rng.randn(C), "var": rng.rand(C) + 0.5,
    }


def step_batch():
    """8 captions: rank 0's rows (``process_slice_batches`` with 2-row
    chunks: rows 0, 1, 4, 5) end early, rank 1's run long."""
    a, ca = tiny_batch(np.float64, seed=0)
    b, cb = tiny_batch(np.float64, seed=1)
    images, caps = np.concatenate([a, b]), np.concatenate([ca, cb])
    T = caps.shape[1]
    rng = np.random.RandomState(5)
    for r in range(GLOBAL):
        n = 2 if r in (0, 1, 4, 5) else T - 1  # <stop> at n
        caps[r, 1:] = 0
        caps[r, 1:n] = rng.randint(4, 64, n - 1)
        caps[r, n] = 3
    return images, caps


def rank_rows(rank):
    return treader.process_slice_batches(list(range(GLOBAL)), GLOBAL // WORLD // ACCUM,
                                         rank, WORLD)


# ---- what each rank runs ------------------------------------------------------


def _bn_rank(rank, d):
    rows = slice(rank * ROWS, (rank + 1) * ROWS)
    out = {}
    for name, R in BN_CASES.items():
        sc = torch.tensor(d["scale"], requires_grad=True)
        of = torch.tensor(d["offset"], requires_grad=True)
        s = {"mean": torch.tensor(d["mean"]), "var": torch.tensor(d["var"])}
        dy = torch.tensor(d["dy"][rows])
        if R is None:
            x = torch.tensor(d["xc"][rows], requires_grad=True)
            w = torch.tensor(np.transpose(d["w"], (3, 2, 0, 1)), requires_grad=True)
            y, mean, var = TMB.conv1x1_bn_train(w, {"scale": sc, "offset": of}, x,
                                                torch.float64)
            new = TL.moving_update(s, mean, var)
            dw, ds, do, dx = torch.autograd.grad(y, (w, sc, of, x), dy)
            extra = {"dw": dw.permute(2, 3, 1, 0).numpy()}
        else:
            x = torch.tensor(d["x"][rows], requires_grad=True)
            y, new = TL.batch_norm_train({"scale": sc, "offset": of}, s, x, R)
            ds, do, dx = torch.autograd.grad(y, (sc, of, x), dy)
            extra = {}
        out[name] = {"y": y.detach().numpy(), "dx": dx.numpy(), "dscale": ds.numpy(),
                     "doffset": do.numpy(), "mean": new["mean"].numpy(),
                     "var": new["var"].numpy(), **extra}
    return out


def _step_rank(rank, fault=False):
    """One data-parallel step on this rank's rows -> flat trees and counts."""
    cfg = tiny_cfg("float64", False, **STEP_OPTIONS)
    params, state = jax_tree(cfg, np.float64)
    images, caps = step_batch()
    idx = rank_rows(rank)
    schedule = tlr.from_config(cfg)
    optimizer = tts.make_optimizer(cfg, schedule)
    tp, ts = train_tree(params, state, device="cpu", dtype=torch.float64)
    steps = tts.build_steps(tcap.ModelOptions.from_config(cfg), optimizer, schedule, ACCUM)
    calls = tdist.collective_calls()
    reduce = tdist.dist.all_reduce
    if fault:  # the token count: this rank's times the world, a mean of means
        tdist.dist.all_reduce = lambda t, *a, **k: t.mul_(WORLD) if t.ndim == 0 else reduce(t)
    try:
        tp, to, tstate, _, loss, _ = steps.train_step(
            tp, optimizer.init(tp), ts, 0, torch.as_tensor(images[idx]),
            torch.as_tensor(caps[idx]))
    finally:
        tdist.dist.all_reduce = reduce
    calls = tdist.collective_calls() - calls
    p, s = (flat(t) for t in reference_tree(tp, tstate))
    mu, nu = (flat(reference_tree(_as_tree(tp, m), {})[0]) for m in to.adam[1:])
    ema = flat(reference_tree(tts.ema_params_from_opt_state(to), {})[0])
    return {"loss": float(loss), "params": p, "state": s, "mu": mu, "nu": nu, "ema": ema,
            "calls": calls}


def rank_worker(rank, d):
    """Everything a rank of the module's group runs."""
    mesh = tmesh.make_mesh(device="cpu")
    batch = np.arange(12).reshape(6, 2)
    out = {
        "mesh": (mesh.size, mesh.rank, mesh.shape),
        "local_rows": tdist.local_rows(batch),
        "shard_batch": tmesh.shard_batch(mesh, batch).numpy(),
        "host_local_slice": [tdist.host_local_slice(t) for t in (0, 1, 7, 8)],
        "sum": tdist.sum_across_processes([rank + 0.5, 2.0 * rank]),
        "distinct": tdist.global_distinct_count({"a b", f"only {rank}"}),
        "gather": tdist.all_gather_rows(torch.tensor([[rank, rank + 10]])).numpy(),
        "put_tree": tdist.put_tree({"a": [torch.full((3,), float(rank))]})["a"][0].numpy(),
        "bn": _bn_rank(rank, d),
        "step": _step_rank(rank),
        "step_fault": _step_rank(rank, fault=True),
        "tf32": (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32),
    }
    return out


# the parent's TF32 switches while it spawns the ranks: both the other way
# round from PyTorch's defaults, which a fresh process starts from
PARENT_TF32 = (True, False)


@pytest.fixture(scope="module")
def ranks():
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = PARENT_TF32
    try:
        return tdist.spawn_local(rank_worker, WORLD, args=(bn_inputs(),), threads=1,
                                 timeout=300)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


# ---- the helpers ------------------------------------------------------------------


@pytest.mark.parametrize("n,lb,count", [(20, 2, 2), (23, 3, 2), (17, 1, 4), (5, 3, 2)])
def test_process_slice_batches_equals_jax(n, lb, count):
    items = list(range(n))
    for i in range(count):
        assert treader.process_slice_batches(items, lb, i, count) == \
            jreader.process_slice_batches(items, lb, i, count)


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_host_local_slice_equals_jax(monkeypatch, count):
    for i in range(count):
        monkeypatch.setattr(jax, "process_count", lambda: count)
        monkeypatch.setattr(jax, "process_index", lambda: i)
        monkeypatch.setattr(tdist, "process_count", lambda: count)
        monkeypatch.setattr(tdist, "process_index", lambda: i)
        for total in (0, 1, 7, 8, 130):
            assert tdist.host_local_slice(total) == jdist.host_local_slice(total)


def test_one_process_helpers_are_identities():
    assert not tdist.active() and tdist.process_count() == 1 and tdist.is_main_process()
    t = torch.arange(4.0)
    assert tdist.all_reduce_sum_(t) is t and tdist.all_gather_rows(t) is t
    assert tdist.sum_across_processes([1.5]).tolist() == [1.5]
    assert tdist.global_distinct_count({"a", "b"}) == 2
    # a model_parallel that does not divide the one process (JAX's
    # test_model_parallel_validation)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_mesh(device="cpu", model_parallel=2)


def test_loop_refuses_vocab_tensor_parallelism(tmp_path):
    """``train.model_parallel`` that does not divide the process count stops
    the loop before it reads data, as its mesh is made (JAX's
    ``test_model_parallel_validation``)."""
    from myimagecaptioningmodel_tpu_torch.config import Config, replace_nested
    from myimagecaptioningmodel_tpu_torch.training import loop as tloop

    cfg = replace_nested(Config(), "train.model_parallel", 2)
    cfg = replace_nested(cfg, "data.dict_path", str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="does not divide"):
        tloop.train(cfg, device="cpu")


def test_rank_helpers(ranks):
    batch = np.arange(12).reshape(6, 2)
    for r, out in enumerate(ranks):
        assert out["mesh"] == (2, r, {"data": 2, "model": 1})
        np.testing.assert_array_equal(out["local_rows"], batch[3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["shard_batch"], batch[3 * r:3 * r + 3])
        assert out["host_local_slice"] == [(0, 0), (0, 1) if r == 0 else (1, 0),
                                           (4 * r, 4 - r), (4 * r, 4)]
        assert out["sum"].tolist() == [2.0, 2.0]
        assert out["distinct"] == 3  # "a b" on both ranks, counted once
        np.testing.assert_array_equal(out["gather"], [[0, 10], [1, 11]])
        np.testing.assert_array_equal(out["put_tree"], [0.0] * 3)  # rank 0's values


def test_ranks_take_the_parent_s_tf32_switches(ranks):
    assert [out["tf32"] for out in ranks] == [PARENT_TF32] * WORLD


def _dies_on_rank_1(rank):
    if rank == 1:
        os._exit(3)
    return rank


def test_spawn_local_fails_fast_when_a_rank_dies():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died before reporting"):
        tdist.spawn_local(_dies_on_rank_1, WORLD, threads=1, timeout=300)
    assert time.monotonic() - t0 < 120


# ---- global-batch BN --------------------------------------------------------------


def jax_bn(name, d):
    R = BN_CASES[name]
    with jax.enable_x64(True):
        s = {k: jnp.asarray(d[k]) for k in ("mean", "var")}
        if R is None:
            def jf(w_, sc, of, x_):
                yn, m, v = JMB.conv1x1_bn_train({"w": w_}, {"scale": sc, "offset": of}, x_,
                                                jnp.float64)
                return yn, {"mean": JL.BN_MOMENTUM * s["mean"] + (1 - JL.BN_MOMENTUM) * m,
                            "var": JL.BN_MOMENTUM * s["var"] + (1 - JL.BN_MOMENTUM) * v}

            args = (d["w"], d["scale"], d["offset"], d["xc"])
            names = ("dw", "dscale", "doffset", "dx")
        else:
            def jf(sc, of, x_):
                return JL.batch_norm({"scale": sc, "offset": of}, s, x_, True, R)

            args = (d["scale"], d["offset"], d["x"])
            names = ("dscale", "doffset", "dx")
        y, vjp, new = jax.vjp(jf, *(jnp.asarray(a) for a in args), has_aux=True)
        grads = vjp(jnp.asarray(d["dy"]))
        out = {"y": np.asarray(y), **{k: np.asarray(g) for k, g in zip(names, grads)}}
        out.update({k: np.asarray(v) for k, v in new.items()})
    return out


def _close(got, want, name, tol=BN_TOL):
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)
    return err


@pytest.mark.parametrize("name", list(BN_CASES))
def test_global_batch_bn_equals_jax_on_the_global_batch(ranks, name):
    d = bn_inputs()
    want = jax_bn(name, d)
    got = [r["bn"][name] for r in ranks]
    for k in ("y", "dx"):  # row for row: rank 0's rows, then rank 1's
        _close(np.concatenate([g[k] for g in got]), want[k], k)
    for k in ("dscale", "doffset") + (("dw",) if "dw" in want else ()):
        _close(sum(g[k] for g in got), want[k], k)  # the gradient bucket's sum
    for k in ("mean", "var"):  # the same bits on both ranks
        np.testing.assert_array_equal(got[0][k], got[1][k])
        _close(got[0][k], want[k], k)


def test_bn_without_the_reduction_misses(ranks):
    """Rank 0's rows normalized with their own statistics (one process) are
    far from the global batch's: the comparison above can see a missing
    all-reduce."""
    d = bn_inputs()
    sc, of = torch.tensor(d["scale"]), torch.tensor(d["offset"])
    s = {"mean": torch.tensor(d["mean"]), "var": torch.tensor(d["var"])}
    y, new = TL.batch_norm_train({"scale": sc, "offset": of}, s, torch.tensor(d["x"][:ROWS]))
    want = jax_bn("exact", d)
    assert np.abs(y.numpy() - want["y"][:ROWS]).max() > 1e3 * BN_TOL * np.abs(want["y"]).max()
    assert np.abs(new["mean"].numpy() - want["mean"]).max() > 1e-3


# ---- one data-parallel train step -----------------------------------------------------


@pytest.fixture(scope="module")
def jax_step():
    cfg = tiny_cfg("float64", False, **STEP_OPTIONS)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        f64_zero_state(mp)
        mp.setattr(jts, "jnp", _Float64Zeros())
        params, state = jax_tree(cfg, np.float64)
        images, caps = step_batch()
        schedule = jlr.from_config(cfg)
        tx = jts.make_optimizer(cfg, schedule)
        steps = jts.build_steps(jcap.ModelOptions.from_config(cfg), tx, schedule,
                                donate=False, grad_accum_steps=ACCUM)
        jp, jo, js, _, jloss, _ = steps.train_step(
            params, tx.init(params), state, jnp.asarray(0), images, caps)
        mu, nu = (flat(t) for t in _adam_state(jo))
        return {"loss": float(jloss), "params": flat(jp), "state": flat(js), "mu": mu,
                "nu": nu, "ema": flat(jts.ema_params_from_opt_state(jo))}


def test_dp_train_step_equals_jax_on_the_global_batch(ranks, jax_step):
    got = ranks[0]["step"]
    for k in ("params", "state", "mu", "nu", "ema"):  # every rank holds the same bits
        for leaf in got[k]:
            np.testing.assert_array_equal(got[k][leaf], ranks[1]["step"][k][leaf],
                                          err_msg=f"{k}/{leaf}")
    assert got["loss"] == ranks[1]["step"]["loss"]
    np.testing.assert_allclose(got["loss"], jax_step["loss"], rtol=1e-9)
    for k in jax_step["state"]:
        np.testing.assert_allclose(got["state"][k], jax_step["state"][k], rtol=0, atol=1e-10,
                                   err_msg=k)
    for k in ("mu", "nu"):
        scale = max(np.abs(v).max() for v in jax_step[k].values())
        for leaf in jax_step[k]:
            np.testing.assert_allclose(got[k][leaf], jax_step[k][leaf], rtol=1e-6,
                                       atol=1e-5 * scale, err_msg=f"{k}/{leaf}")
    gmax = max(np.abs(v).max() for v in jax_step["mu"].values())
    for k, share in (("params", 1.0), ("ema", 1.0 - STEP_OPTIONS["train.ema_decay"])):
        assert got[k].keys() == jax_step[k].keys()
        for leaf, want in jax_step[k].items():
            clear = np.abs(jax_step["mu"][leaf]) > 1e-5 * gmax
            err = np.abs(got[k][leaf] - want)
            assert (err[clear] <= 1e-4 * LR * share).all(), (k, leaf, err[clear].max())
            assert (err <= 2 * LR * share).all(), (k, leaf)


def test_dp_train_step_collectives(ranks):
    """The token count, one gradient bucket (one dtype), and one all-reduce
    per BN layer forward (2 microbatches) and backward: the same on both
    ranks."""
    n_bn = sum(1 for k in ranks[0]["step"]["state"] if k.endswith("/mean"))
    assert n_bn > 30
    assert ranks[0]["step"]["calls"] == ranks[1]["step"]["calls"] == 2 + ACCUM * 2 * n_bn


def test_a_mean_of_per_rank_means_misses_jax(ranks, jax_step):
    got = ranks[0]["step_fault"]["loss"]
    assert abs(got - jax_step["loss"]) > 1e-3 * abs(jax_step["loss"])
