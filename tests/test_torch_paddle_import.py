"""The port's Paddle checkpoint import (``compat/paddle_fmt.py``,
``compat/paddle_import.py``) against the JAX package's, on the CPU.

- ``paddle_fmt``: files written by the JAX package's copy read equal in the
  port's and the other way round, and both writers write the same bytes
  (every dtype of the format, and a persistables directory);
- ``import_persistables`` on the synthetic reference checkpoint of
  ``tests/test_paddle_import.py`` (every variable the reference writes, plus
  optimizer and LR files): the tree (from the same starting tree) and the
  ``ImportReport`` equal the JAX package's, complete and with a variable
  missing and an unknown one, strict (both raise) and not;
- the CLI (``python -m ...compat.paddle_import``, with jax and the JAX
  package blocked) writes a parity-mode bundle whose greedy decode
  (``load_bundle(device="cpu")``) equals the JAX package's decode of its own
  import and the NumPy oracle of the reference decode (``_oracle_greedy``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.compat import paddle_fmt as jfmt
from myimagecaptioningmodel_tpu.compat import paddle_import as jimp
from myimagecaptioningmodel_tpu.models import captioner as jcap
from myimagecaptioningmodel_tpu_torch import config as tconfig
from myimagecaptioningmodel_tpu_torch.compat import paddle_fmt as tfmt
from myimagecaptioningmodel_tpu_torch.compat import paddle_import as timp
from myimagecaptioningmodel_tpu_torch.evaluation.evaluate import load_bundle
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap
from test_paddle_import import STEPS, _make_paddle_vars, _oracle_greedy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, E, H = 64, 8, 16
BLOCKED = ("jax", "jaxlib", "flax", "optax", "myimagecaptioningmodel_tpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def arrays():
    rng = np.random.RandomState(0)
    return {"f32": rng.randn(3, 5).astype(np.float32), "f64": rng.randn(7),
            "i64": rng.randint(-9, 9, (2, 3, 4, 5)).astype(np.int64),
            "f16": rng.randn(4, 1).astype(np.float16),
            "i32": rng.randint(0, 2, (6,)).astype(np.int32),
            "u8": rng.randint(0, 255, (2, 2)).astype(np.uint8),
            "i8": rng.randint(-9, 9, (3,)).astype(np.int8), "b": rng.rand(4) > 0.5,
            "i16": rng.randint(-9, 9, (5,)).astype(np.int16)}


@pytest.mark.parametrize("writer,reader", [(jfmt, tfmt), (tfmt, jfmt)],
                         ids=["jax_to_port", "port_to_jax"])
def test_lod_tensor_files_cross_read_and_match_bytes(tmp_path, writer, reader):
    other = jfmt if writer is tfmt else tfmt
    for name, arr in arrays().items():
        p, q = str(tmp_path / f"{name}_a"), str(tmp_path / f"{name}_b")
        writer.write_lod_tensor(p, arr)
        out = reader.read_lod_tensor(p)
        assert out.dtype == arr.dtype and out.shape == arr.shape, name
        np.testing.assert_array_equal(out, arr)
        other.write_lod_tensor(q, arr)
        assert open(p, "rb").read() == open(q, "rb").read(), name
    writer.write_persistables_dir(str(tmp_path / "dir"), arrays())
    with open(tmp_path / "dir" / "__model__", "wb") as f:
        f.write(b"\x01\x02 a program desc")
    skipped = []
    got = reader.read_persistables_dir(str(tmp_path / "dir"), skipped=skipped)
    assert sorted(got) == sorted(arrays()) and skipped == ["__model__"]


# ---- the import -------------------------------------------------------------------


def port_cfg():
    cfg = tconfig.Config()
    for path, value in (("model.decoder.vocab_size", V), ("model.decoder.embedding_size", E),
                        ("model.decoder.hidden_dim", H), ("model.decoder.sentence_length", STEPS),
                        ("model.decoder.infer_max_length", STEPS),
                        ("model.compute_dtype", "float32"), ("data.image_shape", (32, 32))):
        cfg = tconfig.replace_nested(cfg, path, value)
    return cfg


@pytest.fixture(scope="module")
def paddle_dir(tmp_path_factory):
    """A synthetic reference checkpoint -> (dir, its model variables, the
    port's parity options, the starting tree as numpy)."""
    cfg = port_cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, parity_mode=True))
    opts = tcap.ModelOptions.from_config(cfg)
    params, state = tcap.init(torch.Generator().manual_seed(0), opts)
    variables = _make_paddle_vars({k: {"conv": {"w": v["conv"]["w"].numpy()}}
                                   for k, v in params["encoder"].items()})
    d = str(tmp_path_factory.mktemp("paddle") / "persistables")
    extra = dict(variables)
    extra["fc_0.w_0_moment1_0"] = np.zeros((1280, H), np.float32)
    extra["@LR_DECAY_COUNTER@"] = np.zeros((1,), np.int64)
    jfmt.write_persistables_dir(d, extra)
    return d, variables, cfg, opts


def _start(opts):
    """The port's starting tree (``captioner.init`` from seed 0), as numpy."""
    from myimagecaptioningmodel_tpu_torch.compat.from_jax import to_numpy

    return tuple(to_numpy(t) for t in tcap.init(torch.Generator().manual_seed(0), opts))


def _jax_opts(cfg):
    return jcap.ModelOptions.from_config(
        jconfig.Config.from_json(cfg.to_json()))._replace(use_pallas=False)


def _port_import(paddle_dir, directory, strict):
    _, _, _, opts = paddle_dir
    p0, s0 = _start(opts)
    return timp.import_persistables(directory, opts, p0, s0, strict=strict)


def _as_jnp(tree):
    """numpy leaves -> jax arrays, dict order kept (the import reports the
    variables in the tree's order)."""
    if isinstance(tree, dict):
        return {k: _as_jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _jax_import(paddle_dir, directory, strict):
    """The JAX package's import onto the same starting tree (its own init
    compiles op by op for about 20 s)."""
    _, _, cfg, opts = paddle_dir
    p0, s0 = (_as_jnp(t) for t in _start(opts))
    return jimp.import_persistables(directory, _jax_opts(cfg), p0, s0, strict=strict)


def _trees(paddle_dir, directory, strict):
    """(port tree, report), (JAX tree, report) from the same starting tree."""
    return (_port_import(paddle_dir, directory, strict),
            _jax_import(paddle_dir, directory, strict))


def _assert_same(port, jx):
    (tp, ts, trep), (jp, js, jrep) = port, jx
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    for a, b in ((tp, jp), (ts, js)):
        la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
        assert [k for k, _ in la] == [k for k, _ in lb]
        for (k, x), (_, y) in zip(la, lb):
            assert x.dtype == np.float32, k
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("strict", [False, True], ids=["lenient", "strict"])
def test_import_tree_and_report_equal_jax(paddle_dir, strict):
    d, variables, _, _ = paddle_dir
    port, jx = _trees(paddle_dir, d, strict)
    _assert_same(port, jx)
    assert not port[2].missing and not port[2].unknown and len(port[2].skipped) == 2
    assert len(port[2].imported) == len(variables)
    # Paddle's (i, f, o, g) gates land as (i, f, g, o); convs OIHW -> HWIO once
    np.testing.assert_array_equal(port[0]["decoder"]["lstm"]["w"],
                                  timp.permute_lstm_gates(variables["lstm_w"], H))
    layer = next(iter(port[0]["encoder"]))
    np.testing.assert_array_equal(port[0]["encoder"][layer]["conv"]["w"],
                                  variables[f"{layer}_weights"].transpose(2, 3, 1, 0))


@pytest.mark.parametrize("strict", [False, True], ids=["lenient", "strict"])
def test_incomplete_import_equals_jax(paddle_dir, tmp_path, strict):
    """A variable missing and an unknown one: the same report (lenient), or
    both packages raise (strict)."""
    _, variables, _, _ = paddle_dir
    partial = {k: v for k, v in variables.items() if k != "fc_7.b_0"}
    partial["mystery_var"] = np.ones((2,), np.float32)
    d = str(tmp_path / "partial")
    tfmt.write_persistables_dir(d, partial)
    if strict:
        for run in (_port_import, _jax_import):
            with pytest.raises(ValueError, match="strict import failed"):
                run(paddle_dir, d, strict)
        return
    port, jx = _trees(paddle_dir, d, strict)
    _assert_same(port, jx)
    assert port[2].missing == ["fc_7.b_0"] and port[2].unknown == ["mystery_var"]


# ---- the CLI and the imported bundle's decode -----------------------------------------


def test_cli_bundle_decodes_to_jax_and_the_oracle(paddle_dir, tmp_path):
    d, variables, cfg, _ = paddle_dir
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(port_cfg().to_dict()), encoding="utf-8")
    out = tmp_path / "save" / "infer"
    code = (f"import runpy, sys\nfor name in {BLOCKED!r}:\n    sys.modules[name] = None\n"
            f"sys.argv = ['x', {d!r}, {str(out)!r}, '--config', {str(cfg_path)!r}, '--strict']\n"
            "runpy.run_module('myimagecaptioningmodel_tpu_torch.compat.paddle_import', "
            "run_name='__main__')\n")
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"imported {len(variables)} vars" in proc.stdout, proc.stdout

    serve = tconfig.replace_nested(port_cfg(), "train.checkpoint_path", str(out.parent))
    model, bcfg, opts, decode = load_bundle(serve, "infer", device="cpu")
    assert bcfg.model.parity_mode and opts.parity_mode
    images = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    ids = decode(model, images).numpy()

    _, feat, _ = tcap.img2feature(model, images, opts)
    oracle = _oracle_greedy(variables, feat.numpy().astype(np.float32), STEPS,
                            start=opts.start_idx, pad=opts.padding_idx)
    np.testing.assert_array_equal(ids, oracle)

    jp, js, _ = _jax_import(paddle_dir, d, True)  # the CLI's starting tree: seed 0
    want = np.asarray(jcap.greedy_decode(jp, js, jnp.asarray(images), _jax_opts(bcfg)))
    np.testing.assert_array_equal(ids, want)
