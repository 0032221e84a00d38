"""The port's data plane against the JAX package's, on the CPU: the dataset
build (segmenter, split, tokenizer) file for file, the image shards row for
row (the port's own ``gen_shards`` and ``convert_jax_shards`` of a JAX HDF5
set, float16 and uint8), and ``DataReader`` streams element for element,
bit for bit.

The corpus: 160 synthetic 48x48 JPEGs with two captions each, 32 px rows,
64 rows a shard (three shards), built once per module by both packages into
their own directories. ``corpus``, ``make_cfg`` and ``port_cfg`` are shared
with the other ``test_torch_*`` files of the training slice.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from myimagecaptioningmodel_tpu import config as jconfig
from myimagecaptioningmodel_tpu.data import dataset_gen as jdg
from myimagecaptioningmodel_tpu.data import hdf5 as jhdf5
from myimagecaptioningmodel_tpu.data import image as jimage
from myimagecaptioningmodel_tpu.data import reader as jreader
from myimagecaptioningmodel_tpu.data import segmenter as jseg
from myimagecaptioningmodel_tpu_torch import config as tconfig
from myimagecaptioningmodel_tpu_torch.data import dataset_gen as tdg
from myimagecaptioningmodel_tpu_torch.data import image as timage
from myimagecaptioningmodel_tpu_torch.data import reader as treader
from myimagecaptioningmodel_tpu_torch.data import segmenter as tseg
from myimagecaptioningmodel_tpu_torch.data import shards as tshards
from myimagecaptioningmodel_tpu_torch.models import captioner as tcap

PHRASES = ["一个 男人 在 打 篮球", "一只 猫 在 睡觉", "一个 女人 在 跑步",
           "两个 孩子 在 公园 玩耍", "一个 男人 在 公园 跑步", "一只 狗 在 草地 上 玩耍"]
N_IMAGES = 160  # 8 test, 8 dev, 144 train images under the 5/5/90 split


def build_images(root, n_images=N_IMAGES):
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(7)
    records = []
    for i in range(n_images):
        name = f"img_{i:03d}.jpg"
        Image.fromarray(rng.randint(0, 255, (48, 48, 3), dtype=np.uint8)).save(img_dir / name)
        records.append({"image_id": name,
                        "caption": [PHRASES[i % 6], PHRASES[(i * 5 + 2) % 6]]})
    ann = root / "annotations.json"
    ann.write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")
    return img_dir, ann


def make_cfg(root, img_dir, ann, dataset="dataset", run="run", storage="float16",
             codec="none", train=(), model=()):
    """A JAX ``Config`` for the corpus (the JAX tests' shape: 32 px rows,
    hidden 16, embedding 8, float32); ``train``/``model`` extra dotted
    overrides. ``port_cfg`` gives the port's."""
    out = root / dataset
    cfg = jconfig.Config.from_dict({
        "build_dataset": {"image_paths": [str(img_dir)], "annotation_path": str(ann),
                          "output_path": str(out), "h5_name2idx": str(out / "name2idx.json"),
                          "shard_max_size": 64, "storage_dtype": storage, "codec": codec},
        "data": {"image_shape": [32, 32], "dict_path": str(out), "h5_path": [str(out)],
                 "h5_name2idx": str(out / "name2idx.json"), "sample_count": 32},
        "train": {"seed": 0, "learning_rate": 1e-3, "batch_size": 4, "max_epoch": 2,
                  "log_every_n_step": 1, "checkpoint_path": str(root / run / "save"),
                  "data_loader_capacity": 4},
        "model": {"decoder": {"vocab_size": 0, "embedding_size": 8, "sentence_length": 0,
                              "hidden_dim": 16, "infer_max_length": 8},
                  "compute_dtype": "float32"},
        "log": {"log_path": str(root / run / "log")},
    })
    for path, value in (*train, *model):
        cfg = jconfig.replace_nested(cfg, path, value)
    return cfg


def with_vocab(cfg, tokenize):
    cfg = jconfig.replace_nested(cfg, "model.decoder.vocab_size", tokenize["vocab_size"])
    return jconfig.replace_nested(cfg, "model.decoder.sentence_length", tokenize["max_len"])


def port_cfg(cfg, **paths):
    """The JAX config as the port's, with dotted-path overrides (``a__b``
    for ``a.b``)."""
    port = tconfig.Config.from_json(cfg.to_json())
    for path, value in paths.items():
        port = tconfig.replace_nested(port, path.replace("__", "."), value)
    return port


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Both packages' full builds of one corpus: (root, images, annotations,
    JAX cfg of "jax_ds", port cfg of "port_ds", JAX summary, port summary)."""
    root = tmp_path_factory.mktemp("data_plane")
    img_dir, ann = build_images(root)
    jcfg = make_cfg(root, img_dir, ann, "jax_ds")
    tcfg = port_cfg(make_cfg(root, img_dir, ann, "port_ds"))
    jsum = jdg.build_all(jcfg, segmenter="space", split_seed=0)
    tsum = tdg.build_all(tcfg, segmenter="space", split_seed=0)
    return root, img_dir, ann, jcfg, tcfg, jsum, tsum


def _same_object(a, b):
    if isinstance(a, np.ndarray) and a.dtype == object:
        assert isinstance(b, np.ndarray) and a.shape == b.shape
        for x, y in zip(a.ravel(), b.ravel()):
            _same_object(x, y)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_object(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)  # insertion order too
        for k in a:
            _same_object(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


CAPTION_FILES = ("word_dict.npy", "train_cap.npy", "dev_data.npy", "eval_data.npy",
                 "word2idx.json", "idx2word.json", "name2idx.json", "dataset_meta.json",
                 "temp/token", "temp/token.list", "temp/train.txt", "temp/dev.txt",
                 "temp/test.txt")


@pytest.mark.parametrize("name", CAPTION_FILES)
def test_dataset_build_matches_the_jax_package_file_for_file(corpus, name):
    root, *_ = corpus
    a, b = root / "jax_ds" / name, root / "port_ds" / name
    if name.endswith(".npy"):
        _same_object(np.load(a, allow_pickle=True), np.load(b, allow_pickle=True))
    assert a.read_bytes() == b.read_bytes()


def test_build_summaries_match(corpus):
    *_, jsum, tsum = corpus
    assert {k: v for k, v in jsum.items() if k != "gen_hdf5"} == {
        k: v for k, v in tsum.items() if k != "gen_shards"}
    keep = ("images", "skipped", "storage_dtype", "codec")
    assert {k: jsum["gen_hdf5"][k] for k in keep} == {k: tsum["gen_shards"][k] for k in keep}
    assert jsum["split"] == {"test": 8, "dev": 8, "train": 144}


def test_segmenter_copy_matches():
    assert tseg.get_segmenter("space")[0] == jseg.get_segmenter("space")[0] == "space"
    assert tseg.get_segmenter("auto")[0] == jseg.get_segmenter("auto")[0]
    line = "一个 男人 在 打 篮球"
    assert tseg.get_segmenter("space")[1](line) == jseg.get_segmenter("space")[1](line)
    assert tseg.segmenter_version("space") == jseg.segmenter_version("space") == "-"


def _jax_rows(dirs):
    mgr = jhdf5.Hdf5Manager()
    mgr.load_database([str(d) for d in dirs])
    try:
        return np.stack([mgr.read_index(i) for i in range(len(mgr))]), mgr.storage_info
    finally:
        mgr.close()


def _port_rows(dirs):
    mgr = tshards.ShardManager()
    mgr.load_database([str(d) for d in dirs])
    return np.stack([mgr.read_index(i) for i in range(len(mgr))]), mgr.storage_info


@pytest.fixture(scope="module")
def image_sets(corpus):
    """{storage dtype: (JAX HDF5 dir, port gen_shards dir)}: float16 from the
    full builds, uint8 built by gen_hdf5 and gen_shards alone."""
    root, img_dir, ann, *_ = corpus
    jcfg = make_cfg(root, img_dir, ann, "jax_u8", storage="uint8")
    tcfg = port_cfg(make_cfg(root, img_dir, ann, "port_u8", storage="uint8"))
    jhdf5.gen_hdf5(jcfg, progress_every=0)
    tshards.gen_shards(tcfg, progress_every=0)
    return {"float16": (root / "jax_ds", root / "port_ds"),
            "uint8": (root / "jax_u8", root / "port_u8")}


@pytest.mark.parametrize("storage", ["float16", "uint8"])
def test_gen_shards_rows_match_gen_hdf5(image_sets, storage):
    jdir, tdir = image_sets[storage]
    jrows, jinfo = _jax_rows([jdir])
    trows, tinfo = _port_rows([tdir])
    assert trows.dtype == jrows.dtype == np.dtype(storage)
    np.testing.assert_array_equal(trows, jrows)
    assert tinfo == jinfo
    assert sorted(os.listdir(tdir)).count("aic_flk_2.npy") == 1  # 160 rows, 64 a shard
    assert (jdir / "name2idx.json").read_bytes() == (tdir / "name2idx.json").read_bytes()


@pytest.mark.parametrize("storage,codec", [("float16", "gzip"), ("float16", "none"),
                                           ("uint8", "none")])
def test_convert_jax_shards_bit_for_bit(corpus, tmp_path, storage, codec):
    root, img_dir, ann, *_ = corpus
    jcfg = make_cfg(tmp_path, img_dir, ann, "jax", storage=storage, codec=codec)
    jhdf5.gen_hdf5(jcfg, progress_every=0)
    out = tmp_path / "port"
    info = tshards.convert_jax_shards([str(tmp_path / "jax")], str(out))
    assert info == {"rows": N_IMAGES, "shards": 3}
    jrows, jinfo = _jax_rows([tmp_path / "jax"])
    trows, tinfo = _port_rows([out])
    np.testing.assert_array_equal(trows, jrows)
    assert trows.dtype == jrows.dtype
    assert tinfo == {**jinfo, "codec": "none"}
    assert jinfo["codec"] == codec
    assert (out / "name2idx.json").read_bytes() == (tmp_path / "jax" / "name2idx.json").read_bytes()


def test_shard_builder_and_manager(tmp_path):
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 255, (20, 3, 4, 5)).astype(np.uint8)
    with tshards.ShardBuilder(str(tmp_path / "a"), "set", (3, 4, 5), 7, 20, "uint8",
                              tshards.storage_attrs("uint8", (0.4,) * 3, (0.2,) * 3)) as b:
        b.append_rows(rows[:9])
        for r in rows[9:15]:
            b.append(r)
    # fewer rows than announced: the last header says so
    assert sorted(os.listdir(tmp_path / "a")) == ["set.json", "set_0.npy", "set_1.npy",
                                                  "set_2.npy"]
    mgr = tshards.ShardManager()
    mgr.load_database(str(tmp_path / "a"))
    assert len(mgr) == 15
    idx = rng.permutation(15)
    np.testing.assert_array_equal(mgr.read_batch_idx(idx), rows[idx])
    np.testing.assert_array_equal(mgr.read_index(8), rows[8])
    assert mgr.storage_info == {"dtype": "uint8", "codec": "none", "storage_dtype": "uint8",
                                "normalized": False,
                                "image_mean": [np.float32(0.4).item()] * 3,
                                "image_std": [np.float32(0.2).item()] * 3}
    with pytest.raises(IndexError):
        mgr.read_index(15)
    # two directories with overlapping shard indices: per-directory order, warned
    with tshards.ShardBuilder(str(tmp_path / "b"), "set", (3, 4, 5), 7, 20, "uint8") as b:
        b.append_rows(rows[15:])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mgr.load_database([str(tmp_path / "a"), str(tmp_path / "b")])
    assert any("overlapping" in str(w.message) for w in caught)
    np.testing.assert_array_equal(mgr.read_batch_idx(range(20)), rows)
    with pytest.raises(ValueError, match="storage dtype"):
        tshards.ShardBuilder(str(tmp_path / "c"), "set", (3,), 2, 2, "int32")


def _dataset_cfgs(corpus, image_sets, storage):
    """JAX and port configs over the two builds' caption DBs and the
    ``storage`` image sets."""
    root, img_dir, ann, jcfg, tcfg, *_ = corpus
    jdir, tdir = image_sets[storage]
    jc = jconfig.replace_nested(jcfg, "data.h5_path", (str(jdir),))
    jc = jconfig.replace_nested(jc, "data.h5_name2idx", str(jdir / "name2idx.json"))
    tc = tconfig.replace_nested(tcfg, "data.h5_path", (str(tdir),))
    tc = tconfig.replace_nested(tc, "data.h5_name2idx", str(tdir / "name2idx.json"))
    return jc, tc


def _stacked(item):
    """A reader item (a sample list or a pre-stacked tuple) -> (imgs, second)."""
    if isinstance(item, tuple):
        return item[0], item[1]
    imgs, second = zip(*item)
    return np.stack(imgs), (np.stack(second) if isinstance(second[0], np.ndarray)
                            else list(second))


@pytest.mark.parametrize("storage", ["float16", "uint8"])
@pytest.mark.parametrize("mode", ["train", "dev", "test"])
@pytest.mark.parametrize("keep_raw", [False, True])
@pytest.mark.parametrize("threads", [0, 2])
def test_reader_streams_match_the_jax_serial_reader(corpus, image_sets, storage, mode,
                                                    keep_raw, threads):
    jc, tc = _dataset_cfgs(corpus, image_sets, storage)
    kw = dict(shuffle_seed=5, skip_samples=3) if mode == "train" else {}
    want = list(jreader.DataReader(jc).get_reader(4, mode, keep_float16=keep_raw, **kw)())
    got = list(treader.DataReader(tc).get_reader(4, mode, keep_float16=keep_raw,
                                                 reader_threads=threads, **kw)())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, tuple) == bool(threads)
        gi, gs = _stacked(g)
        wi, ws = _stacked(w)
        assert gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        if mode == "train":
            np.testing.assert_array_equal(gs, ws)
        else:
            assert list(gs) == list(ws)


def test_reader_storage_norm_and_process_shard(corpus, image_sets):
    jc, tc = _dataset_cfgs(corpus, image_sets, "uint8")
    jr, tr = jreader.DataReader(jc), treader.DataReader(tc)
    jr.init_hdf5()
    tr.init_shards()
    assert tr.storage_norm == jr.storage_norm
    assert tr.index_word == jr.index_word and tr.dataset_meta == jr.dataset_meta
    for index in range(2):  # each process's rows of every global batch of 8
        want = list(jr.get_reader(4, "train", keep_float16=True, process_shard=(index, 2))())
        got = list(tr.get_reader(4, "train", keep_float16=True, process_shard=(index, 2))())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(_stacked(g), _stacked(w)):
                np.testing.assert_array_equal(a, b)
    items = list(range(23))
    for index in range(3):
        assert (treader.process_slice_batches(items, 2, index, 3)
                == jreader.process_slice_batches(items, 2, index, 3))


def test_normalize_uint8_chw_equals_prepare_images():
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 256, (3, 3, 8, 9)).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    host = timage.normalize_uint8_chw(raw, mean, std)
    np.testing.assert_array_equal(host, jimage.normalize_uint8_chw(raw, mean, std))
    np.testing.assert_array_equal(timage.normalize_uint8_chw(raw[0], mean, std),
                                  jimage.normalize_uint8_chw(raw[0], mean, std))
    opts = tcap.ModelOptions.from_config(tconfig.Config())._replace(image_norm=(mean, std))
    dev = tcap.prepare_images(torch.from_numpy(raw), opts, torch.device("cpu"))
    np.testing.assert_array_equal(dev.numpy(), host.transpose(0, 2, 3, 1))
    img = Image.fromarray(rng.randint(0, 255, (30, 40, 3), np.uint8))
    np.testing.assert_array_equal(timage.resize_chw_uint8(img, (16, 16)),
                                  jimage.resize_chw_uint8(img, (16, 16)))
    assert timage.resize_chw_uint8(img.convert("L"), (16, 16)) is None


@pytest.mark.parametrize("rows,threads", [(10, 0), (8, 0), (10, 2)])
def test_decode_and_score_pads_and_pipelines(rows, threads):
    """``decode_and_score``: every decode at ``batch_size`` rows (the last
    batch padded with zero images), ``score`` given only the real rows, and
    batch i+1's decode queued before batch i is scored."""
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (rows, 3, 4, 4)).astype(np.uint8)
    items = [(img, [f"ref{i}"]) for i, img in enumerate(imgs)]
    B = 4

    def reader():
        for lo in range(0, rows, B):
            part = items[lo:lo + B]
            if threads:  # the stacked form of reader_threads > 0
                yield np.stack([x for x, _r in part]), [r for _x, r in part]
            else:
                yield part

    events, scored = [], []

    def decode(batch):
        events.append(("decode", batch.shape[0]))
        return torch.as_tensor(batch.reshape(batch.shape[0], -1)[:, :5].astype(np.int32))

    def score(ids, refs, n):
        assert n == len(ids)  # one process: every real row is this one's
        events.append(("score", len(ids)))
        scored.append((ids, refs))

    n_batches = -(-rows // B)
    assert treader.decode_and_score(reader, B, decode, score) == n_batches
    sizes = [min(B, rows - lo) for lo in range(0, rows, B)]
    want = [("decode", B)] + [e for n in sizes[:-1] for e in (("decode", B), ("score", n))]
    assert events == want + [("score", sizes[-1])]
    np.testing.assert_array_equal(np.concatenate([i for i, _r in scored]),
                                  imgs.reshape(rows, -1)[:, :5])
    assert [r for _i, refs in scored for r in refs] == [[f"ref{i}"] for i in range(rows)]
