"""The port's host-side data pipeline against the JAX package's, on the same
synthetic SemanticKITTI tree and seeds: `TrainDataset` and `EvalDataset`
(native and numpy paths; every array equal, `np.array_equal`), the history
windows, augmentation, the drop list (byte for byte), copy-paste, and the
worker pool (order and per-worker seeds)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from streammos_tpu.config import get_config as jax_get_config
from streammos_tpu.data import augment as jax_aug
from streammos_tpu.data import copy_paste as jax_cp
from streammos_tpu.data import dataset as jax_ds
from streammos_tpu.data import droplist as jax_droplist
from streammos_tpu.data import loader as jax_loader
from streammos_tpu.data import semantic_kitti as jax_sk
from streammos_tpu.native import api as jax_native_api

from streammos_tpu_torch.config import get_config
from streammos_tpu_torch.data import augment as t_aug
from streammos_tpu_torch.data import copy_paste as t_cp
from streammos_tpu_torch.data import dataset as t_ds
from streammos_tpu_torch.data import droplist as t_droplist
from streammos_tpu_torch.data import loader as t_loader
from streammos_tpu_torch.data import semantic_kitti as t_sk
from streammos_tpu_torch.parallel import process_shard_indices
from tests.synthetic_kitti import make_sequence
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATIC_FRAMES = (2, 5)  # sequence 00 frames whose movers are relabeled parked


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Sequences 00 (train) and 08 (valid) under <root>/sequences, two
    frames of 00 without moving points, and an object bank beside."""
    root = tmp_path_factory.mktemp("torch_dataset")
    seqs = root / "sequences"
    make_sequence(str(seqs), "00", n_frames=8, n_points=2600, seed=0)
    make_sequence(str(seqs), "08", n_frames=8, n_points=2600, seed=1)
    for i in STATIC_FRAMES:
        path = seqs / "00" / "labels" / f"{i:06d}.label"
        raw = np.fromfile(path, dtype=np.uint32)
        raw[(raw & 0xFFFF) == 252] = 10
        raw.tofile(path)
    bank = root / "object_bank" / "car"
    bank.mkdir(parents=True)
    rng = np.random.default_rng(0)
    pcds = np.stack([rng.uniform(9, 11, 200), rng.uniform(-1, 1, 200),
                     rng.uniform(-1.5, -0.5, 200), rng.uniform(0, 1, 200)],
                    axis=-1).astype(np.float32)
    for name in ("00_0001.npz", "08_0002.npz"):
        np.savez(bank / name, pcds=pcds, cate="car", cate_id=10,
                 center=np.array([10.0, 0.0, -1.0]),
                 size=np.array([2.5, 2.0, 1.2]), yaw=0.0)
    return {"seqs": str(seqs), "bank": str(root / "object_bank"),
            "root": root}


def _cfgs(split: str, seq_dir: str, n: int, **kw):
    """(JAX, port) DatasetConfig of StreamMOS_tiny with the same overrides."""
    return tuple(dataclasses.replace(getattr(g("StreamMOS_tiny"), split),
                                     seq_dir=seq_dir, frame_point_num=n, **kw)
                 for g in (jax_get_config, get_config))


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Which loading path both packages take: JAX's follows its
    `native.available()`, the port's is asked for explicitly."""
    if request.param == "numpy":
        monkeypatch.setattr(jax_native_api, "_TRIED", True)
        monkeypatch.setattr(jax_native_api, "_LIB", None)
    else:
        assert jax_native_api.available(), "JAX's native loader did not build"
    return request.param


def _assert_same(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (where, k)
            assert np.array_equal(a[k], b[k]), (where, k)
        else:
            assert a[k] == b[k], (where, k)


def test_label_tables_match():
    for name in ("LEARNING_MAP", "BF_LEARNING_MAP", "LEARNING_MAP_INV",
                 "SPLITS", "ROAD_LABEL"):
        assert getattr(t_sk, name) == getattr(jax_sk, name), name
    for m in (t_sk.LEARNING_MAP, t_sk.BF_LEARNING_MAP, t_sk.LEARNING_MAP_INV):
        np.testing.assert_array_equal(t_sk.label_lut(m), jax_sk.label_lut(m))
    raw = np.random.default_rng(0).integers(0, 1 << 32, 5000, dtype=np.uint64)
    raw = raw.astype(np.uint32)
    raw[:300] = (raw[:300] & 0xFFFF0000) | 252
    for a, b in zip(t_sk.split_label(raw), jax_sk.split_label(raw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sem = t_sk.split_label(raw)[0] % 360
    for m in (t_sk.LEARNING_MAP, t_sk.BF_LEARNING_MAP):
        np.testing.assert_array_equal(t_sk.relabel(sem, m),
                                      jax_sk.relabel(sem, m))


@pytest.mark.parametrize("total,span", [(8, 5), (6, 3), (4, 3)])
def test_history_ids(total, span):
    """First frames mirror forward, interior and last frames look back."""
    for i in range(total):
        assert t_ds._history_ids(i, total, span) == \
            jax_ds._history_ids(i, total, span)
    assert t_ds._history_ids(0, total, span) == list(range(span))
    assert t_ds._history_ids(total - 1, total, span) == \
        [total - 1 - k for k in range(span)]


def test_augment_matches():
    jcfg, tcfg = (g("StreamMOS_tiny").train.aug for g in (jax_get_config,
                                                          get_config))
    pts = np.random.default_rng(1).normal(size=(500, 4)).astype(np.float32)
    for seed in range(6):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        pj, pt = jax_aug.draw_params(rj, jcfg), t_aug.draw_params(rt, tcfg)
        assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
        a, b = jax_aug.apply(pts, pj, jcfg, rj), t_aug.apply(pts, pt, tcfg, rt)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert rj.random() == rt.random()  # the streams stayed in step


def test_drop_list_byte_for_byte(tree, tmp_path):
    a, b = tmp_path / "jax" / "drop.txt", tmp_path / "port" / "drop.txt"
    assert jax_droplist.write_drop_list(tree["seqs"], str(a)) == \
        t_droplist.write_drop_list(tree["seqs"], str(b)) == (6, 8)
    assert a.read_bytes() == b.read_bytes()
    assert os.listdir(b.parent) == ["drop.txt"]  # no temporary left behind


@pytest.mark.parametrize("bf,copy_paste", [(False, False), (True, True)])
def test_train_dataset_matches(tree, tmp_path, path, bf, copy_paste):
    drop = str(tmp_path / "drop.txt")
    t_droplist.write_drop_list(tree["seqs"], drop)
    jcfg, tcfg = _cfgs("train", tree["seqs"], 2048, with_bf_labels=bf)
    kw = dict(drop_list_path=drop, seq_ids=[0, 8], seed=7)
    jds = jax_ds.TrainDataset(
        jcfg, copy_paste=jax_cp.SequenceCutPaste(tree["bank"], 3)
        if copy_paste else None, **kw)
    tds = t_ds.TrainDataset(
        tcfg, copy_paste=t_cp.SequenceCutPaste(tree["bank"], 3)
        if copy_paste else None, native=path == "native", **kw)
    assert len(tds) == len(jds) == 8 - len(STATIC_FRAMES) + 8
    for (jm, jp), (tm, tp) in zip(jds.samples, tds.samples):
        assert [m.pcd_path for m in jm] == [m.pcd_path for m in tm]
        assert all(np.array_equal(a, b) for a, b in zip(jp, tp))
    for i in range(len(tds)):
        _assert_same(jds[i], tds[i], f"train sample {i}")
    batch = [tds[0], tds[1]]
    _assert_same(jax_ds.TrainDataset.collate(batch),
                 t_ds.TrainDataset.collate(batch), "collate")
    assert t_ds.TrainDataset.collate(batch)["xyzi"].shape == (3, 2, 3, 2048, 4)


@pytest.mark.parametrize("with_labels", [True, False])
def test_eval_dataset_matches(tree, path, with_labels):
    jcfg, tcfg = _cfgs("val", tree["seqs"], 4096, with_bf_labels=True)
    jds = jax_ds.EvalDataset(jcfg, seq_ids=[0, 8], with_labels=with_labels)
    tds = t_ds.EvalDataset(tcfg, seq_ids=[0, 8], with_labels=with_labels,
                           native=path == "native")
    assert len(tds) == len(jds) == 16
    for i in range(len(tds)):
        a, b = jds[i], tds[i]
        _assert_same(a, b, f"eval sample {i}")
        assert a["valid_mask"].shape == (2600,)
        assert b["pad_length"] == 4096 - int(b["valid_mask"].sum())
        static = b["seq_id"] == "00" and int(b["file_id"]) in STATIC_FRAMES
        assert (b["targets"] == 2).any() == (with_labels and not static)


def test_eval_native_equals_numpy(tree):
    _, tcfg = _cfgs("val", tree["seqs"], 4096, with_bf_labels=True)
    a = t_ds.EvalDataset(tcfg, seq_ids=[0, 8])
    b = t_ds.EvalDataset(tcfg, seq_ids=[0, 8], native=False)
    for i in range(len(a)):
        _assert_same(a[i], b[i], f"eval sample {i}")


def test_copy_paste_matches(tree):
    """`SequenceCutPaste` on the bank of `tests/test_copy_paste.py`: the
    same bank (sequence 08 excluded) and, from the same generator, the
    same pasted scans and labels."""
    jcp = jax_cp.SequenceCutPaste(tree["bank"], paste_max_obj_num=5)
    tcp = t_cp.SequenceCutPaste(tree["bank"], paste_max_obj_num=5)
    assert tcp.bank == jcp.bank and len(tcp.bank["car"]) == 1
    np.testing.assert_array_equal(
        t_cp.box_corners_2d((1, 2), (4, 2, 1), 0.3),
        jax_cp.box_corners_2d((1, 2), (4, 2, 1), 0.3))
    q = t_cp.box_corners_2d((0, 0), (4, 2, 1), 0.0)
    pts = np.array([[0, 0], [1.9, 0.9], [2.1, 0], [0, 1.1], [-1.9, -0.9]])
    np.testing.assert_array_equal(t_cp.points_in_quad(pts, q),
                                  [True, True, False, False, True])
    pasted = 0
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        frames = []
        for t in range(5):
            n = 20000
            p = np.stack([rng.uniform(-30, 30, n), rng.uniform(-30, 30, n),
                          rng.uniform(-1.75, -1.65, n), rng.uniform(0, 1, n)],
                         axis=-1).astype(np.float32)
            frames.append((p, np.ones(n, np.int32), np.ones(n, np.int32),
                           np.full(n, 40, np.int32)))
        args = [[f[k] for f in frames] for k in range(3)]
        raws = [f[3] for f in frames]
        roads = [s[r == 40] for s, r in zip(args[0], raws)]
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        out_j = jcp(*args, roads, raws, rj)
        out_t = tcp(*args, roads, raws, rt)
        for lj, lt in zip(out_j, out_t):
            for a, b in zip(lj, lt):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        pasted += sum(s.shape[0] != 20000 for s in out_t[0])
        assert rj.random() == rt.random()
    assert pasted > 0, "no object was pasted"


def test_shard_indices_match():
    from streammos_tpu.parallel import process_shard_indices as jax_shard

    for n, bs in ((10, 3), (8, 1), (7, 4)):
        np.testing.assert_array_equal(
            process_shard_indices(n, np.random.default_rng(n), bs),
            jax_shard(n, np.random.default_rng(n), bs))
    np.testing.assert_array_equal(process_shard_indices(5, None, 2),
                                  [0, 1, 2, 3, 4, 0])


POOL_PROBE = r"""
import json, sys
import numpy as np
from {module} import SampleWorkerPool
from tests.torch_pool_probe import SeedProbe

if __name__ == "__main__":
    order = [int(i) for i in json.loads(sys.argv[1])]
    with SampleWorkerPool(SeedProbe(), num_workers=2, seed=11) as pool:
        got = [list(g[:3]) for g in pool.map_ordered(order)]
        batches = [[list(g[:3]) for g in b]
                   for b in pool.batches(order, 4, list)]
    print(json.dumps({{"got": got, "batches": batches}}))
"""


def _pool_results(module: str, order, tmp_path):
    """Run a 2-worker pool of `module` over `order` in a fresh interpreter
    (so worker identities start at 1, and no thread of this process is
    forked)."""
    script = tmp_path / f"{module.split('.')[0]}_pool.py"
    script.write_text(POOL_PROBE.format(module=module))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, str(script),
                          json.dumps([int(i) for i in order])], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_worker_pool_order_and_seeds(tmp_path):
    """Both pools return samples in the order asked for (a shuffled order
    with repeats), collate full batches and drop the tail, and reseed each
    worker with base_seed + 1000 * its process identity."""
    order = process_shard_indices(45, np.random.default_rng(3), 4)[:-2]
    out = {m: _pool_results(m, order, tmp_path)
           for m in ("streammos_tpu.data.loader",
                     "streammos_tpu_torch.data.loader")}
    for res in out.values():
        got, batches = res["got"], res["batches"]
        assert [g[0] for g in got] == [int(i) for i in order]
        assert [len(b) for b in batches] == [4] * (len(order) // 4)
        assert [g[0] for b in batches for g in b] == \
            [int(i) for i in order[:len(order) // 4 * 4]]
        # the first two processes of a fresh interpreter: identities 1, 2
        for _, seed, ident in got + [g for b in batches for g in b]:
            assert ident[0] in (1, 2) and seed == 11 + 1000 * ident[0]


def test_worker_pool_inline_matches(tree, path):
    """With 0 workers both pools load in the caller: equal batches."""
    jcfg, tcfg = _cfgs("train", tree["seqs"], 1024, drop_few_static_frames=False)
    order = process_shard_indices(8, np.random.default_rng(0), 2)
    jpool = jax_loader.SampleWorkerPool(
        jax_ds.TrainDataset(jcfg, seq_ids=[0], seed=3), 0)
    tpool = t_loader.SampleWorkerPool(
        t_ds.TrainDataset(tcfg, seq_ids=[0], seed=3,
                          native=path == "native"), 0)
    jb = list(jax_loader.PrefetchLoader(
        jpool.batches(order, 2, jax_ds.TrainDataset.collate), depth=2))
    tb = list(t_loader.PrefetchLoader(
        tpool.batches(order, 2, t_ds.TrainDataset.collate), depth=2))
    assert len(tb) == len(jb) == 4
    for a, b in zip(jb, tb):
        _assert_same(a, b, "batch")


def test_prefetch_loader_raises_the_iterators_error():
    def gen():
        yield 1
        raise KeyError("boom")

    it = iter(t_loader.PrefetchLoader(gen(), depth=1))
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
