"""The port's long-term-memory voting against the JAX package on the same
numpy inputs from a seed: the voxel vote (numpy, and torch on the CPU), the
history ids, the port's DBSCAN against scikit-learn's labels, and the
instance vote. All exact."""
import os
import subprocess
import sys

import numpy as np
import pytest
from sklearn.cluster import DBSCAN

from streammos_tpu.config import VoxelConfig as JaxVoxelConfig
from streammos_tpu.postprocess import voting as jax_voting
from streammos_tpu_torch.config import VoxelConfig
from streammos_tpu_torch.postprocess import voting
from streammos_tpu_torch.postprocess.dbscan import dbscan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (64, 64, 16)


def _points(rng, n, lo=(-45, -45, -3.5), hi=(45, 45, 1.5)):
    return np.stack([rng.uniform(lo[i], hi[i], n) for i in range(3)], -1)


def _case(name):
    """(local points, local preds, current points, current preds)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("random"):
        local = _points(rng, 5000)
        preds = rng.integers(0, 3, 5000).astype(np.int32)
        return local, preds, local[:800], preds[:800].copy()
    if name == "ties":
        # in 300 distinct cells, votes 1, 2 (a tie -> 1); in the first 100
        # of them a third vote 2 (-> 2), in the next 50 a third vote 0 (a
        # three-way tie -> 0)
        idx = np.stack(np.unravel_index(
            rng.choice(np.prod(GRID), 300, replace=False), GRID), -1)
        lo = np.array([-50.0, -50.0, -4.0])
        centers = lo + (idx + 0.5) * np.array([100 / 64, 100 / 64, 6 / 16])
        local = np.concatenate([centers, centers, centers[:150]])
        preds = np.concatenate([np.full(300, 1), np.full(300, 2),
                                np.full(100, 2), np.zeros(50)]).astype(np.int32)
        cur = centers
        return local, preds, cur, rng.integers(0, 3, 300).astype(np.int32)
    if name == "current_outside":
        local = _points(rng, 3000)
        preds = rng.integers(0, 3, 3000).astype(np.int32)
        cur = np.concatenate([local[:200], _points(rng, 100, (50, 50, 2),
                                                   (80, 80, 6)),
                              _points(rng, 100, (-90, -90, -9),
                                      (-51, -51, -4.5))])
        return local, preds, cur, rng.integers(0, 3, 400).astype(np.int32)
    if name == "empty_history":  # a one-frame sequence: the current frame
        cur = _points(rng, 700)
        preds = rng.integers(0, 3, 700).astype(np.int32)
        return cur, preds, cur, preds.copy()
    if name == "no_votes":
        cur = _points(rng, 50)
        return (np.zeros((0, 3)), np.zeros(0, np.int32), cur,
                rng.integers(0, 3, 50).astype(np.int32))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random0", "random1", "ties",
                                  "current_outside", "empty_history",
                                  "no_votes"])
def test_voxel_vote_matches_jax(name):
    local, preds, cur, cur_preds = _case(name)
    v, jv = VoxelConfig(bev_shape=GRID), JaxVoxelConfig(bev_shape=GRID)
    want = jax_voting.voxel_vote(local, preds, cur, cur_preds, jv)
    got = voting.voxel_vote(local, preds, cur, cur_preds, v)
    dev = voting.voxel_vote_device(local, preds, cur, cur_preds, v,
                                   device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dev, want)
    if name == "ties":
        assert got.tolist() == [2] * 100 + [0] * 50 + [1] * 150


def test_voxel_vote_device_keeps_the_capacity_contract():
    local, preds, cur, cur_preds = _case("random0")
    with pytest.raises(AssertionError):
        voting.voxel_vote_device(local, preds, cur, cur_preds,
                                 VoxelConfig(bev_shape=GRID), capacity=4096,
                                 device="cpu")


def test_quantize_on_cell_boundaries_is_float64():
    """Points exactly on cell boundaries quantize as JAX's host code does
    (float64, truncated)."""
    v = VoxelConfig()
    dx = 100.0 / 512
    k = np.arange(-256, 256)
    pts = np.stack([k * dx, k[::-1] * dx, np.linspace(-3.9, 1.9, k.size)],
                   -1).astype(np.float32)
    np.testing.assert_array_equal(
        voting._quantize_int(pts, v),
        jax_voting._quantize_int(pts, JaxVoxelConfig()))


@pytest.mark.parametrize("num_frames", [1, 2, 5, 8, 9, 20])
def test_gather_history_matches_jax(num_frames):
    for fid in range(num_frames):
        assert (voting.gather_history(fid, num_frames)
                == jax_voting.gather_history(fid, num_frames))


def _square(cx, spacing=0.5):
    """Four points: a centre and three at `spacing` (binary-exact)."""
    return np.array([[cx, 0, 0], [cx, spacing, 0], [cx, -spacing, 0],
                     [cx + (-spacing if cx <= 0 else spacing), 0, 0]])


def _built_dbscan_case(name):
    """(points, eps, min_samples), coordinates exact in binary so that
    distances equal to eps are computed exactly by every method."""
    if name == "shared_border_a_first":
        return (np.concatenate([_square(0.0), _square(2.0),
                                [[1.0, 0, 0]]]), 1.0, 4)
    if name == "shared_border_b_first":
        return (np.concatenate([_square(2.0), [[1.0, 0, 0]],
                                _square(0.0)]), 1.0, 4)
    if name == "exactly_min_samples":
        # 5 points within eps of each other (a cluster of exactly
        # min_samples), 4 such points elsewhere (noise)
        five = np.array([[0, 0, 0], [0.25, 0, 0], [0, 0.25, 0],
                         [0, 0, 0.25], [0.25, 0.25, 0]])
        four = five[:4] + 10.0
        return np.concatenate([five, four]), 0.5, 5
    if name == "at_eps":
        # a line of points exactly eps apart: interior core, ends border
        line = np.stack([np.arange(12) * 0.5, np.zeros(12), np.zeros(12)], -1)
        return np.concatenate([line, line[:2] + [0, 7.0, 0]]), 0.5, 3
    raise KeyError(name)


@pytest.mark.parametrize("name", ["shared_border_a_first",
                                  "shared_border_b_first",
                                  "exactly_min_samples", "at_eps"])
def test_dbscan_built_cases_match_sklearn(name):
    x, eps, ms = _built_dbscan_case(name)
    want = DBSCAN(eps=eps, min_samples=ms).fit_predict(x)
    got = dbscan(x, eps, ms)
    np.testing.assert_array_equal(got, want)
    if name.startswith("shared_border"):
        # the border point joins the cluster of the lower core index: 0
        border = 4 if name.endswith("b_first") else 8
        assert got[border] == 0 and got.max() == 1
    if name == "exactly_min_samples":
        assert got.tolist() == [0] * 5 + [-1] * 4
    if name == "at_eps":
        assert (got[:12] == 0).all() and (got[12:] == -1).all()


@pytest.mark.parametrize("seed", range(6))
def test_dbscan_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    # blobs of points, with scattered points between them
    centers = rng.uniform(0, 10, (int(rng.integers(3, 12)), 3))
    blobs = [c + rng.normal(scale=rng.uniform(0.1, 0.4),
                            size=(int(rng.integers(5, 300)), 3))
             for c in centers]
    x = np.concatenate(blobs + [rng.uniform(0, 10, (300, 3))])
    if seed % 2:
        x = np.round(x * 8) / 8  # many distances exactly at eps
    eps = (0.3, 0.25)[seed % 2]
    ms = int(rng.integers(3, 8))
    want = DBSCAN(eps=eps, min_samples=ms).fit_predict(x)
    np.testing.assert_array_equal(dbscan(x, eps, ms), want)
    assert want.max() >= 1  # several clusters


def _instance_case(seed):
    """Clusters of 30 (skipped), 31 and 60 movable points, stray points;
    local-map votes: dynamic in the 60-cluster, a tie (2 dynamic x 2 vs 4
    static) in the 31-cluster."""
    rng = np.random.default_rng(seed)

    def cluster(n, at):
        return np.concatenate([rng.normal(scale=0.05, size=(n, 2)),
                               rng.uniform(-0.5, 0.5, (n, 1))], 1) + at

    c30, c31, c60 = (cluster(30, [5, 5, 0]), cluster(31, [-5, 5, 0]),
                     cluster(60, [5, -5, 0]))
    stray = rng.uniform(-40, 40, size=(200, 3))
    cur = np.concatenate([c30, c31, c60, stray]).astype(np.float32)
    cur_preds = rng.integers(1, 3, len(cur)).astype(np.int64)
    bf = np.concatenate([np.full(121, 2), rng.integers(0, 3, 200)])
    tie_pts = np.tile(np.append(c31[:, :2].mean(0), 0.3), (6, 1))  # in the box
    local = np.concatenate([c30, c60, tie_pts, stray]).astype(np.float32)
    local_preds = np.concatenate([np.full(30, 2), np.full(60, 2),
                                  [2, 2, 1, 1, 1, 1],
                                  rng.integers(0, 3, 200)])
    return cur, cur_preds, bf, local, local_preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instance_vote_matches_jax(seed):
    cur, cur_preds, bf, local, local_preds = _instance_case(seed)
    want = jax_voting.instance_vote(cur, cur_preds, bf, local, local_preds)
    got = voting.instance_vote(cur, cur_preds, bf, local, local_preds)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:30], cur_preds[:30])  # <= 30: skipped
    assert (got[30:61] == 1).all()  # the tie stays static
    assert (got[61:121] == 2).all()


def test_instance_vote_without_sklearn():
    probe = (
        "import sys; sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "from streammos_tpu_torch.postprocess.voting import instance_vote\n"
        "rng = np.random.default_rng(0)\n"
        "c = rng.normal(scale=0.05, size=(60, 3)) * [1, 1, 8] + 5\n"
        "out = instance_vote(c, np.ones(60, np.int64), np.full(60, 2), c,\n"
        "                    np.full(60, 2))\n"
        "assert (out == 2).all(), out\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
