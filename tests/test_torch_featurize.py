"""The port's per-frame preprocessing against the JAX functions:
`featurize`, `tta_expand_folded`, `tta_scores`, and the integer cell ids
`_cell_ids` derives from the coordinates.

Tolerances: the BEV coordinates, the TTA expansion and every cell id are
exact; the range-view coordinates and the distance channel carry XLA:CPU's
float32 sqrt and asin, which differ from torch's in the last place
(rtol 1e-6); the TTA scores are a float32 softmax (1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streammos_tpu.models import stream_mos as j_sm
from streammos_tpu.ops import voxel_pool as j_vp

from streammos_tpu_torch.models import stream_mos as t_sm
from streammos_tpu_torch.ops import voxel_pool as t_vp
from tests.test_torch_common import lidar_points, tiny_cfgs, use_few_threads

use_few_threads()


@pytest.fixture(scope="module")
def featurized():
    jcfg, tcfg = tiny_cfgs()
    xyzi = lidar_points(np.random.RandomState(0), (1, 3, 2048))
    fj = jax.jit(lambda x: j_sm.featurize(j_sm.tta_expand_folded(x), jcfg))
    want = {k: np.asarray(v) for k, v in fj(jnp.asarray(xyzi)).items()}
    got = {k: v.numpy() for k, v in
           t_sm.featurize(t_sm.tta_expand_folded(torch.from_numpy(xyzi)),
                          tcfg).items()}
    return xyzi, want, got


def test_tta_expand_folded():
    xyzi = lidar_points(np.random.RandomState(1), (2, 3, 100))
    want = np.asarray(j_sm.tta_expand_folded(jnp.asarray(xyzi)))
    got = t_sm.tta_expand_folded(torch.from_numpy(xyzi)).numpy()
    np.testing.assert_array_equal(got, want)


def test_featurize_coords(featurized):
    _, want, got = featurized
    assert got["points"].shape == want["points"].shape == (1, 3, 2048, 4, 7)
    np.testing.assert_array_equal(got["bev_coord"], want["bev_coord"])
    np.testing.assert_allclose(got["rv_coord"], want["rv_coord"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["points"], want["points"], rtol=1e-6,
                               atol=1e-6)
    # x, y, z, intensity and the BEV fractional parts are exact
    keep = [0, 1, 2, 3, 5, 6]
    np.testing.assert_array_equal(got["points"][..., keep],
                                  want["points"][..., keep])


@pytest.mark.parametrize("kind,scale", [("bev", 1.0), ("bev", 0.5),
                                        ("bev", 0.25), ("rv", 1.0),
                                        ("rv", 0.5), ("rv", 0.25)])
def test_cell_ids_of_featurized_coords(featurized, kind, scale):
    """Every variant's cell ids at every scale the model uses, from each
    side's own coordinates."""
    _, want, got = featurized
    jcfg, _ = tiny_cfgs()
    key, size = (("bev_coord", jcfg.voxel.bev_wl) if kind == "bev"
                 else ("rv_coord", jcfg.voxel.rv_shape))
    out = (int(size[0] * scale), int(size[1] * scale))
    jc = want[key][..., :2].reshape(-1, 1, 2)
    tc = torch.from_numpy(got[key][..., :2].reshape(-1, 1, 2))
    jf, jv = j_vp._cell_ids(jnp.asarray(jc), out, (scale, scale))
    tf, tv, _ = t_vp._cell_ids(tc, out, (scale, scale))
    assert np.asarray(jv).mean() > 0.5
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    if kind == "bev" and scale == 1.0:  # the fused header's layout
        jf, _ = j_vp._cell_ids(jnp.asarray(jc), out, (1.0, 1.0), "outer", 1)
        tf, _, _ = t_vp._cell_ids(tc, out, (1.0, 1.0), "outer", 1)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_tta_scores():
    rng = np.random.RandomState(2)
    logits = (rng.randn(2, 500, 12) * 4).astype(np.float32)
    want = np.asarray(j_sm.tta_scores(jnp.asarray(logits), 3))
    got = t_sm.tta_scores(torch.from_numpy(logits), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
