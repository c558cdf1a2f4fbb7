"""No module of the port imports jax, the JAX package or scikit-learn:
import every module of `streammos_tpu_torch` (and `chip_smoke.py`) in a
fresh interpreter and inspect `sys.modules`."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
               for m in sys.modules), "jax was imported before the probe"
import streammos_tpu_torch
names = [m.name for m in pkgutil.walk_packages(streammos_tpu_torch.__path__,
                                               "streammos_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "streammos_tpu", "sklearn"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    import json

    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in ("config", "geometry", "weights", "serve", "build",
                 "ops.fused_header", "ops.voxel_pool", "ops.pallas_scatter",
                 "ops.pallas_scatter_vmem", "nn.encoder",
                 "models.stream_mos", "losses", "data.semantic_kitti",
                 "train.optim", "train.trainer", "train.checkpoint",
                 "host_geometry", "native.api", "native.build",
                 "data.augment", "data.copy_paste", "data.dataset",
                 "data.droplist", "data.loader", "metrics", "parallel",
                 "utils.ioueval", "utils.logging", "train.evaluate",
                 "tools.val", "tools.train", "postprocess",
                 "postprocess.voting", "postprocess.dbscan", "utils.boxes",
                 "utils.visualize", "tools.voting", "tools.port_weights",
                 "tools.extract_objects", "tools.make_drop_list",
                 "tools.synthetic", "tools.dress_rehearsal"):
        assert f"streammos_tpu_torch.{name}" in report["modules"]


WORKER_PROBE = r"""
import json, sys
import streammos_tpu_torch.data.dataset, streammos_tpu_torch.data.loader
import streammos_tpu_torch.data.copy_paste, streammos_tpu_torch.data.droplist
import streammos_tpu_torch.tools.train, streammos_tpu_torch.tools.val
import streammos_tpu_torch.tools.voting
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_worker_modules_import_no_torch():
    """What a spawned `SampleWorkerPool` or voting worker imports (the
    datasets, and a CLI module as the parent's main) pulls in neither torch
    nor jax."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", WORKER_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    import json

    top = json.loads(res.stdout.strip().splitlines()[-1])
    assert not set(top) & {"torch", "jax", "jaxlib", "streammos_tpu"}, top
