"""Weights carried into the port: `weights.from_flax_variables` against the
JAX package's `flax_to_torch_state_dict` (same keys, equal values), and
coverage of every parameter and buffer of the port model."""
import numpy as np
import pytest
import torch

from streammos_tpu.train.port_torch import flax_to_torch_state_dict

from streammos_tpu_torch.models.stream_mos import StreamMOSNet
from streammos_tpu_torch.weights import (DEAD_KEY_MARKERS, build_mapping,
                                         from_flax_variables,
                                         load_state_dict_checked)
from tests.test_torch_common import jax_tiny_model, tiny_cfgs, use_few_threads

use_few_threads()


@pytest.fixture(scope="module")
def carried():
    _, variables = jax_tiny_model()
    jcfg, cfg = tiny_cfgs()
    return (variables, from_flax_variables(variables, cfg, with_refine=True),
            flax_to_torch_state_dict(variables, jcfg, with_refine=True))


def test_same_keys_and_values_as_jax_inverse_port(carried):
    _, got, want = carried
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)


def test_every_port_parameter_is_covered(carried):
    _, got, _ = carried
    _, cfg = tiny_cfgs()
    model = StreamMOSNet(cfg, with_refine=True)
    live = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(live) == sorted(got)
    for key, value in live.items():
        assert tuple(value.shape) == tuple(got[key].shape), key
    load_state_dict_checked(model, got)
    for key, value in model.state_dict().items():
        if key in got:
            assert torch.equal(value, got[key]), key


def test_stage1_model_takes_a_stage2_state_dict(carried):
    _, got, _ = carried
    _, cfg = tiny_cfgs()
    model = StreamMOSNet(cfg, with_refine=False)
    load_state_dict_checked(model, got)  # refine.* keys are skipped
    n_stage1 = len(build_mapping(cfg, False).params) + len(build_mapping(cfg, False).stats)
    assert n_stage1 == len([k for k in got if not k.startswith("refine.")])


def test_reference_checkpoint_keys(carried):
    """A reference-format state_dict also holds dead modules' keys and the
    BN step counters; those load, a stray live key does not."""
    _, got, _ = carried
    _, cfg = tiny_cfgs()
    model = StreamMOSNet(cfg, with_refine=True)
    ref = dict(got)
    ref["bev_net.up1.conv.weight"] = torch.zeros(3)
    ref["point_pre.layer.0.layer.0.num_batches_tracked"] = torch.tensor(5)
    assert any(m in "bev_net.up1.conv.weight" for m in DEAD_KEY_MARKERS)
    load_state_dict_checked(model, ref)
    ref["bev_net.not_a_module.weight"] = torch.zeros(3)
    with pytest.raises(KeyError):
        load_state_dict_checked(model, ref)
    del ref["bev_net.not_a_module.weight"], ref["pred_layer.pred_layer.0.bias"]
    with pytest.raises(KeyError):
        load_state_dict_checked(model, ref)
