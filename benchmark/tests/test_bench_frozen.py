"""The yardstick's frozen copies equal the program's arithmetic today, at
both configurations: the FLOP counts, K1's operations and bytes, K2's bytes,
the engine's noise ring and the serving checkpoint's layout."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import work
from benchmark.harness.common import BENCH, hparams
from benchmark.harness.traffic import hps_of
from benchmark.reference import flops as ref_flops

CONFIGS = ("base", "adapt")


def _hps(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return hparams(json.load(f))


def _port_models(hps_dict, train):
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from vits_tpu_torch.models.synthesizer import Synthesizer
    with torch.device("meta"):
        return (Synthesizer.from_hps(HParams(**hps_dict), train=train),
                MultiPeriodDiscriminator(False))


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_files_hold_the_shipped_configs(name):
    with open(os.path.join(os.path.dirname(BENCH), "configs", name + ".json")) as f:
        shipped = json.load(f)
    assert _hps(name) == shipped


@pytest.mark.parametrize("name", CONFIGS)
def test_inference_flops_equal_the_port(name):
    from vits_tpu_torch.utils import flops
    hps_dict = _hps(name)
    synth, _ = _port_models(hps_dict, False)
    ref, _ = work.meta_models(hps_of(hps_dict))
    for B, T_x, T_y in ((1, 150, 1000), (16, 96, 640), (1, 384, 2600)):
        assert ref_flops.infer_flops(ref, B, T_x, T_y) == flops.infer_flops(synth, B, T_x, T_y)
        assert ref_flops.infer_q8_split(ref, B, T_x, T_y) == \
            flops.infer_q8_split(synth, B, T_x, T_y)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_flops_equal_the_port(name):
    from vits_tpu_torch.config import HParams
    from vits_tpu_torch.train.step import TrainStepConfig
    from vits_tpu_torch.utils import flops
    from benchmark.reference.step import TrainStepConfig as RefCfg
    hps_dict = _hps(name)
    synth, disc = _port_models(hps_dict, True)
    ref_s, ref_d = work.meta_models(hps_of(hps_dict), train=True)
    cfg, ref_cfg = TrainStepConfig.from_hps(HParams(**hps_dict)), RefCfg.from_hps(hps_of(hps_dict))
    for B, T_x, T_y in ((32, 96, 500), (32, 192, 1000)):
        assert ref_flops.train_step_flops(ref_s, ref_d, ref_cfg, B, T_x, T_y) == \
            flops.train_step_flops(synth, disc, cfg, B, T_x, T_y)


@pytest.mark.parametrize("name", CONFIGS)
def test_k1_ops_and_bytes_equal_the_port(name):
    from vits_tpu_torch.nn import rb_chain
    from benchmark.reference.rb_chain import chain_ops_bytes
    chains = work.decoder_chains(hps_of(_hps(name)), 16, 640)
    assert len(chains) == 12
    for B, M, C, K, n in chains:
        assert chain_ops_bytes(B, M, C, K, n) == rb_chain.chain_ops_bytes(B, M, C, K, n)


def test_k2_bytes_equal_the_port():
    from vits_tpu_torch.ops import mas
    from benchmark.reference.mas import mas_bytes
    t_ys = torch.tensor([500, 420, 333], dtype=torch.int32)
    t_xs = torch.tensor([96, 80, 61], dtype=torch.int32)
    assert mas_bytes(t_ys, t_xs, 512, 96) == mas.mas_bytes(t_ys, t_xs, 512, 96)


def test_engine_ring_equals_the_engines(tmp_path):
    from benchmark.harness.serve import engine_ring
    from benchmark.harness.weights import build_serving_model, write_checkpoint
    from benchmark.tests.tiny import TINY_CONFIG
    from vits_tpu_torch.infer import EmoVITS
    hps_dict = hparams(TINY_CONFIG)
    model = build_serving_model(hps_of(hps_dict), 5, torch.device("cpu"),
                                TINY_CONFIG["assumed"])
    engine = EmoVITS(write_checkpoint(str(tmp_path), model, hps_dict), device="cpu")
    np.testing.assert_array_equal(engine.noise, engine_ring(hps_of(hps_dict)))
    # the checkpoint loads into the program's model with the same values
    ours = model.state_dict()
    for k, v in engine.synth.state_dict().items():
        torch.testing.assert_close(v, ours[k], rtol=0, atol=0)
